"""Integrator and shading in plain PyTorch: device milliseconds a displayed
frame in every kernel outside the traversal kernels (ray generation, the
BSDF, probe sampling, texturing, compaction, the film and the tone map)."""

from fovbench.metrics.traversal_ms import is_traversal


def read(ctx):
    if ctx.trace is None:
        return None
    ms = sum(d for n, d in ctx.trace.kernels() if not is_traversal(n)) * 1e3
    return ms / ctx.trace.frames if ms > 0 else None
