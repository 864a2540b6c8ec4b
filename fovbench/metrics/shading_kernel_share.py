"""Integrator and shading: the share of the bounces shaded by the port's
hand-written kernels (``csrc/shade.cu``) among all bounces shaded, in
percent: the port's ``shade`` counts (``utils/tracing.py``: each bounce
of ``trace_paths`` under ``"kernel"`` or ``"plain"`` by the path it took),
over every frame the run rendered. None where the port keeps no ``shade``
counts."""

from fovbench.spans import port_counters


def read(ctx):
    c = port_counters()
    shade = None if c is None else c.get("shade")
    if not shade:
        return None
    total = sum(shade.values())
    return 100.0 * shade.get("kernel", 0) / total if total else None
