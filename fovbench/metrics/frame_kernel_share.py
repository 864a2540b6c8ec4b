"""Integrator and shading: the share of the frame's ray generation and
film stages taken by the port's hand-written kernels (``csrc/frame.cu``)
among all such stages, in percent: the port's ``raygen`` counts (each
wavefront's ray generation) and ``film`` counts (each frame's film and
tone map), keyed ``"kernel"`` or ``"plain"`` by the path each took
(``utils/tracing.py``), over every frame the run rendered. None where the
port keeps neither group, or counted nothing in them."""

from fovbench.spans import port_counters


def read(ctx):
    c = port_counters()
    if c is None:
        return None
    counts = [n for group in ("raygen", "film")
              for n in (c.get(group) or {}).items()]
    total = sum(n for _, n in counts)
    if not total:
        return None
    return 100.0 * sum(n for k, n in counts if k == "kernel") / total
