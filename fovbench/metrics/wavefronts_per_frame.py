"""Front end: the wavefronts a displayed frame traces (the port's
``wavefronts`` count, one a ``trace_paths`` call, ``utils/tracing.py``):
1 for a mono frame, 2 for a stereo pair whose eyes are traced one after
the other. Read from the port's counters over every frame the run
rendered. None where the port keeps no such count."""

from fovbench.spans import port_counters


def read(ctx):
    c = port_counters()
    if c is None or "wavefronts" not in c or not c.get("frames"):
        return None
    return c["wavefronts"] / c["frames"]
