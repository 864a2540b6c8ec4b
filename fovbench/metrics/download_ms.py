"""Front end: the host's milliseconds a displayed frame in the download
(the port's span ``fov.sync.download``, its whole time, ``ns_total``,
``utils/tracing.py``): the wait for the frame's tail on the device and for
the copy of its pixels to the host, both eyes' for a stereo pair. Read
from the port's counters, which are the process's: over every frame the
run rendered, the warm-up frames and the traced frames included, so a
slow first download or a profiled one weighs in (a reading of the window
alone needs the harness to snapshot the counters around it). None where
the port keeps no such span."""

from fovbench.spans import port_counters

SPAN = "fov.sync.download"


def read(ctx):
    c = port_counters()
    if c is None or not c.get("frames"):
        return None
    ns = c.get("ns_total", {}).get(SPAN)
    return None if ns is None else ns * 1e-6 / c["frames"]
