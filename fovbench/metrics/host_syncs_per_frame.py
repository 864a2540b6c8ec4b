"""Front end: the calls a displayed frame makes that wait for the device
(the port's ``fov.sync.*`` counts, ``utils/tracing.py``: the live-lane
``nonzero``, a narrowing each bounce, the download). Read from the port's
counters over every frame the run rendered: set-up's warm-up, the window
and the traced frames make the same syncs a frame. None where the port
keeps no counters."""

from fovbench.spans import per_frame, port_counters


def read(ctx):
    c = port_counters()
    return None if c is None else per_frame(c).get("host_syncs_per_frame")
