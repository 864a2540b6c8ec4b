"""Integrator and shading: the lanes that enter the bounces over the lanes
a fixed-size, uncompacted bounce would walk (the first bounce's, at every
depth counted), in percent: the port's ``lanes`` counts
(``utils/tracing.py``), over every frame the run rendered. None where the
port keeps no counters."""

from fovbench.spans import per_frame, port_counters


def read(ctx):
    c = port_counters()
    return None if c is None else per_frame(c).get("lanes_alive_share")
