"""Device: the share of a displayed frame in which no kernel, copy or set
ran on the card, in percent: one minus the device's busy seconds a traced
frame (the union of the device intervals of a trace that records the
device's activity alone) over the seconds a frame took in the untraced
window. The profiler slows the host, not the device: traced frames take
longer than the window's (the result's ``info`` line gives both), so their
own idle share would read the profiler's cost."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    busy = ctx.trace.busy_s / ctx.trace.frames
    return 100.0 * (1.0 - busy / ctx.frame_s)
