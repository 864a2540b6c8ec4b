"""Front end: device operations launched a displayed frame (kernels,
copies and sets in the traced window, over its frames)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace.frames
