"""Traversal kernels: the least time the card could take for a frame's
traversal over the time the traversal kernels took, in percent.

The least time is a memory bound, from what the frame's queries need and
not from what a table makes a kernel visit, so that a new layout or kernel
leaves the yardstick where it is: each traced ray read once (origin,
direction, extent), each result written once (t, u, v, triangle,
instance), and the table's triangles read once an eye (v0, e1, e2), at
the card's peak bandwidth. The rays are the frame's ``traces``; the
triangles are ``ctx.triangles``, those that lie on the card: a flat
scene's world triangles, an instanced scene's unique ones (each instance
walks the same unique triangles)."""

from fovbench.metrics.traversal_ms import is_traversal

RAY_BYTES = 3 * 4 + 3 * 4 + 2 * 4  # origin, direction, tmin and tmax
RESULT_BYTES = 3 * 4 + 4 + 4  # t, u, v; triangle; instance
TRIANGLE_BYTES = 9 * 4  # v0, e1, e2


def frame_bytes(traces: float, triangles: int) -> float:
    return traces * (RAY_BYTES + RESULT_BYTES) + triangles * TRIANGLE_BYTES


def read(ctx):
    if ctx.trace is None or ctx.traced_traces is None:
        return None
    s = sum(d for n, d in ctx.trace.kernels() if is_traversal(n))
    if s <= 0:
        return None
    frames = ctx.trace.frames
    least = (frame_bytes(ctx.traced_traces / frames,
                         ctx.triangles * ctx.eyes)
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (s / frames)
