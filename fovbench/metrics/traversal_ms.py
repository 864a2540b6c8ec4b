"""Traversal kernels: device milliseconds a displayed frame in the port's
hand-written walks (``csrc/traverse.cu``, ``csrc/packet_traverse.cu``),
matched by the kernel names below."""

import re

# closest_hit_kernel, closest_hit_group_kernel, closest_hit_instanced_kernel,
# occluded_kernel, occluded_nocull_kernel, occluded_group_kernel,
# occluded_nocull_group_kernel, occluded_instanced_kernel,
# occluded_nocull_instanced_kernel, occluded_packets_kernel, with or without
# template arguments and namespaces
PATTERN = re.compile(r"\b(closest_hit|occluded)\w*_kernel\b")


def is_traversal(name: str) -> bool:
    return PATTERN.search(name) is not None


def read(ctx):
    if ctx.trace is None:
        return None
    ms = sum(d for n, d in ctx.trace.kernels() if is_traversal(n)) * 1e3
    return ms / ctx.trace.frames if ms > 0 else None
