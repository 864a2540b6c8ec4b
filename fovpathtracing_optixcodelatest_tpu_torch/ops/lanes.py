"""A wavefront's live lanes on the card: the wrapper of ``csrc/lanes.cu``.

A lane list has a capacity n, the length of its buffers, and a length,
``count``: a (1,) int32 tensor that the device holds (None: all n). Its
first ``count`` entries are lanes, int64 indices into a wavefront's
full-size state arrays; ray generation's list is the identity (``idx``
None).

``compact`` is the stable compaction of a list by a mask over its
positions: the next list is ``idx[mask]`` over the first ``count``
positions, in their order, and its length is written on the device, with
the lanes' rays gathered from the state's origin and direction arrays and
the length added into a depth's lane count. On CUDA tensors it launches
``compact_kernel`` once (a single pass: warp ballots within a block, a
decoupled look-back across blocks) and nothing goes back to the host, so
``render/integrator.py`` ``trace_paths`` queues a whole wavefront without
waiting for the device; the launch counts in ``kernel_build.LAUNCHES``
(``compact``). On CPU tensors it runs ``compact_plain``, its plain version.

The C interface takes one struct (``CompactArgs``): pointers first, then
32-bit integers, as ``csrc/lanes.cu`` declares it. Besides the lists, the
kernel takes ``tiles``: ``tile_words(n)`` zeroed int32 words of scratch
(the blocks' ticket and each tile's status), which a launch spends.
"""

from __future__ import annotations

import ctypes

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build

# positions a block compacts (csrc/lanes.cu kTile), and the longest list a
# tile's status word counts (kMaxLanes)
TILE = 1024
MAX_LANES = 2**30 - 1

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
# the struct's tensors, in its order, with their dtypes; None marks an
# optional one (a null pointer)
COMPACT_TENSORS = {
    "mask": _BOOL, "idx_in": _I64, "count_in": _I32, "o": _F32, "d": _F32,
    "idx_out": _I64, "count_out": _I32, "o_out": _F32, "d_out": _F32,
    "lanes": _I64, "tiles": _I32,
}


class CompactArgs(ctypes.Structure):
    """``fov_compact``'s argument struct (csrc/lanes.cu)."""

    _fields_ = [*((k, ctypes.c_void_p) for k in COMPACT_TENSORS),
                ("n", ctypes.c_int), ("tile", ctypes.c_int)]


def tile_words(n: int) -> int:
    """The int32 words of scratch a compaction of capacity n takes: the
    ticket and one status word a tile (one tile at least)."""
    return 1 + max(1, -(-n // TILE))


def outputs(n: int, device) -> dict:
    """Fresh outputs for one compaction of capacity n (``compact``'s
    ``out``), its scratch and lane count zeroed."""
    return {
        "idx_out": torch.empty((n,), dtype=_I64, device=device),
        "count_out": torch.empty((1,), dtype=_I32, device=device),
        "o_out": torch.empty((n, 3), dtype=_F32, device=device),
        "d_out": torch.empty((n, 3), dtype=_F32, device=device),
        "lanes": torch.zeros((1,), dtype=_I64, device=device),
        "tiles": torch.zeros((tile_words(n),), dtype=_I32, device=device),
    }


def compact_plain(mask, idx, count, o, d, out: dict) -> None:
    """``compact`` in plain PyTorch: the lanes at the kept positions (the
    mask's, below the length) in their order, their rays, their number;
    the entries past it are left as they were. It reads the length on the
    host."""
    n = mask.shape[0]
    live = n if count is None else min(int(count[0]), n)
    keep = mask[:live]
    lanes = torch.arange(live, device=mask.device) if idx is None \
        else idx[:live]
    lanes = lanes[keep]
    k = lanes.numel()
    out["idx_out"][:k] = lanes
    out["o_out"][:k] = o[lanes]
    out["d_out"][:k] = d[lanes]
    out["count_out"].fill_(k)
    out["lanes"] += k


def compact(mask: torch.Tensor, idx, count, o: torch.Tensor,
            d: torch.Tensor, out: dict) -> None:
    """The stable compaction of the list ``idx`` ((n,) int64, None for the
    identity) of length ``count`` ((1,) int32, None for n) by ``mask``
    ((n,) bool over its positions) into ``out`` (``idx_out``
    (n,) int64, ``count_out`` (1,) int32, ``o_out``, ``d_out`` (n, 3)
    float32, the lanes' rows of the state arrays ``o``, ``d`` (N, 3);
    ``lanes`` (1,) int64, added to; ``tiles`` (``tile_words(n)``,) int32,
    zeroed). CUDA tensors launch ``compact_kernel``; CPU tensors run
    ``compact_plain``."""
    if mask.device.type == "cpu":
        compact_plain(mask, idx, count, o, d, out)
        return
    kernel_build.launch("lanes", "fov_compact", "compact",
                        pack(mask, idx, count, o, d, out))


def pack(mask, idx, count, o, d, out: dict) -> CompactArgs:
    """``compact``'s struct, each tensor checked (``kernel_build.fill``:
    its dtype, contiguity, shape, and the mask's device); raises
    ``ValueError`` on anything else, and on a list longer than
    ``MAX_LANES``."""
    n = mask.shape[0]
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes: a list holds at most {MAX_LANES}")
    shapes = {"mask": (n,), "idx_in": (n,), "count_in": (1,),
              "idx_out": (n,), "count_out": (1,), "o_out": (n, 3),
              "d_out": (n, 3), "lanes": (1,), "tiles": (tile_words(n),)}
    return kernel_build.fill(
        CompactArgs(n=n, tile=TILE), mask.device, COMPACT_TENSORS,
        {"mask": mask, "idx_in": idx, "count_in": count, "o": o, "d": d,
         **out}, shapes)


def resources() -> dict:
    """Registers per thread, local memory per thread (spills), resident
    blocks per SM and threads a block of ``compact``, as the CUDA runtime
    reports them for the loaded build."""
    keys = ("registers", "local_bytes", "blocks_per_sm", "threads")
    return {"compact": dict(zip(keys, kernel_build.query(
        "lanes", "fov_lanes_info", 0)))}
