"""Wide BVH build through the native binned-SAH collapse (counterpart of the
JAX package's ``ops/bvh_native.py`` for single-level scenes)."""

from __future__ import annotations

import ctypes

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh8 import (
    ARITY,
    LEAF_SIZE,
    LEAF_SIZE8,
    WideBVH,
    pack_wide,
    pack_wide_legacy8,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.native import load_library

# scenes at or past this size use the deep-scene packing (L12/A32, DFS,
# treelets) in the JAX package, which this port does not implement yet
DEEP_TRIS_THRESHOLD = 1_000_000


def collapse(tris: np.ndarray, leaf_size: int, arity: int):
    """Native binned-SAH BVH2 + collapse -> (boxes (M, A, 6), meta (M, A, 2),
    order_slots)."""
    lib = load_library()
    tris = np.ascontiguousarray(tris, dtype=np.float32)
    boxes_p = ctypes.POINTER(ctypes.c_float)()
    meta_p = ctypes.POINTER(ctypes.c_int32)()
    perm_p = ctypes.POINTER(ctypes.c_int32)()
    num_nodes = ctypes.c_int64()
    num_slots = ctypes.c_int64()
    rc = lib.fovtix_build_bvhw(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(tris.shape[0]), ctypes.c_int(leaf_size),
        ctypes.c_int(arity), ctypes.byref(boxes_p), ctypes.byref(meta_p),
        ctypes.byref(num_nodes), ctypes.byref(perm_p), ctypes.byref(num_slots),
    )
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    try:
        m, s = num_nodes.value, num_slots.value
        boxes = np.ctypeslib.as_array(boxes_p, shape=(m, arity, 6)).copy()
        meta = np.ctypeslib.as_array(meta_p, shape=(m, arity, 2)).copy()
        perm = np.ctypeslib.as_array(perm_p, shape=(s,)).copy()
    finally:
        lib.fovtix_free(boxes_p)
        lib.fovtix_free(meta_p)
        lib.fovtix_free(perm_p)
    return boxes, meta, perm.astype(np.int64)


def build(tris: np.ndarray, leaf_size: int = LEAF_SIZE,
          arity: int = ARITY) -> WideBVH:
    """Packed single-level WideBVH from (T, 3, 3) float32 corners."""
    if tris.shape[0] >= DEEP_TRIS_THRESHOLD:
        raise NotImplementedError(
            "deep-scene packing (>= 1M triangles) is not ported"
        )
    boxes, meta, perm = collapse(tris, leaf_size, arity)
    return pack_wide(boxes, meta, tris, perm, leaf_size, arity)


def build_legacy8(tris: np.ndarray, leaf_size: int = LEAF_SIZE8) -> WideBVH:
    """The legacy 8-wide f32 table the packet kernel walks."""
    boxes, meta, perm = collapse(tris, leaf_size, 8)
    return pack_wide_legacy8(boxes, meta, tris, perm, leaf_size)
