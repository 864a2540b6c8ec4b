"""Wide BVH build through the native binned-SAH collapse (counterpart of the
JAX package's ``ops/bvh_native.py`` for single-level scenes), with its npz
cache of packed tables; ``build(force_python=True)`` collapses in Python
instead and bypasses the cache.

Which table ``build`` packs:

- Nothing named (``build(tris)``): the (arity, leaf size) = (16, 6) table
  in pack order at every scene size. This is the port's one deviation
  from the JAX package, which picks its deep tables by scene size.
- Any of ``leaf_size``, ``arity`` or ``dfs`` named: the JAX package's
  ``build`` table for the same call, bit for bit. The unnamed ones follow
  its size rule: from ``DEEP_TRIS_THRESHOLD`` (1M) triangles L12/A32, from
  ``DEEPER_TRIS_THRESHOLD`` (4M) L24/A32, ``dfs`` on from 1M; a deep scene
  with ``dfs`` on is laid out in treelets of ``DEEP_TREELET_BUDGET`` rows
  (``FOVTPU_TREELET``, default 8192) with small siblings grouped
  (``bvh8.pack_wide``). So ``build(tris, leaf_size=12, arity=32)`` on
  1.92M triangles gives the JAX package's default deep table, and
  ``dfs=False`` its plain one.

The kernels are compiled for (16, 6), (32, 12) and (32, 24)
(``ops/traverse.py``); a row order is no layout, and every walk takes the
DFS and treelet tables. As in the JAX package, a layout the native
collapse refuses (``collapse`` returns None: leaves of more than 15
triangles, so every L24 table) is collapsed in Python
(``bvh8.collapse_bvh2``), on the host, which takes far longer: seconds at
388,812 triangles where the native build takes a fraction of one, minutes
at 10M.

The cache: the native build of a 10M-triangle scene takes tens of seconds
on the host, and the packed table is a deterministic function of the
triangles, the packing parameters and the packing code. ``build`` keys
scenes of at least ``BVH_CACHE_MIN_TRIS`` triangles by a SHA-1 of those
(the row order, the treelet budget and the grouping variables
``FOVTPU_TGROUP``/``FOVTPU_TGROUP_DIV`` among the parameters; the code as
the digest of its sources, ``packing_digest``), stores the packed
``WideBVH`` as one npz file, and on a hit returns it bit for bit from one
``np.load``; a file without one of its fields is rebuilt. The native
builder's source, which decides the layouts it refuses, is in the digest,
so a key names the tables of one collapse: a Python-collapsed table never
shares a key with a native one (``force_python`` never reads or writes the
cache). The directory is ``FOVTPU_BVH_CACHE`` (the JAX package's variable;
its keys and the port's never collide), by default ``build/bvh_cache/`` in
the checkout; "" disables the cache.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import time

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh8 import (
    ARITY,
    LEAF_SIZE,
    LEAF_SIZE8,
    WideBVH,
    collapse_bvh2,
    pack_wide,
    pack_wide_legacy8,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.build_dir import build_dir
from fovpathtracing_optixcodelatest_tpu_torch.ops.native import load_library

# the JAX package's packing by scene size (its ops/bvh_native.py), which
# ``build`` follows where the caller names a layout or ``dfs``
DEEP_LEAF_SIZE = 12
DEEP_ARITY = 32
DEEP_TRIS_THRESHOLD = 1_000_000
DEEPER_LEAF_SIZE = 24
DEEPER_TRIS_THRESHOLD = 4_000_000
# rows a treelet of a deep table may span
DEEP_TREELET_BUDGET = int(os.environ.get("FOVTPU_TREELET", 8192))
# caching tiny builds costs more in hashing than it saves
BVH_CACHE_MIN_TRIS = 200_000
_HERE = os.path.dirname(os.path.abspath(__file__))
# the sources whose code decides the packed table: the native collapse, the
# packing and this module
PACKING_SOURCES = tuple(os.path.join(_HERE, f) for f in (
    "native/bvh_builder.cpp", "bvh8.py", "bvh_native.py"))


def cache_dir() -> str:
    """The cache directory ("" = no cache): ``FOVTPU_BVH_CACHE``, read at
    each build, else ``build/bvh_cache/`` in the checkout."""
    path = os.environ.get("FOVTPU_BVH_CACHE")
    if path is None:
        return build_dir("bvh_cache")
    return path


def collapse_native(tris: np.ndarray, leaf_size: int, arity: int):
    """The JAX package's name of ``collapse``."""
    return collapse(tris, leaf_size, arity)


def collapse(tris: np.ndarray, leaf_size: int, arity: int):
    """Native binned-SAH BVH2 + collapse -> (boxes (M, A, 6), meta (M, A, 2),
    order_slots), or None where the native builder refuses the layout."""
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
        return None
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


def collapse_any(tris: np.ndarray, leaf_size: int, arity: int):
    """``collapse``, or the pure-Python collapse (``bvh8.collapse_bvh2``)
    where the native builder refuses the layout, as the JAX package's
    ``build`` and ``tlas.build_instanced`` fall through."""
    out = collapse(tris, leaf_size, arity)
    return collapse_bvh2(tris, leaf_size, arity) if out is None else out


@functools.lru_cache(maxsize=1)
def packing_digest() -> str:
    """SHA-1 of ``PACKING_SOURCES``: any edit of the packing code gives new
    cache keys, so a stale table is never returned."""
    h = hashlib.sha1()
    for path in PACKING_SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _cache_key(tris: np.ndarray, leaf_size: int, arity: int,
               dfs: bool = False, budget: int = 0) -> str:
    h = hashlib.sha1()
    grp = os.environ.get("FOVTPU_TGROUP", "1")
    gdiv = os.environ.get("FOVTPU_TGROUP_DIV", "4")
    h.update(f"torch-{packing_digest()}|{tris.shape[0]}|{leaf_size}|"
             f"{arity}|{int(dfs)}|{budget}|g{grp}|d{gdiv}|".encode())
    h.update(np.ascontiguousarray(tris, dtype=np.float32).tobytes())
    return h.hexdigest()


_FIELDS = [f.name for f in dataclasses.fields(WideBVH)]


def _cache_load(path: str) -> WideBVH | None:
    try:
        with np.load(path) as z:
            return WideBVH(**{
                k: z[k] if k in ("table", "leaf_perm") else z[k].item()
                for k in _FIELDS
            })
    except (OSError, KeyError, ValueError):
        return None


def _cache_save(path: str, bvh: WideBVH) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npz"
        np.savez(tmp, **{k: getattr(bvh, k) for k in _FIELDS})
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best-effort


def layout(n_tris: int, leaf_size: int | None = None,
           arity: int | None = None, dfs: bool | None = None
           ) -> tuple[int, int, bool, int]:
    """(leaf_size, arity, dfs, treelet budget) ``build`` packs for a scene
    of ``n_tris`` triangles: the (16, 6) table in pack order where nothing
    is named, else the JAX package's choice for the same arguments."""
    if leaf_size is None and arity is None and dfs is None:
        return LEAF_SIZE, ARITY, False, 0
    deep = n_tris >= DEEP_TRIS_THRESHOLD
    if leaf_size is None:
        leaf_size = (DEEPER_LEAF_SIZE if n_tris >= DEEPER_TRIS_THRESHOLD
                     else DEEP_LEAF_SIZE if deep else LEAF_SIZE)
    if arity is None:
        arity = DEEP_ARITY if deep else ARITY
    if dfs is None:
        dfs = deep
    return leaf_size, arity, dfs, DEEP_TREELET_BUDGET if deep and dfs else 0


def build(tris: np.ndarray, leaf_size: int | None = None,
          arity: int | None = None, force_python: bool = False,
          dfs: bool | None = None, *, timings: dict | None = None) -> WideBVH:
    """Packed single-level WideBVH from (T, 3, 3) float32 corners at the
    packing ``layout`` chooses, through the npz cache for scenes of
    ``BVH_CACHE_MIN_TRIS`` triangles or more. The native collapse builds
    it where it takes the layout, the pure-Python one
    (``bvh8.collapse_bvh2``, the JAX package's tree) where it refuses, as
    the JAX package's ``build`` falls through. ``timings`` gets the host
    seconds of each step taken: ``key_s`` and ``load_s`` on a cache hit,
    else ``collapse_s``, ``pack_s`` and, where the scene is cached,
    ``key_s`` and ``save_s``. ``force_python`` collapses in Python
    whatever the layout and never reads or writes the cache."""
    leaf_size, arity, dfs, budget = layout(tris.shape[0], leaf_size, arity,
                                           dfs)
    clock = {} if timings is None else timings
    t0 = time.perf_counter()
    path = None
    directory = ("" if force_python or tris.shape[0] < BVH_CACHE_MIN_TRIS
                 else cache_dir())
    if directory:
        path = os.path.join(
            directory, _cache_key(tris, leaf_size, arity, dfs, budget)
            + ".npz")
        t0 = _lap(clock, "key_s", t0)
        cached = _cache_load(path)
        if cached is not None:
            _lap(clock, "load_s", t0)
            return cached
        t0 = time.perf_counter()
    collapse_fn = collapse_bvh2 if force_python else collapse_any
    boxes, meta, perm = collapse_fn(tris, leaf_size, arity)
    t0 = _lap(clock, "collapse_s", t0)
    bvh = pack_wide(boxes, meta, tris, perm, leaf_size, arity, dfs=dfs,
                    treelet_budget=budget)
    t0 = _lap(clock, "pack_s", t0)
    if path is not None:
        _cache_save(path, bvh)
        _lap(clock, "save_s", t0)
    return bvh


def _lap(clock: dict, name: str, t0: float) -> float:
    now = time.perf_counter()
    clock[name] = now - t0
    return now


def build_legacy8(tris: np.ndarray, leaf_size: int = LEAF_SIZE8) -> WideBVH:
    """The legacy 8-wide f32 table the packet kernel walks, through the
    native collapse. This is not the tree of the JAX package's
    ``bvh8.build_legacy8``, which collapses in Python (the port's
    ``bvh8.build_legacy8``): the two builders give different tables of the
    same shape."""
    out = collapse(tris, leaf_size, 8)
    if out is None:
        raise ValueError(f"the native collapse refuses leaves of {leaf_size}")
    boxes, meta, perm = out
    return pack_wide_legacy8(boxes, meta, tris, perm, leaf_size)
