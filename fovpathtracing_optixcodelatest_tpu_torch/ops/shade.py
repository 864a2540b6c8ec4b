"""The bounce's shading on the card: the wrappers of ``csrc/shade.cu``.

``shade`` launches ``shade_kernel`` after K1 (and the catcher
pass-through): for each live lane the hit's ``tri_pack`` row, the world
normal on a two-level table, the texture sample, the lane's uniforms, the
probe sample, the NEE with MIS, the BSDF sample and the occlusion query
mask. It returns K2's inputs (``p``, ``wi``, ``query``) and the record
``rec`` that ``resolve`` reads. ``resolve`` launches ``resolve_kernel``
after K2: it scatters the bounce's results into the full-size state
arrays in place, adds the bounce's lanes and occlusion queries to
``traces`` and returns the lanes' ``alive`` mask. Each launch counts in
``kernel_build.LAUNCHES`` (``shade``, ``resolve``).

The kernels' plain version is ``render/integrator.py`` ``plain_bounce``
(``bounce`` and its scatter), which the kernels repeat operation for
operation; ``integrator.shades_on_kernels`` decides which runs.

The C interface takes one struct a kernel (``ShadeArgs``,
``ResolveArgs``): pointers first, then 32-bit integers, as
``csrc/shade.cu`` declares them. ``shade_inputs`` / ``resolve_inputs``
name every tensor and integer that goes into them; ``pack`` checks each
tensor's dtype, contiguity and device and builds the struct.

Over a wavefront's lane list (``render/integrator.py`` ``trace_paths`` on
the card) both take ``count``, the list's length as a (1,) int32 tensor
the device holds (``ops/lanes.py``), and their outputs (``out`` of
``shade_outputs``, ``alive``) from the caller, which allocates them once
a wavefront at the list's capacity: the kernels run over the capacity and
return past the count.
"""

from __future__ import annotations

import ctypes

import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    MATERIAL_FLAGS_COL,
    SCALAR_FIELDS,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import key_words

# rows of the record shade writes and resolve reads (csrc/shade.cu kRec),
# and the row of a lane's flags (kFlags: bit 0 hit, 1 sample_ok, 2 catcher,
# 3 transmitted)
REC_ROWS = 20
REC_FLAGS = 13
# tri_pack's texture id column and its first material column
TEX_COL = 10
MAT_COL = 12
# the material fields the kernels read, as named in the struct
SHADE_FIELDS = ("color", "emission", "eta", "metallic", "subsurface",
                "specular", "roughness", "specular_tint", "clearcoat",
                "clearcoat_gloss", "transmission", "flags")

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
# each struct's tensors, in the struct's order, with the dtype each must
# have; None marks an optional one (a null pointer)
SHADE_TENSORS = {
    "idx": _I64, "o": _F32, "d": _F32, "t": _F32, "hu": _F32, "hv": _F32,
    "tri": _I32, "hit": _BOOL, "inst": _I32, "eta": _F32, "ray_ids": _I64, "tri_pack": _F32, "table": _F32,
    "tex_data": _F32, "tex_sizes": _I64, "probe_rows": _F32,
    "alias_prob": _F32, "alias_idx": _I64, "pdf_flat": _F32,
    "probe_data": _F32, "p_out": _F32, "wi_out": _F32, "query": _BOOL,
    "rec": _F32, "count": _I32,
}
SHADE_INTS = ("n", "rec_rows", "tri_cols", "table_cols", "inst_base",
              "tex_count", "tex_h", "tex_w", "probe_w", "probe_h", "key0",
              "key1", "primary", "has_textures", "has_catcher", "instanced",
              "catcher_bit", *(f"col_{f}" for f in ("tex",) + SHADE_FIELDS))
RESOLVE_TENSORS = {
    "idx": _I64, "rec": _F32, "p": _F32, "occ": _BOOL, "query": _BOOL,
    "o": _F32, "d": _F32, "throughput": _F32, "eta": _F32,
    "radiance": _F32, "alpha": _F32, "normal": _F32, "albedo": _F32,
    "alive": _BOOL, "traces": _I64, "count": _I32,
}
RESOLVE_INTS = ("n", "rec_rows", "primary", "has_catcher")
_UNSIGNED = ("key0", "key1")


def _struct(name, tensors, ints):
    fields = [(k, ctypes.c_void_p) for k in tensors]
    fields += [(k, ctypes.c_uint if k in _UNSIGNED else ctypes.c_int)
               for k in ints]
    return type(name, (ctypes.Structure,), {"_fields_": fields})


ShadeArgs = _struct("ShadeArgs", SHADE_TENSORS, SHADE_INTS)
ResolveArgs = _struct("ResolveArgs", RESOLVE_TENSORS, RESOLVE_INTS)


def material_columns() -> dict:
    """``tri_pack``'s column of each field in ``SHADE_FIELDS`` (the first
    of the three of a color), from ``models/material.py``'s row layout."""
    cols = {"color": MAT_COL, "emission": MAT_COL + 3,
            "flags": MAT_COL + MATERIAL_FLAGS_COL}
    for j, f in enumerate(SCALAR_FIELDS):
        if f in SHADE_FIELDS:
            cols[f] = MAT_COL + 9 + j
    return {f: cols[f] for f in SHADE_FIELDS}


def shade_outputs(k: int, device) -> dict:
    """Fresh tensors for shade's outputs over k lanes (``p_out``,
    ``wi_out``, ``query``, ``rec``)."""
    return {"p_out": torch.empty((k, 3), dtype=_F32, device=device),
            "wi_out": torch.empty((k, 3), dtype=_F32, device=device),
            "query": torch.empty((k,), dtype=_BOOL, device=device),
            "rec": torch.empty((REC_ROWS, k), dtype=_F32, device=device)}


def shade_inputs(scene, idx, o, d, hit, eta, ray_ids, key, primary: bool,
                 count=None, out=None):
    """The shade kernel's arguments for the K lanes ``idx`` of the state
    arrays (``eta``, ``ray_ids``, full size), their
    gathered rays ``o``, ``d`` (K, 3) and K1's answer ``hit`` -> (tensors,
    integers), each by its struct name; the outputs are ``out``
    (``shade_outputs``), or allocated here. ``count`` (None: K) is the
    lanes' number as the device holds it."""
    k, dev = idx.shape[0], o.device
    probe, tex, bvh = scene.probe, scene.textures, scene.bvh
    rows = probe.sample_rows
    tensors = {
        "idx": idx, "o": o, "d": d, "t": hit["t"], "hu": hit["u"],
        "hv": hit["v"], "tri": hit["tri_id"], "hit": hit["hit"],
        "inst": hit["inst"] if bvh.instanced else None,
        "eta": eta, "ray_ids": ray_ids,
        "tri_pack": scene.tri_pack,
        "table": bvh.table if bvh.instanced else None,
        "tex_data": None if tex is None else tex.data,
        "tex_sizes": None if tex is None else tex.sizes,
        "probe_rows": rows,
        "alias_prob": probe.alias_prob if rows is None else None,
        "alias_idx": probe.alias_idx if rows is None else None,
        "pdf_flat": probe.pdf_flat if rows is None else None,
        "probe_data": probe.data,
        **(shade_outputs(k, dev) if out is None else out),
        "count": count,
    }
    key0, key1 = key_words(key)
    ints = {
        "n": k, "rec_rows": REC_ROWS, "tri_cols": scene.tri_pack.shape[1],
        "table_cols": bvh.table.shape[1], "inst_base": bvh.inst_base,
        "tex_count": 0 if tex is None else tex.data.shape[0],
        "tex_h": 0 if tex is None else tex.data.shape[1],
        "tex_w": 0 if tex is None else tex.data.shape[2],
        "probe_w": probe.width, "probe_h": probe.height,
        "key0": key0, "key1": key1, "primary": int(primary),
        "has_textures": int(scene.has_textures),
        "has_catcher": int(scene.has_catcher),
        "instanced": int(bvh.instanced),
        "catcher_bit": MATERIAL_FLAG_SHADOW_CATCHER, "col_tex": TEX_COL,
        **{f"col_{f}": c for f, c in material_columns().items()},
    }
    return tensors, ints


def resolve_inputs(idx, rec, p, occ, query, state, primary: bool,
                   has_catcher: bool, count=None, alive=None):
    """The resolve kernel's arguments: ``shade``'s outputs, K2's answer
    ``occ`` and the full-size state arrays of ``state`` (an
    ``integrator.PathState``) -> (tensors, integers). The alive mask is
    ``alive``, or allocated here; ``count`` as ``shade_inputs``'."""
    k = idx.shape[0]
    tensors = {
        "idx": idx, "rec": rec, "p": p, "occ": occ, "query": query,
        "o": state.o, "d": state.d, "throughput": state.throughput,
        "eta": state.eta, "radiance": state.radiance, "alpha": state.alpha,
        "normal": state.normal, "albedo": state.albedo,
        "alive": torch.empty((k,), dtype=_BOOL, device=idx.device)
        if alive is None else alive,
        "traces": state.traces, "count": count,
    }
    ints = {"n": k, "rec_rows": REC_ROWS, "primary": int(primary),
            "has_catcher": int(has_catcher)}
    return tensors, ints


def pack(cls, dtypes: dict, tensors: dict, ints: dict):
    """The struct ``cls`` of ``ints`` and ``tensors`` (each of its ``dtypes``
    entry, contiguous, on the first tensor's device: ``kernel_build.fill``;
    None gives a null pointer)."""
    return kernel_build.fill(cls(**ints), tensors["idx"].device, dtypes,
                             tensors)


def shade(scene, idx, o, d, hit, eta, ray_ids, key, primary: bool,
          count=None, out=None):
    """Launch ``shade_kernel`` over the lanes ``idx`` (its first ``count``
    where given) -> (p (K, 3), wi (K, 3), query (K,), rec (REC_ROWS, K)),
    ``out``'s tensors where given."""
    tensors, ints = shade_inputs(scene, idx, o, d, hit, eta, ray_ids, key,
                                 primary, count, out)
    args = pack(ShadeArgs, SHADE_TENSORS, tensors, ints)
    if ints["n"]:
        kernel_build.launch("shade", "fov_shade", "shade", args)
    return tensors["p_out"], tensors["wi_out"], tensors["query"], \
        tensors["rec"]


def resolve(idx, rec, p, occ, query, state, primary: bool,
            has_catcher: bool, count=None, alive=None) -> torch.Tensor:
    """Launch ``resolve_kernel`` over the lanes ``idx`` (its first
    ``count`` where given): update ``state`` in place -> the lanes' (K,)
    alive mask, ``alive`` where given."""
    tensors, ints = resolve_inputs(idx, rec, p, occ, query, state, primary,
                                   has_catcher, count, alive)
    args = pack(ResolveArgs, RESOLVE_TENSORS, tensors, ints)
    if ints["n"]:
        kernel_build.launch("shade", "fov_resolve", "resolve", args)
    return tensors["alive"]


def resources() -> dict:
    """Registers per thread, local memory per thread (spills), resident
    blocks per SM and threads a block of ``shade`` and ``resolve``, as the
    CUDA runtime reports them for the loaded build."""
    keys = ("registers", "local_bytes", "blocks_per_sm", "threads")
    return {name: dict(zip(keys, kernel_build.query("shade",
                                                    "fov_shade_info", which)))
            for which, name in enumerate(("shade", "resolve"))}
