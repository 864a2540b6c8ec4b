"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (loaded with ctypes) under
``build/torch_kernels/``. The first call to ``library`` starts one ``nvcc``
per source, all at once, and waits for them; later calls reuse the loaded
libraries. A library is rebuilt when any source under ``csrc/`` is newer.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false``. No FMA
contraction is what lets the kernels' Möller-Trumbore ``t/u/v`` and
``tri_id`` match the plain PyTorch versions bit for bit (PyTorch runs each
elementwise op as its own rounded step).

A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from fovpathtracing_optixcodelatest_tpu_torch.ops.build_dir import build_dir

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
SOURCES = ("traverse", "packet_traverse", "shade", "frame")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the layouts (arity, leaf size) K1, K2 and the non-culling K2 are
# compiled for besides the default (16, 6): the JAX package's wide packings
# ((32, 12) as group-per-ray walks, (32, 24) as one thread a ray)
WIDE_LAYOUTS = ((32, 12), (32, 24))
# the single-level kernels compiled at every layout
LAYOUT_KERNELS = ("closest_hit", "occluded", "occluded_nocull")
# the two-level kernels, also compiled at every layout
INSTANCED_KERNELS = ("closest_hit_instanced", "occluded_instanced")
# the two-level K2 without back-face culling (the 04 raycast of an
# instanced scene), compiled at every layout too
NOCULL_INSTANCED = "occluded_nocull_instanced"
# every kernel compiled at the wide layouts
WIDE_KERNELS = LAYOUT_KERNELS + INSTANCED_KERNELS + (NOCULL_INSTANCED,)


def layout_name(kernel: str, arity: int, leaf_size: int) -> str:
    """The name of ``kernel``'s (arity, leaf_size) instantiation, which
    keys its launch count and its resources: the kernel's own at the
    default (16, 6), else e.g. "closest_hit_a32_l12"."""
    if (arity, leaf_size) == (16, 6):
        return kernel
    return f"{kernel}_a{arity}_l{leaf_size}"


# launches per kernel wrapper; each wrapper adds one where it launches.
# The traversal kernels' own names count every layout's launches; a wide
# layout's are also counted under its ``layout_name``.
LAUNCHES = {"closest_hit": 0, "occluded": 0, "occluded_packets": 0,
            "closest_hit_instanced": 0, "occluded_instanced": 0,
            "occluded_nocull": 0, NOCULL_INSTANCED: 0,
            "shade": 0, "resolve": 0, "raygen": 0, "film": 0,
            **{layout_name(k, *lay): 0 for lay in WIDE_LAYOUTS
               for k in WIDE_KERNELS}}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# C entry points: the launches take (table, origin, direction, active, n,
# tmin, tmax, stack_depth, ...), end in the stream and return
# cudaGetLastError; the *_info queries return a cudaError_t code too. The
# K1/K2 take the table's (arity, leaf_size) before the stream, the
# single-level K1 its global stack buffer (``fov_traverse_stack`` entries)
# before those.
SIGNATURES = {
    "fov_closest_hit": (_P, _P, _P, _P, _I, _F, _F, _I, _U, _P, _P, _P, _P,
                        _P, _P, _I, _I, _P),
    "fov_occluded": (_P, _P, _P, _P, _I, _F, _F, _I, _P, _P, _I, _I, _P),
    # K2 with back faces occluding: fov_occluded's arguments
    "fov_occluded_nocull": (_P, _P, _P, _P, _I, _F, _F, _I, _P, _P, _I, _I,
                            _P),
    # the instanced variants add (inst_base, blas_base[, inst_out])
    "fov_closest_hit_instanced": (_P, _P, _P, _P, _I, _F, _F, _I, _U, _P,
                                  _P, _P, _P, _P, _I, _I, _P, _I, _I, _P),
    "fov_occluded_instanced": (_P, _P, _P, _P, _I, _F, _F, _I, _P, _P, _I,
                               _I, _I, _I, _P),
    # the two-level K2 with back faces occluding: fov_occluded_instanced's
    "fov_occluded_nocull_instanced": (_P, _P, _P, _P, _I, _F, _F, _I, _P, _P,
                                      _I, _I, _I, _I, _P),
    "fov_occluded_packets": (_P, _P, _P, _P, _I, _F, _F, _I, _P, _P, _P,
                             _P),
    "fov_packet_spill": (_I, _I, _P),
    "fov_traverse_info": (_I, _I, _I, _I, _P, _P, _P, _P),
    "fov_traverse_design": (_I, _I, _I, _P, _P, _P),
    "fov_traverse_stack": (_I, _I, _I, _I, _I, _P),
    "fov_packet_info": (_P, _P, _P, _P),
    # the bounce's shading (csrc/shade.cu): a pointer to the kernel's
    # argument struct (ops/shade.py), then the stream
    "fov_shade": (_P, _P),
    "fov_resolve": (_P, _P),
    "fov_shade_info": (_I, _P, _P, _P, _P),
    # the frame's ray generation and film (csrc/frame.cu): a pointer to the
    # kernel's argument struct (ops/frame.py), then the stream
    "fov_raygen": (_P, _P),
    "fov_film": (_P, _P),
    "fov_frame_info": (_I, _P, _P, _P, _P),
    "fov_frame_sizes": (_P, _P),
}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {"seconds": None, "log": {}}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(so: str, src: str) -> bool:
    if not os.path.exists(so):
        return True
    newest = max(
        os.path.getmtime(p) for p in glob.glob(os.path.join(CSRC, "*.cu*"))
    )
    return os.path.getmtime(so) < max(newest, os.path.getmtime(src))


def _start(src: str, so: str):
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(procs: dict) -> None:
    """Wait for every started nvcc, keep its log, and raise if any failed."""
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate(timeout=600)
        BUILD_INFO["log"][name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, so)
            with open(f"{so}.log", "w") as f:
                f.write(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, sig in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _build_all() -> None:
    out_dir = build_dir()
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(out_dir, f"lib{name}.so")
        if _stale(so, src):
            procs[name] = _start(src, so)
        elif os.path.exists(f"{so}.log"):  # the log of the build in use
            with open(f"{so}.log") as f:
                BUILD_INFO["log"][name] = f.read()
    try:
        _finish(procs)
    finally:
        BUILD_INFO["seconds"] = time.perf_counter() - t0
    for name in SOURCES:
        _LIBS[name] = _load(os.path.join(out_dir, f"lib{name}.so"))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source in parallel on first use)."""
    with _LOCK:
        if not _LIBS:
            _build_all()
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


# how a traversal kernel's rows reach its walk, and where its stacks lie
# (``fov_traverse_design``)
ROW_COPIES = ("ldg", "cp.async")
STACK_HOMES = ("shared", "global", "local")


def resources(stack_depth: int) -> dict:
    """Registers per thread, local memory per thread (spills and stack
    frames), resident blocks per SM and dynamic shared memory per block of
    each kernel, as the CUDA runtime reports them for the loaded build; K1/K2
    and their instanced and non-culling variants (and the non-culling
    instanced K2) at ``stack_depth`` (K3's
    shared memory does not depend on it), the wide layouts' K1/K2 and
    non-culling K2 under their ``layout_name``. K1/K2's entries also give
    their design: ``group_lanes`` (the lanes that walk one ray),
    ``row_copy`` (``ROW_COPIES``: 16-byte loads into registers, or
    ``cp.async`` into the ray's shared-memory row buffer) and ``stack``
    (``STACK_HOMES``). The wide layouts' kernels are listed under their
    ``layout_name``, the two-level ones too."""
    out = {}
    which = {"closest_hit": 0, "occluded": 1, "closest_hit_instanced": 2,
             "occluded_instanced": 3, "occluded_nocull": 4,
             NOCULL_INSTANCED: 5}
    queries = [(k, "traverse", "fov_traverse_info", (w, 16, 6, stack_depth))
               for k, w in which.items()]
    queries.append(("occluded_packets", "packet_traverse", "fov_packet_info",
                    ()))
    queries += [(layout_name(k, *lay), "traverse", "fov_traverse_info",
                 (which[k], *lay, stack_depth))
                for lay in WIDE_LAYOUTS for k in WIDE_KERNELS]
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes")
    for kernel, lib, fn, args in queries:
        vals = [ctypes.c_int(0) for _ in keys]
        rc = getattr(library(lib), fn)(*args, *(ctypes.addressof(v)
                                                for v in vals))
        check(rc, fn)
        out[kernel] = dict(zip(keys, (v.value for v in vals)))
        if fn == "fov_traverse_info":
            design = [ctypes.c_int(0) for _ in range(3)]
            check(library(lib).fov_traverse_design(
                *args[:3], *(ctypes.addressof(v) for v in design)),
                "fov_traverse_design")
            group, copy, home = (v.value for v in design)
            out[kernel].update(group_lanes=group, row_copy=ROW_COPIES[copy],
                               stack=STACK_HOMES[home])
    return out


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
