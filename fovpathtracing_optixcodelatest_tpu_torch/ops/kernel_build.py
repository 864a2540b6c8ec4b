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
SOURCES = ("traverse", "packet_traverse")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES = {"closest_hit": 0, "occluded": 0, "occluded_packets": 0}

_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_uint)
# C entry points: (table, width, origin, direction, active, n, tmin, tmax,
# stack_depth, ...), each ending in the stream and returning cudaGetLastError
SIGNATURES = {
    "fov_closest_hit": (_P, _I, _P, _P, _P, _LL, _F, _F, _I, _I, _I, _U,
                        _P, _P, _P, _P, _P),
    "fov_occluded": (_P, _I, _P, _P, _P, _LL, _F, _F, _I, _I, _I, _P, _P),
    "fov_occluded_packets": (_P, _I, _P, _P, _P, _LL, _F, _F, _I, _I, _P,
                             _P),
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


def _build_all() -> None:
    out_dir = build_dir()
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(out_dir, f"lib{name}.so")
        if not _stale(so, src):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate(timeout=600)
        BUILD_INFO["log"][name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, so)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in SOURCES:
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        for fn, sig in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib


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


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
