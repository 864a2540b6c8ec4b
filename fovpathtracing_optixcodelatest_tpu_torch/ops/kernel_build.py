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

Every launch entry is ``int fov_<entry>(const <Entry>Args*, cudaStream_t)``
and returns ``cudaGetLastError``. The ops module that launches it declares
the struct as a ``ctypes.Structure``, fills it (``fill`` checks and sets
its tensors' pointers, one call a struct) and calls ``launch``, which
declares the entry's two arguments as pointers (``LAUNCH_ARGTYPES``) on
its first call and counts the launch in ``LAUNCHES`` under the name the
module gives it. The query entries take 32-bit integers and pointers to
their outputs: ``query`` calls them.
"""

from __future__ import annotations

import collections
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
# every source under csrc/, by its name without ".cu"
SOURCES = tuple(sorted(os.path.basename(p)[:-3]
                       for p in glob.glob(os.path.join(CSRC, "*.cu"))))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every launch entry's arguments: const <Entry>Args*, cudaStream_t
LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p)
# launches by the name each ops module gives its kernel; a name never
# launched reads 0
LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {"seconds": None, "log": {}}


def reset_launches() -> None:
    LAUNCHES.clear()


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
        _LIBS[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source in parallel on first use)."""
    lib = _LIBS.get(name)  # loaded: no lock on the launch path
    if lib is None:
        with _LOCK:
            if not _LIBS:
                _build_all()
            lib = _LIBS[name]
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def launch(source: str, entry: str, name: str,
           args: ctypes.Structure) -> None:
    """Call the launch entry ``entry`` of ``csrc/<source>.cu``,
    ``int entry(const Args*, cudaStream_t)``, with the struct ``args`` on
    the current stream; raise on a non-zero return and count the launch
    under ``name``."""
    fn = getattr(library(source), entry)
    if fn.argtypes is not LAUNCH_ARGTYPES:  # else a bare int is a C int
        fn.argtypes = LAUNCH_ARGTYPES
    check(fn(ctypes.addressof(args), stream()), name)
    LAUNCHES[name] += 1


def query(source: str, entry: str, *ints: int, outs: int = 4,
          out_type=ctypes.c_int) -> list:
    """Call the query entry ``entry`` of ``csrc/<source>.cu`` with the
    integers ``ints`` (each a C ``int``: ctypes' conversion of a Python int,
    which raises where it does not fit) and ``outs`` pointers to
    ``out_type`` -> the values it wrote; raise on a non-zero return."""
    vals = [out_type() for _ in range(outs)]
    check(getattr(library(source), entry)(
        *ints, *[ctypes.byref(v) for v in vals]), entry)
    return [v.value for v in vals]


def fill(args: ctypes.Structure, device, dtypes: dict, tensors: dict,
         shapes: dict | None = None) -> ctypes.Structure:
    """Set each pointer field of ``args`` that ``dtypes`` names to the data
    pointer of its tensor in ``tensors`` (None leaves it null) -> ``args``.
    Raises ``ValueError`` unless each is a contiguous tensor of its
    ``dtypes`` entry on ``device``, of its ``shapes`` entry where given."""
    for name, dtype in dtypes.items():
        x = tensors[name]
        if x is None:
            continue
        if (x.dtype != dtype or x.device != device or not x.is_contiguous()
                or (shapes is not None and name in shapes
                    and x.shape != shapes[name])):
            shape = None if shapes is None else shapes.get(name)
            raise ValueError(
                f"{name}: a contiguous {dtype} tensor"
                f"{'' if shape is None else f' of shape {tuple(shape)}'} on "
                f"{device} is needed, got {x.dtype} {tuple(x.shape)}"
                f"{'' if x.is_contiguous() else ' (strided)'} on {x.device}")
        setattr(args, name, x.data_ptr())
    return args
