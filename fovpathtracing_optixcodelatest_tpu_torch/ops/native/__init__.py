"""Native BVH builder, compiled with g++ at first use into the git-ignored
``build/torch_kernels/`` directory and loaded with ctypes.

The flags are the JAX package's (``-O3 -march=native -std=c++17``): with
``-march=native`` GCC contracts to FMA, and the SAH splits depend on it, so
other flags could pack a different table. A failed build raises; there is
no fallback builder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from fovpathtracing_optixcodelatest_tpu_torch.ops.build_dir import build_dir

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")
_LOCK = threading.Lock()
_LIB = None


def load_library():
    """Compile (once per source change) and load the native builder."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = os.path.join(build_dir(), "libbvh_builder.so")
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(
                    f"native BVH builder failed to compile:\n{res.stderr}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.fovtix_build_bvhw.restype = ctypes.c_int
        lib.fovtix_build_bvhw.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # tris
            ctypes.c_int64,  # T
            ctypes.c_int,  # leaf_size
            ctypes.c_int,  # arity
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # boxes
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),  # meta
            ctypes.POINTER(ctypes.c_int64),  # num_nodes
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),  # tri_perm
            ctypes.POINTER(ctypes.c_int64),  # num_slots
        ]
        lib.fovtix_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB
