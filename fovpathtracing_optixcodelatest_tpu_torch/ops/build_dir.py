"""Where the port builds its native and CUDA libraries, and caches packed
BVH tables: ``build/torch_kernels/`` and ``build/bvh_cache/`` at the root of
the checkout (``build/`` is listed in ``.gitignore``)."""

from __future__ import annotations

import os

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def build_dir(name: str = "torch_kernels") -> str:
    path = os.path.join(_ROOT, "build", name)
    os.makedirs(path, exist_ok=True)
    return path
