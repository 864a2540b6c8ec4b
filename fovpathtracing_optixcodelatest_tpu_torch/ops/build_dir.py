"""Where the port builds its native and CUDA libraries: ``build/torch_kernels/``
at the root of the checkout (listed in ``.gitignore``)."""

from __future__ import annotations

import os

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def build_dir() -> str:
    path = os.path.join(_ROOT, "build", "torch_kernels")
    os.makedirs(path, exist_ok=True)
    return path
