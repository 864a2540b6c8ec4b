"""PyTorch/CUDA port of the foveated path tracer.

The package mirrors the JAX package's layout (``config``, ``models``,
``ops``, ``render``) so each counterpart is found by path. It imports torch
and numpy only. The traversal hot loops are hand-written CUDA kernels under
``csrc/`` (built at first use into ``build/torch_kernels/``); every kernel
wrapper runs its plain PyTorch version when handed CPU tensors.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run on
the CPU (the tests do).
"""

from fovpathtracing_optixcodelatest_tpu_torch.config import (  # noqa: F401
    FoveationPass,
    FoveationSchedule,
    RenderConfig,
)
