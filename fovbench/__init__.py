"""The benchmark of the PyTorch and CUDA port (``fovpathtracing_optixcodelatest_tpu_torch``).

``python3 fovbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Configurations, traffic mixes,
per-layer metric readers and per-cell limits are files found by name under
``configs/``, ``traffic/``, ``metrics/`` and ``limits/``; ``scenes/`` holds
frozen copies of the scene generators and ``reference/`` the plain
reference that decides ``correct``. Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
