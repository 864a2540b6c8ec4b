"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 fovbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA GPU. Set-up (scene
generation, the port's scene build, kernel loading, warm-up frames) is
``setup_s``; the window renders displayed frames back to back for
``--seconds``; ``--trace 1`` profiles a few more frames for the per-layer
metrics. Then chosen pixels of chosen frames are checked against the
reference (``fovbench/check.py``). The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error. Exits 2 without a GPU (or with fewer than the cell needs)
and 3 if JAX or the JAX package was loaded; neither prints a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(REPO, "build", "fovbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from fovbench import harness

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cell = harness.find_cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, info = harness.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace), "cuda",
                                    T0)
    found = harness.banned_modules(list(sys.modules))
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
