"""The control of the check: the reference computed in a lower precision
(bfloat16 for the configuration's float32) put in the program's place, on
the sample a run of the cell would draw. Its numbers have to fail the
cell's limits; they are the upper readings the limits are set below.

    python3 fovbench/control.py --workload <cell> --last <subframe> --seeds 1 2 3

``--last`` is the subframe of the last displayed frame (a run's warm-up
frames plus its window's), which sets how long the sampled histories are.
Not a benchmark run: it times nothing and drives no program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, workload: str, seed: int, last: int, device,
             dtype) -> dict:
    """The control's numbers on one seed's sample, with the sample's size."""
    import torch

    from fovbench import check, harness
    from fovbench.reference.render import Reference

    bench = harness.load_json(os.path.join(os.path.dirname(root),
                                           "BENCHMARK.json"))
    cell = harness.find_cell(bench, workload)
    cfg = harness.config_of(root, bench, cell["config"])
    limits = harness.load_json(os.path.join(root, "limits",
                                            f"{workload}.json"))
    meshes, camera, images, probe = harness.generate_scene(cfg)
    tr = harness.traffic_of(root, cfg, cell["traffic"], seed, camera)
    cams, fov = harness.cameras_of(cfg, tr, camera)
    sample = limits["sample"]
    frames = check.sample_frames(seed, tr.warmup, last, sample["frames"] - 1)
    checks = check.draw(cfg, tr, seed, frames, sample)
    px = {}
    for dt in (torch.float32, dtype):
        ref = Reference(cfg, meshes, images, probe, cams, fov, device, dt)
        px[dt] = check.reference_pixels(ref, cfg, tr, seed, checks)
        del ref
    numbers = check.compare(px[dtype], px[torch.float32])
    return {"workload": workload, "seed": seed, "last": last,
            "checked_pixels": len(checks), **numbers,
            "limits": limits["limits"],
            "fails": any(numbers[k] > v for k, v in limits["limits"].items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--last", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    root = os.path.join(REPO, "fovbench")
    for seed in args.seeds:
        print(json.dumps(readings(root, args.workload, seed, args.last,
                                  args.device, torch.bfloat16)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
