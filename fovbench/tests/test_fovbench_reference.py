"""The reference against the port on the CPU at a tiny size: the random
streams bit for bit, and whole runs of both tiny cells checked correct with
no pixel apart (the reference repeats the port's float32 expressions)."""

import numpy as np
import pytest
import torch

from fovbench import harness
from fovbench.reference import rng


def test_key_chain_and_streams_match_the_port():
    from fovpathtracing_optixcodelatest_tpu_torch.ops import rng as port

    for seed in (0, 7, 2 ** 31 + 99, 2 ** 32 - 1):
        key = rng.prng_key(seed)
        pkey = port.prng_key(seed)
        assert key == port.key_words(pkey)
        for data in (0, 1, 5, 123456):
            assert rng.fold_in(key, data) == port.key_words(
                port.fold_in(pkey, data))
    pkey = port.fold_in(port.prng_key(3), 17)
    s0, s1 = port.key_words(pkey)
    ids = torch.arange(0, 10_000_000, 997, dtype=torch.int64)
    want = port.ray_uniforms(pkey, ids, 8)
    got = rng.uniforms(torch.full_like(ids, s0), torch.full_like(ids, s1),
                       ids, 8)
    assert torch.equal(want, got)


@pytest.mark.parametrize("cell", ["tiny.fixate", "tiny.stereo_saccade"])
def test_reference_agrees_with_the_port(tiny, cell):
    res, info = harness.run_cell(tiny, cell, 2 ** 31 + 5, 0.5, False, "cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["px_over_1lsb"]["value"] == 0.0
    assert res["checks"]["mean_abs_lsb"]["value"] == 0.0
    assert info["checked_pixels"] >= 16
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    # the sample covers lit geometry, not only the sky
    assert info["window_frames"] >= 1


def test_the_sample_holds_every_kind_of_pixel():
    from conftest import BENCH, REPO
    from fovbench import check, traffic

    bench = harness.load_json(REPO + "/BENCHMARK.json")
    cfg = harness.config_of(BENCH, bench, "boxcity262k")
    tr = traffic.Traffic(traffic.load(BENCH, "fixate"), 3, 960, 540)
    sample = harness.load_json(BENCH + "/limits/boxcity262k.fixate.json")["sample"]
    frames = check.sample_frames(3, 2, 300, sample["frames"] - 1)
    checks = check.draw(cfg, tr, 3, frames, sample)
    assert len({s for _, s, _, _ in checks}) == sample["frames"]
    assert max(s for _, s, _, _ in checks) == 300
    passes = cfg["schedule"]["passes"]
    kinds = [check.writer(passes, np.array([x]), np.array([y]), tr.gaze(s),
                          960, 540)[0][0] for _, s, x, y in checks]
    assert set(kinds) == {0, 1, 2}
    # a periphery pixel's history reaches back to subframe 0
    e, s, x, y = next(c for c, k in zip(checks, kinds) if k == 0)
    hist = check.history(passes, tr, e, s, x, y, 960, 540)
    assert [t for t, *_ in hist] == list(range(s + 1))


def test_the_run_keeps_a_uniform_sample_of_its_frames():
    """The reservoir holds the last frame and k others, the same from the
    same seed, each earlier frame as likely as another."""
    from fovbench import check

    seed = 2 ** 31 + 9
    res = check.Reservoir(seed, 2)
    for s in range(2, 500):
        res.add(s, ("frame", s))
        assert len(res.frames()) <= 3
    kept = res.frames()
    assert max(kept) == 499 and len(kept) == 3
    assert all(v == ("frame", s) for s, v in kept.items())
    assert sorted(kept) == check.sample_frames(seed, 2, 499, 2)
    counts = np.zeros(100)
    for sd in range(3000):
        for s in check.sample_frames(sd, 0, 100, 2)[:-1]:
            counts[s] += 1
    # 6000 draws over 100 frames: 60 each, a few sigma of room
    assert counts.min() > 30 and counts.max() < 95
