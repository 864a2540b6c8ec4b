"""A wavefront's live lanes on the card (``csrc/lanes.cu``,
``ops/lanes.py``, ``render/integrator.py`` ``kernel_paths``).

On the CPU: ``compact`` (there ``compact_plain``, the kernel's plain
version) against what it replaces, ``idx[alive]`` and the gathers
``o[idx]``, ``d[idx]``, at lengths 0, 1, a tile (a block's boundary) and
the capacity, over all-false, all-true and random masks; a wavefront's
chain of compactions and its per-depth lane counts; the struct ``pack``
builds and refuses; and the kernel path's wiring: every launch of a bounce
reads that depth's length from the device, nothing waits for the device,
and the per-depth counts reach the counters once they arrive.

On the card (marker ``cuda``; it imports nothing of JAX):
``compact_kernel`` equals ``torch.nonzero`` / ``idx[alive]`` and the
gathers bit for bit on the 262k frame's lanes, and ``trace_paths``' kernel
path gives the host-list path's outputs bit for bit, its lanes a depth,
and no sync (``tools/lanes_check.py``):

    python -m pytest -m cuda tests/test_torch_lanes.py
"""

import dataclasses
import sys
import threading

import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes
from fovpathtracing_optixcodelatest_tpu_torch.ops import shade as shade_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing
from torch_stand_in_kernels import stand_in_kernels  # noqa: F401 (a fixture)

N = 3 * lanes.TILE + 77  # four tiles, the last one ragged


def _state(n: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 3), generator=g),
            torch.randn((n, 3), generator=g))


def _mask(kind: str, n: int, seed: int = 1):
    if kind == "none":
        return torch.zeros((n,), dtype=torch.bool)
    if kind == "all":
        return torch.ones((n,), dtype=torch.bool)
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n,), generator=g) < 0.4


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("count", [0, 1, lanes.TILE, N])
@pytest.mark.parametrize("kind", ["none", "all", "random"])
def test_compact_is_idx_alive_and_the_gathers(count, kind):
    o, d = _state(N)
    g = torch.Generator().manual_seed(2)
    idx = torch.randperm(N, generator=g)  # a list of the state's lanes
    alive = _mask(kind, N)
    out = lanes.outputs(N, "cpu")
    stale = out["idx_out"].fill_(-5).clone()
    lanes.compact(alive, idx, torch.tensor([count], dtype=torch.int32), o,
                  d, out)
    want = idx[:count][alive[:count]]
    k = want.numel()
    assert int(out["count_out"][0]) == k and int(out["lanes"][0]) == k
    assert torch.equal(out["idx_out"][:k], want)
    assert torch.equal(_bits(out["o_out"][:k]), _bits(o[want]))
    assert torch.equal(_bits(out["d_out"][:k]), _bits(d[want]))
    # past the length the list is left as it was
    assert torch.equal(out["idx_out"][k:], stale[k:])


@pytest.mark.parametrize("kind", ["none", "all", "random"])
def test_the_first_list_is_nonzero_of_ray_generations_mask(kind):
    o, d = _state(N)
    active = _mask(kind, N, seed=3)
    out = lanes.outputs(N, "cpu")
    lanes.compact(active, None, None, o, d, out)
    want = torch.nonzero(active).squeeze(1)
    k = want.numel()
    assert int(out["count_out"][0]) == k
    assert torch.equal(out["idx_out"][:k], want)
    assert torch.equal(_bits(out["o_out"][:k]), _bits(o[want]))


def test_a_wavefronts_compactions_count_its_lanes_a_depth():
    """Ray generation's mask, then three bounces' alive masks (stale past
    each list's length): each list is the host narrowing's, in its order,
    and the wave's per-depth counts are its lengths."""
    depths = 4
    o, d = _state(N)
    st = integrator.PathState.start(o, d, torch.ones_like(o))
    wave = integrator.CardWave(N, depths, False, "cpu")
    active = _mask("random", N, seed=4)
    wave.compact(active, st, 0)
    idx = torch.nonzero(active).squeeze(1)
    lengths = [idx.numel()]
    for depth in range(1, depths):
        alive = _mask("random", N, seed=10 + depth)
        wave.compact(alive, st, depth)
        idx = idx[alive[:idx.numel()]]
        lengths.append(idx.numel())
        k = idx.numel()
        assert int(wave.counts[depth]) == k
        assert torch.equal(wave.idx[depth % 2][:k], idx)
        assert torch.equal(_bits(wave.d[:k]), _bits(d[idx]))
    assert wave.lanes.tolist() == lengths
    assert wave.counts.tolist() == lengths


def test_the_wave_carves_one_workspace():
    depths, n = 4, N
    wave = integrator.CardWave(n, depths, True, "cpu")
    ws = wave.lanes.untyped_storage()
    views = (wave.lanes, wave.counts, wave.k1_counters, wave.k2_counters,
             wave.tiles)
    assert all(v.untyped_storage().data_ptr() == ws.data_ptr() for v in views)
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in views)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # disjoint
    assert wave.tiles.shape == (depths, lanes.tile_words(n))
    assert all(int(v.abs().sum()) == 0 for v in views)
    assert wave.lanes.dtype == torch.int64 and wave.lanes.shape == (depths,)
    assert "inst" in wave.hit and wave.every.all()
    assert wave.shaded["rec"].shape == (shade_ops.REC_ROWS, n)


def test_pack_builds_the_struct_and_refuses_other_tensors():
    o, d = _state(N)
    out = lanes.outputs(N, "cpu")
    mask = _mask("random", N)
    args = lanes.pack(mask, None, None, o, d, out)
    assert (args.n, args.tile) == (N, lanes.TILE)
    assert args.idx_in is None and args.count_in is None  # the identity
    assert args.tiles == out["tiles"].data_ptr()
    idx = torch.arange(N)
    cnt = torch.tensor([5], dtype=torch.int32)
    args = lanes.pack(mask, idx, cnt, o, d, out)
    assert (args.idx_in, args.count_in) == (idx.data_ptr(), cnt.data_ptr())
    for name, bad in (("tiles", torch.zeros(2, dtype=torch.int32)),
                      ("count_out", torch.zeros(1, dtype=torch.int64)),
                      ("o_out", torch.zeros((N, 6))[:, ::2])):
        with pytest.raises(ValueError, match=name):
            lanes.pack(mask, idx, cnt, o, d, {**out, name: bad})
    with pytest.raises(ValueError, match="mask"):
        lanes.pack(mask.to(torch.uint8), idx, cnt, o, d, out)


def test_a_compaction_launch_carries_its_struct(stand_in_kernels):
    o, d = _state(N)
    out = lanes.outputs(N, "cpu")
    mask, cnt = _mask("random", N), torch.tensor([9], dtype=torch.int32)
    kernel_build.launch("lanes", "fov_compact", "compact",
                        lanes.pack(mask, torch.arange(N), cnt, o, d, out))
    assert kernel_build.LAUNCHES == {"compact": 1}
    entry, _, copy = stand_in_kernels.calls[0]
    assert entry == "fov_compact"
    assert (copy.n, copy.tile, copy.count_in) == (N, lanes.TILE,
                                                  cnt.data_ptr())
    assert copy.count_out == out["count_out"].data_ptr()


def test_the_kernel_path_reads_each_depths_length_on_the_device(
        monkeypatch):
    """The kernel path's wiring, its kernels replaced by recorders: one
    compaction of ray generation's mask, then K1, shade, K2, resolve a
    depth, each given that depth's length and K1/K2 their own zeroed
    counters, and a compaction after every bounce but the last, reading
    the last length and writing the next; no sync, one ``lane_list`` /
    ``"device"`` and ``shade`` / ``"kernel"`` a depth; the per-depth counts
    handed to ``count_on_device`` once."""
    depths, n = 4, 2 * lanes.TILE
    calls, device_counts = [], []

    def closest_hit(table, o, d, active, *a, count, counter, out, **kw):
        calls.append(("k1", count.data_ptr(), counter.data_ptr()))
        assert active is wave_of[0].every and out is wave_of[0].hit
        return out

    def occluded(table, p, wi, query, *a, count, counter, out, **kw):
        calls.append(("k2", count.data_ptr(), counter.data_ptr()))
        return out

    def shade(scene, idx, o, d, hit, eta, ids, key, primary, count, out):
        calls.append(("shade", count.data_ptr(), idx.data_ptr()))
        return out["p_out"], out["wi_out"], out["query"], out["rec"]

    def resolve(idx, rec, p, occ, query, st, primary, catcher, count, alive):
        calls.append(("resolve", count.data_ptr(), idx.data_ptr()))
        return alive

    def compact(mask, idx, count, o, d, out):
        calls.append(("compact", None if count is None else count.data_ptr(),
                      out["count_out"].data_ptr()))

    wave_of = []
    real_wave = integrator.CardWave

    def wave(*args, **kwargs):
        wave_of.append(real_wave(*args, **kwargs))
        return wave_of[-1]

    monkeypatch.setattr(traverse, "closest_hit", closest_hit)
    monkeypatch.setattr(traverse, "occluded", occluded)
    monkeypatch.setattr(shade_ops, "shade", shade)
    monkeypatch.setattr(shade_ops, "resolve", resolve)
    monkeypatch.setattr(lanes, "compact", compact)
    monkeypatch.setattr(integrator, "CardWave", wave)
    monkeypatch.setattr(tracing, "count_on_device",
                        lambda group, t: device_counts.append((group, t)))
    scene = dataclasses.make_dataclass("S", ["bvh", "has_catcher"])(
        bvh=dataclasses.make_dataclass(
            "B", ["instanced", "table", "walk_args", "instance_kwargs"])(
            False, None, (), {}), has_catcher=False)
    o, d = _state(n)
    st = integrator.PathState.start(o, d, torch.ones_like(o))
    before = tracing.snapshot()
    integrator.kernel_paths(scene, st, _mask("random", n), torch.arange(n),
                            (0, 1), RenderConfig(max_depth=depths))
    got = tracing.diff(before, tracing.snapshot())
    w = wave_of[0]
    cnt = [w.counts[k].data_ptr() for k in range(depths)]
    want = [("compact", None, cnt[0])]
    for k in range(depths):
        lst = w.idx[k % 2].data_ptr()
        want += [("k1", cnt[k], w.k1_counters[k].data_ptr()),
                 ("shade", cnt[k], lst),
                 ("k2", cnt[k], w.k2_counters[k].data_ptr()),
                 ("resolve", cnt[k], lst)]
        if k + 1 < depths:
            want.append(("compact", cnt[k], cnt[k + 1]))
    assert calls == want
    assert got["syncs"] == {} and got["shade"] == {"kernel": depths}
    assert device_counts == [("lanes", w.lanes)]


def test_folded_device_counts_reach_the_counters(monkeypatch):
    """``fold`` adds the counts whose copies have arrived, ``snapshot``
    waits for the rest; both keyed by position."""
    class Done:
        def __init__(self, ready):
            self.ready, self.waited = ready, False

        def query(self):
            return self.ready

        def synchronize(self):
            self.waited = True

    early, late = Done(True), Done(False)
    monkeypatch.setattr(tracing, "_pending", [
        ("test_lanes", torch.tensor([7, 3]), early),
        ("test_lanes", torch.tensor([1, 1, 2]), late)])
    monkeypatch.setitem(tracing.COUNTERS, "test_lanes", {})
    tracing.fold()
    assert tracing.COUNTERS["test_lanes"] == {0: 7, 1: 3}
    assert not late.waited and len(tracing._pending) == 1
    tracing.snapshot()
    assert tracing.COUNTERS["test_lanes"] == {0: 8, 1: 4, 2: 2}
    assert late.waited and tracing._pending == []


def test_threads_folding_at_once_count_each_arrival_once(monkeypatch):
    """Eight threads (the viewer renders on two) each queueing device counts
    as ``count_on_device`` does and folding, switching every microsecond:
    every count is added once."""
    class Done:
        def query(self):
            return True

    monkeypatch.setitem(tracing.COUNTERS, "test_fold", {})
    monkeypatch.setattr(tracing, "_pending", [])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with tracing._lock:
                    tracing._pending.append(
                        ("test_fold", torch.tensor([1, 2]), Done()))
                tracing.fold()

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tracing.fold()
    assert tracing.COUNTERS["test_fold"] == {0: 4000, 1: 8000}
    assert tracing._pending == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame262k():
    """The 262k cell's scene (``box_city_fast(148)``, textured) and its
    960x540 ``reference_32_16_8`` frame's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import (
        kernel_times,
        shade_check,
    )

    scene, cam = shade_check.bench_scene(148, 1024)
    config = RenderConfig(width=960, height=540)
    rays = kernel_times.frame_rays(
        scene, dataclasses.replace(cam, aspect=960 / 540), config,
        FoveationSchedule.reference_32_16_8())
    return scene, config, rays


@pytest.mark.cuda
def test_compact_kernel_is_nonzero_and_the_gathers(frame262k):
    from fovpathtracing_optixcodelatest_tpu_torch.tools import lanes_check

    _, _, rays = frame262k
    kernel_build.reset_launches()
    rep = lanes_check.check_compaction(rays["primary"],
                                       rays["bounce0"]["alive"], reps=3)
    assert rep["exact"], rep
    assert rep["depth0"]["lanes"] > 1_000_000 and rep["depth1"]["lanes"] > 0
    assert kernel_build.LAUNCHES["compact"] > 0
    res = rep["resources"]["compact"]
    assert res["local_bytes"] == 0 and res["blocks_per_sm"] >= 4, res


@pytest.mark.cuda
def test_the_kernel_path_is_the_host_list_path(frame262k):
    from fovpathtracing_optixcodelatest_tpu_torch.tools import lanes_check

    scene, config, rays = frame262k
    rep = lanes_check.check_paths(scene, config, rays["primary"])
    assert rep["exact"], rep
    assert rep["lane_list"] == {"device": 1}
    assert rep["lanes"][0] > rep["lanes"][-1] > 0
