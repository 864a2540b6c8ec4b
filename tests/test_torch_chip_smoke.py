"""The pure helpers of ``chip_smoke.py``, the shape builders of
``tools/kernel_times.py`` (the bench frame's and the instance field's), and
a rehearsal of the smoke's phases a-n at a small size, on the CPU (no card:
the wrappers run the plain versions; a stand-in for ``torch.profiler``
reports the device's kernels where a phase profiles)."""

import collections
import dataclasses
import types

import numpy as np
import pytest
import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationPass,
    FoveationSchedule,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

torch.set_num_threads(2)

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115occluded_kernelILi16ELi6EEEvPK5uint4PKfS5_PKhiffiPbPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115occluded_kernelILi16ELi6EEEvPK5uint4PKfS5_PKhiffiPbPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118closest_hit_kernelILi16ELi6EEEvPK5uint4PKfS5_PKhiffijPfPiS8_S8_S9_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118closest_hit_kernelILi16ELi6EEEvPK5uint4PKfS5_PKhiffijPfPiS8_S8_S9_
    24 bytes stack frame, 16 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 464 bytes cmem[0]
ptxas info    : Function properties for _Z8tri_testPKf
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
"""


def test_kernel_of_reads_plain_templated_and_mangled_names():
    names = {
        "closest_hit_kernel(float const*, int, float const*)": "closest_hit",
        "void (anonymous namespace)::closest_hit_kernel<16, 6>(uint4 const*)":
            "closest_hit",
        "void (anonymous namespace)::occluded_kernel<16, 6>(uint4 const*)":
            "occluded",
        "occluded_packets_kernel(float const*, int, float const*)":
            "occluded_packets",
        "(anonymous namespace)::occluded_packets_kernel(uint4 const*, "
        "float const*)": "occluded_packets",
        "_ZN51_GLOBAL__N__00ab1c48_18_packet_traverse_cu_70e8180a23occluded"
        "_packets_kernelEPK5uint4PKfS4_PKhiffiPbPi": "occluded_packets",
        "_ZN12_GLOBAL__N_115occluded_kernelILi16ELi6EEEvPK5uint4": "occluded",
        "void (anonymous namespace)::closest_hit_instanced_kernel<16, 6>("
        "uint4 const*)": "closest_hit_instanced",
        "_ZN12_GLOBAL__N_125occluded_instanced_kernelILi16ELi6EEEvPK5uint4":
            "occluded_instanced",
        "void (anonymous namespace)::occluded_nocull_kernel<16, 6>("
        "uint4 const*)": "occluded_nocull",
        "_ZN12_GLOBAL__N_122occluded_nocull_kernelILi16ELi6EEEvPK5uint4":
            "occluded_nocull",
        # the wide layouts' group walks
        "void (anonymous namespace)::closest_hit_group_kernel<32, 12, 8>("
        "uint4 const*)": "closest_hit",
        "void (anonymous namespace)::occluded_group_kernel<32, 24, 8>("
        "uint4 const*)": "occluded",
        "_ZN12_GLOBAL__N_128occluded_nocull_group_kernelILi32ELi12ELi8EEEv"
        "PK5uint4": "occluded_nocull",
        # the two-level K2's non-culling instantiation (the 04 raycast of
        # an instanced scene), at (16, 6) and at a wide layout
        "void (anonymous namespace)::occluded_nocull_instanced_kernel<16, 6>("
        "uint4 const*)": "occluded_nocull_instanced",
        "_ZN12_GLOBAL__N_132occluded_nocull_instanced_kernelILi16ELi6EEEv"
        "PK5uint4": "occluded_nocull_instanced",
        "_ZN12_GLOBAL__N_132occluded_nocull_instanced_kernelILi32ELi24EEEv"
        "PK5uint4": "occluded_nocull_instanced",
        "void at::native::elementwise_kernel<128, 2>(int)": None,
        "aten::mul": None,
    }
    for name, kernel in names.items():
        assert chip_smoke._kernel_of(name) == kernel, name


def test_ptxas_spills_per_kernel():
    assert chip_smoke._ptxas_spills(PTXAS_LOG) == {"occluded": 0,
                                                  "closest_hit": 16}
    assert chip_smoke._ptxas_spills("") == {}
    # a wide layout's instantiation is told apart by its template arguments
    wide = PTXAS_LOG.replace("ILi16ELi6EE", "ILi32ELi12EE")
    assert chip_smoke._ptxas_spills(PTXAS_LOG + wide) == {
        "occluded": 0, "closest_hit": 16, "occluded_a32_l12": 0,
        "closest_hit_a32_l12": 16}
    # and so is a group walk, by its first two
    group = PTXAS_LOG.replace("_115occluded_kernelILi16ELi6EE",
                              "_121occluded_group_kernelILi32ELi24ELi8EE")
    assert chip_smoke._ptxas_spills(group)["occluded_a32_l24"] == 0
    # and a two-level kernel's wide instantiation
    inst = PTXAS_LOG.replace("_118closest_hit_kernelILi16ELi6EE",
                             "_128closest_hit_instanced_kernelILi32ELi12EE")
    assert chip_smoke._ptxas_spills(inst)["closest_hit_instanced_a32_l12"] \
        == 16
    # and the non-culling two-level K2's, apart from the culling one's
    nocull = PTXAS_LOG.replace(
        "_115occluded_kernelILi16ELi6EE",
        "_132occluded_nocull_instanced_kernelILi32ELi24EE")
    assert chip_smoke._ptxas_spills(nocull) == {
        "occluded_nocull_instanced_a32_l24": 0, "closest_hit": 16}


def test_k1_agreement_counts_ulps_on_hits():
    t = torch.tensor([1.0, float("inf"), 2.0])
    p = {"t": t, "u": torch.tensor([0.25, 0.0, 0.5]),
         "v": torch.tensor([0.5, 0.0, 0.25]),
         "tri_id": torch.tensor([3, -1, 7], dtype=torch.int32)}
    p["hit"] = p["tri_id"] >= 0
    same = {k: v.clone() for k, v in p.items()}
    assert chip_smoke._k1_agreement(same, p) == (True, True, 0, 0.0)
    off = {k: v.clone() for k, v in p.items()}
    off["t"][2] = torch.nextafter(torch.tensor(2.0), torch.tensor(3.0))
    hit_eq, tri_eq, ulp, err = chip_smoke._k1_agreement(off, p)
    assert (hit_eq, tri_eq, ulp) == (True, True, 1) and 0 < err < 1e-6
    off["tri_id"][0] = 4
    assert chip_smoke._k1_agreement(off, p)[1] is False


def test_bound_takes_the_larger_of_bytes_and_operations():
    table = torch.zeros((100, 64))
    few = {"node_rows": 1, "leaf_rows": 1, "distinct_rows": 2,
           "child_tests": 2, "tri_tests": 5}
    ms, by, fetch = chip_smoke._bound(few, table, 10**6, 10**6, 16)
    assert by == "bytes" and fetch == 2 * 64 * 4
    many = {"node_rows": 10**7, "leaf_rows": 10**7, "distinct_rows": 100,
            "child_tests": 3 * 10**7, "tri_tests": 5 * 10**7}
    ms2, by2, fetch2 = chip_smoke._bound(many, table, 10, 10, 16)
    # the tests done, not the rows' slots: 3 children and 5 triangles a row
    ops = 10**7 * (3 * chip_smoke.SLAB_OPS + 5 * chip_smoke.MT_OPS)
    assert by2 == "operations" and fetch2 == 2 * 10**7 * 64 * 4
    assert abs(ms2 - ops / chip_smoke.F32_OPS_PER_S * 1e3) < 1e-12
    assert ms > 0
    # a two-level walk adds each instance row's transform and its 4 loads
    inst = dict(many, inst_rows=10**7)
    ms3, by3, fetch3 = chip_smoke._bound(inst, table, 10, 10, 20)
    ops += 10**7 * chip_smoke.INST_OPS
    assert by3 == "operations" and fetch3 == fetch2 + 10**7 * 64
    assert abs(ms3 - ops / chip_smoke.F32_OPS_PER_S * 1e3) < 1e-12


def test_bound_reads_only_the_rows_the_walk_fetched():
    # a subset of lanes on a large table is charged the distinct rows its
    # walk fetched, each once, not the whole table nor every fetch
    table = torch.zeros((10**4, 64))
    st = {"node_rows": 5000, "leaf_rows": 4000, "distinct_rows": 300,
          "child_tests": 1, "tri_tests": 1}
    n, n_act = 1000, 900
    ms, by, fetch = chip_smoke._bound(st, table, n, n_act, 1)
    want = (300 * 64 * 4 + n_act * chip_smoke.RAY_BYTES
            + n * (chip_smoke.MASK_BYTES + 1))
    assert by == "bytes"
    assert abs(ms - want / chip_smoke.HBM_BYTES_PER_S * 1e3) < 1e-15
    assert fetch == 9000 * 64 * 4  # the L2 traffic still counts every fetch
    more = dict(st, distinct_rows=600)
    assert chip_smoke._bound(more, table, n, n_act, 1)[0] > ms


def test_bench_rays_and_kernel_calls_on_cpu():
    sched = FoveationSchedule.reference_32_16_8().scaled(10)
    rays = kernel_times.bench_rays("cpu", city_n=4, width=96, height=54,
                                   schedule=sched)
    o, d, act, ids = rays["primary"]
    n = o.shape[0]
    assert d.shape == (n, 3) and act.shape == (n,) and ids.shape == (n,)
    so, sd, sq = rays["shadow"]
    # one shadow ray per active primary lane, walked where queried
    assert so.shape == sd.shape == (int(act.sum()), 3)
    assert 0 < int(sq.sum()) < so.shape[0]
    co, cd, cact = rays["continuation"]
    assert co.shape == cd.shape and bool(cact.all())
    assert co.shape[0] == int(rays["bounce0"]["alive"].sum())
    before = dict(kernel_build.LAUNCHES)
    out = {k: f() for k, f in kernel_times.kernel_calls(rays).items()}
    assert kernel_build.LAUNCHES == before  # CPU tensors: no kernel ran
    assert out["k1_primary"]["t"].shape == (n,)
    assert out["k1_continuation"]["hit"].any()
    # the two occlusion kernels answer alike on the same shadow rays
    assert torch.equal(out["k2_shadow"], out["k3_shadow"])
    assert not out["k2_shadow"][~sq].any()


def test_field_rays_and_calls_on_cpu():
    # kernel_times' field mode at a small size: the field on its two-level
    # table and flattened, the same rays through both
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    rays = kernel_times.field_rays("cpu", count=96, width=120, height=68,
                                   schedule=sched)
    scene, flat = rays["scene"], rays["flat"]
    assert scene.bvh.num_instances == 96 and scene.num_triangles == 320
    assert flat.num_triangles == 96 * 320 and not flat.bvh.instanced
    assert rays["build_s"] > 0 and rays["flat_build_s"] > 0
    calls = kernel_times.field_calls(rays)
    assert list(calls) == ["ik1_primary", "ik2_shadow", "flat_k1_primary",
                           "flat_k2_shadow"]
    before = dict(kernel_build.LAUNCHES)
    mism = kernel_times.field_mismatches(rays, calls)
    assert mism == dict.fromkeys(("hit", "t", "u", "v", "tri_id", "inst",
                                  "occluded"), 0)
    out = {k: f() for k, f in calls.items()}
    assert kernel_build.LAUNCHES == before  # CPU tensors: no kernel ran
    # one geometry in two tables: the hits agree but for rounding at edges
    ih, fh = out["ik1_primary"]["hit"], out["flat_k1_primary"]["hit"]
    assert ih.any() and (ih == fh).float().mean() > 0.999
    assert (out["ik2_shadow"] == out["flat_k2_shadow"]).float().mean() > 0.999
    assert out["ik1_primary"]["inst"][ih].min() >= 0


def _fake_profiler(events):
    """A stand-in for ``torch.profiler.profile`` whose ``key_averages`` are
    ``events`` (each ``(name, device type, self device us, count)``)."""
    class Events(list):
        def table(self, **_):
            return "\n".join(e.key for e in self)

    class Profile:
        def __init__(self, *_, **__):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return Events(types.SimpleNamespace(
                key=k, device_type=t, self_device_time_total=us, count=c)
                for k, t, us, c in events)

    return Profile


def _instanced_profile_events(frames):
    """Per frame: 4 launches of each instanced kernel at 0.5 and 0.25 ms,
    60 of an elementwise kernel at 0.1 ms, and the aten op that ran it."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    return [
        ("void (anonymous namespace)::closest_hit_instanced_kernel<16, 6>("
         "uint4 const*)", cuda, frames * 4 * 500.0, frames * 4),
        ("void (anonymous namespace)::occluded_instanced_kernel<16, 6>("
         "uint4 const*)", cuda, frames * 4 * 250.0, frames * 4),
        ("void at::native::elementwise_kernel<128, 2>(int)", cuda,
         frames * 60 * 100.0, frames * 60),
        ("aten::mul", cpu, frames * 60 * 100.0, frames * 60),
    ]


def test_profile_frames_reads_each_path_kernel(monkeypatch, tmp_path):
    import torch.profiler

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", _fake_profiler(
        _instanced_profile_events(chip_smoke.FRAMES)))
    frames = []
    renderer = types.SimpleNamespace(render=lambda: frames.append(1))
    results = {}
    chip_smoke._profile_frames(renderer, str(tmp_path / "p.txt"), results,
                               name="profile_instanced",
                               path_kernels=chip_smoke.INSTANCED_KERNELS)
    p = results["profile_instanced"]
    assert len(frames) == chip_smoke.FRAMES
    assert p["kernel_launches"] == {"closest_hit_instanced": 4,
                                    "occluded_instanced": 4}
    assert p["kernel_ms_per_launch"] == {"closest_hit_instanced": 0.5,
                                         "occluded_instanced": 0.25}
    assert p["device_launches"] == 68
    assert p["device_busy_ms"] == pytest.approx(2.0 + 1.0 + 6.0)
    assert p["traversal_kernels_ms"] == pytest.approx(3.0)
    assert (tmp_path / "p.txt").read_text().count("kernel") == 3
    # the main path's kernels are missing from this profile: it must fail
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke._profile_frames(renderer, str(tmp_path / "q.txt"), {})


def test_instanced_record_has_the_contract_keys():
    r = {"max_abs_err": 0.0, "ms": 0.4, "plain_ms": 700.0, "bound_ms": 0.07,
         "bound_by": "operations", "flat_ms": 0.3, "lanes": 1923984}
    res = {"closest_hit_instanced": {"registers": 72, "local_bytes": 0,
                                     "blocks_per_sm": 7,
                                     "shared_bytes": 32256,
                                     "spill_bytes": 0}}
    rec = chip_smoke._instanced_record(
        "closest_hit_instanced", "traverse8.py:523", r,
        {"closest_hit_instanced": 16}, res)
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    assert contract <= set(rec)
    assert rec["route"] == "cuda" and rec["launches"] == 16
    assert rec["source"].endswith("csrc/traverse.cu")
    assert rec["replaces"].endswith("ops/traverse8.py:523")
    assert rec["flat_ms"] == 0.3 and rec["library_ms"] is None
    assert rec["registers"] == 72


@pytest.fixture
def no_card(monkeypatch):
    """The smoke's phases on the CPU: the torch.cuda calls they make become
    no-ops (the wrappers run the plain versions on CPU tensors)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)


def _small_bench(n=4, w=120, h=68):
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )

    meshes, cam = scenes.box_city(n=n, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(), device="cpu")
    return scene, dataclasses.replace(cam, aspect=w / h)


def test_rehearse_textured_and_large_probe_phases(no_card, monkeypatch):
    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import probe
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    w, h = 120, 68
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    scene, cam = _small_bench(w=w, h=h)
    tex = chip_smoke.textured_phase(scene, 4, sched, w, h, 1, device="cpu")
    assert tex["finite"] and tex["sampler_err"] == 0.0
    assert tex["triangles"] == 4 * 4 * 12 + 12
    assert tex["textures"] == (8, 256, 256, 3)
    assert tex["differing_off_geometry"] == 0 < tex["differing_pixels"]
    assert tex["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    assert tex["traces"][0] > 0 and tex["frame"].shape == (h, w, 3)

    # the large-probe path at a small size: rows dropped above 1000 texels
    monkeypatch.setattr(probe, "SAMPLE_ROWS_MAX_TEXELS", 1000)
    r = Renderer(scene, RenderConfig(width=w, height=h), sched, device="cpu")
    r.set_camera(cam)
    big = chip_smoke.large_probe_phase(r, 64, 32, 1)
    assert big["finite"] and big["texel_bytes"] == 64 * 32 * 3 * 4
    assert r.scene.probe.alias_idx is not None


def test_rehearse_catcher_and_cli_phases(no_card):
    sched = FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=2, r_inner=8.0, r_outer=1e9, redraw=False),
        FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=9.0, redraw=True,
                      launch_w=18, launch_h=18, centered=True,
                      center_offset=9),
    ))
    cat = chip_smoke.catcher_phase(32, 24, sched, device="cpu")
    assert cat["share"] == 1.0
    assert set(cat["rel_err"]) == {"accum", "normal", "albedo", "denoised"}
    assert all(v == 0.0 for v in cat["rel_err"].values())
    cli = chip_smoke.cli_phase(32, 24, "uniform:1", device="cpu")
    assert len(cli["render_ms"]) == 2 and all(x > 0 for x in cli["render_ms"])
    assert set(cli["files"]) == {"frame.png", "aov.npz", "frame_denoised.png",
                                 "run.tsv"}
    assert "<tmp>" in cli["argv"] and "--device cpu" in cli["argv"]


def test_rehearse_instanced_phase(no_card, monkeypatch, tmp_path):
    # phase e at 120x68 on a 96-instance field: the plain versions stand in
    # for the instanced kernels (no device time), the flattened scene's
    # subframe passes the JAX package's instancing gate; profiled with a
    # stand-in for torch.profiler
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _fake_profiler(
        _instanced_profile_events(chip_smoke.FRAMES)))
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    results = {}
    out = chip_smoke.instanced_phase(sched, 120, 68, 1, device="cpu",
                                     count=96,
                                     profile=str(tmp_path / "p.txt"),
                                     results=results)
    prof = results["profile_instanced"]
    assert prof["kernel_ms_per_launch"]["closest_hit_instanced"] == 0.5
    assert (tmp_path / "p_instanced.txt").exists()
    assert out["finite"] and out["frame"].shape == (68, 120, 3)
    assert out["world_triangles"] == 96 * 320
    assert out["table_bytes"] * 10 < out["flat_table_bytes"]
    assert out["tri_pack_bytes"] * 96 == out["flat_tri_pack_bytes"]
    k1, k2 = out["k1"], out["k2"]
    assert k1["mismatches"] == dict.fromkeys(("hit", "t", "u", "v", "tri_id",
                                              "inst"), 0)
    assert k1["max_abs_err"] == 0.0
    assert k1["hits"] > 0 and k1["work"]["inst_rows"] > 0
    assert k2["mismatches"] == 0 and k2["queried"] > 0
    assert k1["ms"] is None and k1["bound_ms"] > 0
    assert k1["flat_ms"] is None and k2["flat_ms"] is None
    assert out["flat_stack_depth"] > 0
    assert out["close_share"] >= chip_smoke.FLAT_SHARE
    assert out["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    assert out["flattened"]["finite"]
    # the field's two-level tables at the wide layouts: exact, the frame
    # within 1 LSB of the (16, 6) table's
    _check_field_layouts(out["wide"])
    # ... and their frames profiled: the instanced kernels' time a launch
    assert all(r["profile"]["kernel_ms_per_launch"][k] > 0
               for r in out["wide"].values()
               for k in traverse.INSTANCED_KERNELS)
    chip_smoke._field_lines("instanced field", out["wide"])


def _check_field_layouts(wide):
    assert set(wide) == {"field_a32_l12", "field_a32_l24"}
    for rec in wide.values():
        k1, k2 = rec["k1"], rec["k2"]
        assert not any(k1["mismatches"].values()) and k1["max_abs_err"] == 0
        assert k2["mismatches"] == 0 and k2["max_abs_err"] == 0
        assert k1["hits"] > 0 and k1["work"]["inst_rows"] > 0
        assert k1["ms"] is None and k1["bound_ms"] > 0
        assert rec["frame_share"] >= 0.99 and rec["finite"]
        assert rec["resources"] is None and "frame" not in rec


def test_rehearse_city_field_phase(no_card):
    # phase e's second field, 8 instances of a 1,500-triangle BLAS, at
    # 120x68 in its (16, 6) table and at the wide layouts
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    out = chip_smoke.city_field_phase(sched, 120, 68, 1, device="cpu")
    assert out["instances"] == 8 and out["unique_triangles"] == 1500
    assert out["world_triangles"] == 12_000 and out["finite"]
    assert out["frame"].shape == (68, 120, 3)
    assert not any(out["mismatches"].values())
    assert out["k1_ms"] is None and out["k2_ms"] is None  # no device time
    _check_field_layouts(out["wide"])
    # many leaf rows a BLAS: the wide tables' BLASes are more than a leaf
    assert all(r["rows"] - r["blas_base"] > 20 for r in out["wide"].values())
    chip_smoke._field_lines("city field", out["wide"])


def test_field_record_has_the_contract_keys():
    def field(ms):
        k = {"max_abs_err": 0.0, "ms": ms, "plain_ms": 900.0,
             "bound_ms": 0.05, "bound_by": "operations", "lanes": 1923984}
        return {"field_a32_l24": {
            "k1": k, "k2": dict(k, lanes=1405984), "stack_depth": 60,
            "launches": {"closest_hit_instanced_a32_l24": 16,
                         "occluded_instanced_a32_l24": 16},
            "resources": {"closest_hit_instanced": {
                "registers": 90, "local_bytes": 1024, "blocks_per_sm": 5,
                "shared_bytes": 1024}}}}
    inst = {"wide": field(0.9), "k1": {"ms": 0.57}}
    rec = chip_smoke._field_record(inst, {"wide": field(0.2), "k1_ms": 0.1},
                                   "closest_hit_instanced", (32, 24),
                                   "traverse8.py:523", {})
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    assert contract <= set(rec)
    assert rec["name"] == "closest_hit_instanced_a32_l24"
    assert rec["launches"] == 16 and rec["ms"] == 0.9
    assert rec["narrow_ms"] == 0.57 and rec["city"]["ms"] == 0.2
    assert rec["city"]["narrow_ms"] == 0.1
    assert rec["registers"] == 90 and rec["library_ms"] is None


def test_rehearse_spectral_phases(no_card):
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig

    w, h = 120, 68
    scene, cam = _small_bench(w=w, h=h)
    out = chip_smoke.spectral_phase(scene, RenderConfig(width=w, height=h),
                                    sched, cam, 1, 16, device="cpu")
    assert out["finite"] and out["glass_share"] == 1.0
    assert out["frame"].shape == (h, w, 3) and out["traces"][0] > 0
    cli = chip_smoke.cli_phase(32, 24, "uniform:1", device="cpu",
                               spectral=True)
    assert "--spectral" in cli["argv"] and len(cli["render_ms"]) == 2
    assert set(cli["files"]) == {"frame.png", "run.tsv"}


def test_rehearse_deep_phase(no_card, monkeypatch):
    # phase g on box_city_fast(6) at 120x68 (444 triangles), the npz cache
    # forced on: a cold build that writes it, a warm start that reads it;
    # the (32, 12) table beside the (16, 6) one, each table's frames
    # profiled through a stand-in for torch.profiler
    _rehearse_deep_phase(monkeypatch, (32, 12))


def test_rehearse_deep_phase_python_collapsed(no_card, monkeypatch):
    # the same with the (32, 24) table, which the Python collapse builds
    _rehearse_deep_phase(monkeypatch, (32, 24))


def _rehearse_deep_phase(monkeypatch, wide):
    import torch.profiler

    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native

    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    monkeypatch.setattr(torch.profiler, "profile",
                        _fake_profiler(_path_profile_events(1)))
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    g = chip_smoke.deep_phase(6, 1, sched, 120, 68, device="cpu", subset=500,
                              wide=wide)
    assert g["triangles"] == 444 and g["cache_files"] == 1
    assert set(g["cold"]) == {"key_s", "collapse_s", "pack_s", "save_s"}
    assert set(g["warm"]) == {"key_s", "load_s"}
    assert g["finite"] and g["mean_radiance"] > 0
    assert g["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    assert g["table_bytes"] == g["rows"] * 64 * 4
    w = g["wide"]
    assert tuple(w["layout"]) == wide and w["finite"]
    assert w["table_bytes"] == w["rows"] * max(4 * wide[0], 10 * wide[1]) * 4
    assert set(w["build"]) == {"key_s", "collapse_s", "pack_s", "save_s"}
    for rec in (g, w):
        for k in ("k1", "k2", "k2_nocull"):
            assert rec[k]["lanes"] == 500 and rec[k]["max_abs_err"] == 0.0
            assert rec[k]["ms"] is None and rec[k]["bound_ms"] > 0
            # the frame's lanes: more work than the subset's
            assert rec[k]["frame_bound_ms"] > rec[k]["bound_ms"]
        assert rec["k1"]["hit_equal"] and rec["k1"]["ulp"] == 0
        # K2 below all 500 subset lanes, so that not every shadow ray is
        # occluded; culling occludes no more than the non-culling K2
        assert 0 < rec["k2"]["occluded"] < 500
        assert rec["k2"]["occluded"] <= rec["k2_nocull"]["occluded"]
        assert rec["profile"]["device_busy_ms"] > 0
    # one scene in two tables: the same hits, t and frame
    assert w["hit_equal"] and w["t_equal"] and w["frame_share"] >= 0.99
    assert w["ties"]["ties"] == w["ties"]["lanes"]
    # fewer, wider rows: fewer rows a lane
    assert w["rows"] < g["rows"]
    assert sum(w["k1"]["rows_per_lane"]) < sum(g["k1"]["rows_per_lane"])
    assert "frame state" in g["memory_report"]
    chip_smoke._deep_lines("deep", g)


def test_rehearse_jax_tables_phase(no_card, monkeypatch):
    # phase p on box_city_fast(6) at 120x68 (444 triangles), "deep" from
    # 100 triangles with treelets of 24 rows, so that a named L12/A32 build
    # gives the JAX package's default table (DFS rows, grouped treelets);
    # the npz cache forced on, each table's frames profiled through a
    # stand-in for torch.profiler
    import torch.profiler

    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native

    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    monkeypatch.setattr(bvh_native, "DEEP_TRIS_THRESHOLD", 100)
    monkeypatch.setattr(bvh_native, "DEEP_TREELET_BUDGET", 24)
    monkeypatch.setattr(torch.profiler, "profile",
                        _fake_profiler(_path_profile_events(1)))
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    p = chip_smoke.jax_tables_phase(6, 1, sched, 120, 68, device="cpu",
                                    subset=500)
    assert list(p) == [label for label, _ in chip_smoke.JAX_TABLES]
    first, plain, jax_default = p.values()
    assert (first["layout"], first["dfs"], first["top_rows"]) == ((16, 6),
                                                                  False, 0)
    assert (plain["layout"], plain["dfs"]) == ((32, 12), False)
    assert jax_default["layout"] == (32, 12) and jax_default["dfs"]
    assert jax_default["top_rows"] > 0 and jax_default["treelet_stack"] > 0
    assert jax_default["rows"] > plain["rows"]  # the group rows
    for rec in p.values():
        assert rec["triangles"] == 444 and rec["finite"]
        assert set(rec["cold"]) == {"key_s", "collapse_s", "pack_s",
                                    "save_s"}
        assert set(rec["warm"]) == {"key_s", "load_s"}
        assert rec["first_share"] >= 0.99
        for k in ("k1", "k2", "k2_nocull"):
            assert rec[k]["lanes"] == 500 and rec[k]["max_abs_err"] == 0.0
            assert rec[k]["ms"] is None and rec[k]["bound_ms"] > 0
        assert rec["profile"]["device_busy_ms"] > 0
    for rec in (plain, jax_default):
        assert rec["hit_equal"] and rec["t_equal"]
        assert rec["ties"]["ties"] == rec["ties"]["lanes"]
    assert jax_default["plain_share"] >= 0.99
    assert 0.99 <= jax_default["plain_identical"] <= 1.0
    chip_smoke._jax_tables_lines("p", p)
    for rec in p.values():
        rec["launches"] = collections.defaultdict(lambda: 4)
    rows = chip_smoke._jax_tables_record(p, "k1", (32, 12))
    assert list(rows) == ["L12/A32 plain", "JAX default"]
    assert rows["JAX default"]["launches"] == 4
    assert set(chip_smoke._jax_tables_record(p, "k2_nocull", (16, 6))) == {
        "(16, 6)"}


def test_rehearse_deep_field_phase(no_card):
    # phase q on two instances of a box_city_fast(6) BLAS (444 triangles)
    # at 96x54, in its (16, 6) two-level table and at (32, 12)
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    q = chip_smoke.deep_field_phase(6, 1, sched, 96, 54, device="cpu",
                                    subset=500, count=2)
    assert (q["instances"], q["unique_triangles"], q["world_triangles"]) \
        == (2, 444, 888)
    tables = [q["deep_field"], q["deep_field_a32_l12"]]
    assert [tuple(r["layout"]) for r in tables] == [(16, 6), (32, 12)]
    for rec in tables:
        k1, k2 = rec["k1"], rec["k2"]
        assert not any(k1["mismatches"].values()) and k1["max_abs_err"] == 0
        assert k2["mismatches"] == 0 and k2["max_abs_err"] == 0
        assert k1["lanes"] == k2["lanes"] == 500
        assert k1["hits"] > 0 and k1["work"]["inst_rows"] > 0
        assert 0 < k2["occluded"] < 500
        for r in (k1, k2):
            assert r["ms"] is None and r["frame_ms"] is None
            assert 0 < r["bound_ms"] < r["frame_bound_ms"]
        assert rec["frame_share"] >= 0.99 and rec["finite"]
        assert rec["resources"] is None and "frame" not in rec
        assert rec["table_bytes"] == rec["rows"] * 4 * max(
            4 * rec["layout"][0], 10 * rec["layout"][1])
    assert tables[1]["rows"] < tables[0]["rows"]
    chip_smoke._deep_field_lines("q", q)
    for rec in tables:
        rec["launches"] = collections.defaultdict(lambda: 2)
    r = chip_smoke._deep_field_record(q, "closest_hit_instanced", (32, 12))
    assert r["launches"] == 2 and r["lanes"] == 500 and r["ms"] is None


def test_rehearse_oracle_phase_and_nocull_check(no_card):
    orc = chip_smoke.oracle_phase(device="cpu")
    assert orc["oracle_ssim"] >= chip_smoke.ORACLE_SSIM
    assert orc["oracle_mean_abs"] < chip_smoke.ORACLE_MEAN_ABS
    assert orc["broken_ssim"] < 0.9 and orc["fovea_identical"]
    assert orc["golden_ssim"] > chip_smoke.GOLDEN_SSIM
    assert orc["golden_mean_lsb"] < chip_smoke.GOLDEN_MEAN_LSB
    assert orc["raycast_share"] == 1.0
    rs = orc["raycast_shadow"]
    # back faces occlude the raycast's shadow rays only without culling
    assert rs["mismatches"] == 0 and rs["occluded"] > rs["occluded_culling"]
    # the raycast from the wide tables (no kernel runs on the CPU)
    assert orc["raycast_wide"] == {
        traverse.layout_name("occluded_nocull", *lay): {
            "launches": 0, "share": 1.0}
        for lay in traverse.WIDE_LAYOUTS}

    sched = FoveationSchedule.reference_32_16_8().scaled(10)
    rays = kernel_times.bench_rays("cpu", city_n=4, width=96, height=54,
                                   schedule=sched)
    so, sd, sq = rays["shadow"]
    cfg = rays["config"]
    out = chip_smoke.nocull_check(rays["scene"].bvh, so, sd, sq, cfg.tmin,
                                  cfg.tmax, device="cpu")
    assert out["mismatches"] == 0 and out["ms"] is None
    assert out["occluded"] >= out["occluded_culling"]
    assert out["bound_ms"] > 0 and out["queried"] == int(sq.sum())


def test_rehearse_raycast_field_phase(no_card):
    # phase r at 64x36 on 256 instances: the 04 raycast of the instance
    # field from its two-level tables at every compiled layout, the
    # non-culling two-level walk against its plain version (on the CPU the
    # wrappers run the plain versions: no kernel launches)
    rf = chip_smoke.raycast_field_phase(64, 36, device="cpu", count=256)
    assert list(rf) == [traverse.layout_name("raycast_field", *lay)
                        for lay in ((16, 6), (32, 12), (32, 24))]
    chip_smoke._raycast_field_lines(rf)
    chip_smoke._check_raycast_field(rf, device="cpu")
    for rec in rf.values():
        assert rec["frame_shape"] == [36, 64, 3] and rec["plain_identical"]
        assert rec["mismatches"] == 0 and rec["ms"] is None
        assert rec["occluded"] > rec["occluded_culling"] >= 0
        assert rec["bound_ms"] > 0 and rec["queried"] > 0
        assert rec["share_vs_first"] >= 0.99
        assert rec["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    rec = next(iter(rf.values()))
    rec["launches"] = collections.defaultdict(lambda: 3)
    r = chip_smoke._raycast_field_record(rec, {})
    assert r["name"] == "occluded_nocull_instanced" and r["launches"] == 3
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in r, key


def test_rehearse_readme_example(no_card):
    # phase h's line: the README's Renderer(meshes=...) builds the scene
    # itself, on the device asked for
    sched = FoveationSchedule.uniform(1)
    r = chip_smoke.readme_example(24, 16, schedule=sched, device="cpu")
    assert r["shape"] == (16, 24, 3) and 0 < r["mean"] < 255
    assert r["device"] == "cpu" and r["traces"] > 0
    assert r["launches"] == {k: 0 for k in kernel_build.LAUNCHES}


def test_rehearse_demand_phase(no_card):
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    small = FoveationSchedule.uniform(2)
    d = chip_smoke.demand_phase(24, sched, 120, 68, (32, 24), small,
                                cli_size=(32, 24), cli_schedule="uniform:1",
                                device="cpu")
    full, lru = d["runs"][1024]["frames"], d["runs"][64]["frames"]
    assert d["runs"][1024]["total_pages"] == 128
    # every tile fits: requests, loads, nothing open, nothing by frame 3
    assert full[0]["requested"] == full[0]["loaded"] > 64
    assert all(x["open"] == 0 for x in full) and full[2]["requested"] == 0
    # 64 pages: the atlas stays full and the LRU evicts
    assert all(x["resident"] <= 64 for x in lru) and lru[-1]["evicted"] > 0
    assert lru[0]["open"] == lru[0]["requested"] - 64
    assert d["small_share"] == 1.0
    assert set(d["cli"]["files"]) == {"frame.png", "run.tsv"}
    assert "--demand-textures" in d["cli"]["argv"]


def _path_profile_events(frames):
    """Per frame: 4 launches each of K1 and K2 and 60 of an elementwise
    kernel."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    return [
        ("void (anonymous namespace)::closest_hit_kernel<16, 6>(uint4 "
         "const*)", cuda, frames * 4 * 300.0, frames * 4),
        ("void (anonymous namespace)::occluded_kernel<16, 6>(uint4 const*)",
         cuda, frames * 4 * 100.0, frames * 4),
        ("void at::native::elementwise_kernel<128, 2>(int)", cuda,
         frames * 60 * 100.0, frames * 60),
    ]


def test_rehearse_stereo_and_gif_phases(no_card, monkeypatch, tmp_path):
    # phase j at 120x68 an eye, profiled through a stand-in; phase n's GIF
    # of its pairs
    import torch.profiler

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig

    monkeypatch.setattr(torch.profiler, "profile", _fake_profiler(
        _path_profile_events(chip_smoke.FRAMES)))
    w, h = 120, 68
    scene, cam = _small_bench(w=w, h=h)
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    results = {}
    st = chip_smoke.stereo_phase(scene, RenderConfig(width=w, height=h),
                                 sched, cam, 1, device="cpu",
                                 profile=str(tmp_path / "p.txt"),
                                 results=results)
    assert st["mono_equal"] == [True, True] and st["finite"]
    assert len(st["pairs"]) == 2 and st["pairs"][0].shape == (2, h, w, 3)
    assert st["traces"][0] > 0 and st["mrays"] > 0
    assert abs(np.linalg.norm(np.subtract(*st["eyes"])) - chip_smoke.IPD) \
        < 1e-9
    assert st["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    assert results["profile_stereo"]["kernel_launches"] == {
        "closest_hit": 4, "occluded": 4}
    assert (tmp_path / "p_stereo.txt").exists()
    gf = chip_smoke.gif_phase(st["pairs"])
    assert gf["frames"] == 2 and gf["size"] == (2 * w, h)
    assert gf["mean_abs_lsb"] < 8


def test_rehearse_multidevice_and_multiprocess_phases(no_card):
    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.parallel import multihost

    w, h = 120, 68
    scene, cam = _small_bench(w=w, h=h)
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    md = chip_smoke.multidevice_phase(scene, RenderConfig(width=w, height=h),
                                      sched, cam, 1, device="cpu")
    for name in ("samples", "scene", "renderer"):
        assert chip_smoke._exact(md[name]), (name, md[name])
        assert md[name]["within_1lsb"] == 1.0
        assert len(md[name]["frame_ms"]) == 1
    assert md["renderer"]["mesh"] == ["cpu"]
    assert sum(md["block_bytes"]) == md["table_bytes"]
    assert md["block_bytes"][0] == md["block_bytes"][1]
    mp = chip_smoke.multiprocess_phase(multihost.RenderJob(frames=2),
                                       device="cpu", timeout_s=120)
    assert mp["ranks_equal"] and mp["traces"][0] == mp["traces"][1] > 0
    assert chip_smoke._exact(mp["vs_reference"])
    assert mp["frame"].shape == (24, 32, 3)
    assert mp["launches"] == [{k: 0 for k in kernel_build.LAUNCHES}] * 2


def test_rehearse_viewer_phase(no_card):
    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig

    # the progressive start needs 64 pixels a side at warm-up scale 2
    w, h = 128, 72
    scene, cam = _small_bench(w=w, h=h)
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    sealed = FoveationSchedule.reference_32_16_8_sealed().scaled(8)
    vw = chip_smoke.viewer_phase(scene, RenderConfig(width=w, height=h),
                                 sched, cam, device="cpu", timeout_s=120,
                                 cycle=("sealed/8", sealed), warmup_scale=2)
    assert "error" not in vw, vw["error"]
    assert vw["page"] and vw["jpeg_sizes"] == [(w, h)] * 2 and vw["swapped"]
    assert vw["subframe_after"] <= vw["frames_since_input"]
    assert vw["final"]["schedule"] == "sealed/8"
    assert vw["final"]["fps"] > 0 and vw["render_ms"]
    assert vw["frames"] > 5


def test_rehearse_sweep_and_bsdf_phases(no_card):
    sw = chip_smoke.sweep_phase(48, 36, 1, device="cpu",
                                extra=("--skip-uniform", "--scale-rings"))
    assert set(sw["files"]) == set(chip_smoke.SWEEP_FILES)
    assert list(sw["ms_per_frame"]) == [f"fov_{n}" for n in
                                        ("32_2_1", "32_4_2", "32_8_4",
                                         "32_16_8")]
    assert all(v > 0 for v in sw["ms_per_frame"].values())
    assert "<tmp>" in sw["argv"]
    bs = chip_smoke.bsdf_phase(device="cpu")
    assert set(bs) == {"plastic", "glass"}
    for v in bs.values():
        assert v["rel_err"] == 0.0 and v["uv_err"] == 0.0
        assert v["marks"] > 0 and v["marks_differ"] == 0


def test_rehearse_legacy_phase(no_card):
    # phase o on box_city n=4 at 96x54: the threaded and packet walks
    # against K1/K2 (here their plain versions), the Python-built tables
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )

    sched = FoveationSchedule.reference_32_16_8().scaled(10)
    rays = kernel_times.bench_rays("cpu", city_n=4, width=96, height=54,
                                   schedule=sched)
    tris = host_triangles(scenes.box_city(n=4, seed=0)[0])
    lg = chip_smoke.legacy_phase(rays, tris, device="cpu")
    assert lg["triangles"] == 204 and lg["nodes"] > 0
    assert lg["python_rows"] == lg["native_rows"] == 50
    for name in ("primary", "continuation"):
        r = lg[name]
        assert r["steps"] > 0 and r["packet_steps"] > r["steps"]
        assert r["threaded_ms"] is None and r["packet_ms"] is None
        assert r["vs_k1"]["hits"] > 0
        for v in (r["vs_k1"], r["packet_vs_threaded"]):
            assert v["hit_mismatches"] == v["disagree"] == 0
            assert v["tri_id_share"] == 1.0 and v["lanes"] == []
    s = lg["shadow"]
    assert s["queried"] == int(rays["shadow"][2].sum()) and s["occluded"] > 0
    assert s["differ"] == s["packet_differ"] == 0
    assert lg["launches"] == {k: 0 for k in kernel_build.LAUNCHES}
    for k in ("k1", "k2", "k3"):
        r = lg["python_table"][k]
        assert r["max_abs_err"] == 0.0 and r["ms"] is None
        assert r["bound_ms"] > 0
        rec = chip_smoke._python_record(lg, k, "closest_hit")
        assert set(rec) == {"lanes", "ms", "plain_ms", "bound_ms",
                            "bound_by", "launches", "max_abs_err"}
    assert lg["python_table"]["k1"]["vs_native"]["hit_mismatches"] == 0
    assert lg["python_table"]["k3"]["k2_mismatches"] == 0
    c = lg["cdf"]
    assert c["texel_mismatches"] == c["color_mismatches"] == 0
    assert c["dir_max_err"] == c["pdf_max_rel"] == 0.0
    assert lg["argmin_first"]
    chip_smoke._legacy_lines(lg, {})


def test_brute_lanes_report_each_walk_and_brute_force():
    # the records phase o keeps of lanes where two walks disagree
    sched = FoveationSchedule.reference_32_16_8().scaled(10)
    rays = kernel_times.bench_rays("cpu", city_n=4, width=96, height=54,
                                   schedule=sched)
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    scene, cfg = rays["scene"], rays["config"]
    o, d, act, _ = rays["primary"]
    args = (scene.bvh.table, o, d, act, cfg.tmin, cfg.tmax,
            *scene.bvh.walk_args)
    k1 = traverse.closest_hit(*args)
    lanes = torch.nonzero(k1["hit"]).squeeze(1)[:3]
    miss = dict(k1, hit=torch.zeros_like(k1["hit"]))
    assert torch.equal(chip_smoke._disagree(miss, k1, 1e-5), k1["hit"])
    assert not chip_smoke._disagree(k1, k1, 1e-5).any()
    recs = chip_smoke._brute_lanes(scene, o, d, lanes, {"k1": k1},
                                   cfg.tmin, cfg.tmax, cap=2)
    assert [r["lane"] for r in recs] == lanes[:2].tolist()
    for r in recs:
        assert chip_smoke._sides_with(r, "k1") and r["brute"] == r["k1"]
        assert np.array_equal(
            np.array(r["origin_bits"], np.int32).view(np.float32),
            o[r["lane"]].numpy())
    so, sd, sq = rays["shadow"]
    occ = traverse.occluded(scene.bvh.table, so, sd, sq, cfg.tmin, cfg.tmax,
                            *scene.bvh.walk_args)
    lanes = torch.nonzero(occ).squeeze(1)[:2]
    recs = chip_smoke._brute_lanes(scene, so, sd, lanes, {"k2": ~occ},
                                   cfg.tmin, cfg.tmax)
    assert all(r["brute"] is True and r["k2"] is False
               and not chip_smoke._sides_with(r, "k2") for r in recs)
    assert chip_smoke._brute_lanes(scene, so, sd, lanes[:0], {"k2": occ},
                                   cfg.tmin, cfg.tmax) == []
