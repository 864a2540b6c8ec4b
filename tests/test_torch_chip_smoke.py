"""The pure helpers of ``chip_smoke.py`` and the shape builder of
``tools/kernel_times.py``, on the CPU (no card: the wrappers run the plain
versions)."""

import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu_torch.config import FoveationSchedule
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
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
        "void at::native::elementwise_kernel<128, 2>(int)": None,
        "aten::mul": None,
    }
    for name, kernel in names.items():
        assert chip_smoke._kernel_of(name) == kernel, name


def test_ptxas_spills_per_kernel():
    assert chip_smoke._ptxas_spills(PTXAS_LOG) == {"occluded": 0,
                                                  "closest_hit": 16}
    assert chip_smoke._ptxas_spills("") == {}


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
    few = {"node_rows": 1, "leaf_rows": 1, "child_tests": 2, "tri_tests": 5}
    ms, by, fetch = chip_smoke._bound(few, table, 10**6, 10**6, 16)
    assert by == "bytes" and fetch == 2 * 64 * 4
    many = {"node_rows": 10**7, "leaf_rows": 10**7, "child_tests": 3 * 10**7,
            "tri_tests": 5 * 10**7}
    ms2, by2, fetch2 = chip_smoke._bound(many, table, 10, 10, 16)
    # the tests done, not the rows' slots: 3 children and 5 triangles a row
    ops = 10**7 * (3 * chip_smoke.SLAB_OPS + 5 * chip_smoke.MT_OPS)
    assert by2 == "operations" and fetch2 == 2 * 10**7 * 64 * 4
    assert abs(ms2 - ops / chip_smoke.F32_OPS_PER_S * 1e3) < 1e-12
    assert ms > 0


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
