"""The headset configuration (``configs/questpro262k.json``): it loads by
name, its triangle count is the generator's, its schedule and settings are
the desktop Sponza-class configuration's, and a stereo run at its portrait
shape, cut to a tiny size, reports the readers of the port's wavefront
count and download span."""

import os

from conftest import BENCH, REPO, tiny_tree
from fovbench import harness
from fovbench.scenes import box_city_fast


def _configs():
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    return (harness.config_of(BENCH, bench, "questpro262k"),
            harness.config_of(BENCH, bench, "boxcity262k"))


def test_the_headset_configuration_loads_by_name():
    cfg, desk = _configs()
    assert cfg["name"] == "questpro262k"
    assert (cfg["width"], cfg["height"]) == (1800, 1920)
    assert cfg["reduced"] == ["geometry", "textures"]
    for key in ("geometry", "textures", "triangles", "schedule", "max_depth",
                "render", "bvh", "probe"):
        assert cfg[key] == desk[key], key
    # the scene's stand-ins are the desktop's; the field and the radii are
    # named as departures from the headset's display
    assert {k: cfg["replaced"][k] for k in desk["replaced"]} == desk["replaced"]
    assert set(cfg["replaced"]) - set(desk["replaced"]) == {"field_of_view",
                                                            "radii"}
    assert cfg["schedule"]["name"] == "reference_32_16_8"


def test_its_triangles_are_the_generators():
    cfg, _ = _configs()
    geo = dict(cfg["geometry"])
    geo.pop("generator")
    meshes, _, _ = box_city_fast.generate(**geo, texture_size=None)
    assert sum(len(m["index"]) for m in meshes) == cfg["triangles"]


def test_a_portrait_stereo_run_reports_both_readers(tmp_path, monkeypatch):
    """At the panel's 1800:1920 cut to 75x80 (the schedule scaled by 24):
    two wavefronts a pair, and the download's host milliseconds. (The
    counters start afresh, as in a process of its own.)"""
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "COUNTERS", {
        **{s: 0 for s in tracing.SCALARS},
        **{g: {} for g in tracing.GROUPS}})
    tiny = tiny_tree(str(tmp_path), width=75, height=80, scale=24)
    res, info = harness.run_cell(tiny, "tiny.stereo_saccade", 2 ** 31 + 77,
                                 0.3, True, "cpu")
    assert res["correct"] and info["eyes"] == 2
    assert res["metrics"]["wavefronts_per_frame"] == {
        "value": 2.0, "unit": "wavefronts/frame"}
    assert res["metrics"]["download_ms"]["value"] > 0.0
    assert res["metrics"]["download_ms"]["unit"] == "ms/frame"
