"""The PyTorch port's command-line entry point on the CPU (``--device
cpu``): it writes every file it is asked for, in the JAX CLI's orientation
(row 0 of a written image is the top of the frame: the frame is flipped),
resumes from its checkpoint, and refuses the flags it does not port with
the ROADMAP item that will port them."""

import dataclasses

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.utils import exr as jexr
from fovpathtracing_optixcodelatest_tpu.utils import image as jimage
from fovpathtracing_optixcodelatest_tpu_torch.apps import main as cli
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

W, H = 32, 24
BASE = ["--device", "cpu", "--scene", "cornell", "--width", str(W),
        "--height", str(H), "--schedule", "uniform:2"]


def _reference(frames, sampler="random"):
    """The frames the CLI renders, through the Renderer directly."""
    meshes, cam = scenes.cornell()
    r = Renderer(build_scene(meshes, constant_probe((2.5,) * 3), device="cpu"),
                 RenderConfig(width=W, height=H, sampler=sampler),
                 FoveationSchedule.uniform(2), device="cpu")
    r.set_camera(dataclasses.replace(cam, aspect=W / H))
    for _ in range(frames):
        frame = r.render()
    return frame, r.linear_frame()


def test_cli_writes_every_file(tmp_path, capsys):
    out = tmp_path / "frame.png"
    rc = cli.main(BASE + [
        "--frames", "2", "--sampler", "blue_noise", "--out", str(out),
        "--aov-out", str(tmp_path / "aov.npz"), "--denoise",
        "--tsv", str(tmp_path / "run.tsv"),
        "--checkpoint", str(tmp_path / "ck.npz")])
    assert rc == 0
    frame, _ = _reference(2, sampler="blue_noise")
    assert np.array_equal(jimage.load_png(str(out)),
                          frame[::-1].astype(np.float32) / 255.0)
    den = jimage.load_png(str(tmp_path / "frame_denoised.png"))
    assert den.shape == (H, W, 3) and den.max() > 0
    with np.load(tmp_path / "aov.npz") as z:
        assert sorted(z.files) == ["accum", "albedo", "normal"]
        assert all(z[k].shape == (H, W, 3) and np.isfinite(z[k]).all()
                   for k in z.files)
    rows = (tmp_path / "run.tsv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("frame\tstate_ms\trender_ms")
    assert float(rows[-1].split("\t")[2]) > 0
    assert "subframe: 2" in capsys.readouterr().err

    # resume: two more frames continue the accumulation
    out2 = tmp_path / "more.exr"
    assert cli.main(BASE + ["--frames", "2", "--sampler", "blue_noise",
                            "--resume", str(tmp_path / "ck.npz"),
                            "--out", str(out2)]) == 0
    _, lin = _reference(4, sampler="blue_noise")
    want = lin[::-1].astype(np.float16).astype(np.float32)
    assert np.array_equal(jexr.read_exr(str(out2))[..., :3], want)


@pytest.mark.parametrize("flag,item", [
    (["--viewer"], "18"), (["--multichip", "samples"], "19"),
])
def test_cli_refuses_what_is_not_ported(flag, item, capsys):
    assert cli.main(BASE + flag) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and f"ROADMAP item {item}" in err


def test_cli_spectral_renders(tmp_path):
    # --spectral (formerly refused) renders the hero-wavelength path: the
    # same frame as the Renderer's with spectral=True and the dispersion
    out = tmp_path / "spec.png"
    assert cli.main(BASE + ["--frames", "1", "--spectral", "--dispersion",
                            "9000", "--out", str(out)]) == 0
    meshes, cam = scenes.cornell()
    r = Renderer(build_scene(meshes, constant_probe((2.5,) * 3), device="cpu"),
                 RenderConfig(width=W, height=H, spectral=True,
                              dispersion=9000.0),
                 FoveationSchedule.uniform(2), device="cpu")
    r.set_camera(dataclasses.replace(cam, aspect=W / H))
    frame = r.render()
    assert np.array_equal(jimage.load_png(str(out)),
                          frame[::-1].astype(np.float32) / 255.0)


def test_cli_schedules_and_flags_match_jax():
    from fovpathtracing_optixcodelatest_tpu.apps import main as jcli

    for spec in ("32_16_8", "16_4_2", "uniform:3", "uniform"):
        got, want = cli.build_schedule(spec), jcli.build_schedule(spec)
        assert ([dataclasses.asdict(p) for p in got.passes]
                == [dataclasses.asdict(p) for p in want.passes])
    jv = vars(jcli.parse_args([]))
    pv = vars(cli.parse_args([]))
    assert pv.pop("device") == "cuda"
    assert pv == jv


def test_cli_demand_textures_renders(tmp_path, capsys):
    # --demand-textures (formerly refused) pages an OBJ's textures in
    # through a DemandLoader: the frame the Renderer gives with the same
    # loader, processing the requests after every frame
    import chip_smoke
    from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
        DemandLoader,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.obj_loader import (
        load_obj,
    )

    obj = chip_smoke._write_textured_obj(str(tmp_path))
    out = tmp_path / "demand.png"
    assert cli.main(["--device", "cpu", "--obj", obj, "--width", str(W),
                     "--height", str(H), "--frames", "3", "--schedule",
                     "uniform:1", "--demand-textures", "--demand-pages", "4",
                     "--out", str(out)]) == 0
    assert "demand: +" in capsys.readouterr().err
    meshes, textures = load_obj(obj)
    loader = DemandLoader(max_pages=4, device="cpu")
    for img in textures:
        loader.create_texture(img)
    scene = build_scene(meshes, constant_probe((2.5,) * 3), device="cpu",
                        demand=loader.launch_prepare())
    r = Renderer(scene, RenderConfig(width=W, height=H),
                 FoveationSchedule.uniform(1), device="cpu",
                 demand_loader=loader)
    lo = min(float(m.vertex.min()) for m in meshes)
    hi = max(float(m.vertex.max()) for m in meshes)
    span = hi - lo
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera

    r.set_camera(Camera(eye=(span, span * 0.4, span), lookat=(0.0, 0.0, 0.0),
                        fov_y=45.0, aspect=W / H))
    for _ in range(3):
        frame = r.render()
        r.process_demand_requests()
    assert loader.num_tiles_evicted > 0  # 16 tiles through a 4-page atlas
    assert np.array_equal(jimage.load_png(str(out)),
                          frame[::-1].astype(np.float32) / 255.0)
