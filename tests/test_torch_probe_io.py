"""The PyTorch port's large-probe sampling, prefiltered CDF, AA samplers and
host IO (images, EXR, Radiance HDR, OBJ/MTL, checkpoints, TSV) against the
JAX package on the CPU.

Tolerances: probe tables, alias arrays and jitter exact (the jitter's
arithmetic is a few exactly rounded float32 operations in both packages);
probe samples: colors and chosen texels exact, directions and pdfs within
1e-6 relative; every file written by one package reads back bit for bit
through the other's reader; frames under the large-probe path: at least
99% of the pixels within 1 LSB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import obj_loader as jobj
from fovpathtracing_optixcodelatest_tpu.models import probe as jprobe
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import probe_sampling as jps
from fovpathtracing_optixcodelatest_tpu.ops import samplers as jsamplers
from fovpathtracing_optixcodelatest_tpu.render.renderer import Renderer as JRenderer
from fovpathtracing_optixcodelatest_tpu.utils import checkpoint as jckpt
from fovpathtracing_optixcodelatest_tpu.utils import exr as jexr
from fovpathtracing_optixcodelatest_tpu.utils import image as jimage
from fovpathtracing_optixcodelatest_tpu.utils import metrics as jmetrics
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import obj_loader as pobj
from fovpathtracing_optixcodelatest_tpu_torch.models import probe as pprobe
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    _device_probe,
    _probe_arrays,
    build_scene,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as pps
from fovpathtracing_optixcodelatest_tpu_torch.ops import samplers as psamplers
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.utils import checkpoint as pckpt
from fovpathtracing_optixcodelatest_tpu_torch.utils import exr as pexr
from fovpathtracing_optixcodelatest_tpu_torch.utils import image as pimage
from fovpathtracing_optixcodelatest_tpu_torch.utils import metrics as pmetrics

torch.set_num_threads(2)

SMALL_ROWS = 1000  # stands in for SAMPLE_ROWS_MAX_TEXELS in these tests


@pytest.fixture
def rowless(monkeypatch):
    """Both packages drop the sample rows above SMALL_ROWS texels, so small
    probes take the large-probe path."""
    assert jprobe.SAMPLE_ROWS_MAX_TEXELS == pprobe.SAMPLE_ROWS_MAX_TEXELS
    monkeypatch.setattr(jprobe, "SAMPLE_ROWS_MAX_TEXELS", SMALL_ROWS)
    monkeypatch.setattr(pprobe, "SAMPLE_ROWS_MAX_TEXELS", SMALL_ROWS)


def _probe_image(w=64, h=32, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 3)) ** 4 * 20.0
    img[3:5, 10:12] = 500.0  # a hot spot
    return img.astype(np.float32)


@pytest.mark.parametrize("prefilter", [False, True])
def test_large_probe_tables_and_samples(rowless, prefilter):
    img = _probe_image()
    jp = jprobe.build_cdf(img, prefilter=prefilter)
    pp = pprobe.build_cdf(img, prefilter=prefilter)
    assert jp.sample_rows is None and pp.sample_rows is None
    for f in ("data", "pdf_x", "cdf_x", "pdf_y", "cdf_y", "alias_prob",
              "alias_idx", "pdf_flat"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(pp, f)), f
    dev = _device_probe(_probe_arrays(pp), "cpu")
    assert dev.sample_rows is None and dev.alias_idx.dtype == torch.int64
    rng = np.random.default_rng(1)
    r1, r2 = (rng.random(50000).astype(np.float32) for _ in range(2))
    jd, jc, jpdf = (np.asarray(x) for x in jps.probe_sample(
        jp, jnp.asarray(r1), jnp.asarray(r2)))
    pd, pc, ppdf = (x.numpy() for x in pps.probe_sample(
        dev, torch.from_numpy(r1), torch.from_numpy(r2)))
    assert np.array_equal(pc, jc)  # the same texel, gathered
    assert np.allclose(ppdf, jpdf, rtol=1e-6, atol=0)
    assert np.abs(pd - jd).max() <= 1e-6
    # a probe at the limit keeps its rows
    assert pprobe.build_cdf(img[:25, :40]).sample_rows is not None


def test_render_under_rowless_probe_matches_jax(rowless):
    w, h = 32, 24
    probe_img = _probe_image(48, 24, seed=3)
    meshes, cam = jscenes.box_city(n=3, seed=1)
    jscene = j_build(meshes, probe=jprobe.build_cdf(probe_img))
    assert jscene.probe.sample_rows is None
    pmeshes, pcam = pscenes.box_city(n=3, seed=1)
    pscene = build_scene(pmeshes, pprobe.build_cdf(probe_img), device="cpu")
    assert pscene.probe.sample_rows is None
    sched = jconfig.FoveationSchedule.uniform(2)
    jr = JRenderer(scene=jscene, config=jconfig.RenderConfig(width=w, height=h),
                   schedule=sched)
    jr.set_camera(dataclasses.replace(cam, aspect=w / h))
    pr = Renderer(pscene, pconfig.RenderConfig(width=w, height=h),
                  pconfig.FoveationSchedule.uniform(2), device="cpu")
    pr.set_camera(dataclasses.replace(pcam, aspect=w / h))
    for _ in range(2):
        want, got = jr.render(), pr.render()
        d = np.abs(got.astype(int) - want.astype(int)).max(-1)
        assert (d <= 1).mean() >= 0.99
        assert pr.stats["traces"] == jr.stats["traces"]


@pytest.mark.parametrize("sampler", ["random", "stratified", "blue_noise"])
@pytest.mark.parametrize("spp", [1, 5, 16])
def test_aa_jitter_matches_jax(sampler, spp):
    key = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    n_pix = 300
    slots = np.tile(np.arange(spp, dtype=np.int32), n_pix)
    ids = (np.repeat(np.arange(n_pix, dtype=np.int32) * 7 + 3, spp) * 64
           + slots)
    want = np.asarray(jsamplers.aa_jitter(key, jnp.asarray(ids),
                                          jnp.asarray(slots), spp, sampler))
    got = psamplers.aa_jitter(np.asarray(key), torch.from_numpy(ids),
                              torch.from_numpy(slots), spp, sampler).numpy()
    assert np.array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all()


def test_blue_noise_point_sets_match_jax():
    for n in (1, 8, 32):
        assert np.array_equal(psamplers.best_candidate_points(n, seed=7),
                              jsamplers.best_candidate_points(n, seed=7))
        assert np.array_equal(psamplers.projective_blue_noise_points(n),
                              jsamplers.projective_blue_noise_points(n))


def test_png_ppm_pfm_round_trips(tmp_path):
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    flt = rng.uniform(-2, 40, (13, 21, 3)).astype(np.float32)
    for ext, writer, reader in (("png", "save_png", "load_png"),
                                ("ppm", "save_ppm", "load_ppm")):
        a, b = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
        getattr(pimage, writer)(str(a), u8)
        getattr(jimage, writer)(str(b), u8)
        for path in (a, b):
            want = getattr(jimage, reader)(str(path))
            assert np.array_equal(getattr(pimage, reader)(str(path)), want)
            assert np.array_equal(want, u8.astype(np.float32) / 255.0)
    a, b = tmp_path / "p.pfm", tmp_path / "j.pfm"
    pimage.save_pfm(str(a), flt)
    jimage.save_pfm(str(b), flt)
    assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(pimage.load_pfm(str(a)), flt)
    # save_image dispatches by extension like the JAX package's
    for ext in ("png", "pfm", "exr", "npz"):
        pimage.save_image(str(tmp_path / f"d.{ext}"), u8 if ext == "png"
                          else flt)
    assert np.array_equal(jimage.load_png(str(tmp_path / "d.png")),
                          u8.astype(np.float32) / 255.0)
    assert np.array_equal(jexr.read_exr(str(tmp_path / "d.exr"))[..., :3],
                          flt.astype(np.float16).astype(np.float32))
    assert np.array_equal(np.load(tmp_path / "d.npz")["frame"], flt)


def test_exr_round_trips(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 8, (19, 11, 4)).astype(np.float32)
    for half in (True, False):
        want = img.astype(np.float16).astype(np.float32) if half else img
        for writer, reader in ((pexr, jexr), (jexr, pexr)):
            path = str(tmp_path / f"{writer.__name__.split('.')[0]}.exr")
            writer.write_exr(path, img, half=half)
            assert np.array_equal(reader.read_exr(path), want)
            assert np.array_equal(writer.read_exr(path), want)


def _write_rgbe(path, rgbe, rle):
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):  # one literal run and one repeat run per channel
            half = w // 2
            out += bytes([half]) + rgbe[y, :half, c].tobytes()
            out += bytes([128 + (w - half), int(rgbe[y, half, c])])
    with open(path, "wb") as fh:
        fh.write(bytes(out))


@pytest.mark.parametrize("rle", [False, True])
def test_radiance_hdr_probe_matches_jax(tmp_path, rle):
    rng = np.random.default_rng(7)
    rgbe = rng.integers(1, 255, (6, 20, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (6, 20))
    if rle:
        rgbe[:, 10:] = rgbe[:, 10:11]
    path = str(tmp_path / "probe.hdr")
    _write_rgbe(path, rgbe, rle)
    want = jimage.load_hdr_probe(path)
    got = pimage.load_hdr_probe(path)
    assert got.shape == (6, 20, 3) and np.array_equal(got, want)
    assert np.array_equal(pprobe.build_cdf(got).sample_rows,
                          np.asarray(jprobe.build_cdf(want).sample_rows))


OBJ = """mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl tex
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl plain
f -5 -4 -1
"""

MTL = """newmtl tex
Kd 0.5 0.6 0.7
Ns 100
map_Kd checker.png
newmtl plain
Kd 0.2 0.3 0.4
Ke 1 0 0
d 0.5
"""


def test_obj_mtl_loader_matches_jax(tmp_path):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    tex = np.random.default_rng(8).integers(0, 256, (8, 6, 3), dtype=np.uint8)
    jimage.save_png(str(tmp_path / "checker.png"), tex)
    jm, jt = jobj.load_obj(str(tmp_path / "scene.obj"))
    pm, pt = pobj.load_obj(str(tmp_path / "scene.obj"))
    assert len(pm) == len(jm) == 2 and len(pt) == len(jt) == 1
    assert np.array_equal(pt[0], jt[0])
    assert np.array_equal(pt[0][0], tex[-1].astype(np.float32) / 255.0)
    for a, b in zip(jm, pm):
        for f in ("vertex", "index", "texcoord"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.normal is None) == (b.normal is None)
        assert a.diffuse_texture_id == b.diffuse_texture_id
        assert dataclasses.asdict(a.material) == dataclasses.asdict(b.material)
    assert pobj.load_texture(str(tmp_path / "missing.png")) is None
    scene = build_scene(pm, texture_images=pt, device="cpu")
    assert scene.has_textures and scene.num_triangles == 3


def test_checkpoint_round_trips(tmp_path):
    cam = Camera(eye=(1.0, 2.0, 3.0), lookat=(0.0, 0.5, 0.0), fov_y=35.0,
                 aspect=1.5)
    canvas = np.random.default_rng(9).random((20, 30, 3)).astype(np.float32)
    a, b = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    pckpt.save_checkpoint(a, torch.from_numpy(canvas), 7, cam, (4, 5))
    jckpt.save_checkpoint(b, canvas, 7, cam, (4, 5))
    for path in (a, b):
        j, p = jckpt.load_checkpoint(path), pckpt.load_checkpoint(path)
        assert np.array_equal(p["canvas"], j["canvas"])
        assert p["subframe"] == j["subframe"] == 7
        assert p["gaze"] == j["gaze"] == (4, 5)
        assert dataclasses.asdict(p["camera"]) == dataclasses.asdict(cam)
    # resume restores a renderer's canvas, subframe and camera
    scene = build_scene(pscenes.box_city(n=2)[0], device="cpu")
    r = Renderer(scene, pconfig.RenderConfig(width=16, height=12),
                 pconfig.FoveationSchedule.uniform(1), device="cpu")
    r.set_camera(cam)
    r.render()
    pckpt.checkpoint_renderer(r, a, camera=cam)
    r2 = Renderer(scene, pconfig.RenderConfig(width=16, height=12),
                  pconfig.FoveationSchedule.uniform(1), device="cpu")
    pckpt.resume_renderer(r2, a)
    assert r2.subframe == 1 and torch.equal(r2.canvas, r.canvas)
    assert torch.equal(r2.camera_params.u, r.camera_params.u)
    assert np.array_equal(r2.render(), r.render())
    r3 = Renderer(scene, pconfig.RenderConfig(width=8, height=8),
                  pconfig.FoveationSchedule.uniform(1), device="cpu")
    with pytest.raises(ValueError):
        pckpt.resume_renderer(r3, a)


def test_tsv_logger_matches_jax(tmp_path):
    assert pmetrics.TsvLogger.COLUMNS == jmetrics.TsvLogger.COLUMNS
    timers = pmetrics.FrameTimers()
    log = pmetrics.TsvLogger(str(tmp_path / "t.tsv"))
    for _ in range(3):
        timers.begin("render")
        timers.end("render")
        timers.frame_done()
        log.log(timers, gaze=(3, 4), subframe=timers.frame_count)
    log.close()
    rows = (tmp_path / "t.tsv").read_text().splitlines()
    assert rows[0].split("\t") == list(jmetrics.TsvLogger.COLUMNS)
    assert len(rows) == 4 and rows[-1].split("\t")[-3:] == ["3", "4", "3"]


def test_prng_key_matches_jax():
    assert np.array_equal(prng_key(999), np.asarray(jax.random.PRNGKey(999)))
