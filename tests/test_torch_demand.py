"""The PyTorch port's demand-loaded textures (``models/demand.py``) against
the JAX package's on the CPU: the seven checks of ``tests/test_demand.py``,
with the port's context arrays, ``demand_tex2d`` samples, request bitmaps
and loader state held equal to JAX's for the same images and uv, and the
rendered frames (the Renderer's and the CLI's) within 1 LSB on at least 99%
of the pixels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu.models import demand as jdemand
from fovpathtracing_optixcodelatest_tpu_torch.models import demand
from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
    TILE,
    DemandLoader,
    demand_tex2d,
    page_requests,
)

torch.set_num_threads(2)


def _checker_image(w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx / w).astype(np.float32), (yy / h).astype(np.float32),
                     ((xx // TILE + yy // TILE) % 2).astype(np.float32)],
                    axis=-1)


def _pair(max_pages):
    return (DemandLoader(max_pages=max_pages, device="cpu"),
            jdemand.DemandLoader(max_pages=max_pages))


def _same_context(ctx, jctx):
    for f in ("atlas", "page_table", "tile_mean", "tex_meta"):
        assert np.array_equal(getattr(ctx, f).numpy(),
                              np.asarray(getattr(jctx, f))), f


def _sample_both(ctx, jctx, t, u, v):
    """demand_tex2d in both packages (bit-equal) -> the port's tensors."""
    got = demand_tex2d(ctx, torch.from_numpy(t), torch.from_numpy(u),
                       torch.from_numpy(v))
    ref = jdemand.demand_tex2d(jctx, jnp.asarray(t), jnp.asarray(u),
                               jnp.asarray(v))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    return got


def _requests_both(loader, pages, res):
    req = page_requests(loader.total_pages, pages, res)
    jreq = jdemand.page_requests(loader.total_pages, jnp.asarray(pages.numpy()),
                                 jnp.asarray(res.numpy()))
    assert np.array_equal(req.numpy(), np.asarray(jreq))
    return req


def test_demand_cycle_fallback_then_exact():
    img = _checker_image(256, 192)  # 4x3 = 12 tiles
    loader, jloader = _pair(32)
    tid = loader.create_texture(img)
    assert jloader.create_texture(img) == tid
    ctx, jctx = loader.launch_prepare(), jloader.launch_prepare()
    _same_context(ctx, jctx)

    rng = np.random.default_rng(0)
    u = rng.random(4096, dtype=np.float32)
    v = rng.random(4096, dtype=np.float32)
    t = np.full((4096,), tid, np.int32)
    rgb1, res1, pages = _sample_both(ctx, jctx, t, u, v)
    assert not res1.any()  # nothing resident yet
    tx = np.minimum((u * 256).astype(int), 255)
    ty = np.minimum((v * 192).astype(int), 191)
    exact = img[ty, tx]
    assert np.abs(rgb1.numpy() - exact).max() > 1e-4  # means, not texels
    assert np.abs(rgb1.numpy()[:, 0] - exact[:, 0]).max() < 0.2

    req = _requests_both(loader, pages, res1)
    ticket = loader.process_requests(req)
    assert ticket.num_tasks_total() == int(req.sum())
    assert ticket.wait(timeout=60) and ticket.num_tasks_remaining() == 0
    jloader.process_requests(np.asarray(req.numpy())).wait(timeout=60)
    ctx2, jctx2 = loader.launch_prepare(), jloader.launch_prepare()
    # slots are handed out in page order before the fills start
    _same_context(ctx2, jctx2)
    rgb2, res2, _ = demand_tex2d(ctx2, torch.from_numpy(t),
                                 torch.from_numpy(u), torch.from_numpy(v))
    jrgb2, _, _ = jdemand.demand_tex2d(jctx2, jnp.asarray(t), jnp.asarray(u),
                                       jnp.asarray(v))
    assert bool(res2.all())
    assert np.array_equal(rgb2.numpy(), np.asarray(jrgb2))
    np.testing.assert_allclose(rgb2.numpy(), exact, rtol=0, atol=1e-6)
    assert loader.num_tiles_loaded == jloader.num_tiles_loaded == int(req.sum())


def test_demand_lru_eviction_bounded_atlas():
    img = _checker_image(512, 512)  # 8x8 = 64 tiles
    loader, jloader = _pair(8)  # the atlas holds 8 of 64
    tid = loader.create_texture(img)
    jloader.create_texture(img)
    assert loader.total_pages == 64
    u = ((np.arange(8) + 0.5) / 8.0).astype(np.float32)
    t = np.full((8,), tid, np.int32)
    for row in range(4):  # each row requests 8 fresh tiles
        ctx, jctx = loader.launch_prepare(), jloader.launch_prepare()
        v = np.full((8,), (row + 0.5) / 8.0, np.float32)
        _, res, pages = demand_tex2d(ctx, torch.from_numpy(t),
                                     torch.from_numpy(u), torch.from_numpy(v))
        _, jres, jpages = jdemand.demand_tex2d(
            jctx, jnp.asarray(t), jnp.asarray(u), jnp.asarray(v))
        assert np.array_equal(res.numpy(), np.asarray(jres))
        assert np.array_equal(pages.numpy(), np.asarray(jpages))
        loader.touch(pages[res])
        jloader.touch(np.asarray(jpages)[np.asarray(jres)])
        req = _requests_both(loader, pages, res)
        loader.process_requests(req).wait(timeout=60)
        jloader.process_requests(req.numpy()).wait(timeout=60)
    # the atlas stayed bounded; later rows evicted earlier rows
    assert loader.resident_pages <= 8
    assert loader.num_tiles_evicted == jloader.num_tiles_evicted >= 16
    assert np.array_equal(loader.page_table >= 0,
                          np.asarray(jloader._page_table) >= 0)
    # the most recent row is resident and exact
    ctx = loader.launch_prepare()
    v = np.full((8,), 3.5 / 8.0, np.float32)
    rgb, res, _ = demand_tex2d(ctx, torch.from_numpy(t), torch.from_numpy(u),
                               torch.from_numpy(v))
    assert bool(res.all())
    tx = np.minimum((u * 512).astype(int), 511)
    ty = np.minimum((v * 512).astype(int), 511)
    np.testing.assert_allclose(rgb.numpy(), img[ty, tx], atol=1e-6)


def test_demand_multi_texture_page_bases():
    a = _checker_image(128, 64)  # 2x1 = 2 tiles
    b = _checker_image(64, 128)  # 1x2 = 2 tiles
    loader, jloader = _pair(8)
    ta, tb = loader.create_texture(a), loader.create_texture(b)
    jloader.create_texture(a)
    jloader.create_texture(b)
    ctx, jctx = loader.launch_prepare(), jloader.launch_prepare()
    _same_context(ctx, jctx)
    t = np.asarray([ta, ta, tb, tb], np.int32)
    u = np.asarray([0.1, 0.9, 0.5, 0.5], np.float32)
    v = np.asarray([0.5, 0.5, 0.1, 0.9], np.float32)
    _, res, pages = _sample_both(ctx, jctx, t, u, v)
    req = _requests_both(loader, pages, res)
    assert int(req.sum()) == 4  # all four distinct tiles
    loader.process_requests(req).wait(timeout=60)
    rgb, res, _ = demand_tex2d(loader.launch_prepare(), torch.from_numpy(t),
                               torch.from_numpy(u), torch.from_numpy(v))
    assert bool(res.all())
    for i, (img, uu, vv) in enumerate(
            [(a, 0.1, 0.5), (a, 0.9, 0.5), (b, 0.5, 0.1), (b, 0.5, 0.9)]):
        h, w = img.shape[:2]
        px = img[min(int(vv * h), h - 1), min(int(uu * w), w - 1)]
        np.testing.assert_allclose(rgb.numpy()[i], px, atol=1e-6)


def test_ticket_before_processing():
    t = demand.Ticket()
    assert t.num_tasks_total() == -1  # -1 before processing
    assert t.num_tasks_remaining() == -1
    t._start(0)
    assert t.wait(timeout=1) and t.num_tasks_total() == 0


def test_demand_udim_texture():
    imgs = [np.full((64, 64, 3), c, np.float32)
            for c in (0.1, 0.3, 0.5, 0.7)]  # one tile each
    loader, jloader = _pair(8)
    gid = loader.create_udim_texture(imgs, udim=2, vdim=2)
    assert jloader.create_udim_texture(imgs, udim=2, vdim=2) == gid
    ctx, jctx = loader.launch_prepare(), jloader.launch_prepare()
    _same_context(ctx, jctx)
    t = np.full((4,), gid, np.int32)
    u = np.asarray([0.25, 0.75, 0.25, 0.75], np.float32)
    v = np.asarray([0.25, 0.25, 0.75, 0.75], np.float32)
    rgb, res, pages = _sample_both(ctx, jctx, t, u, v)
    assert not res.any()
    np.testing.assert_allclose(rgb.numpy()[:, 0], [0.1, 0.3, 0.5, 0.7],
                               atol=1e-3)
    loader.process_requests(
        _requests_both(loader, pages, res)).wait(timeout=60)
    rgb2, res2, _ = demand_tex2d(loader.launch_prepare(), torch.from_numpy(t),
                                 torch.from_numpy(u), torch.from_numpy(v))
    assert bool(res2.all())
    np.testing.assert_allclose(rgb2.numpy()[:, 0], [0.1, 0.3, 0.5, 0.7],
                               atol=1e-6)
    assert loader.num_tiles_loaded == 4


def _wall():
    return _checker_image(128, 128)  # 2x2 tiles


def test_demand_textures_in_render_loop():
    """A textured quad through ``Renderer`` with a ``DemandLoader`` in both
    packages: frame 1 falls back to tile means and requests its pages,
    frame 2 samples them and requests none; the frames and request counts
    agree with JAX's."""
    from fovpathtracing_optixcodelatest_tpu.config import (
        FoveationSchedule as JFS,
    )
    from fovpathtracing_optixcodelatest_tpu.config import (
        RenderConfig as JRenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu.models.camera import (
        Camera as JCamera,
    )
    from fovpathtracing_optixcodelatest_tpu.models.material import (
        Material as JMaterial,
    )
    from fovpathtracing_optixcodelatest_tpu.models.mesh import (
        make_quad as j_make_quad,
    )
    from fovpathtracing_optixcodelatest_tpu.models.scene import (
        build_scene as j_build,
    )
    from fovpathtracing_optixcodelatest_tpu.render.renderer import (
        Renderer as JRenderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_quad
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    corners = ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0))
    loader, jloader = _pair(8)
    assert loader.create_texture(_wall()) == jloader.create_texture(_wall())
    wall = make_quad(*corners, Material(color=(1.0, 1.0, 1.0)), texture_id=0)
    r = Renderer(build_scene([wall], device="cpu",
                             demand=loader.launch_prepare()),
                 RenderConfig(width=32, height=24, max_depth=2),
                 FoveationSchedule.uniform(2), device="cpu",
                 demand_loader=loader)
    jwall = j_make_quad(*corners, JMaterial(color=(1.0, 1.0, 1.0)),
                        texture_id=0)
    jr = JRenderer(scene=j_build([jwall]),
                   config=JRenderConfig(width=32, height=24, max_depth=2),
                   schedule=JFS.uniform(2), demand_loader=jloader)
    cam = dict(eye=(0, 0, 6), lookat=(0, 0, 0), fov_y=45.0, aspect=32 / 24)
    r.set_camera(Camera(**cam))
    jr.set_camera(JCamera(**cam))
    assert r.scene.demand is not None

    frames = []
    for step in range(2):
        f, jf = r.render(), jr.render()
        assert np.array_equal(r._stats["demand_requests"].numpy(),
                              np.asarray(jr._stats["demand_requests"]))
        n_req, jn_req = r.process_demand_requests(), jr.process_demand_requests()
        assert n_req == jn_req
        if step == 0:
            assert n_req > 0 and loader.num_tiles_loaded == n_req
        else:
            assert n_req == 0  # everything the camera sees is resident
        close = (np.abs(f.astype(int) - jf.astype(int)).max(-1) <= 1).mean()
        assert close >= 0.99, close
        frames.append(f)
    assert frames[1].shape == (24, 32, 3) and frames[1].max() > 0
    assert r.stats["traces"] == jr.stats["traces"]


def test_demand_textures_cli(tmp_path):
    """``--demand-textures`` routes an OBJ's textures through the loader:
    the run pages tiles in after frame 1, renders, and writes the frame the
    JAX CLI writes (99% of the pixels within 1 LSB)."""
    from fovpathtracing_optixcodelatest_tpu.apps.main import main as jmain
    from fovpathtracing_optixcodelatest_tpu.utils.image import (
        load_png,
        save_png,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.apps.main import main

    tex = np.zeros((8, 8, 3), dtype=np.float32)
    tex[::2, ::2] = 1.0
    save_png(str(tmp_path / "checker.png"), tex)
    (tmp_path / "scene.mtl").write_text(
        "newmtl ground\nKd 1 1 1\nmap_Kd checker.png\n")
    obj = ["mtllib scene.mtl"]
    for p in [(-5, 0, 5), (5, 0, 5), (5, 0, -5), (-5, 0, -5)]:
        obj.append(f"v {p[0]} {p[1]} {p[2]}")
    obj += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
            "usemtl ground", "f 1/1 2/2 3/3 4/4"]
    (tmp_path / "scene.obj").write_text("\n".join(obj))
    args = ["--obj", str(tmp_path / "scene.obj"), "--width", "32",
            "--height", "24", "--frames", "2", "--schedule", "uniform:1",
            "--demand-textures", "--demand-pages", "4"]
    out, jout = tmp_path / "render.png", tmp_path / "jax.png"
    assert main(args + ["--device", "cpu", "--out", str(out)]) == 0
    assert jmain(args + ["--out", str(jout)]) == 0
    img, jimg = load_png(str(out)), load_png(str(jout))
    assert img.shape == (24, 32, 3) and img.max() > 0.05
    close = (np.abs(img - jimg).max(-1) <= 1.0 / 255 + 1e-6).mean()
    assert close >= 0.99, close


def test_scene_memory_report_parts():
    # the demand scene's report leaves the context out, as JAX's does
    loader = DemandLoader(max_pages=4, device="cpu")
    loader.create_texture(_wall())
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_quad
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )

    scene = build_scene([make_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0),
                                   (-1, 1, 0), Material(), texture_id=0)],
                        device="cpu", demand=loader.launch_prepare())
    parts = scene.memory_bytes()
    assert parts["textures"] == 0 and parts["geom.tri_pack"] == 2 * 48 * 4
    assert "frame state" in scene.memory_report(n_rays=100)
    assert dataclasses.replace(scene, demand=None).memory_bytes() == parts
