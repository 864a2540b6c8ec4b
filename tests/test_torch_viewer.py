"""The port's browser viewer (``apps/viewer.py``) on the CPU: the JAX
package's four viewer tests, each on a free port, every wait and join
bounded: serving, streaming and input (gaze, orbit, zoom, an AOV view),
input coalescing, the progressive start's swap to full resolution, and
schedule cycling."""

import dataclasses
import io
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import torch
from PIL import Image

from fovpathtracing_optixcodelatest_tpu_torch.apps import viewer as viewer_mod
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationPass,
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Trackball
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

WAIT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=30):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def _get_when_up(port, path):
    """The first request: the serve thread needs a beat to bind."""
    deadline = time.time() + WAIT_S
    while True:
        try:
            return _get(port, path)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def _renderer(w=48, h=36):
    meshes, cam = scenes.cornell(sphere_subdiv=0)
    scene = build_scene(meshes, device="cpu")
    schedule = FoveationSchedule(passes=(
        FoveationPass(factor=2, spp=1, r_inner=0.0, r_outer=1e9,
                      redraw=False),
    ))
    cam = dataclasses.replace(cam, aspect=w / h)
    r = Renderer(scene, RenderConfig(width=w, height=h, max_depth=2),
                 schedule, seed=0, device="cpu")
    r.set_camera(cam)
    tb = Trackball(camera=cam)
    tb.reinitialize_from_camera()
    return r, cam, tb


def _serve(**kw):
    got = {}
    t = threading.Thread(target=lambda: got.update(
        frames=viewer_mod.serve(**kw)))
    t.start()
    return t, got


def test_viewer_serves_streams_and_applies_input():
    renderer, cam, tb = _renderer()
    eye0 = np.asarray(cam.eye, np.float64)
    port = free_port()
    t, got = _serve(renderer=renderer, trackball=tb, port=port,
                    max_frames=25)
    try:
        assert b"/stream" in _get_when_up(port, "/").read()
        for q in ("gx=5&gy=7", "dx=40&dy=10", "zoom=1", "view=normal"):
            assert _get(port, f"/input?{q}").status == 204
        saw_normal, deadline = False, time.time() + WAIT_S
        while time.time() < deadline and t.is_alive():
            s = json.loads(_get(port, "/stats").read())
            if s.get("view") == "normal":
                saw_normal = True
                break
            time.sleep(0.2)
        assert saw_normal, "the AOV view never rendered"
        assert s["gaze"] == [5, 36 - 1 - 7]  # y flipped to film rows
        stream = _get(port, "/stream", timeout=60)
        data = b""
        while data.count(b"\xff\xd9") < 1:  # one whole JPEG
            chunk = stream.read(4096)
            if not chunk:
                break
            data += chunk
        stream.close()
        jpeg = data[data.index(b"\xff\xd8"):data.index(b"\xff\xd9") + 2]
        assert Image.open(io.BytesIO(jpeg)).size == (48, 36)
    finally:
        t.join(timeout=WAIT_S)
    assert not t.is_alive() and got["frames"] == 25
    # the drag orbited the camera (and set_camera restarted the canvas)
    assert not np.allclose(np.asarray(tb.camera.eye), eye0)
    assert renderer.config.resolution == (48, 36)


def test_viewer_state_input_coalescing():
    st = viewer_mod.ViewerState(64, 48)
    with st.lock:
        st.orbit_dx += 3
        st.orbit_dy += 4
        st.zoom_ticks += 2
        st.gaze = (10, 12)
    gaze, dx, dy, z, view, sticks = st.take_input()
    assert gaze == (10, 12) and (dx, dy, z) == (3, 4, 2) and view == "color"
    assert sticks == 0
    _, dx, dy, z, _, _ = st.take_input()
    assert (dx, dy, z) == (0.0, 0.0, 0)


def test_viewer_progressive_startup_swaps_to_full_res():
    w, h = 96, 72
    r, _, tb = _renderer(w, h)
    swapped, stop = threading.Event(), threading.Event()
    t, got = _serve(renderer=r, trackball=tb, port=free_port(),
                    max_frames=2000, progressive=True, warmup_scale=2,
                    stop_event=stop, on_swap=swapped.set)
    try:
        assert swapped.wait(timeout=WAIT_S), "never swapped to full res"
        deadline = time.time() + WAIT_S
        while r.subframe < 1 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=WAIT_S)
    assert not t.is_alive() and got["frames"] >= 1
    # frames after the swap came from the full renderer at full size
    assert r.subframe >= 1
    assert r.last_frame is not None and r.last_frame.shape[:2] == (h, w)


def test_viewer_schedule_cycle():
    renderer, _, tb = _renderer()
    alt = FoveationSchedule.uniform(1)
    port = free_port()
    t, _ = _serve(renderer=renderer, trackball=tb, port=port, max_frames=40,
                  schedules=[("uniform:1", alt)])
    try:
        _get_when_up(port, "/input?sched=next")
        swapped, deadline = False, time.time() + WAIT_S
        while time.time() < deadline and t.is_alive():
            s = json.loads(_get(port, "/stats").read())
            if s.get("schedule") == "uniform:1":
                swapped = True
                break
            time.sleep(0.2)
        assert swapped, "the schedule never switched"
    finally:
        t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert renderer.schedule == alt
