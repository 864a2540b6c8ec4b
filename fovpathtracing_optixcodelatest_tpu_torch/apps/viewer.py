"""Interactive browser viewer: live gaze-contingent rendering
(counterpart of the JAX package's ``apps/viewer.py``, after the
reference's interactive loop: the cursor is the gaze, a drag orbits the
trackball camera, the wheel zooms). The display is a built-in HTTP server
that binds loopback unless told otherwise:

- ``/``        an HTML page; its script forwards cursor moves (gaze), drags
               (orbit), the wheel (zoom) and keys (view, schedule);
- ``/stream``  MJPEG (multipart/x-mixed-replace) of the frames, one JPEG
               (Pillow) a frame;
- ``/input``   the input events, applied to the render loop's state;
- ``/stats``   JSON: fps, render ms, gaze, subframe, warm-up, view,
               schedule.

``serve`` runs the render loop in the calling thread: input, render,
JPEG, stats; an orbit or zoom restarts the accumulation
(``Renderer.set_camera``). With ``progressive=True`` the first frames come
from a 1/``warmup_scale`` resolution clone of the renderer while a
background thread renders the first full-resolution frame, which on the
card waits for the CUDA kernels' build at first use; the loop then swaps
to the full renderer. The background render never shares a ``Renderer``
with the loop, and the schedule is never swapped while it runs.

    python -m fovpathtracing_optixcodelatest_tpu_torch.apps.main --viewer \
        [--viewer-port 8000] --scene cornell --width 240 --height 136
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>fovPathTracing viewer</title><style>
 body { background:#111; color:#ddd; font-family:monospace; margin:1em }
 #view { image-rendering:pixelated; cursor:crosshair; border:1px solid #444 }
 #stats { margin-top:0.5em; white-space:pre }
</style></head><body>
<div>gaze follows the cursor &middot; drag = orbit &middot; wheel = zoom &middot;
 keys: <b>1</b> color <b>2</b> normal <b>3</b> albedo <b>4</b> denoised
 &middot; <b>s</b> cycle schedule</div>
<img id="view" src="/stream">
<div id="stats"></div>
<script>
const img = document.getElementById('view');
let drag = false, lx = 0, ly = 0, scale = () => img.width / %WIDTH%;
function send(q) { fetch('/input?' + q).catch(() => {}); }
img.onmousemove = (e) => {
  const r = img.getBoundingClientRect();
  const x = Math.round((e.clientX - r.left) / scale());
  const y = Math.round((e.clientY - r.top) / scale());
  if (drag) { send(`dx=${e.clientX - lx}&dy=${e.clientY - ly}`); }
  else { send(`gx=${x}&gy=${y}`); }
  lx = e.clientX; ly = e.clientY;
};
img.onmousedown = (e) => { drag = true; lx = e.clientX; ly = e.clientY;
                           e.preventDefault(); };
window.onmouseup = () => { drag = false; };
img.onwheel = (e) => { send('zoom=' + (e.deltaY > 0 ? 1 : -1));
                       e.preventDefault(); };
img.ondragstart = () => false;
window.onkeydown = (e) => {
  const views = {'1':'color','2':'normal','3':'albedo','4':'denoised'};
  if (views[e.key]) send('view=' + views[e.key]);
  if (e.key === 's') send('sched=next');
};
setInterval(async () => {
  try { const s = await (await fetch('/stats')).json();
        document.getElementById('stats').textContent =
          `fps: ${s.fps.toFixed(2)}  render: ${s.render_ms.toFixed(0)} ms  ` +
          `gaze: ${s.gaze[0]},${s.gaze[1]}  subframe: ${s.subframe}`;
  } catch (e) {}
}, 500);
</script></body></html>"""


class ViewerState:
    """Input/output shared between the HTTP threads and the render loop."""

    def __init__(self, width: int, height: int):
        self.lock = threading.Lock()
        self.gaze = (width // 2, height // 2)
        self.orbit_dx = 0.0
        self.orbit_dy = 0.0
        self.zoom_ticks = 0
        self.frame_jpeg: bytes | None = None
        self.frame_event = threading.Event()
        self.stats = {"fps": 0.0, "render_ms": 0.0, "gaze": self.gaze,
                      "subframe": 0}
        self.view = "color"  # color | normal | albedo | denoised
        self.sched_ticks = 0  # 'cycle schedule' requests (coalesced)
        self.running = True
        self.width = width
        self.height = height

    def take_input(self):
        with self.lock:
            dx, dy, z = self.orbit_dx, self.orbit_dy, self.zoom_ticks
            st = self.sched_ticks
            self.orbit_dx = self.orbit_dy = 0.0
            self.zoom_ticks = 0
            self.sched_ticks = 0
            return self.gaze, dx, dy, z, self.view, st

    def put_frame(self, rgb_u8: np.ndarray):
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb_u8).save(buf, "JPEG", quality=88)
        with self.lock:
            self.frame_jpeg = buf.getvalue()
        self.frame_event.set()
        self.frame_event.clear()


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silent server
            pass

        def do_GET(self):  # noqa: N802 (stdlib API)
            url = urlparse(self.path)
            if url.path == "/":
                body = _PAGE.replace("%WIDTH%", str(state.width)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/input":
                q = parse_qs(url.query)
                with state.lock:
                    if "gx" in q and "gy" in q:
                        gx = max(0, min(state.width - 1, int(q["gx"][0])))
                        gy = max(0, min(state.height - 1, int(q["gy"][0])))
                        # browser y is top-down; film is bottom-up (V-up)
                        state.gaze = (gx, state.height - 1 - gy)
                    if "dx" in q:
                        state.orbit_dx += float(q["dx"][0])
                    if "dy" in q:
                        state.orbit_dy += float(q["dy"][0])
                    if "zoom" in q:
                        state.zoom_ticks += int(q["zoom"][0])
                    if "view" in q and q["view"][0] in (
                        "color", "normal", "albedo", "denoised"
                    ):
                        state.view = q["view"][0]
                    if "sched" in q:
                        state.sched_ticks += 1
                self.send_response(204)
                self.end_headers()
            elif url.path == "/stats":
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                try:
                    while state.running:
                        state.frame_event.wait(timeout=2.0)
                        with state.lock:
                            jpeg = state.frame_jpeg
                        if jpeg is None:
                            continue
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def _view_frame(view: str, aovs, config) -> np.ndarray:
    """An AOV dict of (H, W, 3) tensors -> a displayable (H, W, 3) uint8
    image: normal [-1, 1] -> [0, 1]; albedo clamped; denoised: the a-trous
    filter over the accumulated radiance with the normal and albedo guides,
    then the frame's tone map."""
    if view == "normal":
        img = aovs["normal"].cpu().numpy() * 0.5 + 0.5
        return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if view == "albedo":
        img = aovs["albedo"].cpu().numpy()
        return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    from fovpathtracing_optixcodelatest_tpu_torch.ops import tonemap
    from fovpathtracing_optixcodelatest_tpu_torch.ops.denoise import (
        atrous_denoise,
    )

    clean = atrous_denoise(aovs["accum"], aovs["normal"], aovs["albedo"])
    u8 = tonemap.postprocess(
        clean, exposure_stops=config.exposure_stops, white=config.white,
        exposure_on=config.exposure_correction, tonemap_on=config.tone_mapping,
    )
    return u8.cpu().numpy()


def _warmup_renderer(renderer, scale: int):
    """A 1/``scale`` resolution clone of ``renderer`` sharing its scene and
    camera, with the schedule shrunk by ``FoveationSchedule.scaled``: the
    first frames while the full-resolution frame is on its way."""
    import dataclasses
    import math

    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    # round up to a multiple of the coarsest stride: a stride-f pass
    # launches floor(H / f) rows, and a remainder would stay unwritten
    f = max(p.factor for p in renderer.schedule.passes)
    cfg = dataclasses.replace(
        renderer.config,
        width=max(32, math.ceil(renderer.config.width / scale / f) * f),
        height=max(32, math.ceil(renderer.config.height / scale / f) * f),
    )
    low = Renderer(renderer.scene, config=cfg,
                   schedule=renderer.schedule.scaled(scale),
                   device=renderer.device)
    low.camera_params = renderer.camera_params
    return low


def serve(renderer, trackball, port: int = 8000, max_frames: int | None = None,
          host: str = "127.0.0.1", progressive: bool = False,
          warmup_scale: int = 4, stop_event: threading.Event | None = None,
          on_swap=None, schedules=None):
    """The interactive render loop; blocks until ``max_frames`` frames
    (tests), ``stop_event`` or ctrl-c, and returns the frames rendered.
    Binds loopback by default: the stream and the control endpoints are
    unauthenticated, so pass host="0.0.0.0" (``--viewer-host``) only on
    purpose. ``schedules`` are extra (name, FoveationSchedule) pairs that
    the 's' key cycles through after the renderer's own. ``progressive``:
    frames of a 1/``warmup_scale`` clone (``_warmup_renderer``) until a
    background thread's first full-resolution frame lands (on the card it
    also waits for the kernels' build at first use), then the full
    renderer; ``on_swap`` is called at the swap."""
    # 's' cycles through [the renderer's own schedule] + the extra pairs
    sched_names = ["initial"] + [n for n, _ in (schedules or [])]
    schedules = [renderer.schedule] + [s for _, s in (schedules or [])]
    sched_i = 0
    state = ViewerState(renderer.config.width, renderer.config.height)
    server = ThreadingHTTPServer((host, port), _make_handler(state))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"viewer: http://{host}:{server.server_address[1]}/  "
          "(ctrl-c to stop)")

    active = renderer
    scale = 1
    full_ready = threading.Event()
    first_full = None
    if progressive and min(renderer.config.width, renderer.config.height) >= (
        32 * warmup_scale
    ):
        active = _warmup_renderer(renderer, warmup_scale)
        scale = warmup_scale

        def _first_full():
            # one throwaway full-res frame: the kernels' build at first use
            # and the first frame, while the loop renders the clone
            try:
                renderer.render()
            finally:
                full_ready.set()

        first_full = threading.Thread(target=_first_full, daemon=True)
        first_full.start()
    else:
        full_ready.set()

    frames = 0
    t_fps = time.perf_counter()
    try:
        while state.running and (max_frames is None or frames < max_frames):
            if stop_event is not None and stop_event.is_set():
                break
            if scale > 1 and full_ready.is_set():
                renderer.camera_params = active.camera_params
                renderer.subframe = 0  # fresh accumulation at full res
                active, scale = renderer, 1
                if on_swap is not None:
                    on_swap()
            gaze, dx, dy, zoom, view, sched_ticks = state.take_input()
            if sched_ticks and len(schedules) > 1:
                if scale > 1 or not full_ready.is_set():
                    # deferred during the warm-up: the background thread
                    # may be inside renderer.render(), and set_schedule
                    # would race on its canvas (the clone's size was also
                    # rounded for the first schedule's stride only)
                    with state.lock:
                        state.sched_ticks += sched_ticks
                else:
                    sched_i = (sched_i + sched_ticks) % len(schedules)
                    renderer.set_schedule(schedules[sched_i])
                    print(f"viewer: schedule -> {sched_names[sched_i]}")
            if dx or dy:
                active.set_camera(trackball.orbit(dx, dy))
            for _ in range(abs(zoom)):
                active.set_camera(trackball.zoom(1 if zoom > 0 else -1))
            t0 = time.perf_counter()
            g = (gaze[0] // scale, gaze[1] // scale) if scale > 1 else gaze
            if view == "color":
                frame = active.render(gaze=g)
            else:  # the AOV views: the denoiser's guides and its output
                frame, aovs = active.render_aov(gaze=g)
                frame = _view_frame(view, aovs, active.config)
            if getattr(active, "demand_loader", None) is not None:
                active.process_demand_requests()
            render_ms = (time.perf_counter() - t0) * 1e3
            if scale > 1:  # nearest-neighbor upscale to the display canvas
                frame = np.repeat(np.repeat(frame, scale, 0), scale, 1)
                py = max(0, state.height - frame.shape[0])
                px = max(0, state.width - frame.shape[1])
                if py or px:
                    frame = np.pad(frame, ((0, py), (0, px), (0, 0)), "edge")
                frame = frame[: state.height, : state.width]
            state.put_frame(frame[::-1])  # row 0 is the bottom (V up): flip
            frames += 1
            dt = time.perf_counter() - t_fps
            with state.lock:
                state.stats = {
                    "fps": frames / dt if dt > 0 else 0.0,
                    "render_ms": render_ms,
                    "gaze": list(gaze),
                    "subframe": active.subframe,
                    "warmup": scale > 1,
                    "view": view,
                    "schedule": sched_names[sched_i],
                }
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
        server.shutdown()
        server.server_close()
        t.join(timeout=10.0)
        if first_full is not None:  # the renderer is the caller's again
            first_full.join(timeout=600.0)
    return frames
