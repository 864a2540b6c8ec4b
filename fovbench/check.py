"""What decides ``correct``: chosen pixels of chosen frames that the timed
loop displayed, against the reference's.

A frame's pixel is the tone-mapped value of the film canvas, which every
frame composites pass by pass: the periphery (stride 4, accumulating: the
new value lerped against the pixel's history by 1 / (subframe + 1)), then
the annulus and the fovea (redrawn), each over its launch pixels inside its
ring around that frame's gaze. So a pixel that a redrawn pass wrote last
needs the reference's value of that pass's launch pixel in that frame
alone, and any other pixel its history back to the frame where a redrawn
pass wrote it, or to subframe 0: ``history`` walks it and ``canvas``
replays it in the reference's precision.

The sample is drawn from the seed: the last displayed frame and
``frames - 1`` others of the run, kept as they come by ``Reservoir`` (so a
run holds a few frames, not all it displayed); once the window has closed,
in each of them, for each eye, pixels that each redrawn pass (the annulus,
the fovea) wrote last, and ``history`` pixels (drawn once, from those that
no redrawn pass wrote in the last frame) followed through every frame of
the sample; ``redraw`` gives the count of each redrawn pass, in schedule
order.
"""

from __future__ import annotations

import numpy as np
import torch

from fovbench.reference.render import frame_keys


def launch_dims(p: dict, width: int, height: int):
    lw = p["launch_w"] if p["launch_w"] is not None else width // p["factor"]
    lh = p["launch_h"] if p["launch_h"] is not None else height // p["factor"]
    return lw, lh


def cover(p: dict, xs, ys, gx: int, gy: int, width: int, height: int):
    """Whether pass ``p`` writes frame pixels (xs, ys) with the gaze at
    (gx, gy), and the frame pixel of the launch pixel that writes each."""
    f = p["factor"]
    ox, oy = (gx - p["center_offset"], gy - p["center_offset"]) \
        if p["centered"] else (0, 0)
    lx, ly = np.floor_divide(xs - ox, f), np.floor_divide(ys - oy, f)
    lw, lh = launch_dims(p, width, height)
    idx_x, idx_y = lx * f + ox, ly * f + oy
    dx = idx_x.astype(np.float32) - np.float32(gx)
    dy = idx_y.astype(np.float32) - np.float32(gy)
    dist = np.sqrt(dx * dx + dy * dy)
    ring = (dist >= np.float32(p["r_inner"])) & (dist <= np.float32(p["r_outer"]))
    inside = (lx >= 0) & (lx < lw) & (ly >= 0) & (ly < lh)
    return ring & inside, idx_x, idx_y


def writer(passes, xs, ys, gaze, width: int, height: int):
    """The pass that wrote each pixel last in a frame (-1: none), and the
    frame pixel of its launch pixel."""
    who = np.full(np.shape(xs), -1, dtype=np.int64)
    lx = np.zeros(np.shape(xs), dtype=np.int64)
    ly = np.zeros(np.shape(xs), dtype=np.int64)
    for i, p in enumerate(passes):  # inner passes composite later
        c, ix, iy = cover(p, xs, ys, gaze[0], gaze[1], width, height)
        who = np.where(c, i, who)
        lx, ly = np.where(c, ix, lx), np.where(c, iy, ly)
    return who, lx, ly


class Reservoir:
    """The last displayed frame and ``k`` of the earlier ones, drawn
    uniformly from the seed as the frames come (reservoir sampling)."""

    def __init__(self, seed: int, k: int):
        self._rs = np.random.default_rng([int(seed), 0xF4A3E])
        self.k = k
        self.slots = []  # (subframe, frame)
        self.seen = 0
        self.last = None

    def add(self, subframe: int, frame=None) -> None:
        if self.last is not None:
            if len(self.slots) < self.k:
                self.slots.append(self.last)
            else:
                j = int(self._rs.integers(0, self.seen + 1))
                if j < self.k:
                    self.slots[j] = self.last
            self.seen += 1
        self.last = (subframe, frame)

    def frames(self) -> dict:
        """Subframe -> frame of the sample, the last included."""
        return dict(self.slots + [self.last])


def sample_frames(seed: int, first: int, last: int, k: int) -> list:
    """The subframes a run whose displayed frames are ``first`` to ``last``
    keeps, as its ``Reservoir`` keeps them."""
    res = Reservoir(seed, k)
    for s in range(first, last + 1):
        res.add(s)
    return sorted(res.frames())


def draw(cfg: dict, traffic, seed: int, frames, sample: dict) -> list:
    """The checks, drawn from the seed: (eye, subframe, x, y) in the
    sampled subframes ``frames``, the last of them the run's last."""
    rs = np.random.default_rng([int(seed), 0xC4EC])
    w, h, passes = cfg["width"], cfg["height"], cfg["schedule"]["passes"]
    frames = sorted(frames)
    last = frames[-1]
    ys, xs = np.mgrid[0:h, 0:w]
    xs, ys = xs.ravel(), ys.ravel()
    redraw = [i for i, p in enumerate(passes) if p["redraw"]]
    checks = []
    for eye in range(traffic.eyes):
        who_last, _, _ = writer(passes, xs, ys, traffic.gaze(last), w, h)
        pool = np.nonzero(~np.isin(who_last, redraw))[0]
        hist = rs.choice(pool, size=min(len(pool), sample["history"]),
                         replace=False)
        for s in frames:
            who, _, _ = writer(passes, xs, ys, traffic.gaze(s), w, h)
            for i, n in zip(redraw, sample["redraw"]):
                cand = np.nonzero(who == i)[0]
                pick = rs.choice(cand, size=min(len(cand), n), replace=False)
                checks += [(eye, s, int(xs[j]), int(ys[j])) for j in pick]
            checks += [(eye, s, int(xs[j]), int(ys[j])) for j in hist]
    return checks


def history(passes, traffic, eye: int, s: int, x: int, y: int, w: int,
            h: int):
    """The frames a pixel's value at subframe ``s`` depends on, oldest
    first: (subframe, pass or -1, launch x, launch y)."""
    redraw = [p["redraw"] for p in passes]
    steps = []
    t = s
    while t >= 0:
        who, lx, ly = writer(passes, np.array([x]), np.array([y]),
                             traffic.gaze(t), w, h)
        steps.append((t, int(who[0]), int(lx[0]), int(ly[0])))
        if who[0] >= 0 and (redraw[who[0]] or t == 0):
            break
        t -= 1
    return steps[::-1]


def reference_pixels(ref, cfg: dict, traffic, seed: int, checks) -> np.ndarray:
    """The reference's uint8 (n, 3) values of the checks."""
    w, h, passes = cfg["width"], cfg["height"], cfg["schedule"]["passes"]
    hists = [history(passes, traffic, e, s, x, y, w, h)
             for e, s, x, y in checks]
    items = sorted({(p, e, t, lx, ly)
                    for (e, _, _, _), hs in zip(checks, hists)
                    for t, p, lx, ly in hs if p >= 0})
    depth = cfg["max_depth"]
    keys = {}
    for p, e, t, _, _ in items:
        if (e, t) not in keys:
            keys[e, t] = frame_keys(traffic.display, seed, t, e, depth)
    arr = np.asarray([(e, p, lx, ly) for p, e, t, lx, ly in items],
                     dtype=np.int64).reshape(-1, 4)
    jk = np.asarray([keys[e, t][0] for _, e, t, _, _ in items],
                    dtype=np.int64).reshape(-1, 2)
    bk = np.asarray([keys[e, t][1] for _, e, t, _, _ in items],
                    dtype=np.int64).reshape(-1, depth, 2)
    vals = ref.item_values(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], jk, bk)
    vals = vals.cpu()
    where = {it: i for i, it in enumerate(items)}
    canv = torch.zeros((len(checks), 3), dtype=ref.dt)
    acc = cfg["render"]["accumulate"]
    for c, ((e, _, _, _), hs) in enumerate(zip(checks, hists)):
        v = torch.zeros((3,), dtype=ref.dt)
        for t, p, lx, ly in hs:
            if p < 0:
                continue
            new = vals[where[p, e, t, lx, ly]]
            if passes[p]["redraw"] or t == 0 or not acc:
                v = new
            else:
                a = float(np.float32(1.0) / np.float32(t + 1.0))
                v = v + (new - v) * a
        canv[c] = v
    r = cfg["render"]
    # tone-mapped on the reference's device, as the program maps its canvas
    return tonemap(canv.to(ref.dev), r["exposure_stops"],
                   r["white"]).cpu().numpy()


def tonemap(c: torch.Tensor, stops: float, white: float) -> torch.Tensor:
    """Exposure, Reinhard on Rec.709 luminance, sRGB, uint8."""
    c = c * (2.0 ** stops)
    lum = 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]
    c = c / (1.0 + lum / white)[..., None]
    c = torch.clamp(c, 0.0, 1.0)
    c = torch.clamp(c, 0.0, 1.0)
    powed = torch.pow(torch.clamp(c, min=1e-10), 1.0 / 2.4)
    c = torch.where(c < 0.0031308, 12.92 * c, 1.055 * powed - 0.055)
    c = torch.clamp(c, 0.0, 1.0)
    return torch.clamp((c * 256.0).to(torch.int64), max=255).to(torch.uint8)


def compare(program: np.ndarray, reference: np.ndarray) -> dict:
    """The numbers compared: the share of checked pixels with a channel
    more than 1 LSB off, and the mean channel difference in LSB."""
    diff = np.abs(program.astype(np.int64) - reference.astype(np.int64))
    return {"px_over_1lsb": float((diff.max(axis=1) > 1).mean()),
            "mean_abs_lsb": float(diff.mean())}
