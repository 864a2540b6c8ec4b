"""The reference renderer: from the generated meshes, texture images and
probe image, the value that one foveation pass gives one launch pixel in
one frame (its ``spp`` paths traced to ``max_depth`` with probe NEE and MIS
and Disney BSDF sampling, then the film's backplate blend), for a batch of
such items of any frames, eyes and passes at once. The frame's canvas and
tone map are in ``fovbench/check.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fovbench.reference import rng, shading as sh
from fovbench.reference.bvh import RefBVH

RNG_STRIDE = 64  # ray id = frame pixel * RNG_STRIDE + sample slot
OFF_BAND = 512  # the id band of launch pixels off the frame


def camera_frame(eye, lookat, up, fov_y: float, aspect: float):
    """The pinhole's (eye, U, V, W) as float32: W = lookat - eye, U along
    W x up scaled to |V| aspect, V along U x W scaled to |W| tan(fov/2)."""
    eye64 = np.asarray(eye, dtype=np.float64)
    w = np.asarray(lookat, dtype=np.float64) - eye64
    wlen = np.linalg.norm(w)
    u = np.cross(w, np.asarray(up, dtype=np.float64))
    u /= np.linalg.norm(u)
    v = np.cross(u, w)
    v /= np.linalg.norm(v)
    vlen = wlen * math.tan(0.5 * math.radians(fov_y))
    v = v * vlen
    u = u * (vlen * aspect)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return f32(eye), f32(u), f32(v), f32(w)


def eye_cameras(position, forward, up, ipd: float, fov_y: float,
                aspect: float, focus_distance: float = 10.0):
    """Left and right eyes: +-ipd/2 along the view's right axis, both aimed
    at the point ``focus_distance`` ahead -> two (eye, lookat, up) tuples."""
    p = np.asarray(position, dtype=np.float64)
    f = np.asarray(forward, dtype=np.float64)
    f = f / np.linalg.norm(f)
    u = np.asarray(up, dtype=np.float64)
    right = np.cross(f, u)
    right /= np.linalg.norm(right)
    target = p + f * focus_distance
    return [(tuple(p + s * 0.5 * ipd * right), tuple(target), tuple(u))
            for s in (-1.0, 1.0)]


def frame_keys(display: str, seed: int, subframe: int, eye: int,
               max_depth: int):
    """The (jitter key, bounce keys) of one frame of one eye: a mono frame
    keys fold_in(PRNGKey(seed), subframe), a stereo eye
    fold_in(fold_in(PRNGKey(0), subframe), eye); jitter = fold_in(k, 0),
    path = fold_in(k, 1), bounce d = fold_in(path, d)."""
    if display == "stereo":
        key = rng.fold_in(rng.fold_in(rng.prng_key(0), subframe), eye)
    else:
        key = rng.fold_in(rng.prng_key(seed), subframe)
    path = rng.fold_in(key, 1)
    return rng.fold_in(key, 0), [rng.fold_in(path, d) for d in range(max_depth)]


def flatten(meshes, device):
    """Per-triangle float32 tensors of the meshes on ``device``: v0, e1,
    e2, the unit geometric normal (e1 x e2 normalised, as numpy's cross
    and norm order it), the corner uvs (T, 6); and int64 mesh (material)
    and texture ids."""
    verts, index, tcs, mats, texs = [], [], [], [], []
    base = 0
    for i, m in enumerate(meshes):
        idx = np.asarray(m["index"], dtype=np.int64)
        verts.append(np.asarray(m["vertex"], dtype=np.float32))
        tcs.append(np.asarray(m["texcoord"], dtype=np.float32))
        index.append(idx + base)
        base += len(m["vertex"])
        mats.append(np.full(len(idx), i, dtype=np.int64))
        texs.append(np.full(len(idx), int(m["texture_id"]), dtype=np.int64))
    t = lambda a: torch.tensor(np.concatenate(a), device=device)  # noqa: E731
    vert, idx, tc = t(verts), t(index), t(tcs)
    p0, p1, p2 = vert[idx[:, 0]], vert[idx[:, 1]], vert[idx[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    gn = sh.cross(e1, e2)
    gn = gn / torch.clamp(torch.sqrt(sh.dot(gn, gn)), min=1e-20)[:, None]
    uv = torch.cat([tc[idx[:, 0]], tc[idx[:, 1]], tc[idx[:, 2]]], dim=1)
    return p0, e1, e2, gn, uv, t(mats), t(texs)


class Reference:
    """The scene on ``device`` in ``dtype`` (float32, or a lower precision
    for the control), the render settings of a configuration and its
    cameras (a list of (eye, lookat, up) with the configuration's fov)."""

    def __init__(self, cfg: dict, meshes, images, probe_image, cameras,
                 fov_y: float, device, dtype=torch.float32):
        self.dev, self.dt = torch.device(device), dtype
        self.width, self.height = cfg["width"], cfg["height"]
        self.passes = cfg["schedule"]["passes"]
        r = cfg["render"]
        self.max_depth, self.tmin, self.tmax = (cfg["max_depth"], r["tmin"],
                                                r["tmax"])
        v0, e1, e2, gn, uv, self.mat, self.tex = flatten(meshes, self.dev)
        self.bvh = RefBVH(v0.to(dtype), e1.to(dtype), e2.to(dtype))
        self.gn, self.uv = gn.to(dtype), uv.to(dtype)
        self.textured = bool((self.tex >= 0).any())
        self.materials = sh.material_table([m["material"] for m in meshes],
                                           self.dev, dtype)
        self.textures = sh.Textures(images, self.dev, dtype)
        self.probe = sh.Probe(probe_image, self.dev, dtype)
        aspect = self.width / self.height
        self.cams = [tuple(torch.tensor(a, device=self.dev).to(dtype)
                           for a in camera_frame(e, la, up, fov_y, aspect))
                     for e, la, up in cameras]

    # ------------------------------------------------------------ paths
    def _bounce(self, o, d, throughput, eta_in, ray_ids, s0, s1, primary):
        hit = self.bvh.closest_hit(o, d, torch.ones_like(ray_ids, dtype=torch.bool),
                                   self.tmin, self.tmax)
        hit_mask = hit["hit"]
        tri = torch.clamp(hit["tri_id"], min=0)
        p = torch.where(hit_mask[:, None], o + hit["t"][:, None] * d, o)
        nrm = sh.face_forward(self.gn[tri], -d)
        m = sh.material_view(self.materials[self.mat[tri]])
        if self.textured:
            tex_id = self.tex[tri]
            corner = self.uv[tri]
            bu, bv = hit["u"][:, None], hit["v"][:, None]
            uv = ((1.0 - bu - bv) * corner[:, 0:2] + bu * corner[:, 2:4]
                  + bv * corner[:, 4:6])
            albedo = torch.where((tex_id >= 0)[:, None],
                                 self.textures.sample(tex_id, uv), m.color)
        else:
            albedo = m.color
        out_eta = torch.where(eta_in == 1.0, m.eta, 1.0)

        u_all = rng.uniforms(s0, s1, ray_ids, 8).to(self.dt)
        wi, sky_col, sky_pdf = self.probe.sample(u_all[:, 0], u_all[:, 1])
        view = -d
        nee_pdf = sh.bsdf_pdf(m, eta_in, out_eta, nrm, view, wi)
        nee_f = sh.bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, wi)
        denom = 0.5 * nee_pdf + 0.5 * sky_pdf
        weight = torch.where(
            denom > 0, 0.5 * sky_pdf / torch.clamp(denom, min=1e-20), 0.0)
        valid = (nee_pdf > 0.0) & (weight > 0.0) & (sky_pdf > 0.0)
        light_val = torch.where(
            valid[:, None],
            weight[:, None] * sky_col * nee_f * sh.dot(wi, nrm).abs()[:, None]
            / torch.clamp(sky_pdf, min=1e-20)[:, None], 0.0)

        u_frame, v_frame = sh.basis_from_vector(nrm)
        l_dir, pdf = sh.bsdf_sample(m, eta_in, out_eta, u_frame, v_frame, nrm,
                                    view, u_all[:, 2:8])
        sample_ok = pdf > 0.0
        query = hit_mask & (light_val.amax(dim=1) > 0.0) & sample_ok
        occ = self.bvh.occluded(p, wi, query, self.tmin, self.tmax)
        nee = torch.where((~occ)[:, None], light_val, 0.0)
        emitted = (torch.where(hit_mask & primary, 1.0, 0.0)[:, None]
                   .to(self.dt) * m.emission)
        vert_radiance = throughput * nee + emitted
        f_b = sh.bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, l_dir)
        transmitted = sh.dot(l_dir, nrm) <= 0.0
        cont = hit_mask & sample_ok
        thr_scale = (f_b * sh.dot(nrm, l_dir).abs()[:, None]
                     / torch.clamp(pdf, min=1e-20)[:, None])
        return {
            "hit": hit_mask, "alive": cont, "origin": p,
            "direction": torch.where(hit_mask[:, None], l_dir, d),
            "throughput": torch.where(cont[:, None], throughput * thr_scale,
                                      throughput),
            "eta": torch.where(hit_mask & transmitted, out_eta, eta_in),
            "contrib": torch.where(cont[:, None], vert_radiance, 0.0),
        }

    def trace(self, o, d, ray_ids, keys):
        """Paths of (N, 3) rays; ``keys`` (N, max_depth, 2) int64 bounce key
        words -> (radiance (N, 3), alpha (N, 3))."""
        n = o.shape[0]
        o, d = o.clone(), d.clone()
        ones = torch.ones((n, 3), dtype=self.dt, device=self.dev)
        throughput, radiance, alpha = ones.clone(), ones * 0, ones * 0
        eta = torch.ones((n,), dtype=self.dt, device=self.dev)
        idx = torch.arange(n, device=self.dev)
        for depth in range(self.max_depth):
            if idx.numel() == 0:
                break
            b = self._bounce(o[idx], d[idx], throughput[idx], eta[idx],
                             ray_ids[idx], keys[idx, depth, 0],
                             keys[idx, depth, 1], depth == 0)
            o[idx], d[idx] = b["origin"], b["direction"]
            throughput[idx], eta[idx] = b["throughput"], b["eta"]
            radiance[idx] = radiance[idx] + b["contrib"]
            alpha[idx] = torch.where(b["hit"][:, None], 1.0, alpha[idx])
            idx = idx[b["alive"]]
        return radiance, alpha

    # ------------------------------------------------------------ items
    def item_values(self, cam, pass_id, idx_x, idx_y, jitter_keys,
                    bounce_keys, chunk_rays: int = 1 << 20) -> torch.Tensor:
        """The film value of items (one launch pixel of one pass of one
        frame of one camera), as numpy arrays of item fields: ``cam``,
        ``pass_id``, ``idx_x``, ``idx_y`` (frame pixel of the launch pixel),
        ``jitter_keys`` (n, 2), ``bounce_keys`` (n, max_depth, 2) -> (n, 3)
        in the reference's dtype, each item's mean over its pass's spp
        paths blended with the backplate as the film does."""
        out = torch.zeros((len(cam), 3), dtype=self.dt, device=self.dev)
        spp = np.asarray([self.passes[p]["spp"] for p in pass_id], np.int64)
        start = 0
        while start < len(cam):  # whole items, about chunk_rays rays a chunk
            stop = start + 1
            total = int(spp[start])
            while stop < len(cam) and total + spp[stop] <= chunk_rays:
                total += int(spp[stop])
                stop += 1
            sl = slice(start, stop)
            out[sl] = self._items(cam[sl], pass_id[sl], idx_x[sl], idx_y[sl],
                                  jitter_keys[sl], bounce_keys[sl], spp[sl])
            start = stop
        return out

    def _items(self, cam, pass_id, idx_x, idx_y, jkeys, bkeys, spp):
        w, h, dev, dt = self.width, self.height, self.dev, self.dt
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
        item = torch.repeat_interleave(torch.arange(len(cam), device=dev),
                                       t(spp))
        first = torch.cumsum(t(spp), 0) - t(spp)
        slot = torch.arange(item.numel(), device=dev) - first[item]
        ix, iy = t(idx_x)[item], t(idx_y)[item]
        in_frame = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        virt_w = w + 2 * OFF_BAND
        cx = torch.clamp(ix, -OFF_BAND, w + OFF_BAND - 1)
        cy = torch.clamp(iy, -OFF_BAND, h + OFF_BAND - 1)
        off_pix = w * h + (cy + OFF_BAND) * virt_w + (cx + OFF_BAND)
        ray_ids = torch.where(in_frame, iy * w + ix, off_pix) * RNG_STRIDE + slot
        jk = t(jkeys)[item]
        jitter = rng.uniforms(jk[:, 0], jk[:, 1], ray_ids, 2).to(dt)
        cams = t(cam)[item]
        eye, cu, cv, cw = (torch.stack([c[k] for c in self.cams])[cams]
                           for k in range(4))
        ndc_x = 2.0 * (ix.to(dt) + jitter[:, 0]) / w - 1.0
        ndc_y = 2.0 * (iy.to(dt) + jitter[:, 1]) / h - 1.0
        direction = sh.normalize(ndc_x[:, None] * cu + ndc_y[:, None] * cv + cw)
        rad, alpha = self.trace(eye, direction, ray_ids, t(bkeys)[item])
        n_items = len(cam)
        rad_sum = torch.zeros((n_items, 3), dtype=dt, device=dev)
        alpha_sum = torch.zeros((n_items, 3), dtype=dt, device=dev)
        k = int(spp.max())
        if (spp == k).all():  # one pass's items: sum the slots as the film
            rad_sum = rad.reshape(n_items, k, 3).sum(1)
            alpha_sum = alpha.reshape(n_items, k, 3).sum(1)
        else:
            rad_sum.index_add_(0, item, rad)
            alpha_sum.index_add_(0, item, alpha)
        # the backplate: the probe at the unjittered pixel centre
        ci = t(cam)
        eye_c, cu_c, cv_c, cw_c = (torch.stack([c[k] for c in self.cams])[ci]
                                   for k in range(4))
        px = 2.0 * (t(idx_x).to(dt) + 0.5) / w - 1.0
        py = 2.0 * (t(idx_y).to(dt) + 0.5) / h - 1.0
        dirs = sh.normalize(px[:, None] * cu_c + py[:, None] * cv_c + cw_c)
        backplate = self.probe.eval(sh.dir_to_uv(dirs))
        sppf = t(spp)[:, None].to(dt)
        alpha_mean = alpha_sum / sppf
        color = backplate * sppf * (1.0 - alpha_mean) + rad_sum
        return color / sppf
