"""Image IO: PNG/PPM/PFM/EXR read-write + HDR probe loading (the port's own
copy of the JAX package's ``utils/image.py``; PNG and other 8-bit formats
go through Pillow).

Twin of the reference's image paths: sutil loadImage/saveImage (PPM/PNG/EXR,
sutil.cpp:253-360,571+), the golden-image PNG dumps (02HelloRaytracing/
main.cpp:145), and the PFM output of the BSDF visualization harness
(Disney.cuh:431-504). EXR (the reference's tinyexr float interchange format)
is implemented from scratch in utils/exr.py; PFM and NPZ remain as the
simpler float containers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_image(path: str, image: np.ndarray) -> None:
    """Save by extension: .png/.ppm clip to u8; .pfm/.exr keep float;
    .npz stores the raw array (twin of sutil::saveImage dispatch,
    sutil.cpp:571+)."""
    low = path.lower()
    if low.endswith(".exr"):
        from fovpathtracing_optixcodelatest_tpu_torch.utils.exr import write_exr

        write_exr(path, np.asarray(image, np.float32))
    elif low.endswith(".pfm"):
        save_pfm(path, image)
    elif low.endswith(".ppm"):
        save_ppm(path, image)
    elif low.endswith(".npz"):
        save_npz_frame(path, frame=np.asarray(image))
    else:
        save_png(path, image)


def save_png(path: str, image: np.ndarray) -> None:
    """Save (H, W, 3) uint8 or float [0,1] as PNG."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_png(path: str) -> np.ndarray:
    """Load PNG/JPG as float32 (H, W, 3) in [0,1]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def save_ppm(path: str, image: np.ndarray) -> None:
    """Binary PPM (P6) writer."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = arr.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(arr[..., :3].tobytes())


def load_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6) reader → float32 (H, W, 3) in [0,1]."""
    with open(path, "rb") as fh:
        data = fh.read()
    # header: magic, dims, maxval separated by whitespace/comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"{path}: not a binary PPM")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1
    arr = np.frombuffer(data[i : i + w * h * 3], dtype=np.uint8)
    return arr.reshape(h, w, 3).astype(np.float32) / float(maxval)


def save_pfm(path: str, image: np.ndarray) -> None:
    """PFM float writer (scale -1.0 = little-endian, bottom-up rows)."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    h, w = arr.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"PF\n")
        fh.write(f"{w} {h}\n".encode())
        fh.write(b"-1.0\n")
        fh.write(arr[::-1, :, :3].astype("<f4").tobytes())


def load_pfm(path: str) -> np.ndarray:
    """PFM reader → float32 (H, W, 3)."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        dims = fh.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(fh.readline().strip())
        endian = "<" if scale < 0 else ">"
        channels = 3 if magic == b"PF" else 1
        count = w * h * channels
        arr = np.frombuffer(fh.read(count * 4), dtype=f"{endian}f4")
    arr = arr.reshape(h, w, channels)[::-1]
    if channels == 1:
        arr = arr.repeat(3, axis=-1)
    return arr.astype(np.float32)


def load_hdr_probe(path: str) -> Optional[np.ndarray]:
    """Load a lat-long environment map for loadProbe (main.cpp:161-171):
    Radiance .hdr (RGBE) or any PIL-readable LDR (converted to linear-ish by
    squaring — the reference feeds stbi's raw values straight to the CDF, so
    exactness is not required for parity)."""
    if path.lower().endswith(".hdr"):
        return _load_radiance_hdr(path)
    if path.lower().endswith(".pfm"):
        return load_pfm(path)
    if path.lower().endswith(".exr"):
        from fovpathtracing_optixcodelatest_tpu_torch.utils.exr import read_exr

        return read_exr(path)[:, :, :3]
    try:
        ldr = load_png(path)
    except (OSError, ValueError):  # missing, or not an image PIL reads
        return None
    return ldr**2.2


def _load_radiance_hdr(path: str) -> Optional[np.ndarray]:
    """Minimal Radiance RGBE (.hdr) decoder (RLE + flat scanlines)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"#?"):
        return None
    # header ends at blank line; next line is the resolution spec
    pos = data.find(b"\n\n")
    if pos < 0:
        return None
    pos += 2
    eol = data.find(b"\n", pos)
    spec = data[pos:eol].split()
    if len(spec) != 4 or spec[0] != b"-Y" or spec[2] != b"+X":
        return None
    h, w = int(spec[1]), int(spec[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    buf = data[pos:]
    bi = 0
    for y in range(h):
        if bi + 4 <= len(buf) and buf[bi] == 2 and buf[bi + 1] == 2 and (
            (buf[bi + 2] << 8) | buf[bi + 3]
        ) == w:
            bi += 4  # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    run = buf[bi]
                    bi += 1
                    if run > 128:  # run of identical values
                        rgbe[y, x : x + run - 128, c] = buf[bi]
                        bi += 1
                        x += run - 128
                    else:  # literal run
                        rgbe[y, x : x + run, c] = np.frombuffer(
                            buf[bi : bi + run], dtype=np.uint8
                        )
                        bi += run
                        x += run
        else:  # flat scanline
            row = np.frombuffer(buf[bi : bi + w * 4], dtype=np.uint8)
            rgbe[y] = row.reshape(w, 4)
            bi += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def save_npz_frame(path: str, **arrays) -> None:
    """Float frame dump (EXR stand-in) — e.g. accum/normal/albedo AOVs."""
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})


def save_gif(path: str, frames, fps: float = 10.0) -> None:
    """Animated GIF of a sequence of (H, W, 3) uint8 or float [0, 1]
    frames (Pillow), looping forever."""
    from PIL import Image

    imgs = []
    for f in frames:
        arr = np.asarray(f)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        imgs.append(Image.fromarray(arr))
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000.0 / fps), loop=0)
