"""OpenEXR scanline image IO, pure numpy (the port's own copy of the JAX
package's ``utils/exr.py``).

The reference reads and writes EXR through vendored tinyexr
(sutil/sutil.cpp:253-360, support/tinyexr); EXR is its float-image
interchange format. This is a from-scratch minimal EXR 2.0 codec:

- write: HALF or FLOAT RGB(A), NONE or ZIP compression (zlib is in the
  stdlib; ZIP is the OpenEXR default and what tinyexr emits).
- read: single-part scanline images, NONE / ZIPS / ZIP compression,
  HALF/FLOAT/UINT channels, arbitrary channel sets (R,G,B[,A] selected when
  present, alphabetic otherwise).

Format notes (OpenEXR file layout v2):
  magic 0x01312f76 LE, version int32 (2), attribute list (name\\0 type\\0
  int32 size, payload) ended by an empty name, uint64 scanline-block offset
  table, then blocks of [int32 y, int32 packed_size, bytes]. A ZIP block
  holds 16 scanlines; pixel data inside a block is scanline-major, channel
  (alphabetical) next, then x. ZIP packing applies a byte deinterleave +
  delta predictor before zlib (ImfZip.cpp semantics, re-derived).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76
_NO_COMPRESSION = 0
_ZIPS_COMPRESSION = 2  # 1 scanline / block
_ZIP_COMPRESSION = 3  # 16 scanlines / block
_PIXEL_UINT = 0
_PIXEL_HALF = 1
_PIXEL_FLOAT = 2

_DTYPE = {
    _PIXEL_UINT: np.dtype("<u4"),
    _PIXEL_HALF: np.dtype("<f2"),
    _PIXEL_FLOAT: np.dtype("<f4"),
}


def _zip_pack(raw: bytes) -> bytes:
    """EXR ZIP pre-filter + deflate: deinterleave even/odd bytes, then delta
    encode (d[i] = s[i] - s[i-1] + 128 + 256 mod 256), then zlib."""
    b = np.frombuffer(raw, np.uint8)
    half = (len(b) + 1) // 2
    tmp = np.empty_like(b)
    tmp[:half] = b[0::2]
    tmp[half:] = b[1::2]
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - np.asarray(tmp[:-1], np.int16) + (128 + 256)
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_unpack(data: bytes, n: int) -> bytes:
    """Inverse of _zip_pack. ``n`` = expected unpacked byte count."""
    t = np.frombuffer(zlib.decompress(data), np.uint8).copy()
    # undo predictor: running byte sum with -128 bias
    d = t.astype(np.int64)
    d[1:] -= 128
    t = np.cumsum(d, dtype=np.int64).astype(np.uint8)
    # re-interleave the two halves
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half : n]
    return out.tobytes()


def _attr(name: str, typ: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + typ.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr(
    path: str,
    image: np.ndarray,
    half: bool = True,
    compression: str = "zip",
) -> None:
    """Write (H, W), (H, W, 3) or (H, W, 4) float data as scanline EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    ptype = _PIXEL_HALF if half else _PIXEL_FLOAT
    dt = _DTYPE[ptype]
    comp = {"none": _NO_COMPRESSION, "zip": _ZIP_COMPRESSION}[compression]
    lines_per_block = 16 if comp == _ZIP_COMPRESSION else 1

    # channel list: alphabetical order is required
    order = sorted(range(c), key=lambda i: names[i])
    chan_payload = b"".join(
        names[i].encode() + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
        for i in order
    ) + b"\0"

    header = b"".join(
        [
            _attr("channels", "chlist", chan_payload),
            _attr("compression", "compression", struct.pack("<B", comp)),
            _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
            _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)),
            _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    data = img[:, :, order].astype(dt)  # (H, W, C) channel-minor
    blocks: List[bytes] = []
    for y0 in range(0, h, lines_per_block):
        y1 = min(y0 + lines_per_block, h)
        # block layout: per scanline, per channel, per x
        raw = np.ascontiguousarray(
            np.transpose(data[y0:y1], (0, 2, 1))
        ).tobytes()
        if comp == _ZIP_COMPRESSION:
            packed = _zip_pack(raw)
            if len(packed) >= len(raw):  # spec: store raw when zip grows it
                packed = raw
        else:
            packed = raw
        blocks.append(struct.pack("<ii", y0, len(packed)) + packed)

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(preamble)
    offset = table_pos + 8 * len(blocks)
    table = []
    for b in blocks:
        table.append(struct.pack("<Q", offset))
        offset += len(b)
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(b"".join(table))
        f.write(b"".join(blocks))


def _read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_channels(payload: bytes) -> List[Tuple[str, int]]:
    chans = []
    pos = 0
    while pos < len(payload) and payload[pos] != 0:
        name, pos = _read_cstr(payload, pos)
        ptype = struct.unpack_from("<i", payload, pos)[0]
        pos += 16  # type + pLinear/reserved + xSampling + ySampling
        chans.append((name, ptype))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR to (H, W, C) float32. Channels are
    returned as RGB(A) when those names exist, else in file (alphabetical)
    order."""
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & 0x1000:
        raise ValueError(f"{path}: multi-part EXR not supported")
    pos = 8
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        typ, pos = _read_cstr(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size

    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if comp == _NO_COMPRESSION:
        lines_per_block = 1
    elif comp == _ZIPS_COMPRESSION:
        lines_per_block = 1
    elif comp == _ZIP_COMPRESSION:
        lines_per_block = 16
    else:
        raise ValueError(f"{path}: unsupported compression {comp}")

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    line_bytes = sum(w * _DTYPE[t].itemsize for _, t in chans)
    out = {name: np.empty((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        rows = min(lines_per_block, h - (y - y0))
        raw_n = line_bytes * rows
        if comp != _NO_COMPRESSION and size != raw_n:
            data = _zip_unpack(data, raw_n)
        p = 0
        for r in range(rows):
            for name, t in chans:
                dt = _DTYPE[t]
                nb = w * dt.itemsize
                row = np.frombuffer(data, dt, count=w, offset=p)
                out[name][y - y0 + r] = row.astype(np.float32)
                p += nb

    names = [n for n, _ in chans]
    want = [n for n in ("R", "G", "B", "A") if n in names]
    sel = want if want else names
    return np.stack([out[n] for n in sel], axis=2)
