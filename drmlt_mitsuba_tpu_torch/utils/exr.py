"""Minimal OpenEXR 2.0 scanline writer in pure numpy (the writer half of
drmlt_mitsuba_tpu/utils/exr.py, copied so the port does not import the
reference package).  Writes uncompressed or ZIP/ZIPS scanline RGB(A)
images in HALF or FLOAT.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2

_NP_TYPE = {_HALF: np.float16, _FLOAT: np.float32}


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (name.encode() + b"\x00" + type_.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data)


def _channel_list(names, pix_type: int) -> bytes:
    out = b""
    for n in sorted(names):   # EXR requires alphabetical channel order
        out += n.encode() + b"\x00" + struct.pack("<iiii", pix_type, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str, img: np.ndarray, half: bool = True,
              compression: str = "none"):
    """Write an (H, W, 3|4|1) float image as a scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    ptype = _HALF if half else _FLOAT
    dt = _NP_TYPE[ptype]
    comp = {"none": 0, "zip": 3, "zips": 2}[compression]

    header = b""
    header += _attr("channels", "chlist", _channel_list(names, ptype))
    header += _attr("compression", "compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    # channel-interleaved by scanline, channels alphabetical; ZIP blocks
    # hold 16 scanlines, NONE/ZIPS hold one
    order = np.argsort(np.asarray(names))
    lines_per_block = 16 if comp == 3 else 1
    blocks = []
    for y0b in range(0, h, lines_per_block):
        raw = b"".join(
            b"".join(img[y, :, order[i]].astype(dt).tobytes()
                     for i in range(c))
            for y in range(y0b, min(y0b + lines_per_block, h)))
        blocks.append((y0b, raw if comp == 0 else _exr_zip_compress(raw)))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        pos = f.tell() + 8 * len(blocks)
        offsets = []
        for _, blk in blocks:
            offsets.append(pos)
            pos += 8 + len(blk)
        f.write(struct.pack(f"<{len(blocks)}q", *offsets))
        for y0b, blk in blocks:
            f.write(struct.pack("<ii", y0b, len(blk)))
            f.write(blk)


def _exr_zip_compress(raw: bytes) -> bytes:
    # OpenEXR Zip::compress: split bytes even/odd into two halves, then
    # delta-predict over the reordered buffer, then zlib
    buf = np.frombuffer(raw, np.uint8)
    n = len(buf)
    reord = np.concatenate([buf[0::2], buf[1::2]])
    delta = np.empty(n, np.uint8)
    delta[0] = reord[0]
    d = reord[1:].astype(np.int16) - reord[:-1].astype(np.int16) + 128
    delta[1:] = (d & 0xFF).astype(np.uint8)
    z = zlib.compress(delta.tobytes())
    return z if len(z) < n else raw
