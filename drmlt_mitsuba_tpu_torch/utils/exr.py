"""Minimal OpenEXR 2.0 scanline IO in pure numpy (a copy of
drmlt_mitsuba_tpu/utils/exr.py, so the port does not import the reference
package).  Writes uncompressed or ZIP/ZIPS scanline RGB(A) images in HALF
or FLOAT; reads uncompressed and ZIP/ZIPS single-part scanline files
(zlib and the EXR byte-deinterleave predictor), the environment maps of
scene XMLs.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2

_PIXEL_SIZE = {_HALF: 2, _FLOAT: 4}
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
              compression: str = "none", layers=None):
    """Write an (H, W, 3|4|1) float image as a scanline EXR; with `layers`
    (n names), an (H, W, 3 n) image whose channels are <layer>.R, .G, .B
    (a multichannel render's AOVs)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if layers is not None:
        if c != 3 * len(layers):
            raise ValueError(f"{c} channels for layers {list(layers)}")
        names = [f"{n}.{x}" for n in layers for x in "RGB"]
    else:
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


def _exr_zip_decompress(data: bytes, expected: int) -> bytes:
    if len(data) == expected:
        return data
    raw = zlib.decompress(data)
    buf = np.frombuffer(raw, np.uint8)
    n = len(buf)
    half = (n + 1) // 2
    # OpenEXR Zip::uncompress: undo the predictor over the flat buffer
    # (out[i] = out[i-1] + in[i] - 128 mod 256), then interleave the two
    # halves back to byte order
    rec = np.empty(n, np.uint8)
    rec[0] = buf[0]
    rec[1:] = (int(buf[0]) + np.cumsum(buf[1:].astype(np.int64) - 128)) & 0xFF
    inter = np.empty(n, np.uint8)
    inter[0::2] = rec[:half]
    inter[1::2] = rec[half:]
    return inter.tobytes()


def read_exr(path: str) -> np.ndarray:
    """(H, W, C) float32 image of a single-part scanline EXR with NO, ZIPS
    or ZIP compression and HALF or FLOAT channels (R, G, B(, A) in that
    order)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _ = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        type_ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1

    chdata = attrs["channels"][1]
    channels = []
    cp = 0
    while chdata[cp] != 0:
        e = chdata.index(b"\x00", cp)
        cname = chdata[cp:e].decode()
        cp = e + 1
        ptype, _, _, _ = struct.unpack_from("<iiii", chdata, cp)
        cp += 16
        channels.append((cname, ptype))
    (comp,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    if comp not in (0, 2, 3):
        raise NotImplementedError(f"{path}: EXR compression {comp} is not "
                                  f"read (NONE, ZIPS and ZIP are)")
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"][1], 0)
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lines_per_block = {0: 1, 2: 1, 3: 16}[comp]
    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)

    out = np.zeros((h, w, len(channels)), np.float32)
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        blk = data[off + 8: off + 8 + size]
        nlines = min(lines_per_block, h - (y - y0))
        expected = sum(w * _PIXEL_SIZE[pt] for _, pt in channels) * nlines
        raw = _exr_zip_decompress(blk, expected) if comp else blk
        bp = 0
        for li in range(nlines):
            for ci, (_, ptype) in enumerate(channels):
                arr = np.frombuffer(raw, _NP_TYPE[ptype], count=w, offset=bp)
                out[y - y0 + li, :, ci] = arr.astype(np.float32)
                bp += w * _PIXEL_SIZE[ptype]

    names = [c[0] for c in channels]
    if names == ["B", "G", "R"]:
        out = out[..., ::-1]
    elif names == ["A", "B", "G", "R"]:
        out = out[..., [3, 2, 1, 0]]
    return out
