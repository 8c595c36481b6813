"""Bitmap albedo from the texture atlas (counterpart of the reference's
integrators/path.py:_albedo and its kernels' tex_albedo_tile,
megatrace.py:802).

`tex_albedo` reads the packed atlas `tex` (N * H * W, 4) of
ops/megatrace.py, one rgb texel per row (page-major, then row, then
column), bilinearly at uv (wrapped into [0, 1)), with the kernels' corner
order and weights.
"""
from __future__ import annotations

import torch


def tex_albedo(tex, shape, tid, tu, tv):
    """Bilinear albedo (R, 3) of pages tid (R,) (clamped into the atlas)
    at (tu, tv) (R,) each; lanes with tid < 0 are the caller's to mask."""
    n_pages, th, tw = shape
    x = torch.clamp(torch.remainder(tu, 1.0), 0.0, 1.0) * (tw - 1)
    y = torch.clamp(torch.remainder(tv, 1.0), 0.0, 1.0) * (th - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.clamp(x0 + 1.0, max=tw - 1.0)
    y1 = torch.clamp(y0 + 1.0, max=th - 1.0)
    fx = x - x0
    fy = y - y0
    page = torch.clamp(tid, 0.0, n_pages - 1.0) * float(th * tw)
    out = None
    for yc, xc, w in ((y0, x0, (1 - fx) * (1 - fy)), (y0, x1, fx * (1 - fy)),
                      (y1, x0, (1 - fx) * fy), (y1, x1, fx * fy)):
        c = tex[(page + yc * tw + xc).to(torch.int64), 0:3]
        out = w[:, None] * c if out is None else out + w[:, None] * c
    return out
