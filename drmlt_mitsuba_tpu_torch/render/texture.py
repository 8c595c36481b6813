"""Bitmap albedo from the texture atlas (counterpart of the reference's
integrators/path.py:_albedo and its kernels' tex_albedo_tile,
megatrace.py:802), per-vertex colors and normal maps.

`tex_albedo` reads the packed atlas `tex` (N * H * W, 4) of
ops/megatrace.py, one rgb texel per row (page-major, then row, then
column), bilinearly at uv (wrapped into [0, 1)), with the kernels' corner
order and weights.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.frame import to_world
from drmlt_mitsuba_tpu_torch.core.math import cross, dot, normalize


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


def _bilinear(atlas, page, uv):
    """The reference's bilinear atlas lookup (path.py:_albedo): atlas
    (N, H, W, 3), pages (R,) clamped into it, uv (R, 2) wrapped."""
    n, h, w, _ = atlas.shape
    x = torch.clamp(torch.remainder(uv[:, 0], 1.0), 0.0, 1.0) * (w - 1)
    y = torch.clamp(torch.remainder(uv[:, 1], 1.0), 0.0, 1.0) * (h - 1)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    ti = torch.clamp(page.to(torch.int64), 0, n - 1)
    return ((atlas[ti, y0, x0] * (1 - fx) + atlas[ti, y0, x1] * fx)
            * (1 - fy)
            + (atlas[ti, y1, x0] * (1 - fx) + atlas[ti, y1, x1] * fx) * fy)


def surface_albedo(albedo, tex_id, atlas, vcolors, hit):
    """The albedo (R, 3) at hits (the reference's path.py:_albedo): the
    material's constant `albedo` (R, 3), its atlas page where tex_id (R,)
    >= 0, or with tex_id == -2 the hit triangle's per-vertex colors
    (vcolors (T, 3, 3)) interpolated barycentrically."""
    base = albedo
    if atlas is not None:
        base = torch.where((tex_id >= 0)[:, None],
                           _bilinear(atlas, tex_id, hit.tex_uv), base)
    if vcolors is not None:
        prim = torch.clamp(hit.prim.to(torch.int64), 0,
                           vcolors.shape[0] - 1)
        vc = vcolors[prim]
        b1, b2 = hit.uv[:, 0:1], hit.uv[:, 1:2]
        col = (1.0 - b1 - b2) * vc[:, 0] + b1 * vc[:, 1] + b2 * vc[:, 2]
        base = torch.where(((tex_id == -2) & (hit.prim >= 0))[:, None], col,
                           base)
    return base


def apply_normal_map(ntid, atlas, tris, hit, ns):
    """The shading normal perturbed by the tangent-space normal page ntid
    (R,) (-1: unperturbed; the reference's path.py:apply_normal_map):
    tangents follow the triangle's uv parametrisation, degenerate uvs
    fall back to the shading frame's first axis.  `tris` holds the
    triangle table's e1, e2, uv0, uv1, uv2 on the hits' device."""
    n_ts = _bilinear(atlas, ntid, hit.tex_uv) * 2.0 - 1.0
    pi = torch.clamp(hit.prim.to(torch.int64), 0, tris.e1.shape[0] - 1)
    duv1 = tris.uv1[pi] - tris.uv0[pi]
    duv2 = tris.uv2[pi] - tris.uv0[pi]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    t_uv = tris.e1[pi] * duv2[:, 1:2] - tris.e2[pi] * duv1[:, 1:2]
    t_fb = to_world(ns, torch.zeros_like(ns) + ns.new_tensor([1.0, 0, 0]))
    t = torch.where((torch.abs(det) > 1e-12)[:, None], t_uv, t_fb)
    t = t - ns * dot(t, ns)[:, None]
    t_len = torch.sqrt(torch.clamp(dot(t, t), min=1e-20))[:, None]
    t = torch.where(t_len > 1e-9, t / t_len, t_fb)
    b = cross(ns, t)
    n_new = normalize(t * n_ts[:, 0:1] + b * n_ts[:, 1:2]
                      + ns * torch.clamp(n_ts[:, 2:3], min=1e-3))
    use = (ntid >= 0) & (hit.prim >= 0)
    return torch.where(use[:, None], n_new, ns)
