"""Area and environment emitters: emission at a hit, the environment on
escape, and direct (NEE) sampling.

Plain-PyTorch forms of the emitter part of the reference's path kernel
(megatrace.py:1106-1158, 1250-1313 and :1332-1455), which mirror
render/emitter.py for area and image-environment rows.  They read the
packed tables of ops/megatrace.py: the emitter table `em` (E, 20)
(radiance 0:3, area 3, pmf 4, cdf 5, v0 6:9, e1 9:12, e2 12:15, unit
geometric normal 15:18, kind 18) and the lat-long environment's `env_tab`
(He * We, 4) (rgb, pixel pmf), `env_col` (He, We) (each row's column cdf)
and `env_row` (He,) (the marginal row cdf).  Point, spot and directional
emitters are not ported.
"""
from __future__ import annotations

import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import cdiv, dot
from drmlt_mitsuba_tpu_torch.core.warp import square_to_uniform_triangle

# pseudo-distance of an environment shadow ray (render/emitter.py:_DIR_DIST)
DIR_DIST = 1.0e7
# the upper clamp of a lat-long coordinate, 1 - 1e-6 in float32
_U_MAX = 1.0 - 1e-6


def emitter_rows(em, row):
    """Gather emitter rows for lanes; row < 0 (no emitter) reads zeros with
    area 1, as the kernel's select loop does."""
    g = em[torch.clamp(row, min=0)]
    none = (row < 0)[:, None]
    g = torch.where(none, 0.0, g)
    g[:, 3] = torch.where(row < 0, 1.0, g[:, 3])
    return g


def hit_emission(em, erow, d, ng, t_hit):
    """Radiance (R, 3) of the emitter row hit by direction d, whether the
    hit faces the ray, and the area-sampling pdf of that hit in solid angle
    (what NEE at the previous vertex would have used)."""
    g = emitter_rows(em, erow)
    cos_l = -dot(d, ng)
    front = cos_l > 0
    ok = (erow >= 0) & front
    # the masked quotient divides by 1, not by the 1e-30 floor, so its
    # backward stays finite
    den = torch.where(ok, cos_l * g[:, 3], 1.0)
    nee_pdf = torch.where(
        ok, g[:, 4] * t_hit * t_hit / torch.clamp(den, min=1e-30), 0.0)
    return g[:, 0:3], front, nee_pdf


def pick_row(em, u_pick):
    """cdf inversion: the count of cdf entries <= u, clamped to E - 1
    (searchsorted side right)."""
    rows = (u_pick[:, None] >= em[None, :, 5]).sum(-1)
    return torch.clamp(rows, max=em.shape[0] - 1)


def sample_direct(em, p, u_pick, u_l1, u_l2):
    """Sample a point on an area emitter as seen from p (R, 3).

    Returns (direction (R, 3), distance (R,), solid-angle pdf (R,),
    radiance (R, 3))."""
    g = em[pick_row(em, u_pick)]
    bary = square_to_uniform_triangle(torch.stack([u_l1, u_l2], -1))
    pl = (g[:, 6:9] + bary[:, 0:1] * g[:, 9:12]
          + bary[:, 1:2] * g[:, 12:15])
    tol = pl - p
    dist2 = dot(tol, tol)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    ld = tol / dist[:, None]
    lcos = -dot(ld, g[:, 15:18])
    area = g[:, 3]
    ok = lcos * area > 0
    den = torch.where(ok, lcos * area, 1.0)
    pdf = torch.where(ok, g[:, 4] * dist2 / torch.clamp(den, min=1e-30), 0.0)
    pdf = torch.where(lcos > 1e-7, pdf, 0.0)
    return ld, dist, pdf, g[:, 0:3]


# ------------------------------------------------------------ environment
def env_dir_to_uv(d):
    """Lat-long (u, v) (R,) each of world directions d (R, 3), Mitsuba's
    Y-up convention (emitter.env_dir_to_uv)."""
    theta = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0))
    phi = torch.arctan2(d[:, 0], -d[:, 2])
    return (cdiv(phi, math.pi) + 1.0) * 0.5, cdiv(theta, math.pi)


def env_uv_to_dir(u, v):
    """World direction (R, 3) of lat-long coordinates (emitter.
    env_uv_to_dir)."""
    th = v * math.pi
    st = torch.sin(th)
    ph = (u * 2.0 - 1.0) * math.pi
    return torch.stack([st * torch.sin(ph), torch.cos(th),
                        -st * torch.cos(ph)], -1)


def env_bilinear(env_tab, shape, u, v):
    """Bilinear radiance (R, 3) of the lat-long image at (u, v), wrapping
    in u and clamping in v (emitter.env_lookup; the kernels' corner order
    and weights, megatrace.py:1112-1135)."""
    he, we = shape
    x = torch.clamp(u, 0.0, _U_MAX) * we - 0.5
    y = torch.clamp(v, 0.0, _U_MAX) * he - 0.5
    x0 = torch.clamp(torch.floor(x), 0.0, we - 1.0)
    y0 = torch.clamp(torch.floor(y), 0.0, he - 1.0)
    x1 = torch.remainder(x0 + 1.0, float(we))
    y1 = torch.clamp(y0 + 1.0, max=he - 1.0)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    out = None
    for yc, xc, w in ((y0, x0, (1 - fx) * (1 - fy)), (y0, x1, fx * (1 - fy)),
                      (y1, x0, (1 - fx) * fy), (y1, x1, fx * fy)):
        c = env_tab[(yc * we + xc).to(torch.int64), 0:3]
        out = w[:, None] * c if out is None else out + w[:, None] * c
    return out


def env_pdf_sa(env_tab, shape, u, v, dy):
    """Solid-angle pdf (R,) of the environment's importance sampling for
    the direction with lat-long (u, v) and y component dy, without the
    emitter row's pick probability (emitter.env_pdf_dir)."""
    he, we = shape
    xn = torch.clamp(torch.floor(u * we), 0.0, we - 1.0)
    yn = torch.clamp(torch.floor(v * he), 0.0, he - 1.0)
    pmf = env_tab[(yn * we + xn).to(torch.int64), 3]
    theta = torch.arccos(torch.clamp(dy, -1.0, 1.0))
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    return pmf * float(he * we) / (2.0 * math.pi * math.pi * sin_t)


def env_sample(env_tab, env_col, env_row, shape, u1, u2):
    """Importance-sample the lat-long image with (u1, u2): the marginal row
    cdf, then the row's column cdf, each inverted as searchsorted (side
    right), the cdf residuals reused as the within-pixel jitter
    (emitter.sample_emitter_direct's env branch).  Returns (direction
    (R, 3), solid-angle pdf without the row pick (R,), radiance (R, 3))."""
    he, we = shape
    y = torch.clamp(torch.searchsorted(env_row, u1.contiguous(), right=True),
                    max=he - 1)
    col = env_col[y]
    x = torch.clamp(torch.searchsorted(col, u2.contiguous()[:, None],
                                       right=True)[:, 0], max=we - 1)
    row_lo = torch.where(y > 0, env_row[torch.clamp(y - 1, min=0)], 0.0)
    row_hi = env_row[y]
    ju = torch.clamp((u1 - row_lo) / torch.clamp(row_hi - row_lo, min=1e-12),
                     0.0, _U_MAX)
    rows = torch.arange(y.shape[0], device=y.device)
    col_lo = torch.where(x > 0, col[rows, torch.clamp(x - 1, min=0)], 0.0)
    col_hi = col[rows, x]
    jv = torch.clamp((u2 - col_lo) / torch.clamp(col_hi - col_lo, min=1e-12),
                     0.0, _U_MAX)
    ue = cdiv(x.to(u1.dtype) + jv, float(we))
    ve = cdiv(y.to(u1.dtype) + ju, float(he))
    d = env_uv_to_dir(ue, ve)
    st = torch.sin(ve * math.pi)
    pmf = env_tab[y * we + x, 3]
    pdf = pmf * float(he * we) / (2.0 * math.pi * math.pi
                                  * torch.clamp(st, min=1e-6))
    return d, pdf, env_bilinear(env_tab, shape, ue, ve)
