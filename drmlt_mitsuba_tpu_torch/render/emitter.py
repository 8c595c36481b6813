"""Area emitters: emission at a hit and direct (NEE) sampling.

Plain-PyTorch forms of the emitter part of the reference's path kernel
(megatrace.py:1250-1278 and :1332-1391), which mirror render/emitter.py for
area rows.  They read the packed emitter table `em` (E, 20) of
ops/megatrace.py: radiance 0:3, area 3, pmf 4, cdf 5, v0 6:9, e1 9:12,
e2 12:15, unit geometric normal 15:18.  Point, spot, directional and
environment emitters come later.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.math import dot
from drmlt_mitsuba_tpu_torch.core.warp import square_to_uniform_triangle


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
    nee_pdf = torch.where(
        (erow >= 0) & (cos_l > 0),
        g[:, 4] * t_hit * t_hit / torch.clamp(cos_l * g[:, 3], min=1e-30),
        0.0)
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
    pdf = torch.where(lcos * area > 0,
                      g[:, 4] * dist2 / torch.clamp(lcos * area, min=1e-30),
                      0.0)
    pdf = torch.where(lcos > 1e-7, pdf, 0.0)
    return ld, dist, pdf, g[:, 0:3]
