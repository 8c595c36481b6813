"""Area and environment emitters: emission at a hit, the environment on
escape, and direct (NEE) sampling.

Plain-PyTorch forms of the emitter part of the reference's path kernel
(megatrace.py:1106-1158, 1250-1313 and :1332-1455), which mirror
render/emitter.py for area and image-environment rows.  They read the
packed tables of ops/megatrace.py: the emitter table `em` (E, 20)
(radiance 0:3, area 3, pmf 4, cdf 5, v0 6:9, e1 9:12, e2 12:15, unit
geometric normal 15:18, kind 18) and the lat-long environment's `env_tab`
(He * We, 4) (rgb, pixel pmf), `env_col` (He, We) (each row's column cdf)
and `env_row` (He,) (the marginal row cdf).

The path wavefront (integrators/path.py:trace_paths_wavefront) reads every
emitter kind through `EmitterRows`: `sample_emitter_direct`,
`pdf_emitter_direct`, `eval_emitter`, `eval_env` and `env_pdf_dir`, the
reference's render/emitter.py:92-245 (triangle area rows, point, spot
with its cone falloff, directional, collimated and the image
environment).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    cdiv, cross, dot, normalize, safe_div,
)
from drmlt_mitsuba_tpu_torch.core.warp import square_to_uniform_triangle
from drmlt_mitsuba_tpu_torch.scene.types import (
    EMITTER_AREA, EMITTER_DIRECTIONAL, EMITTER_ENV, EMITTER_POINT,
    EMITTER_SPOT,
)

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


# ------------------------------------------------------- every emitter kind
@dataclasses.dataclass(frozen=True)
class EmitterRows:
    """The emitter table on one device, for the path wavefront: `rows`
    (E, 26) = radiance 0:3, area 3, pos 4:7, aux 7:11, pmf 11, and the
    area row's triangle v0 12:15, e1 15:18, e2 18:21, unit normal 21:24;
    `kind` (E,) int64, `cdf` (E,), the constant environment `env_rgb`
    (3,), and an image environment's packed tables (ops/megatrace.py:
    env_tab, env_col, env_row; env_shape None without an image) with the
    pick probability of its row."""
    rows: torch.Tensor
    kind: torch.Tensor
    cdf: torch.Tensor
    env_rgb: torch.Tensor
    env_tab: torch.Tensor
    env_col: torch.Tensor
    env_row: torch.Tensor
    env_shape: tuple | None
    env_row_pick: float


def emitter_table_rows(scene, tables) -> EmitterRows:
    """EmitterRows of `scene` with the packed tables `tables`
    (pack_mega_tables_torch on the target device)."""
    em, tris = scene.emitters, scene.tris
    dev = tables[0].device

    def f(x):
        return x.to(device=dev, dtype=torch.float32)

    ti = torch.clamp(em.tri_idx.to(device=dev, dtype=torch.int64), 0,
                     tris.v0.shape[0] - 1)
    e1, e2 = f(tris.e1)[ti], f(tris.e2)[ti]
    rows = torch.cat([f(em.radiance), f(em.area)[:, None], f(em.pos),
                      f(em.aux), f(em.pmf)[:, None], f(tris.v0)[ti], e1, e2,
                      normalize(cross(e1, e2))], 1).contiguous()
    kind = em.kind.to(device=dev, dtype=torch.int64)
    shape = (tuple(em.env_image.shape[:2]) if em.env_image is not None
             else None)
    pick = (float(em.pmf[em.kind == EMITTER_ENV].sum()) if shape else 0.0)
    return EmitterRows(rows=rows, kind=kind, cdf=f(em.cdf).contiguous(),
                       env_rgb=f(em.env_radiance), env_tab=tables[7],
                       env_col=tables[8], env_row=tables[9].reshape(-1),
                       env_shape=shape, env_row_pick=pick)


@dataclasses.dataclass
class DirectSample:
    """A sampled connection toward an emitter from a reference point."""
    d: torch.Tensor          # (R, 3) unit direction toward the emitter
    dist: torch.Tensor       # (R,)
    radiance: torch.Tensor   # (R, 3) the NEE factor: f radiance w / pdf
    pdf: torch.Tensor        # (R,) solid-angle (area, env) or discrete pdf
    delta: torch.Tensor      # (R,) bool: a delta emitter (MIS weight 1)


def sample_emitter_direct(er: EmitterRows, p_ref, u3) -> DirectSample:
    """Sample a direct connection from p_ref (R, 3); u3 (R, 3) = (pick,
    u, v) (the reference's sample_emitter_direct).  A collimated row
    lights p_ref from the beam's origin with the beam's power, unattenuated
    and whatever the beam's direction, as the reference's does."""
    rows = (u3[:, 0:1] >= er.cdf[None, :]).sum(-1)
    row = torch.clamp(rows, max=er.cdf.shape[0] - 1)
    g = er.rows[row]
    kind = er.kind[row]
    e_rad, e_area, e_pos, e_aux, pmf = (g[:, 0:3], g[:, 3], g[:, 4:7],
                                        g[:, 7:11], g[:, 11])
    # area rows
    b = square_to_uniform_triangle(u3[:, 1:3])
    p_l = g[:, 12:15] + b[:, 0:1] * g[:, 15:18] + b[:, 1:2] * g[:, 18:21]
    to_l = p_l - p_ref
    dist2_a = dot(to_l, to_l)
    dist_a = torch.sqrt(torch.clamp(dist2_a, min=1e-20))
    d_a = to_l / dist_a[:, None]
    cos_l = -dot(d_a, g[:, 21:24])
    vis_a = cos_l > 1e-7
    pdf_a = safe_div(pmf * dist2_a, cos_l * e_area)
    # point and spot rows
    to_p = e_pos - p_ref
    dist2_p = dot(to_p, to_p)
    dist_p = torch.sqrt(torch.clamp(dist2_p, min=1e-20))
    d_p = to_p / dist_p[:, None]
    rad_p = e_rad / torch.clamp(dist2_p, min=1e-12)[:, None]
    cos_cut = e_aux[:, 3]
    cos_spot = -dot(d_p, e_aux[:, 0:3])
    cos_beam = torch.cos(torch.arccos(torch.clamp(cos_cut, -1, 1)) * 0.75)
    spot_f = torch.clamp(safe_div(cos_spot - cos_cut, cos_beam - cos_cut),
                         0.0, 1.0)
    spot_f = torch.where(cos_spot >= cos_beam, 1.0, spot_f)
    # environment rows
    if er.env_shape is not None:
        d_env, pdf_env, rad_env = env_sample(er.env_tab, er.env_col,
                                             er.env_row, er.env_shape,
                                             u3[:, 1], u3[:, 2])
    else:
        d_env, pdf_env, rad_env = -e_pos, torch.ones_like(pmf), e_rad
    is_area = (kind == EMITTER_AREA)[:, None]
    is_point = (kind == EMITTER_POINT)[:, None]
    is_spot = (kind == EMITTER_SPOT)[:, None]
    is_dir = (kind == EMITTER_DIRECTIONAL)[:, None]
    is_env = (kind == EMITTER_ENV)[:, None]
    d = torch.where(is_area, d_a, torch.where(
        is_dir, -e_pos, torch.where(is_env, d_env, d_p)))
    dist = torch.where(is_area[:, 0], dist_a,
                       torch.where((is_dir | is_env)[:, 0], DIR_DIST,
                                   dist_p))
    radiance = torch.where(
        is_area, torch.where(vis_a[:, None], e_rad, 0.0),
        torch.where(is_point, rad_p, torch.where(
            is_spot, rad_p * spot_f[:, None],
            torch.where(is_env, rad_env, e_rad))))
    pdf = torch.where(is_area[:, 0], torch.where(vis_a, pdf_a, 0.0),
                      torch.where(is_env[:, 0], pmf * pdf_env, pmf))
    return DirectSample(d=d, dist=dist, radiance=radiance, pdf=pdf,
                        delta=~(is_area | is_env)[:, 0])


def pdf_emitter_direct(er: EmitterRows, p_ref, erow, hit_p, hit_n):
    """Solid-angle pdf of sample_emitter_direct for the point hit_p of the
    area row erow (R,) a BSDF-sampled ray hit (0 elsewhere)."""
    row = torch.clamp(erow.to(torch.int64), 0, er.cdf.shape[0] - 1)
    g = er.rows[row]
    to_l = hit_p - p_ref
    dist2 = dot(to_l, to_l)
    d = to_l / torch.sqrt(torch.clamp(dist2, min=1e-20))[:, None]
    cos_l = -dot(d, hit_n)
    pdf = safe_div(g[:, 11] * dist2, cos_l * g[:, 3])
    ok = (erow >= 0) & (cos_l > 0) & (er.kind[row] == EMITTER_AREA)
    return torch.where(ok, pdf, 0.0)


def eval_emitter(er: EmitterRows, erow, wi_world, hit_ng):
    """Radiance (R, 3) toward wi_world of the area row erow a ray hit."""
    row = torch.clamp(erow.to(torch.int64), 0, er.cdf.shape[0] - 1)
    ok = ((erow >= 0) & (dot(wi_world, hit_ng) > 0)
          & (er.kind[row] == EMITTER_AREA))
    return torch.where(ok[:, None], er.rows[row, 0:3], 0.0)


def eval_env(er: EmitterRows, d):
    """The environment's radiance (R, 3) along escaped directions d."""
    if er.env_shape is None:
        return er.env_rgb.expand(d.shape[0], 3)
    u, v = env_dir_to_uv(d)
    return env_bilinear(er.env_tab, er.env_shape, u, v)


def env_pdf_dir(er: EmitterRows, d):
    """Solid-angle pdf of the environment's direct sampling along d, its
    row's pick probability included (0 without an image)."""
    if er.env_shape is None:
        return torch.zeros_like(d[:, 0])
    u, v = env_dir_to_uv(d)
    return env_pdf_sa(er.env_tab, er.env_shape, u, v, d[:, 1]) * \
        er.env_row_pick
