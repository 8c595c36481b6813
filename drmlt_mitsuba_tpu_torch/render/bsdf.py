"""BSDF evaluation and sampling for the kinds the port renders: the seven
kinds of the reference's megakernels (megatrace.py:55-57): diffuse, rough
diffuse (Oren-Nayar), mirror, smooth dielectric, smooth conductor, rough
conductor (GGX) and null.

These are the plain-PyTorch forms of what the reference's kernels compute
in megatrace.py `_fresnel_cond1` (:202), `_oren_nayar_term` (:1584),
`_eval_kinds` (:1602) and `_sample_kinds` (:1659), which in turn mirror
render/bsdf.py.  A material is a dict of per-lane rows (`material_rows`):
`kind` (R,), albedo / eta / k / spec_refl / spec_trans (R, 3), the
roughness column (R,); directions are local (R, 3).  A kind's lobe is
evaluated only where the material table has that kind: the dict's `kinds`
(the table's kinds, known on the host when the table is packed) decides
that without reading the lanes back from the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    cdiv, dot, fresnel_dielectric, normalize, safe_sqrt,
)
from drmlt_mitsuba_tpu_torch.core.warp import square_to_cosine_hemisphere
from drmlt_mitsuba_tpu_torch.render.microfacet import (
    ggx_g1, ggx_g2, ggx_ndf, ggx_sample_vndf, ggx_vndf_pdf,
)
from drmlt_mitsuba_tpu_torch.scene.types import (
    BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_MIRROR, BSDF_NULL,
    BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIFFUSE,
)

SUPPORTED_KINDS = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                   BSDF_ROUGH_CONDUCTOR, BSDF_MIRROR, BSDF_NULL,
                   BSDF_ROUGH_DIFFUSE)
# the kinds beyond slices 1-4: a scene with one of them takes the kernels'
# full-scope instantiation
EXTRA_KINDS = (BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR, BSDF_NULL)


def _div_pi(x):
    """x / pi as a true division on every device (core/math.py:cdiv)."""
    return cdiv(x, math.pi)


def material_rows(mat, mat_id, kinds, albedo=None):
    """Per-lane material parameters from the packed table mat (M, 18) of
    ops/megatrace.py, whose BSDF kinds are `kinds` (a frozenset, see
    ops/megatrace.py:scope_fields); `albedo` (R, 3) overrides the constant
    albedo (a bitmap texture's lookup)."""
    m = mat[mat_id.to(torch.int64)]
    return dict(kind=m[:, 0].to(torch.int64),
                albedo=m[:, 1:4] if albedo is None else albedo,
                eta=m[:, 4:7], k=m[:, 7:10], rough=m[:, 10],
                spec_refl=m[:, 11:14], spec_trans=m[:, 14:17],
                tex_id=m[:, 17], kinds=kinds)


def _has(m, kind) -> bool:
    """Whether a lobe needs evaluating: the material table has `kind`."""
    return kind in m["kinds"]


def is_delta(kind):
    return ((kind == BSDF_MIRROR) | (kind == BSDF_DIELECTRIC)
            | (kind == BSDF_CONDUCTOR) | (kind == BSDF_NULL))


def fresnel_conductor(ci, eta, k):
    """Per-channel conductor Fresnel reflectance (R, 3) for cosines ci
    (R,) and complex IOR eta + i k (R, 3) (megatrace.py:_fresnel_cond1)."""
    ci = torch.clamp(ci, 0.0, 1.0)[:, None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = torch.where(t1 + t2 > 0,
                     (t1 - t2) / torch.clamp(t1 + t2, min=1e-30), 0.0)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * torch.where(t3 + t4 > 0,
                          (t3 - t4) / torch.clamp(t3 + t4, min=1e-30), 0.0)
    return 0.5 * (rp + rs)


def oren_nayar(wi, wo, sigma):
    """Qualitative Oren-Nayar factor (roughdiffuse.cpp "fast" mode); the
    roughness column is sigma in radians."""
    s2 = sigma * sigma
    a_on = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b_on = 0.45 * s2 / (s2 + 0.09)
    ci = torch.abs(wi[:, 2])
    co = torch.abs(wo[:, 2])
    sin_i = safe_sqrt(1.0 - ci * ci)
    sin_o = safe_sqrt(1.0 - co * co)
    denom = torch.clamp(sin_i * sin_o, min=1e-7)
    cos_dphi = torch.clamp((wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1])
                           / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(sin_i, sin_o)
    tan_beta = torch.minimum(sin_i / torch.clamp(ci, min=1e-7),
                             sin_o / torch.clamp(co, min=1e-7))
    return a_on + b_on * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta


def _sign1(x):
    """sign(x), with 1 at 0."""
    return torch.where(x < 0, -1.0, 1.0)


def _rough_conductor_eval(m, wi, wo):
    """(f * |cos_o|, pdf) of the GGX conductor (megatrace.py:1629-1656)."""
    cos_i = wi[:, 2]
    h = normalize(wo + wi)
    h = h * _sign1(h[:, 2])[:, None]
    si = _sign1(cos_i)
    alpha = m["rough"]
    d = ggx_ndf(h[:, 2], alpha)
    g = ggx_g2(wi[:, 2] * si, wo[:, 2] * si, alpha)
    f = fresnel_conductor(torch.abs(dot(wi, h)), m["eta"], m["k"])
    denom = 4.0 * torch.abs(cos_i)
    base = torch.where(denom > 0, d * g / torch.clamp(denom, min=1e-30), 0.0)
    m_pdf = ggx_vndf_pdf(wi * si[:, None], h, alpha)
    pdf = m_pdf / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-12)
    return m["spec_refl"] * f * base[:, None], pdf


def eval_bsdf(m, wi, wo):
    """(f * |cos_o| (R, 3), solid-angle pdf (R,)) of the non-delta kinds;
    delta kinds evaluate to zero.  wi.z is the incident cosine."""
    kind = m["kind"]
    cos_o = wo[:, 2]
    abs_co = torch.abs(cos_o)
    same_side = (wi[:, 2] * cos_o) > 0
    scale = _div_pi(abs_co)
    m_on = kind == BSDF_ROUGH_DIFFUSE
    if _has(m, BSDF_ROUGH_DIFFUSE):
        scale = torch.where(m_on, scale * oren_nayar(wi, wo, m["rough"]),
                            scale)
    md = ((kind == BSDF_DIFFUSE) | (kind == BSDF_ROUGH_DIFFUSE)) & same_side
    f = torch.where(md[:, None], m["albedo"] * scale[:, None], 0.0)
    pdf = torch.where(md, _div_pi(torch.clamp(abs_co, min=0.0)), 0.0)
    mr = (kind == BSDF_ROUGH_CONDUCTOR) & same_side
    if _has(m, BSDF_ROUGH_CONDUCTOR):
        f_rc, pdf_rc = _rough_conductor_eval(m, wi, wo)
        f = torch.where(mr[:, None], f_rc, f)
        pdf = torch.where(mr, pdf_rc, pdf)
    return f, pdf


@dataclasses.dataclass
class BSDFSample:
    wo: torch.Tensor       # (R, 3) local direction
    weight: torch.Tensor   # (R, 3) f * |cos| / pdf
    pdf: torch.Tensor      # (R,) solid-angle pdf (0 for delta lobes)
    delta: torch.Tensor    # (R,) bool
    eta: torch.Tensor      # (R,) relative IOR crossed (1 unless refracted)


def _rough_conductor_sample(m, wi, sign_i, ub):
    """(wo, weight, pdf) of a GGX visible-normal sample
    (megatrace.py:1772-1799)."""
    alpha = m["rough"]
    wi_u = wi * sign_i[:, None]
    h = ggx_sample_vndf(wi_u, alpha, ub[:, 0], ub[:, 1])
    im = dot(wi_u, h)
    r = 2.0 * im[:, None] * h - wi_u
    m_pdf = ggx_vndf_pdf(wi_u, h, alpha)
    pdf = m_pdf / torch.clamp(4.0 * torch.abs(dot(r, h)), min=1e-12)
    g2 = ggx_g2(wi_u[:, 2], r[:, 2], alpha)
    g1 = ggx_g1(wi_u[:, 2], alpha)
    gw = torch.where(g1 > 0, g2 / torch.clamp(g1, min=1e-20), 0.0)
    f = fresnel_conductor(torch.abs(im), m["eta"], m["k"]) * gw[:, None]
    ok = r[:, 2] > 0
    return (r * sign_i[:, None],
            torch.where(ok[:, None], m["spec_refl"] * f, 0.0),
            torch.where(ok, pdf, 0.0))


def sample_bsdf(m, wi, uc, ub):
    """Sample an outgoing direction; uc is the component pick, ub (R, 2)
    the direction uniforms (the PSS layout's bsdf dims)."""
    kind = m["kind"]
    albedo, eta = m["albedo"], m["eta"]
    spec_refl, spec_trans = m["spec_refl"], m["spec_trans"]
    cos_i = wi[:, 2]
    sign_i = torch.where(cos_i == 0, 1.0, torch.sign(cos_i))
    zero3 = torch.zeros_like(wi)
    spec = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1)

    # diffuse: cosine hemisphere on the incident side; rough diffuse
    # samples the same and weighs the albedo by the Oren-Nayar factor
    dw = square_to_cosine_hemisphere(ub) * sign_i[:, None]
    d_pdf = _div_pi(torch.clamp(dw[:, 2] * sign_i, min=0.0))
    m_on = kind == BSDF_ROUGH_DIFFUSE
    m_d = (kind == BSDF_DIFFUSE) | m_on
    wo = torch.where(m_d[:, None], dw, zero3)
    d_w = albedo
    if _has(m, BSDF_ROUGH_DIFFUSE):
        d_w = torch.where(m_on[:, None],
                          albedo * oren_nayar(wi, dw, m["rough"])[:, None],
                          albedo)
    weight = torch.where(m_d[:, None], d_w, zero3)
    pdf = torch.where(m_d, d_pdf, 0.0)

    # mirror
    m_m = (kind == BSDF_MIRROR)[:, None]
    wo = torch.where(m_m, spec, wo)
    weight = torch.where(m_m, spec_refl, weight)

    # smooth dielectric: reflect with probability F, else refract
    m_g = kind == BSDF_DIELECTRIC
    eta_out = torch.ones_like(cos_i)
    if _has(m, BSDF_DIELECTRIC):
        eta_d = eta[:, 0]
        f_d, cos_t, _ = fresnel_dielectric(cos_i, eta_d)
        pick_refl = uc < f_d
        eta_ti = torch.where(cos_i > 0, 1.0 / eta_d, eta_d)
        refr = torch.stack([-wi[:, 0] * eta_ti, -wi[:, 1] * eta_ti,
                            torch.where(cos_i > 0, -cos_t, cos_t)], -1)
        w_refr = spec_trans * eta_ti[:, None] * eta_ti[:, None]
        wo = torch.where(m_g[:, None],
                         torch.where(pick_refl[:, None], spec, refr), wo)
        weight = torch.where(
            m_g[:, None], torch.where(pick_refl[:, None], spec_refl, w_refr),
            weight)
        eta_out = torch.where(
            m_g, torch.where(pick_refl, 1.0,
                             torch.where(cos_i > 0, eta_d, 1.0 / eta_d)), 1.0)

    # the kinds beyond the diffuse one and the mirror, evaluated only where
    # the table has them
    m_c = kind == BSDF_CONDUCTOR
    if _has(m, BSDF_CONDUCTOR):
        f_c = fresnel_conductor(torch.abs(cos_i), eta, m["k"])
        wo = torch.where(m_c[:, None], spec, wo)
        weight = torch.where(m_c[:, None], spec_refl * f_c, weight)
    m_r = kind == BSDF_ROUGH_CONDUCTOR
    if _has(m, BSDF_ROUGH_CONDUCTOR):
        wo_r, w_r, pdf_r = _rough_conductor_sample(m, wi, sign_i, ub)
        wo = torch.where(m_r[:, None], wo_r, wo)
        weight = torch.where(m_r[:, None], w_r, weight)
        pdf = torch.where(m_r, pdf_r, pdf)
    m_n = kind == BSDF_NULL
    if _has(m, BSDF_NULL):
        wo = torch.where(m_n[:, None], -wi, wo)
        weight = torch.where(m_n[:, None], 1.0, weight)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, delta=is_delta(kind),
                      eta=eta_out)
