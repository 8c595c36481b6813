"""BSDF evaluation and sampling.

  * `eval_bsdf` / `sample_bsdf` over per-lane material rows: every surface
    kind but irawan.  The seven kinds of the reference's megakernels
    (megatrace.py:55-57), diffuse, rough diffuse (Oren-Nayar), mirror,
    smooth dielectric, smooth conductor, rough conductor (GGX) and null,
    are evaluated in the kernels' order (the trace kernels' twins use
    them); the others (plastic, rough plastic, thin and rough dielectric,
    phong, ward, difftrans, hk) follow the reference's render/bsdf.py
    `_eval_core` (:100) and `_sample_core` (:367);
  * `eval_bsdf_table` / `sample_bsdf_table` / `is_delta_table` over the
    whole material table (`MaterialRows`): the mask, coating and mixture
    wrappers around them (the reference's :629-690, eval_bsdf :713,
    sample_bsdf :757, is_delta_kind :863), which the path wavefront
    (integrators/path.py:trace_paths_wavefront) evaluates.

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

from drmlt_mitsuba_tpu_torch.core.frame import to_world
from drmlt_mitsuba_tpu_torch.core.math import (
    cdiv, dot, fresnel_dielectric, normalize, safe_div, safe_sqrt,
)
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.core.warp import square_to_cosine_hemisphere
from drmlt_mitsuba_tpu_torch.render.microfacet import (
    ggx_g1, ggx_g2, ggx_ndf, ggx_sample_vndf, ggx_vndf_pdf,
)
from drmlt_mitsuba_tpu_torch.render.phase import hg_phase
from drmlt_mitsuba_tpu_torch.scene.types import (
    BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFTRANS, BSDF_DIFFUSE, BSDF_HK,
    BSDF_MIRROR, BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC, BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_DIFFUSE, BSDF_ROUGH_PLASTIC,
    BSDF_THIN_DIELECTRIC, BSDF_WARD,
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
            | (kind == BSDF_CONDUCTOR) | (kind == BSDF_NULL)
            | (kind == BSDF_THIN_DIELECTRIC))


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


# ---------------------------------------------------------------------------
# The kinds beyond the kernels' seven, one lobe each: (f |cos wo|, pdf),
# zero where the lobe does not reach wo (the reference's _eval_core).
# ---------------------------------------------------------------------------

def _lobe(ok, val, pdf):
    return torch.where(ok[:, None], val, 0.0), torch.where(ok, pdf, 0.0)


def _reflect(wi, h):
    return 2.0 * dot(wi, h)[:, None] * h - wi


def _plastic_eval(m, wi, wo):
    """The diffuse base under the (Dirac) coat of smooth and rough plastic."""
    eta_d = m["eta"][:, 0]
    abs_co = torch.abs(wo[:, 2])
    f_i, _, _ = fresnel_dielectric(torch.abs(wi[:, 2]), eta_d)
    f_o, _, _ = fresnel_dielectric(abs_co, eta_d)
    val = m["albedo"] * _div_pi((1.0 - f_i) * (1.0 - f_o) * abs_co)[:, None]
    pdf = (1.0 - torch.clamp(f_i, 0.05, 0.95)) * _div_pi(abs_co)
    return _lobe((wi[:, 2] * wo[:, 2] > 0) & (wi[:, 2] > 0), val, pdf)


def _difftrans_eval(m, wi, wo):
    abs_co = torch.abs(wo[:, 2])
    return _lobe(wi[:, 2] * wo[:, 2] <= 0,
                 m["albedo"] * _div_pi(abs_co)[:, None], _div_pi(abs_co))


def _hk_eval(m, wi, wo):
    """Hanrahan-Krueger single scattering in a slab: sigma_s = spec_refl,
    sigma_a = spec_trans, thickness = the roughness column, the HG g =
    k.x; the pdf is the cosine lobe on each side less the unscattered
    share."""
    spec_refl, alpha = m["spec_refl"], m["rough"]
    abs_co = torch.abs(wo[:, 2])
    sigma_t = spec_refl + m["spec_trans"]
    alb_ss = spec_refl / torch.clamp(sigma_t, min=1e-20)
    tau = sigma_t * alpha[:, None]
    mu_i = torch.clamp(torch.abs(wi[:, 2]), min=1e-4)
    mu_o = torch.clamp(abs_co, min=1e-4)
    ph = hg_phase(m["k"][:, 0], -dot(wi, wo))[:, None]
    f_r = alb_ss * ph / (mu_i + mu_o)[:, None] * (
        1.0 - torch.exp(-tau * (1.0 / mu_i + 1.0 / mu_o)[:, None]))
    dmu = (mu_i - mu_o)[:, None]
    small = torch.abs(dmu) < 1e-4
    ratio = (torch.exp(-tau / mu_i[:, None])
             - torch.exp(-tau / mu_o[:, None])) / torch.where(small, 1.0, dmu)
    lim = tau / (mu_i * mu_i)[:, None] * torch.exp(-tau / mu_i[:, None])
    f_t = alb_ss * ph * torch.where(small, lim, ratio)
    same_side = (wi[:, 2] * wo[:, 2]) > 0
    val = torch.where(same_side[:, None], f_r, f_t) * abs_co[:, None]
    t0_mean = torch.exp(-tau.mean(-1) / mu_i)
    return val, (1.0 - t0_mean) * 0.5 * _div_pi(abs_co)


def _phong_exponent(alpha):
    return torch.clamp(2.0 / torch.clamp(alpha * alpha, min=1e-6) - 2.0,
                       min=1.0)


def _spec_weight(m):
    """The specular lobe's sampling share of phong and ward."""
    ls = luminance(m["spec_refl"])
    ld = luminance(m["albedo"])
    return torch.clamp(safe_div(ls, ls + ld, 0.5), 0.05, 0.95)


def _phong_eval(m, wi, wo):
    albedo, spec_refl = m["albedo"], m["spec_refl"]
    abs_co = torch.abs(wo[:, 2])
    n_exp = _phong_exponent(m["rough"])
    refl = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1)
    lobe = torch.clamp(dot(refl, wo), 0.0, 1.0) ** n_exp
    spec = spec_refl * ((n_exp + 2) / (2 * math.pi) * lobe)[:, None]
    w_s = _spec_weight(m)
    pdf = (1 - w_s) * _div_pi(abs_co) + w_s * (n_exp + 1) / (2 * math.pi) * lobe
    return _lobe((wi[:, 2] * wo[:, 2] > 0) & (wi[:, 2] > 0),
                 (_div_pi(albedo) + spec) * abs_co[:, None], pdf)


def _ward_eval(m, wi, wo):
    albedo, alpha = m["albedo"], m["rough"]
    abs_co = torch.abs(wo[:, 2])
    hn = normalize(wi + wo)
    a2 = alpha * alpha
    ct_h2 = torch.clamp(hn[:, 2] ** 2, min=1e-7)
    expf = torch.exp(-((1.0 - ct_h2) / ct_h2) / a2)
    norm_w = expf / (4 * math.pi * a2 * torch.clamp(
        torch.abs(wi[:, 2]) * abs_co, min=1e-7))
    val = (_div_pi(albedo) + m["spec_refl"] * norm_w[:, None]) \
        * abs_co[:, None]
    h_pdf = expf / (math.pi * a2 * ct_h2
                    * torch.clamp(torch.sqrt(ct_h2), min=1e-7))
    wo_dot_h = torch.clamp(torch.abs(dot(wo, hn)), min=1e-7)
    w_s = _spec_weight(m)
    pdf = (1 - w_s) * _div_pi(abs_co) + w_s * h_pdf / (4 * wo_dot_h)
    return _lobe((wi[:, 2] * wo[:, 2] > 0) & (wi[:, 2] > 0), val, pdf)


def _rough_dielectric_eval(m, wi, wo):
    """Walter et al. 2007 rough dielectric (GGX, the visible-normal pdf):
    its reflection and refraction lobes."""
    eta_d, alpha = m["eta"][:, 0], m["rough"]
    cos_i, cos_o = wi[:, 2], wo[:, 2]
    sign_i = torch.sign(torch.where(cos_i == 0, 1.0, cos_i))[:, None]
    wi_u, wo_u = wi * sign_i, wo * sign_i
    reflecting = (cos_i * cos_o) > 0
    eta_rel = torch.where(cos_i > 0, eta_d, 1.0 / eta_d)
    h_r = normalize(wi_u + wo_u)
    h_t = -(wi_u + wo_u * eta_rel[:, None])
    h_t = h_t / torch.clamp(torch.sqrt(dot(h_t, h_t)), min=1e-12)[:, None]
    h_t = h_t * torch.sign(h_t[:, 2:3])
    h = torch.where(reflecting[:, None], h_r, h_t)
    d = ggx_ndf(h[:, 2], alpha)
    g = ggx_g2(wi_u[:, 2], wo_u[:, 2], alpha)
    i_dot_h = dot(wi_u, h)
    o_dot_h = dot(wo_u, h)
    f, _, _ = fresnel_dielectric(i_dot_h, eta_d)
    refl_val = m["spec_refl"] * safe_div(d * g * f,
                                         4.0 * torch.abs(cos_i))[:, None]
    denom = i_dot_h + eta_rel * o_dot_h
    jac = safe_div(eta_rel * eta_rel * torch.abs(o_dot_h),
                   torch.clamp(denom * denom, min=1e-12))
    trans = safe_div(torch.abs(i_dot_h) * d * g * (1.0 - f),
                     torch.abs(cos_i)) * jac / torch.clamp(
        torch.abs(cos_o), min=1e-7) / (eta_rel * eta_rel)
    trans_val = m["spec_trans"] * (trans * torch.abs(cos_o))[:, None]
    m_pdf = ggx_vndf_pdf(wi_u, h, alpha)
    pdf_refl = f * m_pdf / torch.clamp(4.0 * torch.abs(o_dot_h), min=1e-12)
    pdf_trans = (1.0 - f) * m_pdf * jac
    side_ok = torch.where(reflecting, (i_dot_h > 0) & (o_dot_h > 0),
                          (i_dot_h > 0) & (o_dot_h < 0))
    return _lobe((h[:, 2] > 0) & side_ok,
                 torch.where(reflecting[:, None], refl_val, trans_val),
                 torch.where(reflecting, pdf_refl, pdf_trans))


# (kinds, lobe) of the kinds beyond the kernels' seven
_EXTRA_LOBES = (((BSDF_PLASTIC, BSDF_ROUGH_PLASTIC), _plastic_eval),
                ((BSDF_DIFFTRANS,), _difftrans_eval),
                ((BSDF_HK,), _hk_eval),
                ((BSDF_PHONG,), _phong_eval),
                ((BSDF_WARD,), _ward_eval),
                ((BSDF_ROUGH_DIELECTRIC,), _rough_dielectric_eval))


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
    for kinds, lobe in _EXTRA_LOBES:
        if any(_has(m, k) for k in kinds):
            mk = kind == kinds[0]
            for k in kinds[1:]:
                mk = mk | (kind == k)
            f_k, pdf_k = lobe(m, wi, wo)
            f = torch.where(mk[:, None], f_k, f)
            pdf = torch.where(mk, pdf_k, pdf)
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
    # the kinds beyond the kernels' seven (the reference's _sample_core),
    # each only where the table has it
    delta = is_delta(kind)
    alpha, eta_d = m["rough"], eta[:, 0]
    wi_u = wi * sign_i[:, None]

    def put(kk, wo_k, w_k, pdf_k, delta_k=None, eta_k=None):
        nonlocal wo, weight, pdf, delta, eta_out
        mk = kind == kk
        wo = torch.where(mk[:, None], wo_k, wo)
        weight = torch.where(mk[:, None], w_k, weight)
        pdf = torch.where(mk, pdf_k, pdf)
        if delta_k is not None:
            delta = torch.where(mk, delta_k, delta)
        if eta_k is not None:
            eta_out = torch.where(mk, eta_k, eta_out)

    def via_eval(lobe, wo_k):
        """(weight, pdf) of wo_k sampled from `lobe`'s own pdf."""
        v, p = lobe(m, wi, wo_k)
        return v / torch.clamp(p, min=1e-12)[:, None], p

    zero = torch.zeros_like(cos_i)
    if _has(m, BSDF_THIN_DIELECTRIC):
        f_d, _, _ = fresnel_dielectric(cos_i, eta_d)
        f_thin = torch.where(f_d < 1.0, f_d * 2.0 / (1.0 + f_d), 1.0)
        pick = (uc < f_thin)[:, None]
        put(BSDF_THIN_DIELECTRIC, torch.where(pick, spec, -wi),
            torch.where(pick, spec_refl, spec_trans), zero)
    if _has(m, BSDF_PLASTIC) or _has(m, BSDF_ROUGH_PLASTIC):
        f_i, _, _ = fresnel_dielectric(torch.abs(cos_i), eta_d)
        spec_prob = torch.clamp(f_i, 0.05, 0.95)
        pick_spec = uc < spec_prob
        wo_pl = torch.where(pick_spec[:, None], spec, dw)
        f_o, _, _ = fresnel_dielectric(torch.abs(wo_pl[:, 2]), eta_d)
        w_pl = torch.where(
            pick_spec[:, None], spec_refl * safe_div(f_i, spec_prob)[:, None],
            albedo * safe_div((1.0 - f_i) * (1.0 - f_o),
                              1.0 - spec_prob)[:, None])
        pdf_pl = torch.where(pick_spec, 0.0, (1.0 - spec_prob) * d_pdf)
        for kk in (BSDF_PLASTIC, BSDF_ROUGH_PLASTIC):
            put(kk, wo_pl, w_pl, pdf_pl, pick_spec)
    if _has(m, BSDF_DIFFTRANS):
        put(BSDF_DIFFTRANS, -dw, albedo, d_pdf)
    if _has(m, BSDF_HK):
        tau = (spec_refl + spec_trans) * alpha[:, None]
        mu_i = torch.clamp(torch.abs(cos_i), min=1e-4)
        t0 = torch.exp(-tau / mu_i[:, None])
        t0_mean = torch.clamp(t0.mean(-1), 1e-4, 1.0 - 1e-4)
        pick_delta = uc < t0_mean
        pick_refl = (uc - t0_mean) / (1.0 - t0_mean) < 0.5
        side = torch.where(pick_refl, 1.0, -1.0) * sign_i
        wo_s = square_to_cosine_hemisphere(ub) * side[:, None]
        w_s, p_s = via_eval(_hk_eval, wo_s)
        put(BSDF_HK, torch.where(pick_delta[:, None], -wi, wo_s),
            torch.where(pick_delta[:, None], t0 / t0_mean[:, None], w_s),
            torch.where(pick_delta, 0.0, p_s), pick_delta)
    if _has(m, BSDF_PHONG) or _has(m, BSDF_WARD):
        pick_spec = uc < _spec_weight(m)
    if _has(m, BSDF_PHONG):
        n_exp = _phong_exponent(alpha)
        cos_l = ub[:, 0] ** (1.0 / (n_exp + 1.0))
        sin_l = safe_sqrt(1 - cos_l * cos_l)
        phi_l = 2 * math.pi * ub[:, 1]
        lobe = torch.stack([sin_l * torch.cos(phi_l),
                            sin_l * torch.sin(phi_l), cos_l], -1)
        refl_u = torch.stack([-wi_u[:, 0], -wi_u[:, 1], wi_u[:, 2]], -1)
        wo_ph = torch.where(pick_spec[:, None],
                            to_world(refl_u, lobe) * sign_i[:, None], dw)
        w_ph, p_ph = via_eval(_phong_eval, wo_ph)
        ok = (wo_ph[:, 2] * sign_i > 0)[:, None]
        put(BSDF_PHONG, wo_ph, torch.where(ok, w_ph, 0.0), p_ph)
    if _has(m, BSDF_WARD):
        t2 = -(alpha * alpha) * torch.log(torch.clamp(ub[:, 0], min=1e-38))
        ct = 1.0 / torch.sqrt(1.0 + t2)
        st = safe_sqrt(1 - ct * ct)
        phi_h = 2 * math.pi * ub[:, 1]
        hvec = torch.stack([st * torch.cos(phi_h), st * torch.sin(phi_h),
                            ct], -1)
        wo_wd = torch.where(pick_spec[:, None],
                            _reflect(wi_u, hvec) * sign_i[:, None], dw)
        w_wd, p_wd = via_eval(_ward_eval, wo_wd)
        ok = (wo_wd[:, 2] * sign_i > 0)[:, None]
        put(BSDF_WARD, wo_wd, torch.where(ok, w_wd, 0.0), p_wd)
    if _has(m, BSDF_ROUGH_DIELECTRIC):
        h = ggx_sample_vndf(wi_u, alpha, ub[:, 0], ub[:, 1])
        i_dot_h = dot(wi_u, h)
        f_rd, _, _ = fresnel_dielectric(i_dot_h * sign_i, eta_d)
        eta_rel = torch.where(cos_i > 0, eta_d, 1.0 / eta_d)
        inv_eta = 1.0 / eta_rel
        under = 1.0 + inv_eta * inv_eta * (i_dot_h * i_dot_h - 1.0)
        refl = (uc < f_rd) | (under < 0)
        wo_refr_u = ((inv_eta * i_dot_h - safe_sqrt(under))[:, None] * h
                     - inv_eta[:, None] * wi_u)
        wo_rd_u = torch.where(refl[:, None], _reflect(wi_u, h), wo_refr_u)
        wo_rd = wo_rd_u * sign_i[:, None]
        _, p_rd = _rough_dielectric_eval(m, wi, wo_rd)
        base_w = safe_div(ggx_g2(wi_u[:, 2], wo_rd_u[:, 2], alpha),
                          ggx_g1(wi_u[:, 2], alpha))[:, None]
        w_rd = torch.where(refl[:, None], spec_refl * base_w,
                           spec_trans * base_w / (eta_rel * eta_rel)[:, None])
        ok = (torch.abs(wo_rd_u[:, 2]) > 1e-6)[:, None]
        put(BSDF_ROUGH_DIELECTRIC, wo_rd, torch.where(ok, w_rd, 0.0), p_rd,
            eta_k=torch.where(refl, 1.0,
                              torch.where(cos_i > 0, eta_d, 1.0 / eta_d)))
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, delta=delta,
                      eta=eta_out)


# ---------------------------------------------------------------------------
# The material table with the mask, coating and mixture wrappers (the
# path wavefront's BSDF; the reference's render/bsdf.py :629-690, eval_bsdf
# :713, sample_bsdf :757, is_delta_kind :863) around eval_bsdf /
# sample_bsdf.
# ---------------------------------------------------------------------------

# the kinds the wavefront renders (irawan's woven cloth is not ported)
TABLE_KINDS = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
               BSDF_ROUGH_CONDUCTOR, BSDF_PLASTIC, BSDF_ROUGH_PLASTIC,
               BSDF_THIN_DIELECTRIC, BSDF_ROUGH_DIELECTRIC, BSDF_MIRROR,
               BSDF_NULL, BSDF_PHONG, BSDF_WARD, BSDF_ROUGH_DIFFUSE,
               BSDF_DIFFTRANS, BSDF_HK)


@dataclasses.dataclass(frozen=True)
class MaterialRows:
    """The material table on one device: `mat` (M, 18) of
    ops/megatrace.py:pack_mat_table (kind, albedo, eta, k, roughness,
    spec_refl, spec_trans, tex_id), the modifier columns (None where no
    row has the modifier) and the static set of kinds."""
    mat: torch.Tensor
    kinds: frozenset
    opacity: torch.Tensor | None = None      # (M, 3)
    mix_other: torch.Tensor | None = None    # (M,) int64
    mix_weight: torch.Tensor | None = None   # (M,)
    coat_eta: torch.Tensor | None = None     # (M,)
    coat_sigma_a: torch.Tensor | None = None  # (M, 3)
    mix_depth: int = 0
    mix_kinds: frozenset = frozenset()   # the kinds of the mixture links
    mix_root_kinds: frozenset = frozenset()  # of the rows that mix

    @property
    def modified(self) -> bool:
        return (self.opacity is not None or self.mix_other is not None
                or self.coat_eta is not None)


def material_table_rows(table, mat) -> MaterialRows:
    """MaterialRows of a MaterialTable whose packed (M, 18) form is `mat`
    (on the device the rows are to live on)."""
    dev = mat.device

    def f(x):
        return None if x is None else x.to(device=dev, dtype=torch.float32)

    kinds = frozenset(int(k) for k in table.kind.unique())
    if not kinds <= set(TABLE_KINDS):
        raise NotImplementedError(
            f"BSDF kinds {sorted(kinds - set(TABLE_KINDS))} not yet ported "
            "(irawan)")
    mix_kinds = mix_root_kinds = frozenset()
    if table.mix_other is not None:
        # the rows a mixture chain reaches past its root; the kind of row
        # 0 joins them, which the lanes without a mixture read at weight 0
        other = table.mix_other.tolist()
        reach = {0}
        todo = [o for o in other if o >= 0]
        while todo:
            r = todo.pop()
            if r not in reach:
                reach.add(r)
                todo += [other[r]] if other[r] >= 0 else []
        mix_kinds = frozenset(int(table.kind[r]) for r in reach)
        mix_root_kinds = frozenset(
            int(k) for k in table.kind[table.mix_other >= 0])
    return MaterialRows(
        mat=mat, kinds=kinds, mix_kinds=mix_kinds,
        mix_root_kinds=mix_root_kinds, opacity=f(table.opacity),
        mix_other=(None if table.mix_other is None
                   else table.mix_other.to(device=dev, dtype=torch.int64)),
        mix_weight=f(table.mix_weight), coat_eta=f(table.coat_eta),
        coat_sigma_a=f(table.coat_sigma_a),
        mix_depth=int(table.mix_depth) if table.mix_other is not None else 0)


def _mixture_params(tab: MaterialRows, mat_id):
    mid = mat_id.to(torch.int64)
    other = tab.mix_other[mid]
    w = torch.where(other >= 0, torch.clamp(tab.mix_weight[mid], 0.0, 1.0),
                    0.0)
    return torch.clamp(other, min=0), w


def _coating_params(tab: MaterialRows, mat_id, cos_i):
    """(coated, F(wi), p_spec, eta, sigma_a) of the coating layer."""
    mid = mat_id.to(torch.int64)
    ce, sig = tab.coat_eta[mid], tab.coat_sigma_a[mid]
    coated = ce > 0
    e = torch.where(coated, torch.clamp(ce, min=1.0 + 1e-4), 1.5)
    f_i, _, _ = fresnel_dielectric(cos_i, e)
    f_i = torch.where(coated, f_i, 0.0)
    p_spec = torch.where(coated, torch.clamp(f_i, 0.05, 0.95), 0.0)
    return coated, f_i, p_spec, e, sig


def _coat_absorb(coated, sig, cos_i, cos_o):
    secs = (1.0 / torch.clamp(torch.abs(cos_i), min=1e-4)
            + 1.0 / torch.clamp(torch.abs(cos_o), min=1e-4))
    return torch.where(coated[:, None], torch.exp(-sig * secs[:, None]), 1.0)


def _mixture_eval(tab: MaterialRows, mat_id, albedo, wi, wo,
                  root_kinds=None):
    """eval_bsdf with the mixture chain folded in; components past the
    root read their row's constant albedo.  `root_kinds` limits the
    root's lobes (default: every kind of the table)."""
    v1, p1 = eval_bsdf(material_rows(
        tab.mat, mat_id, tab.kinds if root_kinds is None else root_kinds,
        albedo), wi, wo)
    if tab.mix_other is None:
        return v1, p1
    other, w = _mixture_params(tab, mat_id)
    val = (1.0 - w)[:, None] * v1
    pdf = (1.0 - w) * p1
    scale, cur = w, other
    for _ in range(tab.mix_depth):
        v2, p2 = eval_bsdf(material_rows(tab.mat, cur, tab.mix_kinds),
                           wi, wo)
        other, w = _mixture_params(tab, cur)
        val = val + (scale * (1.0 - w))[:, None] * v2
        pdf = pdf + scale * (1.0 - w) * p2
        scale, cur = scale * w, other
    return val, pdf


def eval_bsdf_table(tab: MaterialRows, mat_id, albedo, wi, wo):
    """(f |cos wo| (R, 3), pdf (R,)) of the material rows mat_id with
    albedo (R, 3) for local directions wi, wo: the reference's eval_bsdf
    with its wrappers (mask -> coating -> mixture -> eval_bsdf)."""
    val, pdf = _mixture_eval(tab, mat_id, albedo, wi, wo)
    if not tab.modified:
        return val, pdf
    cos_i, cos_o = wi[:, 2], wo[:, 2]
    mid = mat_id.to(torch.int64)
    if tab.coat_eta is not None:
        coated, f_i, p_spec, e, sig = _coating_params(tab, mat_id, cos_i)
        f_o, _, _ = fresnel_dielectric(cos_o, e)
        f_o = torch.where(coated, f_o, 0.0)
        val = val * ((1.0 - f_i) * (1.0 - f_o))[:, None]
        val = val * _coat_absorb(coated, sig, cos_i, cos_o)
        pdf = (1.0 - p_spec) * pdf
    if tab.opacity is not None:
        opac = tab.opacity[mid]
        val = val * opac
        pdf = pdf * torch.clamp(opac.mean(-1), 0.0, 1.0)
    return val, pdf


def sample_bsdf_table(tab: MaterialRows, mat_id, albedo, wi, u3):
    """Sample the material rows mat_id (the reference's sample_bsdf with
    its wrappers); u3 (R, 3) = (component, u, v).  The wrappers' picks
    rescale the component uniform in turn: the mask, the coating, the
    mixture chain, then sample_bsdf sees what is left."""
    mid = mat_id.to(torch.int64)
    uc = u3[:, 0]
    cos_i = wi[:, 2]
    if tab.opacity is not None:
        opac = tab.opacity[mid]
        p_keep = torch.clamp(opac.mean(-1), 0.0, 1.0)
        pick_null = uc >= p_keep
        uc = torch.where(pick_null, safe_div(uc - p_keep, 1.0 - p_keep),
                         safe_div(uc, torch.clamp(p_keep, min=1e-6)))
    if tab.coat_eta is not None:
        coated, f_i, p_spec, e, sig = _coating_params(tab, mat_id, cos_i)
        pick_spec = uc < p_spec
        uc = torch.where(pick_spec, uc, safe_div(uc - p_spec, 1.0 - p_spec))
    mat_eff, alb_eff = mid, albedo
    if tab.mix_other is not None:
        wmix_root = _mixture_params(tab, mat_id)[1]
        cur = mid
        done = torch.zeros_like(uc, dtype=torch.bool)
        for _ in range(tab.mix_depth + 1):
            other, w = _mixture_params(tab, cur)
            pick = ~done & (uc < w)
            uc = torch.where(
                pick, safe_div(uc, torch.clamp(w, min=1e-6)),
                torch.where(done, uc, safe_div(
                    uc - w, torch.clamp(1.0 - w, min=1e-6))))
            done = done | ~pick
            cur = torch.where(pick, other, cur)
        mat_eff = cur
        alb_eff = torch.where((cur == mid)[:, None], albedo,
                              tab.mat[cur, 1:4])
    if tab.modified:
        uc = torch.clamp(uc, 0.0, 1.0 - 1e-7)
    s = sample_bsdf(material_rows(tab.mat, mat_eff, tab.kinds, alb_eff), wi,
                    uc, u3[:, 1:3])
    wo, pdf, delta, eta_out = s.wo, s.pdf, s.delta, s.eta
    # the reference's samplers give nothing at a grazing incidence
    weight = torch.where((torch.abs(cos_i) < 1e-7)[:, None], 0.0, s.weight)
    if tab.mix_other is not None:
        # only the lanes whose root row mixes read it
        v_mix, p_mix = _mixture_eval(tab, mat_id, albedo, wi, wo,
                                     tab.mix_root_kinds)
        use_nd = (wmix_root > 0) & ~delta
        weight = torch.where(use_nd[:, None],
                             v_mix / torch.clamp(p_mix, min=1e-12)[:, None],
                             weight)
        pdf = torch.where(use_nd, p_mix, pdf)
    if tab.coat_eta is not None:
        cos_o = wo[:, 2]
        f_o, _, _ = fresnel_dielectric(cos_o, e)
        f_o = torch.where(coated, f_o, 0.0)
        scale = torch.where(coated, safe_div((1.0 - f_i) * (1.0 - f_o),
                                             1.0 - p_spec, 1.0), 1.0)
        weight = weight * scale[:, None] * _coat_absorb(coated, sig, cos_i,
                                                        cos_o)
        pdf = torch.where(coated, (1.0 - p_spec) * pdf, pdf)
        wo_spec = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1)
        ps = pick_spec[:, None]
        wo = torch.where(ps, wo_spec, wo)
        weight = torch.where(ps, safe_div(f_i, p_spec)[:, None]
                             * torch.ones_like(weight), weight)
        pdf = torch.where(pick_spec, 0.0, pdf)
        delta = delta | pick_spec
        eta_out = torch.where(pick_spec, 1.0, eta_out)
    if tab.opacity is not None:
        w_null = (1.0 - opac) * safe_div(torch.ones_like(p_keep),
                                         1.0 - p_keep, 0.0)[:, None]
        w_kept = weight * opac * safe_div(torch.ones_like(p_keep), p_keep,
                                          0.0)[:, None]
        pn = pick_null[:, None]
        wo = torch.where(pn, -wi, wo)
        weight = torch.where(pn, w_null, w_kept)
        pdf = torch.where(pick_null, 0.0, pdf * p_keep)
        delta = delta | pick_null
        eta_out = torch.where(pick_null, 1.0, eta_out)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, delta=delta,
                      eta=eta_out)


def is_delta_table(tab: MaterialRows, mat_id):
    """True for rows whose every lobe is Dirac (no NEE): the reference's
    is_delta_kind, a mixture all-Dirac only if every component is."""
    mid = mat_id.to(torch.int64)
    out = is_delta(tab.mat[mid, 0].to(torch.int64))
    if tab.mix_other is not None:
        cur = mid
        for _ in range(tab.mix_depth + 1):
            other, w = _mixture_params(tab, cur)
            out = out & ((w <= 0) | is_delta(tab.mat[other, 0].to(
                torch.int64)))
            cur = other
    return out
