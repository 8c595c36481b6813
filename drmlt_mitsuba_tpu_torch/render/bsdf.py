"""BSDF evaluation and sampling for the kinds the port renders: diffuse,
rough diffuse (Oren-Nayar), mirror and smooth dielectric.

These are the plain-PyTorch forms of what the reference's kernels compute
in megatrace.py `_oren_nayar_term` (:1584), `_eval_kinds` (:1602) and
`_sample_kinds` (:1659), which in turn mirror render/bsdf.py.  Inputs are
per-lane: `kind` (R,), material parameters (R, 3) and the roughness column
(R,), local-frame directions (R, 3).  The other three kernel kinds
(conductor, rough conductor, null) come later.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import fresnel_dielectric, safe_sqrt
from drmlt_mitsuba_tpu_torch.core.warp import square_to_cosine_hemisphere
from drmlt_mitsuba_tpu_torch.scene.types import (
    BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_MIRROR, BSDF_ROUGH_DIFFUSE,
)

SUPPORTED_KINDS = (BSDF_DIFFUSE, BSDF_MIRROR, BSDF_DIELECTRIC,
                   BSDF_ROUGH_DIFFUSE)


def _div_pi(x):
    """x / pi as a true division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which rounds
    differently from the kernels' x / pi."""
    return x / torch.full((), math.pi, dtype=x.dtype, device=x.device)


def is_delta(kind):
    return (kind == BSDF_MIRROR) | (kind == BSDF_DIELECTRIC)


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


def eval_bsdf(kind, albedo, rough, wi, wo):
    """(f * |cos_o| (R, 3), solid-angle pdf (R,)) of the non-delta kinds;
    delta kinds evaluate to zero.  wi.z is the incident cosine."""
    cos_o = wo[:, 2]
    abs_co = torch.abs(cos_o)
    same_side = (wi[:, 2] * cos_o) > 0
    scale = _div_pi(abs_co)
    scale = torch.where(kind == BSDF_ROUGH_DIFFUSE,
                        scale * oren_nayar(wi, wo, rough), scale)
    m = ((kind == BSDF_DIFFUSE) | (kind == BSDF_ROUGH_DIFFUSE)) & same_side
    f = torch.where(m[:, None], albedo * scale[:, None], 0.0)
    pdf = torch.where(m, _div_pi(torch.clamp(abs_co, min=0.0)), 0.0)
    return f, pdf


@dataclasses.dataclass
class BSDFSample:
    wo: torch.Tensor       # (R, 3) local direction
    weight: torch.Tensor   # (R, 3) f * |cos| / pdf
    pdf: torch.Tensor      # (R,) solid-angle pdf (0 for delta lobes)
    delta: torch.Tensor    # (R,) bool
    eta: torch.Tensor      # (R,) relative IOR crossed (1 unless refracted)


def sample_bsdf(kind, albedo, rough, eta, spec_refl, spec_trans, wi, uc,
                ub):
    """Sample an outgoing direction; uc is the component pick, ub (R, 2)
    the direction uniforms (the PSS layout's bsdf dims)."""
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
    d_w = torch.where(m_on[:, None],
                      albedo * oren_nayar(wi, dw, rough)[:, None], albedo)
    weight = torch.where(m_d[:, None], d_w, zero3)
    pdf = torch.where(m_d, d_pdf, 0.0)

    # mirror
    m_m = (kind == BSDF_MIRROR)[:, None]
    wo = torch.where(m_m, spec, wo)
    weight = torch.where(m_m, spec_refl, weight)

    # smooth dielectric: reflect with probability F, else refract
    eta_d = eta[:, 0]
    f_d, cos_t, _ = fresnel_dielectric(cos_i, eta_d)
    pick_refl = uc < f_d
    eta_ti = torch.where(cos_i > 0, 1.0 / eta_d, eta_d)
    refr = torch.stack([-wi[:, 0] * eta_ti, -wi[:, 1] * eta_ti,
                        torch.where(cos_i > 0, -cos_t, cos_t)], -1)
    w_refr = spec_trans * eta_ti[:, None] * eta_ti[:, None]
    m_g = kind == BSDF_DIELECTRIC
    wo = torch.where(m_g[:, None],
                     torch.where(pick_refl[:, None], spec, refr), wo)
    weight = torch.where(m_g[:, None],
                         torch.where(pick_refl[:, None], spec_refl, w_refr),
                         weight)
    eta_out = torch.where(
        m_g, torch.where(pick_refl, 1.0,
                         torch.where(cos_i > 0, eta_d, 1.0 / eta_d)), 1.0)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, delta=is_delta(kind),
                      eta=eta_out)
