"""Small math helpers (counterpart of drmlt_mitsuba_tpu/core/math.py).

Elementwise torch functions; vector axes are the last axis.  Dot products,
cross products and norms are written out component by component, in the
order the CUDA kernels evaluate them, so that the plain versions and the
kernels round alike.
"""
from __future__ import annotations

import torch

RAY_EPS = 1e-4  # min-t offset to avoid self-intersection


def safe_sqrt(x):
    """sqrt(max(x, 0)), with a backward that is 0, not inf, at x <= 0."""
    ok = x > 0.0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_div(a, b, default=0.0):
    """a / b where b may be 0; returns `default` there."""
    ok = torch.abs(b) > 0
    return torch.where(ok, a / torch.where(ok, b, 1.0), default)


def mis_power(pdf_a, pdf_b):
    """Power heuristic (beta = 2), as in the reference `path` integrator."""
    a = pdf_a * pdf_a
    b = pdf_b * pdf_b
    s = a + b
    return torch.where(s > 0, a / torch.where(s > 0, s, 1.0), 0.0)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-30))[..., None]


def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel for relative IOR `eta` (inside /
    outside); cos_i is signed w.r.t. the normal.  Returns (F, |cos_t|, tir)."""
    eta_it = torch.where(cos_i > 0, eta, 1.0 / eta)
    ci = torch.abs(cos_i)
    sin2_t = (1.0 - ci * ci) / (eta_it * eta_it)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_s = safe_div(ci - eta_it * cos_t, ci + eta_it * cos_t)
    r_p = safe_div(eta_it * ci - cos_t, eta_it * ci + cos_t)
    f = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, f), cos_t, tir
