"""GGX microfacet functions with visible-normal sampling (counterpart of
drmlt_mitsuba_tpu/render/microfacet.py).

Written in the order the CUDA kernels evaluate them
(csrc/path_trace.cuh: ggx_*), which follow the reference kernel's
megatrace.py:_ggx_* (:222-278): cosines are the z components of local
directions, alpha the isotropic roughness, and every vector is normalised
by a square root and a division.  Per-lane tensors: directions (R, 3),
the rest (R,).
"""
from __future__ import annotations

import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import cross, dot, normalize


def ggx_lambda(cz, alpha):
    """Smith Lambda of a direction with cosine cz."""
    cz = torch.abs(cz)
    s2 = torch.clamp(1.0 - cz * cz, min=0.0)
    a2 = alpha * alpha
    return 0.5 * (torch.sqrt(torch.clamp(
        1.0 + a2 * s2 / torch.clamp(cz * cz, min=1e-12), min=0.0)) - 1.0)


def ggx_g1(cz, alpha):
    return 1.0 / (1.0 + ggx_lambda(cz, alpha))


def ggx_g2(ci, co, alpha):
    """Height-correlated Smith shadowing-masking."""
    return 1.0 / (1.0 + ggx_lambda(ci, alpha) + ggx_lambda(co, alpha))


def ggx_ndf(mz, alpha):
    """GGX normal distribution D(m) of a half vector with cosine mz."""
    a2 = alpha * alpha
    c2 = mz * mz
    den = c2 * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * den * den, min=1e-12)
    return torch.where(mz > 0, d, 0.0)


def ggx_sample_vndf(wi, alpha, u1, u2):
    """Heitz 2018 visible-normal sample around wi (upper hemisphere):
    the unit half vector m (R, 3)."""
    v = torch.stack([alpha * wi[:, 0], alpha * wi[:, 1], wi[:, 2]], -1)
    v = v / torch.sqrt(torch.clamp(dot(v, v), min=1e-24))[:, None]
    lensq = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
    nl = torch.sqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-18
    zero = torch.zeros_like(nl)
    t1 = torch.stack([torch.where(big, -v[:, 1] / nl, 1.0),
                      torch.where(big, v[:, 0] / nl, 0.0), zero], -1)
    t2 = cross(v, t1)
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    n = p1[:, None] * t1 + p2[:, None] * t2 + p3[:, None] * v
    return normalize(torch.stack([alpha * n[:, 0], alpha * n[:, 1],
                                  torch.clamp(n[:, 2], min=1e-6)], -1))


def ggx_vndf_pdf(wi, m, alpha):
    """pdf of ggx_sample_vndf in the half-vector measure."""
    g1 = ggx_g1(wi[:, 2], alpha)
    d = ggx_ndf(m[:, 2], alpha)
    dot_im = torch.clamp(dot(wi, m), min=0.0)
    return g1 * dot_im * d / torch.clamp(torch.abs(wi[:, 2]), min=1e-12)
