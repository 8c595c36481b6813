"""Square -> distribution warps (counterpart of drmlt_mitsuba_tpu/core/warp.py).

Every warp maps (..., 2) uniforms elementwise to samples and is paired
with its pdf where it has one, so core/chisquare.py can test it: the
concentric disk, the cosine and uniform hemispheres, the uniform sphere,
triangle and cone, Box-Muller, the tent and von Mises-Fisher.
"""
from __future__ import annotations

import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWO_PI = 0.5 / math.pi


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping; u is (..., 2)."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    zero = (x == 0) & (y == 0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    ratio = torch.where(
        use_x,
        torch.where(x != 0, y / torch.where(x != 0, x, 1.0), 0.0),
        torch.where(y != 0, x / torch.where(y != 0, y, 1.0), 0.0),
    )
    phi = torch.where(use_x, (math.pi / 4.0) * ratio,
                      (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    r = torch.where(zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere direction around +z."""
    p = square_to_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - p[..., 0] * p[..., 0]
                               - p[..., 1] * p[..., 1], min=0.0))
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_uniform_triangle(u):
    """Barycentric (b0, b1) uniform on the unit triangle (sqrt warp)."""
    t = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - t, t * u[..., 1]], -1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def _polar(z, u1):
    """Unit vectors of height z at azimuth 2 pi u1."""
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_sphere(u):
    return _polar(1.0 - 2.0 * u[..., 0], u[..., 1])


def square_to_uniform_sphere_pdf(d):
    return torch.full(d.shape[:-1], 0.25 * INV_PI, device=d.device)


def square_to_uniform_hemisphere(u):
    return _polar(u[..., 0], u[..., 1])


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0, 0.5 * INV_PI, 0.0)


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction in the cone around +z of aperture cos_cutoff."""
    return _polar(1.0 - u[..., 0] * (1.0 - cos_cutoff), u[..., 1])


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWO_PI / (1.0 - cos_cutoff)


def square_to_std_normal(u):
    """Box-Muller: two U(0, 1) -> two N(0, 1) (the reference's
    GaussianKernel::sample form)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u[..., 0],
                                                min=1e-38)))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def interval_to_tent(u):
    """U(0, 1) -> the tent distribution on [-1, 1]."""
    lo = u < 0.5
    s = torch.where(lo, 1.0, -1.0)
    x = torch.where(lo, 2.0 * u, 2.0 - 2.0 * u)
    return s * (1.0 - safe_sqrt(x))


def square_to_vmf(u, kappa):
    """von Mises-Fisher direction around +z with concentration kappa."""
    w = 1.0 + torch.log(torch.clamp(u[..., 0], min=1e-38)
                        + (1.0 - u[..., 0]) * math.exp(-2.0 * kappa)) / kappa
    return _polar(w, u[..., 1])


def square_to_vmf_pdf(d, kappa):
    """kappa e^(kappa cos) / (2 pi (e^kappa - e^-kappa))."""
    c = kappa / (2.0 * math.pi * (1.0 - math.exp(-2.0 * kappa)))
    return c * torch.exp(kappa * (d[..., 2] - 1.0))
