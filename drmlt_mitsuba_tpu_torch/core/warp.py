"""Square -> distribution warps (counterpart of drmlt_mitsuba_tpu/core/warp.py).

Only the warps the path technique consumes: the concentric disk, the
cosine hemisphere built on it, and the uniform triangle.
"""
from __future__ import annotations

import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import safe_sqrt


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
