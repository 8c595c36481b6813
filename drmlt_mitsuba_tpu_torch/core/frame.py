"""Orthonormal shading frames (counterpart of drmlt_mitsuba_tpu/core/frame.py).

Tangents come from the branchless Duff et al. 2017 construction; vectors
are (..., 3).
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.math import dot


def coordinate_system(n):
    """(s, t) tangent and bitangent for the unit normal n."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return s, t


def to_local(n, v):
    """World vector v into the local frame of n (z = n)."""
    s, t = coordinate_system(n)
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], -1)


def to_world(n, v):
    """Local vector v (z = n) back to world space."""
    s, t = coordinate_system(n)
    return v[..., 0:1] * s + v[..., 1:2] * t + v[..., 2:3] * n
