"""Real spherical harmonics of bands l = 0..3, 16 coefficients
(counterpart of drmlt_mitsuba_tpu/core/sh.py): `eval_sh` is the
hard-coded polynomials, elementwise; projection and reconstruction are
matrix products over a batch of directions."""
from __future__ import annotations

import math

import torch

N_COEFFS = 16  # bands 0..3


def eval_sh(d):
    """The 16 real SH basis functions (no Condon-Shortley phase) at unit
    directions d (..., 3) -> (..., 16)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),        # l=0
        0.4886025119029199 * y,                          # l=1, m=-1
        0.4886025119029199 * z,                          # l=1, m=0
        0.4886025119029199 * x,                          # l=1, m=1
        1.0925484305920792 * x * y,                      # l=2, m=-2
        1.0925484305920792 * y * z,                      # l=2, m=-1
        0.31539156525252005 * (3.0 * z2 - 1.0),          # l=2, m=0
        1.0925484305920792 * x * z,                      # l=2, m=1
        0.5462742152960396 * (x2 - y2),                  # l=2, m=2
        0.5900435899266435 * y * (3.0 * x2 - y2),        # l=3, m=-3
        2.890611442640554 * x * y * z,                   # l=3, m=-2
        0.4570457994644658 * y * (5.0 * z2 - 1.0),       # l=3, m=-1
        0.3731763325901154 * z * (5.0 * z2 - 3.0),       # l=3, m=0
        0.4570457994644658 * x * (5.0 * z2 - 1.0),       # l=3, m=1
        1.445305721320277 * z * (x2 - y2),               # l=3, m=2
        0.5900435899266435 * x * (x2 - 3.0 * y2),        # l=3, m=3
    ], -1)


def project(values, dirs):
    """Monte-Carlo projection of a spherical function sampled at uniform
    unit directions: values (N,) or (N, C) at dirs (N, 3) -> coefficients
    (16,) or (16, C)."""
    basis = eval_sh(dirs)
    v = values if values.ndim > 1 else values[:, None]
    coeffs = basis.T @ v * (4.0 * math.pi / dirs.shape[0])
    return coeffs if values.ndim > 1 else coeffs[:, 0]


def reconstruct(coeffs, dirs):
    """The expansion at unit directions: (16,) or (16, C) coefficients,
    dirs (N, 3) -> (N,) or (N, C)."""
    return eval_sh(dirs) @ coeffs
