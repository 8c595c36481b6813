"""Quadrature, spline and root-finding helpers (counterpart of
drmlt_mitsuba_tpu/core/quad.py): Gauss-Legendre / Gauss-Lobatto nodes, a
Gauss-Legendre integral, Catmull-Rom interpolation of uniform samples and
a vectorised Brent-Dekker root finder.

Nodes and weights are computed in float64 by numpy and returned as float32
tensors; the rest is elementwise torch on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(a, device=None):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def gauss_legendre(n: int, device=None):
    """(nodes, weights) on [-1, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return _f32(x, device), _f32(w, device)


def gauss_lobatto(n: int, device=None):
    """Gauss-Lobatto (nodes, weights) on [-1, 1], endpoints included."""
    if n < 2:
        raise ValueError(f"gauss_lobatto needs n >= 2, got {n}")
    # the interior nodes are the roots of P'_{n-1}
    leg = np.polynomial.legendre.Legendre.basis(n - 1)
    x = np.concatenate([[-1.0], np.sort(leg.deriv().roots()), [1.0]])
    w = 2.0 / (n * (n - 1) * leg(x) ** 2)
    return _f32(x, device), _f32(w, device)


def integrate(f, a: float, b: float, n: int = 64, device=None):
    """The integral of f over [a, b] by n-point Gauss-Legendre; f maps a
    (n,) tensor of nodes to (n,) values."""
    x, w = gauss_legendre(n, device)
    xm = 0.5 * (a + b) + 0.5 * (b - a) * x
    return 0.5 * (b - a) * torch.sum(w * f(xm))


def catmull_rom(x, xs, ys):
    """Catmull-Rom interpolation at x of samples ys at uniform xs."""
    n = ys.shape[0]
    t = (x - xs[0]) / (xs[1] - xs[0])
    i = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    f = t - i
    p0 = ys[torch.clamp(i - 1, min=0)]
    p1, p2 = ys[i], ys[i + 1]
    p3 = ys[torch.clamp(i + 2, max=n - 1)]
    m1 = 0.5 * (p2 - p0)
    m2 = 0.5 * (p3 - p1)
    f2 = f * f
    f3 = f2 * f
    return ((2 * f3 - 3 * f2 + 1) * p1 + (f3 - 2 * f2 + f) * m1
            + (-2 * f3 + 3 * f2) * p2 + (f3 - f2) * m2)


def brent(f, a, b, n_iters: int = 64):
    """Brent-Dekker roots of f on the brackets [a, b] (elementwise):
    n_iters branchless steps choosing inverse quadratic interpolation,
    the secant or bisection per lane.  f(a) and f(b) must differ in sign;
    a converged lane stops moving.  Returns the best root estimates."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    fa, fb = f(a), f(b)
    # b holds the best guess: |f(b)| <= |f(a)|
    swap = torch.abs(fa) < torch.abs(fb)
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    fa, fb = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    c, fc = a, fa
    mflag = torch.zeros_like(fa, dtype=torch.bool)
    for _ in range(n_iters):
        use_iqi = (fa != fc) & (fb != fc)
        s_iqi = (
            a * fb * fc / torch.where(use_iqi, (fa - fb) * (fa - fc), 1.0)
            + b * fa * fc / torch.where(use_iqi, (fb - fa) * (fb - fc), 1.0)
            + c * fa * fb / torch.where(use_iqi, (fc - fa) * (fc - fb), 1.0))
        s_sec = b - fb * (b - a) / torch.where(fb != fa, fb - fa, 1.0)
        s = torch.where(use_iqi, s_iqi, s_sec)
        # bisect when s leaves [(3a + b) / 4, b] or after a bisection
        lo = (3.0 * a + b) / 4.0
        mflag = ((s - lo) * (s - b) >= 0) | mflag
        s = torch.where(mflag, 0.5 * (a + b), s)
        fs = f(s)
        c, fc = b, fb
        # keep the bracket: s replaces the endpoint of f(s)'s sign
        same = (fa * fs) > 0
        a, fa, b, fb = (torch.where(same, s, a), torch.where(same, fs, fa),
                        torch.where(same, b, s), torch.where(same, fb, fs))
        swap = torch.abs(fa) < torch.abs(fb)
        a, b = torch.where(swap, b, a), torch.where(swap, a, b)
        fa, fb = torch.where(swap, fb, fa), torch.where(swap, fa, fb)
    return b
