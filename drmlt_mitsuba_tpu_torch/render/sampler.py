"""Sample generators for the forward renderers (counterpart of
drmlt_mitsuba_tpu/render/sampler.py; the reference's independent,
stratified, halton, hammersley, ldsampler and sobol plugins).

Each generator maps global sample indices to rows of the primary-sample
matrix.  The randomisation (Cranley-Patterson shifts, digital shifts,
stratified jitter) is an explicit argument; `make_sampler` draws it from a
torch.Generator, the shifts once a render and the per-sample uniforms per
call, so a test can pass the reference's instead.  MCMC uses only
`independent`, as the reference enforces.
"""
from __future__ import annotations

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.core.math import cdiv
from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.render.sobol import ld02, sobol

SAMPLERS = ("independent", "stratified", "halton", "hammersley",
            "ldsampler", "sobol")


def _first_primes(n: int) -> np.ndarray:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return np.asarray(out, np.int64)


# one base per dimension (reusing a base would correlate dimensions)
PRIMES = _first_primes(160)


def radical_inverse(index, base: int):
    """Van der Corput radical inverse of integer indices (float32), in the
    reference's order so that it is bit-equal: inv + digit * scale, then
    the next digit's scale, over ceil(log 2^31 / log base) digits, clamped
    to 1 - 1e-7.  The reference's loop is a compiled scan, where XLA
    fuses inv + digit * scale into one fused multiply-add and turns
    `scale / base` into a multiply by float32(1 / base).  This one does
    the same: the multiply-add in float64 (digit * scale is exact there)
    rounded once to float32."""
    i = index.to(torch.int64)
    inv = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    scale = torch.full(i.shape, 1.0 / base, dtype=torch.float32,
                       device=i.device)
    inv_base = torch.full((), 1.0 / base, dtype=torch.float32,
                          device=i.device)
    for _ in range(int(np.ceil(np.log(2 ** 31) / np.log(base)))):
        inv = (inv.double() + (i % base).double() * scale.double()).float()
        i = i // base
        scale = scale * inv_base
    return torch.clamp(inv, max=1.0 - 1e-7)


def halton(idx, n_dims: int, shift):
    """Halton points (N, n_dims) of indices idx (N,), rotated by the
    Cranley-Patterson shift (n_dims,) in [0, 1)."""
    pts = torch.stack([radical_inverse(idx, int(PRIMES[d]))
                       for d in range(n_dims)], -1)
    return torch.remainder(pts + shift[None, :], 1.0)


def hammersley(idx, n_total: int, n_dims: int, shift_halton, shift):
    """Hammersley points: dimension 0 is (i + 0.5) / n_total, the others
    Halton's under shift_halton (n_dims - 1,).  As in the reference, the
    whole point is then rotated again by shift (n_dims,), so dimensions
    1.. carry two rotations."""
    first = cdiv(idx.to(torch.float32) + 0.5, float(n_total))
    pts = torch.cat([first[:, None], halton(idx, n_dims - 1, shift_halton)],
                    -1)
    return torch.remainder(pts + shift[None, :], 1.0)


def stratified(idx, n_total: int, u):
    """Jittered strata on dimensions 0 and 1 (the film position), the
    others u as drawn; u (N, n_dims) are the uniforms.  As in the
    reference, dimensions 0 and 1 are stratified by the global index over
    floor(sqrt(n_total)) strata each, not per pixel."""
    n_strata = int(np.floor(np.sqrt(n_total)))
    sx = (idx % n_strata).to(torch.float32)
    sy = ((idx // n_strata) % n_strata).to(torch.float32)
    u = u.clone()
    u[:, 0] = cdiv(sx + u[:, 0], float(n_strata))
    u[:, 1] = cdiv(sy + u[:, 1], float(n_strata))
    return u


def _bits32(shape, generator):
    """32-bit random words (int64) from `generator`."""
    return torch.randint(0, 2 ** 32, shape, generator=generator,
                         device=generator.device, dtype=torch.int64)


def make_sampler(kind: str, generator, n_dims: int):
    """sample(start, n, n_total) -> (n, n_dims) rows of samples start ..
    start + n - 1 of a render of n_total samples.  The shifts are drawn
    from `generator` here, once; independent and stratified draw their
    uniforms from it at each call.  An unknown kind raises ValueError."""
    kind = kind.lower()
    if kind not in SAMPLERS:
        raise ValueError(f"unknown sampler '{kind}'")
    dev = generator.device
    if kind == "halton":
        shift = uniform((n_dims,), generator)
    elif kind == "hammersley":
        shift_h = uniform((n_dims - 1,), generator)
        shift = uniform((n_dims,), generator)
    elif kind == "sobol":
        shift = _bits32((n_dims,), generator)
    elif kind == "ldsampler":
        shift = _bits32(((n_dims + 1) // 2, 2), generator)

    def sample(start: int, n: int, n_total: int):
        if kind == "independent":
            return uniform((n, n_dims), generator)
        idx = start + torch.arange(n, device=dev)
        if kind == "stratified":
            return stratified(idx, n_total, uniform((n, n_dims), generator))
        if kind == "halton":
            return halton(idx, n_dims, shift)
        if kind == "hammersley":
            return hammersley(idx, n_total, n_dims, shift_h, shift)
        if kind == "sobol":
            return sobol(idx, n_dims, shift)
        return ld02(idx, n_dims, shift)

    return sample

