"""Sobol' low-discrepancy points (counterpart of
drmlt_mitsuba_tpu/render/sobol.py; the reference's sobol and ldsampler
plugins).

Direction numbers: dimensions 2-21 take the Joe-Kuo (new-joe-kuo-6.21201)
table's entries; higher dimensions take primitive polynomials found by an
exhaustive GF(2) search, with odd initial values from a fixed LCG (numpy,
at first use, the reference's search copied).  Every dimension is a
base-2 (0, 1)-sequence.

A point is the XOR of the direction vectors that the bits of its index
select, computed directly in int64 held to 32 bits (torch's uint32 lacks
shifts and xor on CUDA), so any index is reached in 32 steps.
Randomisation is a digital XOR shift per dimension, passed in by the
caller (the reference draws it with jax.random.bits); the top 24 bits of
a point, times 2^-24, give the float32 in [0, 1).
"""
from __future__ import annotations

import numpy as np
import torch

# --- Joe-Kuo table rows (d, s, a, m_1..m_s) for dims 2..21 (dim 1 is the
# van der Corput sequence, handled specially). ---
_JOE_KUO = [
    (2, 1, 0, [1]),
    (3, 2, 1, [1, 3]),
    (4, 3, 1, [1, 3, 1]),
    (5, 3, 2, [1, 1, 1]),
    (6, 4, 1, [1, 1, 3, 3]),
    (7, 4, 4, [1, 3, 5, 13]),
    (8, 5, 2, [1, 1, 5, 5, 17]),
    (9, 5, 4, [1, 1, 5, 5, 5]),
    (10, 5, 7, [1, 1, 7, 11, 19]),
    (11, 5, 11, [1, 1, 5, 1, 1]),
    (12, 5, 13, [1, 1, 1, 3, 11]),
    (13, 5, 14, [1, 3, 5, 5, 31]),
    (14, 6, 1, [1, 3, 3, 9, 7, 49]),
    (15, 6, 13, [1, 1, 1, 15, 21, 21]),
    (16, 6, 16, [1, 3, 1, 13, 27, 49]),
    (17, 6, 19, [1, 1, 1, 15, 7, 5]),
    (18, 6, 22, [1, 3, 1, 15, 13, 25]),
    (19, 6, 25, [1, 1, 5, 5, 19, 61]),
    (20, 7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (21, 7, 4, [1, 3, 7, 13, 13, 15, 69]),
]

_N_BITS = 32
MAX_DIMS = 160


def _poly_mul_mod(a: int, b: int, p: int, s: int) -> int:
    """(a*b) mod p over GF(2), p of degree s (bitmask encoding)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> s & 1:
            a ^= p
    return r


def _is_irreducible(p: int, s: int) -> bool:
    """Trial division by all polynomials of degree 1..s//2."""
    for d in range(1, s // 2 + 1):
        for q in range(1 << d, 1 << (d + 1)):
            # polynomial long division p / q over GF(2)
            rem = p
            while rem.bit_length() - 1 >= d:
                rem ^= q << (rem.bit_length() - 1 - d)
            if rem == 0:
                return False
    return True


def _prime_factors(n: int):
    out, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def _poly_pow_x(e: int, p: int, s: int) -> int:
    """x^e mod p over GF(2)."""
    result, base = 1, 2  # 1 and x
    while e:
        if e & 1:
            result = _poly_mul_mod(result, base, p, s)
        base = _poly_mul_mod(base, base, p, s)
        e >>= 1
    return result


def _primitive_polys(degree: int):
    """All primitive polynomials of the given degree, as 'a' encodings
    (interior coefficient bits, Joe-Kuo convention)."""
    n = (1 << degree) - 1
    factors = _prime_factors(n)
    out = []
    for interior in range(1 << (degree - 1)):
        # full poly bitmask: x^s + interior bits + 1
        p = (1 << degree) | (interior << 1) | 1
        if not _is_irreducible(p, degree):
            continue
        if any(_poly_pow_x(n // f, p, degree) == 1 for f in factors):
            continue
        out.append(interior)
    return out


def _direction_vectors(n_dims: int) -> np.ndarray:
    """(n_dims, 32) uint32 direction vectors V_k = m_k << (32-k)."""
    assert n_dims <= MAX_DIMS, f"sobol: {n_dims} dims > {MAX_DIMS}"
    rows = []
    # dim 1: van der Corput, m_k = 1 for all k.
    rows.append([1 << (_N_BITS - k) for k in range(1, _N_BITS + 1)])

    specs = [(s, a, list(m)) for (_, s, a, m) in _JOE_KUO]
    if n_dims - 1 > len(specs):
        # extend with searched primitive polynomials + LCG odd initials
        lcg = 0x9E3779B9
        degree = 1
        while len(specs) < n_dims - 1:
            for a in _primitive_polys(degree):
                if (degree, a) in [(s0, a0) for s0, a0, _ in specs]:
                    continue
                m = []
                for i in range(1, degree + 1):
                    lcg = (lcg * 1664525 + 1013904223) & 0xFFFFFFFF
                    m.append(((lcg >> 8) % (1 << i)) | 1)  # odd, < 2^i
                specs.append((degree, a, m))
                if len(specs) >= n_dims - 1:
                    break
            degree += 1

    for s, a, m in specs[: n_dims - 1]:
        m = list(m)
        for k in range(s, _N_BITS):
            new = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    new ^= m[k - i] << i
            m.append(new)
        rows.append([m[k] << (_N_BITS - 1 - k) for k in range(_N_BITS)])
    return np.asarray(rows, np.uint32)


_V_CACHE: dict[int, np.ndarray] = {}


def _vectors(n_dims: int) -> np.ndarray:
    if n_dims not in _V_CACHE:
        _V_CACHE[n_dims] = _direction_vectors(n_dims)
    return _V_CACHE[n_dims]


def _to_unit(x):
    """Top 24 bits of 32-bit values (int64) as float32 in [0, 1)."""
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def sobol_bits(idx, n_dims: int):
    """(N, n_dims) 32-bit Sobol' points (int64) of the integer indices idx
    (N,), unshifted."""
    v = torch.from_numpy(_vectors(n_dims).astype(np.int64)).to(idx.device)
    idx = idx.to(torch.int64)
    acc = torch.zeros((idx.shape[0], n_dims), dtype=torch.int64,
                      device=idx.device)
    for k in range(_N_BITS):
        bit = (idx >> k) & 1
        acc = acc ^ (v[None, :, k] * bit[:, None])
    return acc


def sobol(idx, n_dims: int, shift=None):
    """Sobol' points (N, n_dims) in [0, 1) of indices idx (N,); shift
    (n_dims,) int64 holds each dimension's 32-bit XOR shift (None: the
    canonical, unscrambled sequence)."""
    x = sobol_bits(idx, n_dims)
    if shift is not None:
        x = x ^ shift.to(torch.int64)[None, :]
    return _to_unit(x)


def ld02(idx, n_dims: int, shift):
    """ldsampler: every consecutive pair of dimensions is a copy of the
    canonical (0, 2)-sequence (Sobol' dimensions 1-2) under its own
    digital shift, so each 2-D request sees a (0, 2)-stratified set.
    shift: ((n_dims + 1) // 2, 2) int64 32-bit shifts.  As in the
    reference, one index drives every pair (no per-pixel permutation),
    so a render is unbiased over its shifts but its image mean moves with
    them far more than sobol's."""
    # the reference rounds the pair through float32 first: the low 8 bits go
    bits = (sobol_bits(idx, 2) >> 8) << 8
    n_pairs = (n_dims + 1) // 2
    x = bits[:, None, :] ^ shift.to(torch.int64)[None, :, :]
    return _to_unit(x.reshape(idx.shape[0], n_pairs * 2)[:, :n_dims])
