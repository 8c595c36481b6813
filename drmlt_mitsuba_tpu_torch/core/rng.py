"""Primary-sample-space RNG (counterpart of drmlt_mitsuba_tpu/core/rng.py).

The reference replays bootstrap seeds through JAX's counter-based threefry.
The port draws its host-side randomness from an explicit `torch.Generator`
(bootstrap vectors, resampling uniforms, the chain kernel's seed) and keeps
the replay contract by indexing: a chain's initial state is the bootstrap
vector it was resampled from, re-traced.

Inside the chain kernel the uniforms come from a counter-based Philox4x32-10
(`philox_uniforms` below is its exact torch twin, so the CPU path and the
card draw the same stream).  Draw j of mutation m of chain c in launch l is
word j % 4 of Philox(counter=(c, m, j // 4, 0), key=(seed, l)), kept to its
top 23 bits so that u < 1.
"""
from __future__ import annotations

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def pss_wrap(y):
    """Reflective [0, 1] wrap of a perturbed primary sample: floor-mod 2
    (the sign of the divisor, like jnp.mod), then reflect (1, 2] onto
    [0, 1).  The chain kernel computes y - 2*floorf(y/2) the same way."""
    t = y - 2.0 * torch.floor(y * 0.5)
    return torch.where(t > 1.0, 2.0 - t, t)


def uniform(shape, generator):
    """U[0, 1) float32 samples from an explicit generator, on its device."""
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m for a < 2**32 held in int64, without
    overflowing int64: a is split into 16-bit halves."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al. 2011) on int64 tensors holding uint32
    values.  Returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, launch: int, m: int, n_rand: int,
                    n_chains: int, device=None):
    """The chain kernel's (n_rand, n_chains) uniforms of mutation m."""
    nb = -(-n_rand // 4)
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)
    blk = torch.arange(nb, dtype=torch.int64, device=device)[:, None]
    c0 = chain[None, :].expand(nb, n_chains)
    c1 = torch.full_like(c0, m)
    c2 = blk.expand(nb, n_chains)
    c3 = torch.zeros_like(c0)
    words = philox4x32_10(c0, c1, c2, c3, seed & _MASK32, launch & _MASK32)
    bits = torch.stack(words, 1).reshape(nb * 4, n_chains)[:n_rand]
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)
