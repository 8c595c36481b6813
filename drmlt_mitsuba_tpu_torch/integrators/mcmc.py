"""Shared MCMC machinery (counterpart of drmlt_mitsuba_tpu/integrators/mcmc.py):
batched chain state, bootstrap seeding, acceptance helpers.
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats

BOOTSTRAP_BATCH = 8192


@dataclasses.dataclass
class ChainState:
    """State of C parallel chains with PSS dimension D and one splat."""
    u: torch.Tensor       # (C, D) current primary samples in [0, 1]
    lum: torch.Tensor     # (C,) luminance of the current state
    pos: torch.Tensor     # (C, 1, 2) current splat position
    value: torch.Tensor   # (C, 1, 3) current splat value / lum


def state_from_splats(u, sp: Splats) -> ChainState:
    """Normalise the splat by its luminance (SplatList::normalize): stored
    values have unit luminance; non-finite luminance becomes 0."""
    lum = torch.where(torch.isfinite(sp.lum), sp.lum, 0.0)
    value = torch.where((lum > 0)[:, None, None],
                        sp.value / torch.clamp(lum, min=1e-30)[:, None, None],
                        0.0)
    return ChainState(u=u, lum=lum, pos=sp.pos, value=value)


def bootstrap_from_uniforms(trace_fn, u_boot, u_pick, n_chains: int):
    """Kelemen bootstrap on given uniforms.

    u_boot: (n_total, D) bootstrap vectors, n_total a multiple of
    BOOTSTRAP_BATCH; u_pick: (n_chains,) resampling uniforms.  b is the
    mean luminance over all n_total samples; chains are resampled
    proportional to luminance by cdf inversion (searchsorted, side left,
    clipped) and re-traced from their vectors (the seed-replay contract).
    Returns (ChainState, b, idx)."""
    n_total = u_boot.shape[0]
    lums = []
    for s in range(0, n_total, BOOTSTRAP_BATCH):
        lum = trace_fn(u_boot[s:s + BOOTSTRAP_BATCH]).lum
        lums.append(torch.where(torch.isfinite(lum) & (lum >= 0), lum, 0.0))
    lums = torch.cat(lums)
    b = lums.sum() / n_total
    cdf = torch.cumsum(lums, 0)
    idx = torch.clamp(torch.searchsorted(cdf, u_pick[:n_chains] * cdf[-1]),
                      0, n_total - 1)
    u0 = u_boot[idx]
    return state_from_splats(u0, trace_fn(u0)), b, idx


def bootstrap(trace_fn, generator, n_dims: int, n_bootstrap: int,
              n_chains: int):
    """Draw the bootstrap vectors and resampling uniforms from `generator`
    (in that order) and run bootstrap_from_uniforms.  b averages over
    n_total = ceil(n_bootstrap / 8192) * 8192 samples, as the reference
    does.  Returns (ChainState, b)."""
    n_total = -(-n_bootstrap // BOOTSTRAP_BATCH) * BOOTSTRAP_BATCH
    u_boot = uniform((n_total, n_dims), generator)
    u_pick = uniform((n_chains,), generator)
    state, b, _ = bootstrap_from_uniforms(trace_fn, u_boot, u_pick,
                                          n_chains)
    return state, b


def metropolis_clamp(ratio):
    """min(1, ratio) with NaN / negative guarded to 0."""
    ratio = torch.where(torch.isfinite(ratio) & (ratio >= 0), ratio, 0.0)
    return torch.clamp(ratio, max=1.0)


def select_state(accept, proposed: ChainState,
                 current: ChainState) -> ChainState:
    a = accept[:, None]
    a3 = accept[:, None, None]
    return ChainState(
        u=torch.where(a, proposed.u, current.u),
        lum=torch.where(accept, proposed.lum, current.lum),
        pos=torch.where(a3, proposed.pos, current.pos),
        value=torch.where(a3, proposed.value, current.value),
    )
