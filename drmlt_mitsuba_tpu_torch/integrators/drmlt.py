"""DRMLT over the path technique (counterpart of
drmlt_mitsuba_tpu/integrators/drmlt.py: DRMLTConfig and render_drmlt_path).

Bold-then-timid delayed-rejection MLT: every mutation proposes a bold y
(a1 = min(1, Ly/Lx)) and, on rejection, a timid z with the per-type
second-stage acceptance (green: reverse-path third trace; mira: q-ratio;
orbital: wrapped-Cauchy rotation with a2 = clamp((Lz-Ly)/(Lx-Ly))).  The
mutation loop runs n_mut mutations per launch in the chain kernel
(ops/megadrmlt.py); bootstrap and the initial chain state go through the
path kernel (ops/megatrace.py).
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.integrators import kernels
from drmlt_mitsuba_tpu_torch.integrators.mcmc import bootstrap
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.ops import megadrmlt
from drmlt_mitsuba_tpu_torch.ops.megatrace import make_tables

TYPE_GREEN = "green"
TYPE_MIRA = "mira"
TYPE_ORBITAL = "orbital"


@dataclasses.dataclass(frozen=True)
class DRMLTConfig:
    """Mirrors DRMLTConfiguration (drmlt.h:35-191); the reference config's
    fields, defaults and validation, less its fuse_traces switch (the chain
    kernel traces every proposal of a mutation in one launch)."""
    type: str = TYPE_GREEN             # green | mira | orbital
    n_chains: int = 8192
    p_large: float = 0.3
    s1: float = kernels.S1_DEFAULT
    s2: float = kernels.S2_DEFAULT
    sigma: float = kernels.SIGMA_DEFAULT
    scale_second: float = kernels.SCALE_SECOND_DEFAULT
    rho: float = kernels.RHO_DEFAULT
    kelemen_scale: float = kernels.KELEMEN_SCALE_ORBITAL
    timid_after_large: bool = False
    acceptance_map: bool = False
    use_mixture: bool = False
    fix_emitter_path: bool = False
    n_bootstrap: int = 100_000
    splat_mode: str = "three"          # three | sampled

    def __post_init__(self):
        if self.splat_mode not in ("three", "sampled"):
            raise ValueError(
                f"splat_mode must be 'three' or 'sampled', got "
                f"{self.splat_mode!r}")
        if self.type not in (TYPE_GREEN, TYPE_MIRA, TYPE_ORBITAL):
            raise ValueError(f"unknown DRMLT type {self.type!r}")


def render_drmlt_path(scene, pcfg, cfg: DRMLTConfig, film_cfg, generator,
                      n_steps: int, average_luminance=None, n_mut: int = 64):
    """DRMLT over the unidirectional path technique on generator.device.

    Bootstrap (path kernel), packed chain state, ceil(n_steps / n_mut)
    chain-kernel launches (n_mut forced to 16 when n_steps < 32), then
    img = film * b / (n_chains * steps_eff / npixels).  The generator's
    draws, in order: bootstrap vectors, resampling uniforms, the chain
    kernel's seed.  Returns (image (H, W, 3), aux) like the reference."""
    if cfg.use_mixture or cfg.acceptance_map:
        raise NotImplementedError(
            "useMixture / acceptanceMap are not ported to the chain kernel")
    if film_cfg.filter.footprint != 1:
        raise NotImplementedError("the chain kernel splats with a box filter")
    device = generator.device
    n_dims = pcfg.n_dims + pcfg.n_dims % 2   # orbital needs even dims
    trace_fn = make_path_trace(scene, pcfg, device)
    state, b = bootstrap(trace_fn, generator, n_dims, cfg.n_bootstrap,
                         cfg.n_chains)
    if average_luminance is not None:
        b = torch.tensor(average_luminance, dtype=torch.float32,
                         device=device)
    if n_steps < 32:
        n_mut = 16
    n_launches = max(1, -(-n_steps // n_mut))
    steps_eff = n_launches * n_mut
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=device))
    arr = megadrmlt.pack_chain_state(state)
    film = torch.zeros((film_cfg.height, film_cfg.width, 3),
                       dtype=torch.float32, device=device)
    stats = torch.zeros((6, cfg.n_chains), dtype=torch.float32,
                        device=device)
    tables = make_tables(scene, pcfg, device)
    for i in range(n_launches):
        megadrmlt.drmlt_chain_step(tables, cfg, n_mut, arr, film, stats,
                                  seed, i)
    n_per_pixel = cfg.n_chains * steps_eff / film_cfg.npixels
    img = film * (b / n_per_pixel)
    sums = stats.sum(1) / (cfg.n_chains * steps_eff)
    stats_d = dict(a1=sums[0], a2=sums[1], accept1=sums[2],
                   accept2=sums[3], large=sums[4])
    return img, dict(b=b, state=arr, stats=stats_d, steps=steps_eff)
