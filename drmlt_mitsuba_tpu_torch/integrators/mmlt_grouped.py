"""Depth-grouped DRMLT over the MMLT technique (counterpart of
drmlt_mitsuba_tpu/integrators/mmlt_grouped.py).

The MMLT depth dimension is pinned, so the chain population factorizes
into independent per-depth groups: group k's chains only ever trace depth-k
paths.  Each group has its own bootstrap (luminance pass over
max(8192, n_bootstrap // max_depth) samples), its own chain starts
resampled proportional to luminance, and its own chain-kernel launches;
it accumulates into its own film, developed with b_k / (N_k * steps_eff /
npixels), so every group is normalized by its own mutation count, and the
image is the sum.

Two routes per group, as in the reference: the chain kernel (the
reference's `_run_group_mega`: ops/megadrmlt.py on a CUDA device, its twin
on the CPU, in DRMLT or in pssmlt mode), and, where `use_mixture`,
`acceptance_map`, a filter footprint other than 1 or a thin lens (the
MMLT kernel's exclusion; the group's trace is then the bidirectional
wavefront) rule the chain kernel out, the generic step
(integrators/drmlt.py:run_chains over the group's MMLT trace, steps_k
steps, the strategy dim frozen; mmlt_grouped.py:256-320).  The generic
groups develop with b_k / (N_k * steps_k / npixels) and share one
acceptance map.  The sharded driver is not ported.

Randomness comes from one torch.Generator, drawn in this order: the
bootstrap vectors of groups 1..max_depth, then for each group that runs
(in order of k) its resampling uniforms and then its chain seed or its
steps' uniforms.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.integrators.bidir import (
    BDPTConfig, make_bidir_tables, trace_mmlt_wavefront,
)
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
    run_chains, warn_splat_mode,
)
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (
    BOOTSTRAP_BATCH, state_from_splats,
)
from drmlt_mitsuba_tpu_torch.ops import megadrmlt, megammlt
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.types import Scene

N_MUT = 64     # mutations per chain-kernel launch (16 below 32 steps)


def make_mmlt_trace_fixed(scene: Scene, k: int, light_image: bool, device,
                          thinlens: bool = False):
    """trace(u) -> Splats for a depth-k group, u = [strategy, eye dims...,
    light dims..., (pad)]: the MMLT trace with its depth dim pinned to k
    and the uniform depth-pmf factor k divided out (luminance-proportional
    group allocation replaces the pmf).  Returns (trace, cfg_k, n_dims,
    tables) with n_dims even-padded for orbital.  A thin lens (which the
    MMLT kernel excludes) takes the bidirectional wavefront,
    bidir.trace_mmlt_wavefront at depth k, and tables is None: such a
    group runs the generic step."""
    cfg = BDPTConfig(max_depth=k, light_image=light_image,
                     thinlens=thinlens)
    n_core = 1 + cfg.eye_dims + cfg.light_dims
    n_dims = n_core + n_core % 2
    if thinlens:
        bt = make_bidir_tables(scene, cfg, device)

        def trace(u):
            depth = torch.full((u.shape[0],), k, dtype=torch.int64,
                               device=u.device)
            return trace_mmlt_wavefront(bt, cfg, u[:, :n_core], depth)

        return trace, cfg, n_dims, None
    tables = megammlt.make_mmlt_tables(scene, cfg, device)
    u_depth = 1.0 - 0.5 / k

    def trace(u):
        col = torch.full((1, u.shape[0]), u_depth, device=u.device)
        out = megammlt.mmlt_trace(
            tables, torch.cat([col, u[:, :n_core].T]).contiguous())
        return megammlt.to_splats(out, 1.0 / k)

    return trace, cfg, n_dims, tables


def grouped_masks(cfg: BDPTConfig, n_dims: int, device=None):
    """The frozen mask of a depth-k group: its strategy dim (index 0)
    moves only on large steps; a group has no pinned dim."""
    mask = torch.zeros((n_dims,), dtype=torch.bool, device=device)
    mask[0] = True
    return mask


def grouped_emitter_mask(cfg: BDPTConfig, n_dims: int, device=None):
    """A depth-k group's light-subpath dims (fixEmitterPath)."""
    mask = torch.zeros((n_dims,), dtype=torch.bool, device=device)
    start = 1 + cfg.eye_dims
    mask[start:start + cfg.light_dims] = True
    return mask


def grouped_lt_mask_fn(cfg: BDPTConfig):
    """lt(u) -> (C,) bool: is the group's chain light tracing, s = min(
    floor(u0 (k + 1)), k) == k (t = k + 1 - s == 1)?"""
    k = cfg.max_depth

    def lt(u):
        return torch.clamp((u[:, 0] * (k + 1)).to(torch.int32), max=k) == k

    return lt


def group_bootstrap(trace, u_boot):
    """Luminance pass over the bootstrap vectors (n_total, n_dims) in
    batches of 8192: (lums (n_total,), b_k)."""
    lums = []
    for s in range(0, u_boot.shape[0], BOOTSTRAP_BATCH):
        lum = trace(u_boot[s:s + BOOTSTRAP_BATCH]).lum
        lums.append(torch.where(torch.isfinite(lum) & (lum >= 0), lum, 0.0))
    lums = torch.cat(lums)
    return lums, lums.sum() / u_boot.shape[0]


def group_starts(trace, u_boot, lums, u_pick):
    """cdf-inversion resample of len(u_pick) starts proportional to lums,
    re-traced from their bootstrap vectors."""
    cdf = torch.cumsum(lums, 0)
    idx = torch.clamp(torch.searchsorted(cdf, u_pick * cdf[-1]), 0,
                      lums.shape[0] - 1)
    u0 = u_boot[idx]
    return state_from_splats(u0, trace(u0))


def group_schedule(b_ks, n_chains: int, n_steps: int, equal_chains: bool,
                   min_group: int):
    """(chains, steps) per group, mutations per group proportional to b_k
    (mmlt_grouped.py:224-246).  equal_chains: every group runs n_chains
    chains for round(n_steps * b_k / b) steps, and a group whose share
    rounds to 0 is skipped; otherwise chain counts follow b_k in multiples
    of min_group and every group runs n_steps."""
    b_total = sum(b_ks)
    sizes, steps = [], []
    for bk in b_ks:
        if b_total <= 0 or bk <= 0:
            sizes.append(0)
            steps.append(0)
        elif equal_chains:
            sizes.append(n_chains)
            steps.append(int(round(n_steps * bk / b_total)))
        else:
            raw = n_chains * bk / b_total
            sizes.append(max(min_group,
                             int(round(raw / min_group)) * min_group))
            steps.append(n_steps)
    return sizes, steps


def render_drmlt_mmlt_grouped(scene: Scene, bcfg: BDPTConfig, dcfg,
                              film_cfg, generator, n_steps: int,
                              average_luminance=None, min_group: int = 1024,
                              equal_chains: bool = True,
                              pssmlt: bool = False):
    """Full depth-grouped DRMLT-over-MMLT render on generator.device.

    Per group k: ceil(steps_k / N_MUT) chain-kernel launches of N_MUT
    mutations (16 when steps_k < 32), then img += film_k * b_k / (N_k * steps_eff /
    npixels).  average_luminance, when given, scales every b_k so that
    they sum to it (mmlt_grouped.py:222-225); the schedule does not change.
    pssmlt runs every launch in the chain kernel's pssmlt mode (stage-1-only
    PSSMLT, the reference's control).  With use_mixture, acceptance_map or
    a filter footprint other than 1 every group runs the generic step
    instead (so does a thin lens, bcfg.thinlens, over the wavefront MMLT
    trace), steps_k steps developed at b_k / (N_k * steps_k / npixels),
    and pssmlt raises ValueError there (mmlt_grouped.py:276-281).  Returns
    (image (H, W, 3), aux) with aux b, b_k, sizes, steps_per_group, accmap
    (None unless acceptance_map), and per group that ran its steps_eff,
    stats and image (the summand), like the reference."""
    device = generator.device
    generic = (dcfg.use_mixture or dcfg.acceptance_map
               or film_cfg.filter.footprint != 1 or bcfg.thinlens)
    D = bcfg.max_depth
    n_total = -(-max(8192, dcfg.n_bootstrap // D) // BOOTSTRAP_BATCH) \
        * BOOTSTRAP_BATCH

    groups = []
    for k in range(1, D + 1):
        trace, cfg_k, n_dims, tables = make_mmlt_trace_fixed(
            scene, k, bcfg.light_image, device, bcfg.thinlens)
        u_boot = uniform((n_total, n_dims), generator)
        lums, b_k = group_bootstrap(trace, u_boot)
        groups.append(dict(k=k, trace=trace, cfg=cfg_k, tables=tables,
                           u_boot=u_boot, lums=lums, b=b_k))

    b_ks = [float(g["b"]) for g in groups]     # one host sync at set-up
    b_total = sum(b_ks)
    if average_luminance is not None and b_total > 0:
        b_ks = [bk * (float(average_luminance) / b_total) for bk in b_ks]
        b_total = float(average_luminance)
    sizes, steps = group_schedule(b_ks, dcfg.n_chains, n_steps,
                                  equal_chains, min_group)

    img = torch.zeros((film_cfg.height, film_cfg.width, 3),
                      dtype=torch.float32, device=device)
    accmap = (filmlib.new_film(film_cfg, device) if dcfg.acceptance_map
              else None)
    all_stats, steps_eff_k, images = {}, {}, {}
    for g, n_k, bk, steps_k in zip(groups, sizes, b_ks, steps):
        if n_k == 0 or steps_k == 0:
            continue
        if generic:
            if pssmlt:
                raise ValueError(
                    f"pssmlt=True but depth group k={g['k']} runs the "
                    "generic step; use integrators.pssmlt instead")
            warn_splat_mode(dcfg, f"depth group k={g['k']}")
            cfg_k = g["cfg"]
            n_dims = g["u_boot"].shape[1]
            fix = dcfg.fix_emitter_path
            u_pick = uniform((n_k,), generator)
            state = group_starts(g["trace"], g["u_boot"], g["lums"], u_pick)
            _, film, accmap, stats = run_chains(
                g["trace"], dcfg, film_cfg, generator, state, steps_k,
                grouped_masks(cfg_k, n_dims, device), accmap,
                emitter_mask=(grouped_emitter_mask(cfg_k, n_dims, device)
                              if fix else None),
                lt_mask_fn=grouped_lt_mask_fn(cfg_k) if fix else None)
            images[g["k"]] = filmlib.develop(
                film_cfg, film, mode="splat",
                scale=bk / (n_k * steps_k / film_cfg.npixels))
            img = img + images[g["k"]]
            all_stats[g["k"]] = stats
            steps_eff_k[g["k"]] = steps_k
            continue
        nm = 16 if steps_k < 32 else N_MUT
        n_launches = max(1, -(-steps_k // nm))
        steps_eff = n_launches * nm
        u_pick = uniform((n_k,), generator)
        state = group_starts(g["trace"], g["u_boot"], g["lums"], u_pick)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=device))
        arr = megadrmlt.pack_chain_state(state)
        film = torch.zeros((film_cfg.height, film_cfg.width, 3),
                           dtype=torch.float32, device=device)
        stats = torch.zeros((6, n_k), dtype=torch.float32, device=device)
        for i in range(n_launches):
            megadrmlt.drmlt_chain_step(g["tables"], dcfg, nm, arr, film,
                                       stats, seed, i, pssmlt=pssmlt)
        images[g["k"]] = film * (bk / (n_k * steps_eff / film_cfg.npixels))
        img = img + images[g["k"]]
        sums = stats.sum(1) / (n_k * steps_eff)
        all_stats[g["k"]] = dict(a1=sums[0], a2=sums[1], accept1=sums[2],
                                 accept2=sums[3], large=sums[4])
        steps_eff_k[g["k"]] = steps_eff
    return img, dict(b=b_total, b_k=b_ks, sizes=sizes,
                     steps_per_group=steps, steps_eff=steps_eff_k,
                     stats=all_stats, images=images, accmap=accmap)
