"""DRMLT (counterpart of drmlt_mitsuba_tpu/integrators/drmlt.py).

Bold-then-timid delayed-rejection MLT: every mutation proposes a bold y
(a1 = min(1, Ly/Lx)) and, on rejection, a timid z with the per-type
second-stage acceptance (green: reverse-path third trace y* = z - (y - x);
mira: the q-ratio Q1(z|y) / Q1(x|y); orbital: a wrapped-Cauchy rotation of
y - x about y, a2 = clamp((Lz - Ly) / (Lx - Ly))), and splats all three
states with w_y = a1, w_z = (1 - a1) a2, w_x = 1 - w_y - w_z.

Two routes, as in the reference:
  * the chain kernel (ops/megadrmlt.py): `render_drmlt_path` runs n_mut
    whole mutations per launch, box filter only;
  * the generic step (`drmlt_step`, `drmlt_mixture_step`, `render_drmlt`):
    one host step per mutation over any `trace_fn(u) -> Splats` (the path
    kernel, the pooled or per-depth MMLT kernel; their twins on the CPU),
    every proposal of a step traced in one call (2C lanes, 3C for green)
    and the three states splatted in one call of the splat kernel.  It
    carries what the chain kernel does not: the `useMixture` baseline, the
    acceptance map, any reconstruction filter, fixEmitterPath over the
    pooled MMLT encoding.  `render_drmlt_path` sends those options to it,
    where the reference does (drmlt.py:405-409).

Randomness.  The `*_from_uniforms` functions take their uniforms
explicitly (`DRMLTUniforms`, the fields the reference draws from its
`jax.random.split` keys); `drmlt_step` and `drmlt_mixture_step` draw them
from a torch.Generator (`draw_drmlt_uniforms`), and `render_drmlt` draws
the bootstrap's first (integrators/mcmc.py).
"""
from __future__ import annotations

import dataclasses
import logging
import math

import torch

from drmlt_mitsuba_tpu_torch.core.rng import pss_wrap, uniform
from drmlt_mitsuba_tpu_torch.integrators import kernels
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (
    ChainState, bootstrap, metropolis_clamp, select_state, splat_state,
    state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.ops import megadrmlt
from drmlt_mitsuba_tpu_torch.ops.megatrace import make_tables
from drmlt_mitsuba_tpu_torch.render import film as filmlib

TYPE_GREEN = "green"
TYPE_MIRA = "mira"
TYPE_ORBITAL = "orbital"


@dataclasses.dataclass(frozen=True)
class DRMLTConfig:
    """Mirrors DRMLTConfiguration (drmlt.h:35-191); the reference config's
    fields, defaults and validation, less its fuse_traces switch (the
    generic step traces every proposal of a mutation in one call, the
    chain kernel in one launch)."""
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
    splat_mode: str = "three"          # three | sampled (chain kernel only)

    def __post_init__(self):
        if self.splat_mode not in ("three", "sampled"):
            raise ValueError(
                f"splat_mode must be 'three' or 'sampled', got "
                f"{self.splat_mode!r}")
        if self.type not in (TYPE_GREEN, TYPE_MIRA, TYPE_ORBITAL):
            raise ValueError(f"unknown DRMLT type {self.type!r}")

    def stage1_kernel(self):
        if self.type == TYPE_ORBITAL:
            return kernels.Kelemen(self.s1 * self.kelemen_scale,
                                   self.s2 * self.kelemen_scale)
        return kernels.Kelemen(self.s1, self.s2)

    def stage2_kernel(self):
        if self.type == TYPE_ORBITAL:
            return kernels.WrappedCauchy(self.rho)
        return kernels.Gaussian(self.scale_second * self.sigma)


@dataclasses.dataclass
class DRMLTUniforms:
    """The uniforms of one step of C chains over D dims.

    drmlt_step reads every field; drmlt_mixture_step reads coin, u_large,
    u1 and u2 for its two proposals, accept1 as its bold / timid coin and
    accept2 as its Metropolis coin."""
    coin: torch.Tensor      # (C,) the large-step coin
    u_large: torch.Tensor   # (C, D) a large step's vector
    u1: torch.Tensor        # stage-1 pairs (C, D, 2); orbital (C, D/2, 2, 2)
    u2: torch.Tensor        # stage-2 pairs (C, D, 2); orbital (C, D/2, 2)
    accept1: torch.Tensor   # (C,) the stage-1 coin
    accept2: torch.Tensor   # (C,) the stage-2 coin


def draw_drmlt_uniforms(generator, n_chains: int, n_dims: int,
                        type: str) -> DRMLTUniforms:
    """One step's uniforms from `generator`, in the field order."""
    C, D = n_chains, n_dims
    orbital = type == TYPE_ORBITAL
    return DRMLTUniforms(
        coin=uniform((C,), generator),
        u_large=uniform((C, D), generator),
        u1=uniform((C, D // 2, 2, 2) if orbital else (C, D, 2), generator),
        u2=uniform((C, D // 2, 2) if orbital else (C, D, 2), generator),
        accept1=uniform((C,), generator),
        accept2=uniform((C,), generator))


def propose_stage1(cfg: DRMLTConfig, u, draws: DRMLTUniforms, frozen_mask,
                   pinned_mask=None):
    """Bold proposal y (unwrapped) and the large-step mask.

    frozen_mask: (D,) dims unchanged on small steps, resampled on large
    steps (the MMLT strategy dim); pinned_mask: (D,) dims that never move
    (the pooled MMLT depth dim).  Orbital perturbs dim pairs (2i, 2i+1)
    by a 2-D Kelemen step: radius from the pair's first uniform, angle
    from its third (drmlt_sampler.cpp:339-360)."""
    C, D = u.shape
    large = draws.coin < cfg.p_large
    kern = cfg.stage1_kernel()
    if cfg.type == TYPE_ORBITAL:
        d = kern.sample(draws.u1[:, :, 0, :])            # (C, D/2)
        ang = draws.u1[:, :, 1, 0] * (2.0 * math.pi)
        du = torch.stack([d * torch.cos(ang), d * torch.sin(ang)],
                         -1).reshape(C, D)
    else:
        du = kern.sample(draws.u1)
    du = torch.where(frozen_mask[None, :], 0.0, du)
    y = torch.where(large[:, None], draws.u_large, u + du)
    if pinned_mask is not None:
        y = torch.where(pinned_mask[None, :], u, y)
    return y, large


def propose_stage2(cfg: DRMLTConfig, x, y, u2, frozen_mask,
                   pinned_mask=None, freeze2=None):
    """Timid proposal z (unwrapped) from the current x and the unwrapped
    stage-1 y.  Green / mira: z = x + a small Gaussian step.  Orbital:
    y - x rotated about y by a wrapped-Cauchy angle, its norm kept
    (drmlt_sampler.cpp:361-394).  freeze2: (C, D) per-chain dims held at x
    (fixEmitterPath)."""
    C, D = x.shape
    kern = cfg.stage2_kernel()
    if cfg.type == TYPE_ORBITAL:
        theta = kern.sample(u2)                           # (C, D/2)
        du = (y - x).reshape(C, D // 2, 2)
        nrm = torch.sqrt(torch.clamp((du * du).sum(-1), min=1e-30))
        mu = torch.atan2(-du[..., 1], -du[..., 0])
        yp = y.reshape(C, D // 2, 2)
        c1 = yp[..., 0] + torch.cos(theta + mu) * nrm
        c2 = yp[..., 1] + torch.sin(theta + mu) * nrm
        z = torch.stack([c1, c2], -1).reshape(C, D)
    else:
        z = x + kern.sample(u2)
    z = torch.where(frozen_mask[None, :], x, z)
    if pinned_mask is not None:
        z = torch.where(pinned_mask[None, :], x, z)
    if freeze2 is not None:
        z = torch.where(freeze2, x, z)
    return z


def mira_transition_ratio(cfg: DRMLTConfig, x, y, z, frozen_mask,
                          pinned_mask=None):
    """Q1(z|y) / Q1(x|y) as exp of the summed log-pdfs over the dims that
    are neither frozen nor pinned (drmlt_sampler.cpp:400-414)."""
    kern = cfg.stage1_kernel()
    skip = frozen_mask if pinned_mask is None else frozen_mask | pinned_mask
    lp = torch.where(skip[None, :], 0.0,
                     kern.log_pdf(z - y) - kern.log_pdf(x - y))
    return torch.exp(lp.sum(-1))


def _split(sp, n: int, C: int):
    """The n consecutive C-lane parts of one traced batch of Splats."""
    return [dataclasses.replace(sp, pos=sp.pos[i * C:(i + 1) * C],
                                value=sp.value[i * C:(i + 1) * C],
                                lum=sp.lum[i * C:(i + 1) * C])
            for i in range(n)]


def drmlt_step_from_uniforms(trace_fn, cfg: DRMLTConfig, film_cfg,
                             frozen_mask, carry, draws: DRMLTUniforms,
                             accmap_cfg=None, pinned_mask=None,
                             emitter_mask=None, lt_mask_fn=None):
    """One DRMLT mutation of every chain; carry = (state, film, accmap).

    accmap, when cfg.acceptance_map, gains one splat a chain: R = 1 on a
    small step's stage-1 accept, G = 1 on a stage-2 accept, at the
    accepted state's position (drmlt_proc.cpp:443-450).  fixEmitterPath
    holds the emitter dims (emitter_mask) in stage 2 unless lt_mask_fn(x)
    says the chain is light tracing (drmlt_proc.cpp:133-141).  Returns
    ((state, film, accmap), stats): the means of a1, a2, accept1, accept2
    and large, and the counts n_accept1 (stage-1 accepts of small steps)
    and n_accept2."""
    state, film, accmap = carry
    x = state.u
    C = x.shape[0]
    y_raw, large = propose_stage1(cfg, x, draws, frozen_mask, pinned_mask)
    y = pss_wrap(y_raw)
    freeze2 = None
    if (cfg.fix_emitter_path and emitter_mask is not None
            and lt_mask_fn is not None):
        freeze2 = emitter_mask[None, :] & ~lt_mask_fn(x)[:, None]
    z_raw = propose_stage2(cfg, x, y_raw, draws.u2, frozen_mask,
                           pinned_mask, freeze2)
    z = pss_wrap(z_raw)
    batch = [y, z]
    if cfg.type == TYPE_GREEN:
        batch.append(pss_wrap(z_raw - (y_raw - x)))
    parts = _split(trace_fn(torch.cat(batch)), len(batch), C)

    prop1 = state_from_splats(y, parts[0])
    a1 = metropolis_clamp(prop1.lum / torch.clamp(state.lum, min=1e-30))
    accept1 = draws.accept1 < a1
    do_second = ~accept1
    if not cfg.timid_after_large:
        do_second = do_second & ~large

    prop2 = state_from_splats(z, parts[1])
    lum_ratio = prop2.lum / torch.clamp(state.lum, min=1e-30)
    if cfg.type == TYPE_GREEN:
        rev = parts[2].lum
        a_rev = metropolis_clamp(
            torch.where(torch.isfinite(rev) & (rev >= 0), rev, 0.0)
            / torch.clamp(prop2.lum, min=1e-30))
        a2 = metropolis_clamp(lum_ratio * (1.0 - a_rev)
                              / torch.clamp(1.0 - a1, min=1e-12))
        a2 = torch.where(a_rev >= 1.0, 0.0, a2)
    elif cfg.type == TYPE_MIRA:
        a_rev = metropolis_clamp(prop1.lum
                                 / torch.clamp(prop2.lum, min=1e-30))
        q_ratio = mira_transition_ratio(cfg, x, y_raw, z_raw, frozen_mask,
                                        pinned_mask)
        q_ratio = torch.where(large, 1.0, q_ratio)
        a2 = metropolis_clamp(lum_ratio * q_ratio * (1.0 - a_rev)
                              / torch.clamp(1.0 - a1, min=1e-12))
        a2 = torch.where(a_rev >= 1.0, 0.0, a2)
        a2 = torch.where(torch.isfinite(q_ratio), a2, 0.0)
    else:
        # Eq. 11 with its early exits (drmlt_proc.cpp:655-669)
        num = prop2.lum - prop1.lum
        den = state.lum - prop1.lum
        a2 = torch.where(
            prop2.lum < prop1.lum, 0.0,
            torch.where(prop2.lum >= state.lum, 1.0, metropolis_clamp(
                num / torch.where(torch.abs(den) > 0, den, 1.0))))
    a2 = torch.where(prop2.lum > 0, a2, 0.0)
    a2 = torch.where(do_second, a2, 0.0)
    accept2 = (draws.accept2 < a2) & do_second

    # the three states in one splat call (paper Fig. 10)
    w_y = a1
    w_z = (1.0 - a1) * a2
    w_x = 1.0 - w_y - w_z
    film = splat_state(film_cfg, film,
                       torch.cat([state.pos, prop1.pos, prop2.pos]),
                       torch.cat([state.value, prop1.value, prop2.value]),
                       torch.cat([w_x, w_y, w_z]))
    acc1_small = accept1 & ~large
    if cfg.acceptance_map and accmap is not None:
        r = acc1_small.float()
        g = accept2.float()
        rgb = torch.stack([r, g, torch.zeros_like(r)], -1)[:, None, :]
        # one splat a chain at its first splat's position (BDPT's pixel
        # splat: the reference's map takes every splat's position and
        # fails to reshape its one value when S > 1)
        pos = torch.where(accept2[:, None, None], prop2.pos[:, :1],
                          prop1.pos[:, :1])
        accmap = splat_state(accmap_cfg or film_cfg, accmap, pos, rgb,
                             torch.ones_like(r))

    state = select_state(accept1, prop1, select_state(accept2, prop2, state))
    stats = dict(a1=a1.mean(), a2=a2.mean(), accept1=accept1.float().mean(),
                 accept2=accept2.float().mean(), large=large.float().mean(),
                 n_accept1=acc1_small.sum(), n_accept2=accept2.sum())
    return (state, film, accmap), stats


def drmlt_mixture_step_from_uniforms(trace_fn, cfg: DRMLTConfig, film_cfg,
                                     frozen_mask, carry,
                                     draws: DRMLTUniforms):
    """The `useMixture` baseline: single-stage MH whose proposal is the
    bold or the timid kernel with equal odds (drmlt_proc.cpp:161-380).

    As the reference does, the timid proposal is propose_stage2(x, y=x)
    on the stage-1 draws' own key, and neither proposal takes a pinned
    mask; for orbital y - x = 0, so the timid proposal is x rotated about
    itself at radius 1e-15, x to within float precision.  Returns ((state,
    film, accmap), stats) with the mean of a as a1; accmap is passed
    through."""
    state, film, accmap = carry
    x = state.u
    pick_bold = draws.accept1 < 0.5
    y_bold, large = propose_stage1(cfg, x, draws, frozen_mask)
    z_timid = propose_stage2(cfg, x, x, draws.u2, frozen_mask)
    y = pss_wrap(torch.where((pick_bold | large)[:, None], y_bold, z_timid))
    prop = state_from_splats(y, trace_fn(y))
    a = metropolis_clamp(prop.lum / torch.clamp(state.lum, min=1e-30))
    film = splat_state(film_cfg, film, torch.cat([state.pos, prop.pos]),
                       torch.cat([state.value, prop.value]),
                       torch.cat([1.0 - a, a]))
    state = select_state(draws.accept2 < a, prop, state)
    return (state, film, accmap), dict(a1=a.mean())


def drmlt_step(trace_fn, cfg: DRMLTConfig, film_cfg, frozen_mask, carry,
               generator, accmap_cfg=None, pinned_mask=None,
               emitter_mask=None, lt_mask_fn=None):
    """drmlt_step_from_uniforms on a step's uniforms from `generator`."""
    u = carry[0].u
    return drmlt_step_from_uniforms(
        trace_fn, cfg, film_cfg, frozen_mask, carry,
        draw_drmlt_uniforms(generator, u.shape[0], u.shape[1], cfg.type),
        accmap_cfg, pinned_mask, emitter_mask, lt_mask_fn)


def drmlt_mixture_step(trace_fn, cfg: DRMLTConfig, film_cfg, frozen_mask,
                       carry, generator):
    """drmlt_mixture_step_from_uniforms on uniforms from `generator`."""
    u = carry[0].u
    return drmlt_mixture_step_from_uniforms(
        trace_fn, cfg, film_cfg, frozen_mask, carry,
        draw_drmlt_uniforms(generator, u.shape[0], u.shape[1], cfg.type))


def warn_splat_mode(cfg: DRMLTConfig, where: str):
    """The generic step always runs the three-state splat: say so when the
    configuration asked for the chain kernel's sampled one."""
    if cfg.splat_mode != "three":
        logging.getLogger(__name__).warning(
            "splat_mode=%r requested but %s runs the generic step "
            "(three-state splat executed)", cfg.splat_mode, where)


def run_chains(trace_fn, cfg: DRMLTConfig, film_cfg, generator,
               state: ChainState, n_steps: int, frozen_mask, accmap=None,
               pinned_mask=None, emitter_mask=None, lt_mask_fn=None,
               on_step=None):
    """n_steps generic steps (the mixture's when cfg.use_mixture) from
    `state` into a new film.  Returns (state, film, accmap, stats), stats
    one (steps,) tensor per key.  `on_step(done, film)`, when given, is
    called after every step; a true return stops the chains there."""
    film = filmlib.new_film(film_cfg, generator.device)
    per_step = []
    for i in range(n_steps):
        if cfg.use_mixture:
            (state, film, accmap), st = drmlt_mixture_step(
                trace_fn, cfg, film_cfg, frozen_mask, (state, film, accmap),
                generator)
        else:
            (state, film, accmap), st = drmlt_step(
                trace_fn, cfg, film_cfg, frozen_mask, (state, film, accmap),
                generator, pinned_mask=pinned_mask,
                emitter_mask=emitter_mask, lt_mask_fn=lt_mask_fn)
        per_step.append(st)
        if on_step is not None and on_step(i + 1, film):
            break
    stats = ({k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
             if per_step else {})
    return state, film, accmap, stats


def render_drmlt(trace_fn, cfg: DRMLTConfig, film_cfg, generator,
                 n_dims: int, n_steps: int, frozen_mask=None,
                 average_luminance=None, pinned_mask=None,
                 emitter_mask=None, lt_mask_fn=None, on_step=None):
    """The generic DRMLT render on generator.device: bootstrap, n_steps
    steps (the mixture's when cfg.use_mixture, which takes no pinned
    mask, as in the reference), then img = film * b / (n_chains * steps
    / npixels).  Returns (image (H, W, 3), aux) with aux b, state, the
    per-step stats, accmap ((H, W, 4), None unless cfg.acceptance_map) and
    steps.  `on_step(done, develop)`, when given, is called after every
    step; develop() gives the image of the steps done, and a true return
    stops the render there, which then develops with the steps done."""
    if n_dims % 2 and cfg.type == TYPE_ORBITAL:
        raise ValueError("orbital requires an even PSS dimension count")
    device = generator.device
    if frozen_mask is None:
        frozen_mask = torch.zeros((n_dims,), dtype=torch.bool, device=device)
    warn_splat_mode(cfg, "render_drmlt")
    state, b = bootstrap(trace_fn, generator, n_dims, cfg.n_bootstrap,
                         cfg.n_chains)
    if average_luminance is not None:
        b = torch.tensor(average_luminance, dtype=torch.float32,
                         device=device)
    accmap = (filmlib.new_film(film_cfg, device) if cfg.acceptance_map
              else None)

    def develop(film, steps):
        n_per_pixel = cfg.n_chains * steps / film_cfg.npixels
        return filmlib.develop(film_cfg, film, mode="splat",
                               scale=b / n_per_pixel)

    hook = None if on_step is None else (
        lambda done, film: on_step(done, lambda: develop(film, done)))
    state, film, accmap, stats = run_chains(
        trace_fn, cfg, film_cfg, generator, state, n_steps, frozen_mask,
        accmap, pinned_mask, emitter_mask, lt_mask_fn, hook)
    steps = len(next(iter(stats.values()))) if stats else n_steps
    return develop(film, steps), dict(b=b, state=state, stats=stats,
                                      accmap=accmap, steps=steps)


def render_drmlt_path(scene, pcfg, cfg: DRMLTConfig, film_cfg, generator,
                      n_steps: int, average_luminance=None, n_mut: int = 64):
    """DRMLT over the unidirectional path technique on generator.device.

    With cfg.use_mixture, cfg.acceptance_map or a filter footprint other
    than 1 this is render_drmlt over the path kernel (drmlt.py:405-409).
    Otherwise the chain kernel: bootstrap (path kernel), packed chain
    state, ceil(n_steps / n_mut) chain-kernel launches (n_mut forced to 16
    when n_steps < 32), then img = film * b / (n_chains * steps_eff /
    npixels).  The generator's draws, in order: bootstrap vectors,
    resampling uniforms, the chain kernel's seed.  Returns (image (H, W,
    3), aux) like the reference."""
    device = generator.device
    n_dims = pcfg.n_dims + pcfg.n_dims % 2   # orbital needs even dims
    trace_fn = make_path_trace(scene, pcfg, device)
    if (cfg.use_mixture or cfg.acceptance_map
            or film_cfg.filter.footprint != 1):
        return render_drmlt(trace_fn, cfg, film_cfg, generator, n_dims,
                            n_steps, average_luminance=average_luminance)
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
