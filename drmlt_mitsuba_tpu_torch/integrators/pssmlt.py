"""PSSMLT: Kelemen-style primary-sample-space MLT (counterpart of
drmlt_mitsuba_tpu/integrators/pssmlt.py).

One step advances every chain: propose (a large step draws fresh uniforms,
a small step adds Kelemen-hole or Gaussian offsets to every dim, or
perturbs only the image dims or the trailing dims), trace the proposal,
accept it by Metropolis, and splat both states with their expected
weights, Kelemen's or Veach's (pssmlt_proc.cpp:204-225).

`trace_fn(u) -> Splats` is the technique: the path kernel
(integrators/path.py:make_path_trace) or the pooled MMLT kernel
(integrators/mmlt.py:make_mmlt_trace, with `mmlt_masks`' pinned depth
dim), each on a CUDA device or as its twin on the CPU; the splats go
through render/film.py (the splat kernel on a CUDA film).  The step loop
runs on the host, one trace and two splats per step.

Kelemen's weights count a large step as a uniform sample of the whole
primary sample space (density p_large).  Under a pinned dim a chain's
large steps keep its depth: a depth k held by a share s_k of the chains
sees large steps at density K s_k p_large, and the image's expected splat
at a point z of depth k is f(z) (I(z)/b + K s_k p_large) / (I(z)/b +
p_large), not f(z).  Veach's weights are unbiased.  The reference computes
the same estimator, and the port keeps it (tests/test_torch_pssmlt_bias.py
holds both to that expectation).

Randomness.  `propose_from_uniforms` and `pssmlt_step_from_uniforms` take
their uniforms explicitly (`StepUniforms`: the mutation coin (C,), the
large-step vectors (C, D), the kernel pairs (C, D, 2) and the acceptance
uniform (C,), the reference's four `jax.random.split` draws);
`pssmlt_step` draws them from a torch.Generator in that order, and
`render_pssmlt` draws the bootstrap's first (integrators/mcmc.py).
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.core.rng import pss_wrap, uniform
from drmlt_mitsuba_tpu_torch.integrators import kernels
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (
    bootstrap, metropolis_clamp, select_state, splat_state, state_from_splats,
)
from drmlt_mitsuba_tpu_torch.render import film as filmlib


@dataclasses.dataclass(frozen=True)
class PSSMLTConfig:
    """Options of the reference pssmlt plugin (pssmlt.cpp:297-307).

    p_lens: the probability that a small step perturbs only the image-plane
    dims (a PSS analog of Veach's lens perturbation, mut_lens.cpp);
    p_caustic: that it perturbs only the trailing caustic_dims dims (the
    analog of the caustic perturbation, mut_caustic.cpp)."""
    n_chains: int = 8192
    p_large: float = 0.3
    kelemen_style_mutation: bool = True   # Kelemen hole vs Gaussian
    kelemen_style_weights: bool = True
    mutation_size_low: float = kernels.S1_DEFAULT
    mutation_size_high: float = kernels.S2_DEFAULT
    sigma: float = kernels.SIGMA_DEFAULT
    n_bootstrap: int = 100_000            # luminanceSamples
    p_lens: float = 0.0                   # lens-perturbation probability
    p_caustic: float = 0.0                # caustic-perturbation probability
    lens_sigma: float = 0.02              # image-space gaussian
    caustic_dims: int = 7                 # trailing dims for p_caustic


@dataclasses.dataclass
class StepUniforms:
    """The uniforms of one step of C chains over D dims."""
    coin: torch.Tensor      # (C,) large / lens / caustic / small pick
    u_large: torch.Tensor   # (C, D) a large step's vector
    u2: torch.Tensor        # (C, D, 2) the small-step kernels' pairs
    accept: torch.Tensor    # (C,) the Metropolis coin


def draw_uniforms(generator, n_chains: int, n_dims: int) -> StepUniforms:
    """One step's uniforms from `generator`, in the field order."""
    return StepUniforms(coin=uniform((n_chains,), generator),
                        u_large=uniform((n_chains, n_dims), generator),
                        u2=uniform((n_chains, n_dims, 2), generator),
                        accept=uniform((n_chains,), generator))


def small_step_kernel(cfg: PSSMLTConfig):
    if cfg.kelemen_style_mutation:
        return kernels.Kelemen(cfg.mutation_size_low, cfg.mutation_size_high)
    return kernels.Gaussian(cfg.sigma)


def propose_from_uniforms(cfg: PSSMLTConfig, u, draws: StepUniforms,
                          pinned_mask=None):
    """Full-state proposal of every chain: (u', large_step_mask).

    One coin picks, in this order of its intervals, a large step, a lens
    perturbation (the image dims 0-1 only, Gaussian(lens_sigma)), a
    caustic perturbation (the last caustic_dims dims only, the small-step
    kernel) or a full small step.  pinned_mask: (D,) dims never mutated
    (the pooled MMLT technique's depth dim)."""
    D = u.shape[1]
    coin = draws.coin
    large = coin < cfg.p_large
    pick_lens = ~large & (coin < cfg.p_large + cfg.p_lens)
    pick_caustic = (~large & ~pick_lens
                    & (coin < cfg.p_large + cfg.p_lens + cfg.p_caustic))
    du = small_step_kernel(cfg).sample(draws.u2)
    if cfg.p_lens > 0 or cfg.p_caustic > 0:
        dim = torch.arange(D, device=u.device)
        lens = kernels.Gaussian(cfg.lens_sigma).sample(draws.u2)
        du_lens = torch.where((dim < 2)[None, :], lens, 0.0)
        du = torch.where(pick_lens[:, None], du_lens, du)
        tail = (dim >= D - cfg.caustic_dims)[None, :]
        du = torch.where(pick_caustic[:, None],
                         torch.where(tail, du, 0.0), du)
    out = torch.where(large[:, None], draws.u_large, pss_wrap(u + du))
    if pinned_mask is not None:
        out = torch.where(pinned_mask[None, :], u, out)
    return out, large


def pssmlt_step_from_uniforms(trace_fn, cfg: PSSMLTConfig, b, film_cfg,
                              carry, draws: StepUniforms, pinned_mask=None):
    """One mutation of every chain; carry = (state, film).  Returns
    ((state, film), stats) with stats' accept and large shares."""
    state, film = carry
    u_prop, large = propose_from_uniforms(cfg, state.u, draws, pinned_mask)
    proposed = state_from_splats(u_prop, trace_fn(u_prop))
    a = metropolis_clamp(proposed.lum / torch.clamp(state.lum, min=1e-30))
    if cfg.kelemen_style_weights:
        # pssmlt_proc.cpp:205-215: the weights carry the 1/b pLarge MIS
        # with large steps; the film develops at 1/n instead of b/n
        den_cur = state.lum / b + cfg.p_large
        w_cur = (1.0 - a) * state.lum / den_cur
        w_prop = (a + large.float()) * proposed.lum / (proposed.lum / b
                                                       + cfg.p_large)
        w_prop = torch.where(a > 0, w_prop, 0.0)
        w_cur = torch.where(a > 0, w_cur, state.lum / den_cur)
    else:
        w_cur = 1.0 - a
        w_prop = a
    film = splat_state(film_cfg, film, state.pos, state.value, w_cur)
    film = splat_state(film_cfg, film, proposed.pos, proposed.value, w_prop)
    accept = draws.accept < a
    state = select_state(accept, proposed, state)
    return (state, film), dict(accept=accept.float().mean(),
                               large=large.float().mean())


def pssmlt_step(trace_fn, cfg: PSSMLTConfig, b, film_cfg, carry, generator,
                pinned_mask=None):
    """pssmlt_step_from_uniforms on a step's uniforms from `generator`."""
    u = carry[0].u
    return pssmlt_step_from_uniforms(
        trace_fn, cfg, b, film_cfg, carry,
        draw_uniforms(generator, u.shape[0], u.shape[1]), pinned_mask)


def render_pssmlt(trace_fn, cfg: PSSMLTConfig, film_cfg, generator,
                  n_dims: int, n_steps: int, average_luminance=None,
                  pinned_mask=None, on_step=None):
    """Full PSSMLT render on generator.device: bootstrap, n_steps steps,
    the developed image.

    Returns (image (H, W, 3), aux) with aux b, state, stats (accept and
    large per step, (steps,) each) and steps.  `average_luminance`
    overrides the bootstrap's b (drmlt.cpp:298-299).  The film develops at
    1/n with Kelemen's weights and at b/n with Veach's, n the mutations per
    pixel.  `on_step(done, develop)`, when given, is called after every
    step; develop() gives the image of the steps done, and a true return
    stops the render there, which then develops with the steps done."""
    device = generator.device
    state, b = bootstrap(trace_fn, generator, n_dims, cfg.n_bootstrap,
                         cfg.n_chains)
    if average_luminance is not None:
        b = torch.tensor(average_luminance, dtype=torch.float32,
                         device=device)
    film = filmlib.new_film(film_cfg, device)

    def develop(steps):
        n_per_pixel = cfg.n_chains * steps / film_cfg.npixels
        return filmlib.develop(film_cfg, film, mode="splat", scale=(
            1.0 / n_per_pixel if cfg.kelemen_style_weights
            else b / n_per_pixel))

    accept, large = [], []
    for i in range(n_steps):
        (state, film), st = pssmlt_step(trace_fn, cfg, b, film_cfg,
                                        (state, film), generator,
                                        pinned_mask)
        accept.append(st["accept"])
        large.append(st["large"])
        if on_step is not None and on_step(i + 1, lambda: develop(i + 1)):
            break
    steps = len(accept)
    stats = dict(accept=torch.stack(accept), large=torch.stack(large))
    return develop(steps), dict(b=b, state=state, stats=stats, steps=steps)
