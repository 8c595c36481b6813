"""Kelemen's weights over the pooled MMLT trace are biased by its pinned
depth dim, in the JAX reference as in the port, by the amount the
estimator predicts.

The pooled MMLT technique pins the depth dim u[0] (depth = 1 + floor(u0
K)): a chain's large steps draw every other dim afresh and keep its depth.
Kelemen's weights (pssmlt_proc.cpp:205-215) take a large step as a uniform
sample of the whole primary sample space, at density p_large.  Per step
and chain, the expected splat at a point z of depth k is then

    f(z) (I(z)/b + K s_k p_large) / (I(z)/b + p_large),

s_k the share of the chains at depth k: the chains' states land at density
I/b, their large steps at K s_k p_large (uniform over a slice of measure
1/K that s_k of the chains hold).  Unless s_k = 1/K that is not f(z), the
plain Monte-Carlo value; Veach's weights have no such term.

A case runs one implementation's PSSMLT steps over its own pooled MMLT
trace of tests/data/cornell.xml (the file's maxDepth 4, p_large 0.3), both
weight styles on the same draws and so on the same chains, and holds each
channel's ratio of the Kelemen image to the Veach image to that
expectation, taken over a plain-MC pool of the same trace with the run's b
and s_k.  The chains start from the pool, resampled in proportion to
luminance (the bootstrap); both implementations get the same numpy pool.
8,192 chains x 16 steps; in trials over three pools the ratio kept within
0.003 of the expectation, which lies 0.01 / 0.026 / 0.039 above 1.  The
reference's case runs here, the port's in tests/test_torch_pssmlt_host.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drmlt_mitsuba_tpu.integrators import pssmlt as jps
from drmlt_mitsuba_tpu.integrators.mcmc import (
    state_from_splats as jax_state_from_splats,
)
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.xml import load_scene_xml as jax_load_scene
from drmlt_mitsuba_tpu.utils import cli as jax_cli
from drmlt_mitsuba_tpu_torch.integrators import pssmlt
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_masks,
)
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.utils import cli

torch.set_num_threads(1)

CORNELL = "tests/data/cornell.xml"
C, STEPS, POOL = 8192, 16, 4     # chains, steps, pool batches of C
TOL = 0.006                      # per channel, on the ratio


class _Memo:
    """trace_fn that returns its last splats again for an equal input: the
    two weight styles' steps trace the same proposal."""

    def __init__(self, trace, equal):
        self.trace, self.equal, self.u, self.sp = trace, equal, None, None

    def __call__(self, u):
        if self.u is None or not self.equal(u, self.u):
            self.u, self.sp = u, self.trace(u)
        return self.sp


def _pool():
    rng = np.random.default_rng(7)
    return ([rng.random((C, 24), dtype=np.float32) for _ in range(POOL)],
            rng.random(C))


def _start(u, lum, pick):
    """Indices of the chains' start vectors in the pool, resampled in
    proportion to luminance by cdf inversion (mcmc.py:bootstrap)."""
    cdf = np.cumsum(lum)
    return np.clip(np.searchsorted(cdf, pick * cdf[-1]), 0, len(lum) - 1)


def _expected_ratio(f, lum, u0, b, chain_u0, K, p_large):
    """Per channel, E[Kelemen image] / E[image] (the module docstring)."""
    k = np.minimum(np.floor(u0 * K), K - 1).astype(int)
    ck = np.minimum(np.floor(chain_u0 * K), K - 1).astype(int)
    s = np.bincount(ck, minlength=K) / len(ck)
    r = (lum / b + K * s[k] * p_large) / (lum / b + p_large)
    return (f * r[:, None]).sum(0) / f.sum(0)


def _lum_value(lum, value):
    lum = np.asarray(lum, np.float64)
    ok = np.isfinite(lum) & (lum >= 0)
    return (np.where(ok, lum, 0.0),
            np.where(ok[:, None], np.asarray(value, np.float64).sum(1), 0.0))


def run_reference(pool, pick):
    scene, settings = jax_load_scene(CORNELL, {})
    icfg = dict(settings.integrator, technique="mmlt")
    trace, n, _, pinned, _ = jax_cli.build_trace(scene, settings, icfg)
    assert n == pool[0].shape[1]
    tj = jax.jit(trace)
    sps = [tj(jnp.asarray(u)) for u in pool]
    lum, f = _lum_value(np.concatenate([sp.lum for sp in sps]),
                        np.concatenate([sp.value for sp in sps]))
    u = np.concatenate(pool)
    b = float(lum.mean())
    u0 = jnp.asarray(u[_start(u, lum, pick)])
    state = jax_state_from_splats(u0, tj(u0))
    cfgs = {w: jps.PSSMLTConfig(n_chains=C, kelemen_style_weights=w)
            for w in (True, False)}
    fc = jfilm.make_film_config(settings.width, settings.height, "box")
    films = {w: jfilm.new_film(fc) for w in cfgs}

    @functools.partial(jax.jit, static_argnums=0)
    def step(cfg, carry, key, sp):
        """The reference's pssmlt_step, compiled, over the splats `sp` of
        the proposal traced outside it (the two weight styles trace the
        same proposal); also returns the proposal it traced."""
        seen = []

        def trace_fn(u):
            seen.append(u)
            return sp
        out = jps.pssmlt_step(trace_fn, cfg, jnp.float32(b), fc, carry, key,
                              pinned)
        return out, seen[0]

    propose = jax.jit(jps.propose, static_argnums=0)
    for i in range(STEPS):
        key = jax.random.PRNGKey(100 + i)
        u_prop, _ = propose(cfgs[True], jax.random.split(key)[0], state.u,
                            pinned)
        sp = tj(u_prop)
        for w in cfgs:
            ((nxt, films[w]), _), u_in = step(cfgs[w], (state, films[w]),
                                              key, sp)
            assert bool(jnp.array_equal(u_in, u_prop))
        state = nxt
    sums = {w: np.asarray(films[w], np.float64)[..., :3].sum((0, 1))
            for w in cfgs}
    return (sums[True] / (sums[False] * b), f, lum, u[:, 0], b,
            np.asarray(state.u[:, 0]), int(icfg["maxDepth"]),
            cfgs[True].p_large)


def run_port(pool, pick):
    scene, settings = cli.load_scene(CORNELL, {})
    K = int(settings.integrator["maxDepth"])
    bcfg = BDPTConfig(max_depth=K, light_image=True,
                      thinlens=cli._thinlens(scene))
    _, pinned, n = mmlt_masks(bcfg)
    assert n == pool[0].shape[1]
    trace = make_mmlt_trace(scene, bcfg, "cpu")
    sps = [trace(torch.from_numpy(u)) for u in pool]
    lum, f = _lum_value(torch.cat([sp.lum for sp in sps]).numpy(),
                        torch.cat([sp.value for sp in sps]).numpy())
    u = np.concatenate(pool)
    b = float(lum.mean())
    u0 = torch.from_numpy(u[_start(u, lum, pick)])
    state = state_from_splats(u0, trace(u0))
    memo = _Memo(trace, torch.equal)
    cfgs = {w: pssmlt.PSSMLTConfig(n_chains=C, kelemen_style_weights=w)
            for w in (True, False)}
    fc = film.make_film_config(settings.width, settings.height, "box")
    films = {w: film.new_film(fc, "cpu") for w in cfgs}
    gen = torch.Generator().manual_seed(100)
    bt = torch.tensor(b, dtype=torch.float32)
    for _ in range(STEPS):
        draws = pssmlt.draw_uniforms(gen, C, n)
        for w in cfgs:
            (nxt, films[w]), _ = pssmlt.pssmlt_step_from_uniforms(
                memo, cfgs[w], bt, fc, (state, films[w]), draws, pinned)
        state = nxt
    sums = {w: films[w].double()[..., :3].sum((0, 1)).numpy() for w in cfgs}
    return (sums[True] / (sums[False] * b), f, lum, u[:, 0], b,
            state.u[:, 0].numpy(), K, cfgs[True].p_large)


def check_against_expectation(run):
    """The Kelemen / Veach image ratio of each channel within TOL of the
    estimator's expectation, which lies more than 5 TOL above 1 in some
    channel and above 1 in all: the bias is the estimator's."""
    pool, pick = _pool()
    ratio, f, lum, u0, b, chain_u0, K, p_large = run(pool, pick)
    assert K == 4 and np.all(np.isfinite(ratio))
    expected = _expected_ratio(f, lum, u0, b, chain_u0, K, p_large)
    np.testing.assert_allclose(ratio, expected, rtol=0, atol=TOL)
    assert expected.max() - 1.0 > 5 * TOL, expected
    assert np.all(expected > 1.0), expected


def test_reference_kelemen_weights_over_pinned_depth_match_expectation():
    """The JAX reference's pssmlt_step over its pooled MMLT trace (the
    port's counterpart runs in tests/test_torch_pssmlt_host.py, so that
    each file runs in at most 25 s)."""
    check_against_expectation(run_reference)
