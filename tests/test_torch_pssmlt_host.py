"""The host form of the port's PSSMLT (integrators/pssmlt.py) vs the JAX
reference: propose and step against the reference's on the very uniforms
its jax.random.split draws, over one analytic trace written in both
frameworks (state to 1e-5, film to 1e-4 relative).  render_pssmlt is held
to plain MC in tests/test_torch_pssmlt_render.py; Kelemen's weights over
the pooled MMLT trace to their expectation here and, for the reference, in
tests/test_torch_pssmlt_bias.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators import pssmlt as jps
from drmlt_mitsuba_tpu.integrators.mcmc import (
    state_from_splats as jax_state_from_splats,
)
from drmlt_mitsuba_tpu.integrators.path import Splats as JSplats
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (
    PSSMLTConfig, StepUniforms, propose_from_uniforms,
    pssmlt_step_from_uniforms,
)
from drmlt_mitsuba_tpu_torch.render import film
from test_torch_pssmlt_bias import check_against_expectation, run_port

torch.set_num_threads(1)


def _jax_trace_fn(u):
    """An analytic stand-in for a trace, zero on a quarter of PSS."""
    rgb = jnp.stack([u[:, 2] + 0.1, u[:, 3] * u[:, 4], 0.5 * u[:, 5]], -1)
    rgb = jnp.where((u[:, 2] < 0.25)[:, None], 0.0, rgb)
    lum = 0.212671 * rgb[:, 0] + 0.715160 * rgb[:, 1] + 0.072169 * rgb[:, 2]
    return JSplats(pos=u[:, None, :2], value=rgb[:, None, :], lum=lum)


def _torch_trace_fn(u):
    rgb = torch.stack([u[:, 2] + 0.1, u[:, 3] * u[:, 4], 0.5 * u[:, 5]], -1)
    rgb = torch.where((u[:, 2] < 0.25)[:, None], 0.0, rgb)
    lum = 0.212671 * rgb[:, 0] + 0.715160 * rgb[:, 1] + 0.072169 * rgb[:, 2]
    return Splats(pos=u[:, None, :2], value=rgb[:, None, :], lum=lum)


@jax.jit
def _reference_draws(key, u):
    """The uniforms the reference's pssmlt_step draws from `key` for the
    chain vectors u (pssmlt.py:62-66, 99)."""
    n, d = u.shape
    k_prop, k_acc = jax.random.split(key)
    k_coin, k_large, k_kern, _ = jax.random.split(k_prop, 4)
    return (jax.random.uniform(k_coin, (n,)),
            jax.random.uniform(k_large, (n, d)),
            jax.random.uniform(k_kern, (n, d, 2)),
            jax.random.uniform(k_acc, (n,)))


@pytest.mark.parametrize("kelemen", [True, False],
                         ids=["kelemen", "veach"])
def test_propose_and_step_match_reference(kelemen):
    """Three steps of 1024 chains over 12 dims, dim 0 pinned, p_lens and
    p_caustic 0.2 (Kelemen mutation and weights, or Gaussian mutation and
    Veach weights); lanes whose proposal has zero luminance (a == 0, the
    swapped Kelemen weight) are present."""
    n, d, b, w = 1024, 12, 0.3, 8
    kw = dict(n_chains=n, kelemen_style_mutation=kelemen,
              kelemen_style_weights=kelemen, p_lens=0.2, p_caustic=0.2,
              caustic_dims=5)
    cfg, jcfg = PSSMLTConfig(**kw), jps.PSSMLTConfig(**kw)
    pinned = torch.zeros(d, dtype=torch.bool)
    pinned[0] = True
    u0 = np.random.default_rng(3).random((n, d), dtype=np.float32)
    u0[:, 2] = 0.3 + 0.7 * u0[:, 2]                # every start lit
    st = state_from_splats(torch.from_numpy(u0),
                           _torch_trace_fn(torch.from_numpy(u0)))
    jst = jax_state_from_splats(jnp.asarray(u0), _jax_trace_fn(
        jnp.asarray(u0)))
    fc = film.make_film_config(w, w, "box")
    jfc = jfilm.make_film_config(w, w, "box")
    fm, jfm = film.new_film(fc, "cpu"), jfilm.new_film(jfc)
    jpropose = jax.jit(jps.propose, static_argnums=0)
    jstep = jax.jit(jps.pssmlt_step, static_argnums=(0, 1, 3))
    zero_a = 0
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        draws = StepUniforms(*(torch.from_numpy(np.array(x))
                               for x in _reference_draws(key, jst.u)))
        u_ref, large_ref = jpropose(jcfg, jax.random.split(key)[0],
                                       jst.u, jnp.asarray(pinned.numpy()))
        u_got, large = propose_from_uniforms(cfg, st.u, draws, pinned)
        np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref),
                                   atol=1e-5)
        assert np.array_equal(large.numpy(), np.asarray(large_ref))
        zero_a += int((_torch_trace_fn(u_got).lum == 0).sum())
        (st, fm), stats = pssmlt_step_from_uniforms(
            _torch_trace_fn, cfg, torch.tensor(b), fc, (st, fm), draws,
            pinned)
        (jst, jfm), jstats = jstep(
            _jax_trace_fn, jcfg, jnp.float32(b), jfc, (jst, jfm), key,
            jnp.asarray(pinned.numpy()))
        np.testing.assert_allclose(st.u.numpy(), np.asarray(jst.u),
                                   atol=1e-5)
        np.testing.assert_allclose(st.lum.numpy(), np.asarray(jst.lum),
                                   rtol=1e-5)
        np.testing.assert_allclose(fm.numpy(), np.asarray(jfm), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jfm).max()))
        assert float(stats["accept"]) == pytest.approx(
            float(jstats["accept"]), abs=1e-6)
    assert zero_a > 0
    assert bool((st.u[:, 0] == torch.from_numpy(u0[:, 0])).all())  # pinned


def test_splat_state_and_masks_match_reference():
    """integrators/mcmc.py:splat_state (two splats per chain, each with
    its chain's weight) and mmlt_masks against the reference's on the same
    numbers."""
    from drmlt_mitsuba_tpu.integrators import mmlt as jmmlt
    from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPT
    from drmlt_mitsuba_tpu.integrators.mcmc import (
        splat_state as jax_splat_state,
    )
    from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
    from drmlt_mitsuba_tpu_torch.integrators.mcmc import splat_state
    from drmlt_mitsuba_tpu_torch.integrators.mmlt import mmlt_masks

    rng = np.random.default_rng(9)
    pos = rng.random((300, 2, 2), dtype=np.float32)
    pos[0, 0] = (1.0, 0.5)                         # on the edge: dropped
    value = rng.random((300, 2, 3), dtype=np.float32)
    w = rng.random(300, dtype=np.float32)
    fc = film.make_film_config(12, 10, "box")
    got = splat_state(fc, film.new_film(fc, "cpu"), torch.from_numpy(pos),
                      torch.from_numpy(value), torch.from_numpy(w))
    ref = jax_splat_state(jfilm.make_film_config(12, 10, "box"),
                          jfilm.new_film(jfilm.make_film_config(12, 10,
                                                                "box")),
                          jnp.asarray(pos), jnp.asarray(value),
                          jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)

    for depth in (1, 4, 5):
        for even in (True, False):
            got = mmlt_masks(BDPTConfig(max_depth=depth), even)
            ref = jmmlt.mmlt_masks(JBDPT(max_depth=depth), even)
            assert got[2] == ref[2]
            for a, b in zip(got[:2], ref[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_kelemen_weights_over_pinned_depth_match_expectation():
    """The port's pssmlt_step over its pooled MMLT trace (the twin of the
    MMLT kernel) on tests/data/cornell.xml: the Kelemen / Veach image ratio
    against the estimator's expectation, as the reference's is in
    tests/test_torch_pssmlt_bias.py."""
    check_against_expectation(run_port)
