"""The port's DRMLT chain step (the plain twin of its CUDA chain kernel) vs
the JAX reference on identical uniforms.

The reference chain kernel (ops/pallas/megadrmlt.py, technique="path")
reads every uniform from an input array in a documented order when run
with debug_uniforms; the port's twin reads the same array in the same
order.  One case runs the reference Pallas kernel in interpret mode; the
other types and splat modes run against the reference test-suite's
pure-JAX loop `_reference_multistep` (tests/test_megadrmlt.py) fed the XLA
trace_paths, and the timid_after_large cases, which that loop does not
take, against the reference's own DRMLT step (integrators/drmlt.py:
drmlt_step) with its draws answered from the same uniforms.  Tolerances are those of the reference's own kernel-vs-loop
test (tests/test_megadrmlt.py:437-444): state u to 2e-5, lum rtol 2e-4,
film (scaled by its max) to 5e-3.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_megadrmlt import _reference_multistep

from drmlt_mitsuba_tpu.integrators import drmlt as JDR
from drmlt_mitsuba_tpu.integrators.drmlt import DRMLTConfig as JDRMLTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mcmc import ChainState as JChainState
from drmlt_mitsuba_tpu.integrators.mcmc import select_state as jax_select
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.ops.pallas import megadrmlt as JMD
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.core.rng import philox_uniforms
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (
    ChainState, bootstrap, bootstrap_from_uniforms, select_state,
    state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.path import Splats, make_path_trace
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops.megatrace import make_tables
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

C = 64
DEPTH = 2


@pytest.fixture(scope="module")
def ref_trace():
    """The reference XLA trace of the 32x32 box, compiled once."""
    jscene = jax_cornell(32, 32)
    jcfg = JPathConfig(max_depth=DEPTH, rr_depth=100)
    return jax.jit(lambda u: jax_trace(jscene, jcfg, u[:, :jcfg.n_dims]))


def _setup(W, H, seed):
    """Port tables and a starting chain state (every lum > 0) built by the
    port's trace; the reference gets the same numbers as numpy."""
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    scene = cornell_box(W, H)
    trace = make_path_trace(scene, pcfg, "cpu")
    cand = torch.from_numpy(np.random.default_rng(seed).random(
        (16 * C, D), dtype=np.float32))
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    st = state_from_splats(u0, trace(u0))
    jst = JChainState(u=jnp.asarray(st.u.numpy()),
                      lum=jnp.asarray(st.lum.numpy()),
                      pos=jnp.asarray(st.pos.numpy()),
                      value=jnp.asarray(st.value.numpy()))
    return MD.pack_chain_state(st), jst, make_tables(scene, pcfg, "cpu"), D


def _run_port(tables, cfg, n_mut, state0, W, H, uni):
    state = state0.clone()
    film = torch.zeros((H, W, 3))
    stats = torch.zeros((6, C))
    MD.drmlt_chain_step(tables, cfg, n_mut, state, film, stats, 0, 0,
                       torch.from_numpy(uni))
    return MD.unpack_chain_state(state, state.shape[0] - 6), film, stats


def _compare(got, film, ref_u, ref_lum, ref_film):
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref_u), atol=2e-5)
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(ref_lum),
                               rtol=2e-4, atol=1e-6)
    a, b = film.numpy(), np.asarray(ref_film)[..., :3]
    scale = np.abs(b).max() + 1e-8
    assert scale > 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)


def test_chain_twin_matches_interpret_kernel():
    """Orbital, three-state splat, against the reference Pallas chain
    kernel in interpret mode (its film needs H % 8 == 0, W % 128 == 0)."""
    W, H, n_mut = 128, 32, 2
    state0, jst0, tables, D = _setup(W, H, 21)
    cfg = DRMLTConfig(type="orbital", n_chains=C)
    n_rand = MD.n_rand(cfg, D)
    assert n_rand == 3 + D + 3 * (D // 2)
    uni = np.random.default_rng(8).random((n_mut * n_rand, C),
                                          dtype=np.float32)
    step = JMD.make_mega_drmlt(
        jax_cornell(W, H), JPathConfig(max_depth=DEPTH, rr_depth=100),
        JDRMLTConfig(type="orbital", n_chains=C),
        jfilm.make_film_config(W, H, "box"), DEPTH, D, n_mut=n_mut,
        interpret=True, passes=2, debug_uniforms=True, lane_block=C // 8,
        technique="path")
    out, film_d, stats = step(JMD.pack_chain_state(jst0, D),
                              jnp.asarray([0, 0], jnp.int32),
                              jnp.asarray(uni.reshape(-1, 8, C // 8)))
    ref = JMD.unpack_chain_state(out, D)
    got, film, st = _run_port(tables, cfg, n_mut, state0, W, H, uni)
    _compare(got, film, ref.u, ref.lum, film_d)
    np.testing.assert_allclose(st.sum(1).numpy(), np.asarray(stats),
                               rtol=1e-5, atol=1e-6)


class _Draws:
    """jax.random as integrators/drmlt.py:drmlt_step draws from it, for one
    mutation: each draw is answered from the twin's uniforms U (n_rand, C)
    of that mutation (ops/megadrmlt.py gives their order).  The keys are
    the names of the draws."""

    def __init__(self, drtype, U, D):
        C, P = U.shape[1], D // 2
        T = U.T
        if drtype == "orbital":
            kern = np.zeros((C, P, 2, 2), np.float32)    # radius, angle
            kern[:, :, 0, 0] = T[:, 1 + D:1 + D + P]
            kern[:, :, 1, 0] = T[:, 1 + D + P:1 + 2 * D]
            stage2 = np.stack([T[:, 1 + 2 * D:1 + 2 * D + P]] * 2, -1)
            j = 1 + 2 * D + P
        else:
            kern = np.stack([T[:, 1 + D:1 + 2 * D]] * 2, -1)
            stage2 = np.stack([T[:, 1 + 2 * D:1 + 3 * D],
                               T[:, 1 + 3 * D:1 + 4 * D]], -1)
            j = 1 + 4 * D
        self.draws = dict(coin=U[0], large=T[:, 1:1 + D], kern=kern,
                          stage2=stage2, acc1=U[j], acc2=U[j + 1])

    def split(self, key, n):
        return (("stage1", "stage2", "acc1", "acc2") if key is None
                else ("coin", "large", "kern"))

    def uniform(self, key, shape):
        return jnp.asarray(self.draws[key]).reshape(shape)


def jax_drmlt_steps(monkeypatch, trace, jcfg, fc, jst, uni, n_mut, frozen):
    """n_mut mutations of the reference's integrators/drmlt.py:drmlt_step
    (three-state splat) on the twin's uniforms: (state, film, summed
    stats a1, a2, accept1, accept2, large over chains and mutations)."""
    n_rand = uni.shape[0] // n_mut
    C, D = jst.u.shape
    film = jfilm.new_film(fc)
    sums = np.zeros(5)
    for m in range(n_mut):
        draws = _Draws(jcfg.type, uni[m * n_rand:(m + 1) * n_rand], D)
        monkeypatch.setattr(JDR, "jax", types.SimpleNamespace(
            random=draws, tree=jax.tree))
        (jst, film, _), st = JDR.drmlt_step(trace, jcfg, fc, frozen,
                                            (jst, film, None), None)
        sums += C * np.asarray([st[k] for k in ("a1", "a2", "accept1",
                                                "accept2", "large")])
    monkeypatch.undo()
    return jst, film, sums


@pytest.mark.parametrize("drtype,mode,timid", [
    ("green", "three", False), ("mira", "three", False),
    ("orbital", "sampled", False), ("green", "three", True),
    ("orbital", "three", True)], ids=[
    "green-three", "mira-three", "orbital-sampled", "green-three-timid",
    "orbital-three-timid"])
def test_chain_twin_matches_reference_loop(ref_trace, monkeypatch, drtype,
                                           mode, timid):
    """timid: stage 2 after large steps too, held to drmlt_step, with the
    stats (a1, a2, accept1, accept2, large) summed over chains to 1e-5."""
    W, H, n_mut = 32, 32, 2
    state0, jst0, tables, D = _setup(W, H, 13)
    cfg = DRMLTConfig(type=drtype, n_chains=C, splat_mode=mode,
                      timid_after_large=timid)
    jcfg = JDRMLTConfig(type=drtype, n_chains=C, splat_mode=mode,
                        timid_after_large=timid, fuse_traces=False)
    fc = jfilm.make_film_config(W, H, "box")
    n_rand = MD.n_rand(cfg, D)
    uni = np.random.default_rng(6).random((n_mut * n_rand, C),
                                          dtype=np.float32)
    got, film, stats = _run_port(tables, cfg, n_mut, state0, W, H, uni)
    if timid:
        ref_state, ref_film, ref_stats = jax_drmlt_steps(
            monkeypatch, ref_trace, jcfg, fc, jst0, uni, n_mut,
            jnp.zeros((D,), bool))
        np.testing.assert_allclose(stats.sum(1)[:5].numpy(), ref_stats,
                                   rtol=1e-5, atol=1e-4)
    else:
        ref_state, ref_film = _reference_multistep(
            ref_trace, jcfg, fc, DEPTH, jst0, jnp.asarray(uni), n_mut,
            n_rand, splat_mode=mode, frozen0=False)
    _compare(got, film, ref_state.u, ref_state.lum, ref_film)


def test_philox_stream_equals_uniform_mode():
    """Without uniforms the step draws the Philox stream of core/rng.py:
    the same result as passing that stream in explicitly."""
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    tables = make_tables(cornell_box(16, 16), pcfg, "cpu")
    trace = make_path_trace(cornell_box(16, 16), pcfg, "cpu")
    u = torch.from_numpy(np.random.default_rng(2).random((C, D),
                                                         dtype=np.float32))
    state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    cfg = DRMLTConfig(type="green", splat_mode="sampled")
    n_rand = MD.n_rand(cfg, D)
    outs = []
    for uni in (None, torch.cat([philox_uniforms(99, 4, m, n_rand, C)
                                 for m in range(2)])):
        st, film, stats = (state0.clone(), torch.zeros(16, 16, 3),
                           torch.zeros(6, C))
        outs.append(MD.drmlt_chain_step(tables, cfg, 2, st, film, stats, 99, 4,
                                       uni))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uniforms shape"):
        MD.drmlt_chain_step(tables, cfg, 2, state0.clone(),
                           torch.zeros(16, 16, 3), torch.zeros(6, C), 0, 0,
                           torch.zeros(3, C))


def test_bootstrap_matches_reference_formula():
    """b and the resampled indices equal the reference's bootstrap
    arithmetic (mcmc.py:48-85) on the same luminances and uniforms; the
    chosen states replay (re-tracing u0 gives their lum)."""
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    path_trace = make_path_trace(cornell_box(16, 16), pcfg, "cpu")
    traced = []

    def trace(u):
        sp = path_trace(u)
        traced.append(sp.lum)
        return sp

    rng = np.random.default_rng(4)
    u = rng.random((8192, pcfg.n_dims), dtype=np.float32)
    u_pick = rng.random(256, dtype=np.float32)
    state, b, idx = bootstrap_from_uniforms(trace, torch.from_numpy(u),
                                            torch.from_numpy(u_pick), 256)
    lums = jnp.asarray(traced[0].numpy())
    lums = jnp.where(jnp.isfinite(lums) & (lums >= 0), lums, 0.0)
    cdf = jnp.cumsum(lums)
    ref_idx = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u_pick) * cdf[-1]),
                       0, 8191)
    np.testing.assert_allclose(float(b), float(jnp.sum(lums) / 8192),
                               rtol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(state.u.numpy(), u[idx.numpy()])
    assert float(state.lum.min()) > 0
    torch.testing.assert_close(state.lum, traced[1])

    # bootstrap() draws n_total = ceil(n / 8192) * 8192 vectors, then the
    # resampling uniforms, from its generator (luminance stand-in: u[:, 0])
    def fake(u):
        return Splats(pos=u[:, None, :2], value=u[:, None, :3], lum=u[:, 0])

    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    s1, b1 = bootstrap(fake, g1, 6, 100, 32)
    u2 = torch.rand((8192, 6), generator=g2)
    s2, b2, _ = bootstrap_from_uniforms(fake, u2,
                                        torch.rand(32, generator=g2), 32)
    assert float(b1) == float(b2) and torch.equal(s1.u, s2.u)
    assert torch.rand(1, generator=g1).item() == torch.rand(
        1, generator=g2).item()


def test_chain_state_layout_and_n_rand():
    st = ChainState(u=torch.rand(32, 8), lum=torch.rand(32),
                    pos=torch.rand(32, 1, 2), value=torch.rand(32, 1, 3))
    arr = MD.pack_chain_state(st)
    assert arr.shape == (14, 32) and arr.is_contiguous()
    back = MD.unpack_chain_state(arr, 8)
    for f in ("u", "lum", "pos", "value"):
        assert torch.equal(getattr(back, f), getattr(st, f))
    ref = JMD.pack_chain_state(JChainState(
        u=jnp.asarray(st.u.numpy()), lum=jnp.asarray(st.lum.numpy()),
        pos=jnp.asarray(st.pos.numpy()),
        value=jnp.asarray(st.value.numpy())), 8)
    np.testing.assert_array_equal(np.asarray(ref).reshape(14, 32),
                                  arr.numpy())
    # select_state picks the proposal where accepted, lane by lane
    other = ChainState(u=torch.rand(32, 8), lum=torch.rand(32),
                       pos=torch.rand(32, 1, 2), value=torch.rand(32, 1, 3))
    acc = torch.rand(32) < 0.5

    def to_jax(s):
        return JChainState(**{f: jnp.asarray(getattr(s, f).numpy())
                              for f in ("u", "lum", "pos", "value")})

    sel = select_state(acc, other, st)
    ref_sel = jax_select(jnp.asarray(acc.numpy()), to_jax(other), to_jax(st))
    for f in ("u", "lum", "pos", "value"):
        np.testing.assert_array_equal(getattr(sel, f).numpy(),
                                      np.asarray(getattr(ref_sel, f)))
    # the slice's D = 76: the reference's n_rand formula (megadrmlt.py:585)
    for t, n in (("orbital", 193), ("green", 307), ("mira", 307)):
        for mode, extra in (("three", 0), ("sampled", 1)):
            assert MD.n_rand(DRMLTConfig(type=t, splat_mode=mode),
                             76) == n + extra
