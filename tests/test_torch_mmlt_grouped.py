"""The port's chain step in MMLT mode and its depth-grouped driver vs the
JAX reference.

The chain twin (ops/megadrmlt.py, technique "mmlt") is held to the
reference test-suite's pure-JAX mutation loop `_reference_multistep`
(tests/test_megadrmlt.py, frozen strategy dim) fed the reference's XLA
fixed-depth trace `make_mmlt_trace_fixed(force_xla=True)` on identical
uniforms (the timid_after_large case, which that loop does not take, to
the reference's integrators/drmlt.py:drmlt_step, as in
tests/test_torch_drmlt.py), with the tolerances of tests/test_torch_drmlt.py (the reference's
own kernel-vs-loop ones): state u to 2e-5, lum rtol 2e-4, film (scaled by
its max) to 5e-3.  The grouped render is held to the reference's pieces
composed the same way and, statistically, to the reference's Monte-Carlo
render (tests/test_mmlt_grouped.py: channel means to 0.15).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_megadrmlt import _reference_multistep
from test_torch_drmlt import jax_drmlt_steps

from drmlt_mitsuba_tpu.integrators.drmlt import DRMLTConfig as JDRMLTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mcmc import ChainState as JChainState
from drmlt_mitsuba_tpu.integrators.mcmc import (
    state_from_splats as jax_state_from_splats,
)
from drmlt_mitsuba_tpu.integrators.mmlt_grouped import (
    make_mmlt_trace_fixed as jax_fixed_trace,
)
from drmlt_mitsuba_tpu.integrators.path import render_pt as jax_render_pt
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.core.rng import philox_uniforms
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    make_mmlt_trace_fixed, render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

C = 1024        # chains; every reference trace runs at this width
K = 3           # the chain tests' group depth
W = H = 32


@pytest.fixture(scope="module")
def group():
    """A depth-K group on the 32x32 box: the port's tables and starting
    states (every lum > 0), and the reference's jitted XLA trace, compiled
    once (at C lanes) for the whole file; the box's geometry and camera do
    not depend on the film size."""
    trace, _, n_dims, tables = make_mmlt_trace_fixed(
        cornell_box(W, H), K, True, "cpu")
    cand = torch.from_numpy(np.random.default_rng(5).random(
        (4 * C, n_dims), dtype=np.float32))
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    st = state_from_splats(u0, trace(u0))
    jst = JChainState(**{f: jnp.asarray(getattr(st, f).numpy())
                         for f in ("u", "lum", "pos", "value")})
    jtrace = jax.jit(jax_fixed_trace(jax_cornell(W, H), K,
                                     force_xla=True)[0])
    return tables, MD.pack_chain_state(st), jst, jtrace, n_dims


def _run_twin(tables, cfg, n_mut, state0, uni):
    state = state0.clone()
    fm = torch.zeros((H, W, 3))
    stats = torch.zeros((6, C))
    MD.drmlt_chain_step(tables, cfg, n_mut, state, fm, stats, 0, 0,
                        torch.from_numpy(uni))
    return MD.unpack_chain_state(state, state.shape[0] - 6), fm


def _compare(got, fm, ref_state, ref_film):
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref_state.u),
                               atol=2e-5)
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(ref_state.lum),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref_state.pos),
                               atol=2e-5)
    a, b = fm.numpy(), np.asarray(ref_film)[..., :3]
    scale = np.abs(b).max() + 1e-8
    assert scale > 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)


@pytest.mark.parametrize("drtype,mode,timid", [
    ("orbital", "three", False), ("green", "sampled", False),
    ("mira", "three", False), ("green", "three", True)], ids=[
    "orbital-three", "green-sampled", "mira-three", "green-three-timid"])
def test_mmlt_chain_twin_matches_reference_loop(group, monkeypatch, drtype,
                                                mode, timid):
    tables, state0, jst0, jtrace, D = group
    n_mut = 2
    cfg = DRMLTConfig(type=drtype, n_chains=C, splat_mode=mode,
                      timid_after_large=timid)
    jcfg = JDRMLTConfig(type=drtype, n_chains=C, splat_mode=mode,
                        timid_after_large=timid, fuse_traces=False)
    fc = jfilm.make_film_config(W, H, "box")
    nr = MD.n_rand(cfg, D)
    uni = np.random.default_rng(9).random((n_mut * nr, C), dtype=np.float32)
    got, fm = _run_twin(tables, cfg, n_mut, state0, uni)
    if timid:
        ref_state, ref_film, _ = jax_drmlt_steps(
            monkeypatch, jtrace, jcfg, fc, jst0, uni, n_mut,
            jnp.arange(D) == 0)
    else:
        ref_state, ref_film = _reference_multistep(
            jtrace, jcfg, fc, K, jst0, jnp.asarray(uni), n_mut, nr,
            splat_mode=mode, frozen0=True)
    _compare(got, fm, ref_state, ref_film)
    # the frozen strategy dim moves on large steps only
    moved = got.u[:, 0] != state0[0]
    large = torch.from_numpy(uni[0::nr] < cfg.p_large).any(0)
    assert bool((~moved | large).all())


def test_chain_twin_traces_only_stage2_chains(group, monkeypatch):
    """Green, one mutation at a time on 256 chains: z is traced on exactly
    the chains that run stage 2 (y rejected on a small step, from the
    per-chain stats) and y* on those whose z carries light (from a twin
    that traces every chain), the work counts say so, and state, film and
    stats equal that twin's bit for bit."""
    tables, state0, _, _, D = group
    n = 256
    state0 = state0[:, :n].contiguous()
    cfg = DRMLTConfig(type="green", n_chains=n, splat_mode="three")
    nr = MD.n_rand(cfg, D)
    uni = torch.from_numpy(np.random.default_rng(12).random(
        (2 * nr, n), dtype=np.float32))
    gathered = MD._trace_lanes
    runs = {}
    for every in (True, False):
        seen = []

        def trace_lanes(tables, v, lanes, work, kind, every=every):
            out = (MD._trace(tables, v, work) if every
                   else gathered(tables, v, lanes, work, kind))
            seen.append((kind, lanes, out[0]))
            return out

        monkeypatch.setattr(MD, "_trace_lanes", trace_lanes)
        state, fm, stats = state0.clone(), torch.zeros((H, W, 3)), []
        works = []
        for m in range(2):
            st, work = torch.zeros((6, n)), {}
            MD.drmlt_chain_step_reference(tables, cfg, 1, state, fm, st, 0,
                                          0, uni[m * nr:(m + 1) * nr],
                                          work=work)
            stats.append(st)
            works.append(work)
        runs[every] = (state, fm, torch.stack(stats), seen, works)
    monkeypatch.undo()
    state, fm, stats, seen, works = runs[False]
    for m in range(2):
        do_second = (stats[m, 2] == 0) & (stats[m, 4] == 0)
        lum_z_every = runs[True][3][3 * m + 1][2]
        rev = do_second & (lum_z_every > 0)
        assert [k for k, _, _ in seen[3 * m:3 * m + 3]] == ["y", "z",
                                                           "y_rev"]
        assert torch.equal(seen[3 * m + 1][1], do_second)
        assert torch.equal(seen[3 * m + 2][1], rev)
        assert torch.equal(seen[3 * m + 1][2][do_second],
                           lum_z_every[do_second])
        assert works[m]["y_lanes"] == n
        assert works[m]["z_lanes"] == int(do_second.sum()) > 0
        assert works[m]["y_rev_lanes"] == int(rev.sum()) > 0
        assert works[m]["z_lanes"] < n and works[m]["y_rev_lanes"] < n
    for a, b in zip((state, fm, stats), runs[True][:3]):
        assert torch.equal(a, b)


def test_mmlt_chain_twin_fix_emitter_path(group):
    """fixEmitterPath: stage 2 keeps the light-walk dims unless the chain
    is light tracing.  For mira, a Box-Muller u1 of 0 is an exact zero
    step, so the reference loop without the option, fed uniforms whose
    light-dim u1 are zeroed on the chains that are not light tracing,
    makes the same proposals; it runs one mutation at a time so that the
    chains' current strategy is known."""
    tables, state0, jst0, jtrace, D = group
    n_mut = 2
    cfg = DRMLTConfig(type="mira", n_chains=C, fix_emitter_path=True)
    nr = MD.n_rand(cfg, D)
    uni = np.random.default_rng(11).random((n_mut * nr, C),
                                           dtype=np.float32)
    got, fm = _run_twin(tables, cfg, n_mut, state0, uni)
    em_lo = 1 + tables.eye_dims
    em_hi = em_lo + tables.light_dims
    fc = jfilm.make_film_config(W, H, "box")
    st, ref_film = jst0, 0.0
    n_fixed = 0
    for m in range(n_mut):
        u_m = uni[m * nr:(m + 1) * nr].copy()
        s_cur = np.minimum(np.floor(np.asarray(st.u[:, 0]) * (K + 1)), K)
        fixed = s_cur != K
        n_fixed += int(fixed.sum())
        g1 = 1 + 2 * D          # mira: large, D u_large, D u_kel, D u_g1
        u_m[g1 + em_lo:g1 + em_hi, fixed] = 0.0
        st, f_m = _reference_multistep(
            jtrace, JDRMLTConfig(type="mira", n_chains=C), fc, K, st,
            jnp.asarray(u_m), 1, nr, splat_mode="three", frozen0=True)
        ref_film = ref_film + np.asarray(f_m)
    assert 0 < n_fixed < n_mut * C
    assert 0 < int((got.u[:, em_lo:em_hi] != state0[em_lo:em_hi].T).any(1)
                   .sum())
    _compare(got, fm, st, ref_film)


def test_grouped_render_equals_reference_composition_and_mc(group):
    """16x16 box, 1024 chains, depth 3.  Exact: with the generator's draws
    replayed, the depth-3 group equals the reference's pieces composed the
    same way (XLA fixed-depth trace for the bootstrap and the chain starts,
    jnp.searchsorted resampling, the reference step loop on the chain
    kernel's Philox stream, the scale b_k / (N_k steps_eff / npixels));
    the groups run the same code at other widths, and the image is their
    sum.  Statistical: the image agrees with the reference's Monte-Carlo
    render of the box (tests/test_mmlt_grouped.py: channel means to
    0.15)."""
    _, _, _, jtrace, n_dims = group
    w = h = 16
    depth, n_steps, seed = K, 24, 7
    cfg = DRMLTConfig(type="orbital", n_chains=C, n_bootstrap=16384,
                      splat_mode="sampled")
    fc = film.make_film_config(w, h, "box")
    img, aux = render_drmlt_mmlt_grouped(
        cornell_box(w, h), BDPTConfig(max_depth=depth), cfg, fc,
        torch.Generator().manual_seed(seed), n_steps)
    assert sorted(aux["images"]) == [1, 2, 3]      # every group ran
    torch.testing.assert_close(img, sum(aux["images"].values()))
    assert aux["b"] == pytest.approx(sum(aux["b_k"]))
    assert aux["steps_eff"][K] == 16 and aux["sizes"][K - 1] == C

    # the generator's draws, in the driver's order: every group's
    # bootstrap vectors, then per group its resampling uniforms and seed
    g = torch.Generator().manual_seed(seed)
    boots = []
    for k in range(1, depth + 1):
        n = 1 + (3 * k - 1) + 5 + 3 * max(0, k - 2)
        boots.append(torch.rand((8192, n + n % 2), generator=g).numpy())
    for k in range(1, K):
        torch.rand(C, generator=g)
        torch.randint(0, 2 ** 31 - 1, (1,), generator=g)
    u_pick = torch.rand(C, generator=g).numpy()
    chain_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))

    u_boot = boots[K - 1]
    assert u_boot.shape[1] == n_dims
    lums = jnp.concatenate([jtrace(jnp.asarray(u_boot[i:i + C])).lum
                            for i in range(0, 8192, C)])
    lums = jnp.where(jnp.isfinite(lums) & (lums >= 0), lums, 0.0)
    bk = jnp.sum(lums) / 8192
    np.testing.assert_allclose(aux["b_k"][K - 1], float(bk), rtol=1e-5)
    cdf = jnp.cumsum(lums)
    idx = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u_pick) * cdf[-1]), 0,
                   8191)
    u0 = jnp.asarray(u_boot)[idx]
    state0 = jax_state_from_splats(u0, jtrace(u0))
    nr = MD.n_rand(cfg, n_dims)
    uni = torch.cat([philox_uniforms(chain_seed, 0, m, nr, C)
                     for m in range(16)]).numpy()
    jfc = jfilm.make_film_config(w, h, "box")
    _, f_k = _reference_multistep(
        jtrace, JDRMLTConfig(type="orbital", n_chains=C,
                             splat_mode="sampled"),
        jfc, K, state0, jnp.asarray(uni), 16, nr, splat_mode="sampled",
        frozen0=True)
    ref_k = np.asarray(f_k)[..., :3] * (float(bk) / (C * 16 / (w * h)))
    got_k = aux["images"][K].numpy()
    scale = np.abs(ref_k).max()
    assert scale > 0
    np.testing.assert_allclose(got_k / scale, ref_k / scale, atol=5e-3)

    pt = np.asarray(jfilm.develop(jfc, jax_render_pt(
        jax_cornell(w, h), JPathConfig(max_depth=depth, rr_depth=100),
        jax.random.PRNGKey(43), w * h * 256, jfc, mode="accum"),
        mode="accum")).mean((0, 1))
    got = img.numpy()
    assert np.all(np.isfinite(got))
    err = np.abs(got.mean((0, 1)) - pt).mean() / pt.mean()
    assert err < 0.15, err
