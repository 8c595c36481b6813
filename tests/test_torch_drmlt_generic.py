"""The port's generic DRMLT step (integrators/drmlt.py) vs the JAX reference.

propose_stage1 / propose_stage2 / mira_transition_ratio and three steps of
drmlt_step and of drmlt_mixture_step, for green, mira and orbital, against
the reference's functions on the very uniforms its jax.random.split tree
draws (`_reference_draws`), over one analytic trace written in both
frameworks (tests/test_torch_pssmlt_host.py): 1,024 chains over the 12
dims of the pooled MMLT encoding at max_depth 2, its depth dim pinned, its
strategy dim frozen, fixEmitterPath over its light dims.  State to 1e-5,
film to 1e-4 relative, the acceptance map exactly; the mira ratio to 1e-4
relative where finite (the Kelemen log-pdf is -inf outside [s1, s2] in
both).  Then the masks of the pooled and the grouped MMLT encodings
exactly, and render_drmlt over the path twin against the reference's
render_pt (tests/test_mcmc.py:135-170's gate).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators import drmlt as jdr
from drmlt_mitsuba_tpu.integrators import mmlt as jmmlt
from drmlt_mitsuba_tpu.integrators import mmlt_grouped as jgrp
from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mcmc import (
    state_from_splats as jax_state_from_splats,
)
from drmlt_mitsuba_tpu.integrators.path import render_pt as jax_render_pt
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators import drmlt as dr
from drmlt_mitsuba_tpu_torch.integrators import mmlt_grouped as grp
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    mmlt_emitter_mask, mmlt_lt_mask_fn, mmlt_masks,
)
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from test_torch_pssmlt_host import _jax_trace_fn, _torch_trace_fn

torch.set_num_threads(1)

N, W = 1024, 8
BCFG = BDPTConfig(max_depth=2)          # the pooled encoding's 12 dims
JBCFG = JBDPTConfig(max_depth=2)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _reference_draws(key, C, D, orbital, mixture):
    """The uniforms the reference's drmlt_step (drmlt.py:196, 106-113,
    141-146, 257, 290) or drmlt_mixture_step (:322-327) draws from `key`,
    in DRMLTUniforms' field order."""
    s1 = (C, D // 2, 2, 2) if orbital else (C, D, 2)
    s2 = (C, D // 2, 2) if orbital else (C, D, 2)
    if mixture:
        kp, kc, kacc = jax.random.split(key, 3)
        k1, k2, ka1, ka2 = kp, kp, kc, kacc
    else:
        k1, k2, ka1, ka2 = jax.random.split(key, 4)
    k_coin, k_large, k_kern = jax.random.split(k1, 3)
    u = jax.random.uniform
    return (u(k_coin, (C,)), u(k_large, (C, D)), u(k_kern, s1), u(k2, s2),
            u(ka1, (C,)), u(ka2, (C,)))


def _draws(key, C, D, orbital, mixture=False):
    return dr.DRMLTUniforms(*(torch.from_numpy(np.array(x)) for x in
                              _reference_draws(key, C, D, orbital, mixture)))


def _masks():
    """The pooled encoding's masks in both frameworks."""
    frozen, pinned, n = mmlt_masks(BCFG)
    assert n == 12
    em = mmlt_emitter_mask(BCFG, n)
    return (frozen, pinned, em, mmlt_lt_mask_fn(BCFG)), tuple(
        jnp.asarray(m.numpy()) for m in (frozen, pinned, em)) + (
        jmmlt.mmlt_lt_mask_fn(JBCFG),)


def _starts(seed):
    u0 = np.random.default_rng(seed).random((N, 12), dtype=np.float32)
    u0[:, 2] = 0.3 + 0.7 * u0[:, 2]                 # every start lit
    st = state_from_splats(torch.from_numpy(u0),
                           _torch_trace_fn(torch.from_numpy(u0)))
    jst = jax_state_from_splats(jnp.asarray(u0),
                                _jax_trace_fn(jnp.asarray(u0)))
    return u0, st, jst


def _close_state(st, jst):
    np.testing.assert_allclose(st.u.numpy(), np.asarray(jst.u), atol=1e-5)
    np.testing.assert_allclose(st.lum.numpy(), np.asarray(jst.lum),
                               rtol=1e-5, atol=1e-7)


def _close_film(fm, jfm):
    np.testing.assert_allclose(fm.numpy(), np.asarray(jfm), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jfm).max()))


@functools.partial(jax.jit, static_argnums=0)
def _reference_step(jcfg, carry, key, mix_carry, mix_key, masks):
    """One step of the reference's drmlt_step and of its
    drmlt_mixture_step, with the proposals and the mira ratio that step
    draws from its stage keys (drmlt.py:196-208); one compile a type."""
    frozen, pinned, em = masks
    lt = jmmlt.mmlt_lt_mask_fn(JBCFG)
    x = carry[0].u
    k1, k2, _, _ = jax.random.split(key, 4)
    y, large = jdr.propose_stage1(jcfg, k1, x, frozen, pinned)
    free2 = em[None, :] & ~lt(x)[:, None]
    z = jdr.propose_stage2(jcfg, k2, x, y, frozen, pinned, free2)
    q = jdr.mira_transition_ratio(jcfg, x, y, z, frozen, pinned)
    out = jdr.drmlt_step(_jax_trace_fn, jcfg, jfilm.make_film_config(
        W, W, "box"), frozen, carry, key, pinned_mask=pinned,
        emitter_mask=em, lt_mask_fn=lt)
    mix = jdr.drmlt_mixture_step(_jax_trace_fn, jcfg, jfilm.make_film_config(
        W, W, "box"), frozen, mix_carry, mix_key)
    return (y, large, free2, z, q), out, mix


@pytest.mark.parametrize("kind", ["green", "mira", "orbital"])
def test_proposals_and_steps_match_reference(kind):
    """Three drmlt_steps with the acceptance map and fixEmitterPath, the
    proposals and the mira ratio of each step on its own draws, and three
    mixture steps from other starts."""
    cfg = dr.DRMLTConfig(type=kind, n_chains=N, acceptance_map=True,
                         fix_emitter_path=True)
    jcfg = jdr.DRMLTConfig(type=kind, n_chains=N, acceptance_map=True,
                           fix_emitter_path=True, fuse_traces=True)
    (frozen, pinned, em, lt), jmasks = _masks()
    u0, st, jst = _starts(5)
    _, mst, jmst = _starts(6)
    fc = film.make_film_config(W, W, "box")
    fm, acc, mfm = (film.new_film(fc, "cpu") for _ in range(3))
    jfm, jacc, jmfm = (jfilm.new_film(jfilm.make_film_config(W, W, "box"))
                       for _ in range(3))
    orbital = kind == "orbital"
    n_acc2 = 0
    for i in range(3):
        key, mkey = jax.random.PRNGKey(200 + i), jax.random.PRNGKey(300 + i)
        draws = _draws(key, N, 12, orbital)
        (y_ref, large_ref, free_ref, z_ref, q_ref), \
            ((jst, jfm, jacc), jstats), ((jmst, jmfm, _), jmstats) = \
            _reference_step(jcfg, (jst, jfm, jacc), key, (jmst, jmfm, None),
                            mkey, jmasks[:3])
        y, large = dr.propose_stage1(cfg, st.u, draws, frozen, pinned)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
        assert np.array_equal(large.numpy(), np.asarray(large_ref))
        free2 = em[None, :] & ~lt(st.u)[:, None]
        assert np.array_equal(free2.numpy(), np.asarray(free_ref))
        z = dr.propose_stage2(cfg, st.u, y, draws.u2, frozen, pinned, free2)
        # orbital: where the wrapped-Cauchy cosine sits an ulp from 1, the
        # two libraries' arccos differ by up to ~1e-4 rad
        dz = np.abs(z.numpy() - np.asarray(z_ref))
        assert (dz > 1e-5).mean() <= (1e-3 if orbital else 0.0)
        assert dz.max() < 1e-3
        if kind == "mira":
            # the reference's log(max(pdf, 1e-38)) is -87.5 outside [s1,
            # s2] here, the port's -inf (an expected divergence): a large
            # step (whose ratio the step replaces by 1) or a dim of |z - y|
            # outside gives 0 or NaN in the port, so compare the rest
            q_ref = np.asarray(q_ref)
            q = dr.mira_transition_ratio(cfg, st.u, y, z, frozen,
                                         pinned).numpy()
            fin = np.isfinite(q) & np.isfinite(q_ref) & (q > 0)
            assert fin[~large.numpy()].mean() > 0.25
            np.testing.assert_allclose(q[fin], q_ref[fin], rtol=1e-4)
            assert np.all(q_ref[np.isfinite(q) & ~fin] < 1e-30)
        (st, fm, acc), stats = dr.drmlt_step_from_uniforms(
            _torch_trace_fn, cfg, fc, frozen, (st, fm, acc), draws,
            pinned_mask=pinned, emitter_mask=em, lt_mask_fn=lt)
        _close_state(st, jst)
        _close_film(fm, jfm)
        assert np.array_equal(acc.numpy(), np.asarray(jacc))
        for k in ("a1", "a2", "accept1", "accept2", "large"):
            assert float(stats[k]) == pytest.approx(float(jstats[k]),
                                                    abs=1e-6), k
        n_acc2 += int(stats["n_accept2"])
        # the mixture baseline
        (mst, mfm, _), mstats = dr.drmlt_mixture_step_from_uniforms(
            _torch_trace_fn, cfg, fc, frozen, (mst, mfm, None),
            _draws(mkey, N, 12, orbital, mixture=True))
        _close_state(mst, jmst)
        _close_film(mfm, jmfm)
        assert float(mstats["a1"]) == pytest.approx(float(jmstats["a1"]),
                                                    abs=1e-6)
    # the integer counts are the accmap's G sum; on this near-linear trace
    # only orbital's stage 2 accepts (green's reverse path is brighter, and
    # mira's q-ratio small), render_drmlt's test sees the others accept
    assert float(acc[..., 1].double().sum()) == n_acc2
    assert n_acc2 > 0 or not orbital
    assert bool((st.u[:, 0] == torch.from_numpy(u0[:, 0])).all())  # pinned
    if orbital:
        # the orbital mixture's timid proposal is x to within f32
        z = dr.propose_stage2(cfg, mst.u, mst.u,
                              _draws(mkey, N, 12, True, True).u2, frozen)
        assert float((z - mst.u).abs().max()) < 1e-6


def test_mmlt_masks_match_reference():
    """mmlt_emitter_mask / mmlt_lt_mask_fn and the grouped encoding's
    masks, exactly, at depths 1 and 3 on random vectors."""
    u = np.random.default_rng(0).random((4096, 24), dtype=np.float32)
    for d in (1, 3):
        cfg, jcfg = BDPTConfig(max_depth=d), JBDPTConfig(max_depth=d)
        _, _, n = mmlt_masks(cfg)
        assert np.array_equal(mmlt_emitter_mask(cfg, n).numpy(), np.asarray(
            jmmlt.mmlt_emitter_mask(jcfg, n)))
        assert np.array_equal(
            mmlt_lt_mask_fn(cfg)(torch.from_numpy(u)).numpy(),
            np.asarray(jmmlt.mmlt_lt_mask_fn(jcfg)(jnp.asarray(u))))
        ng = 1 + cfg.eye_dims + cfg.light_dims
        ng += ng % 2
        for mine, ref in ((grp.grouped_masks, jgrp.grouped_masks),
                          (grp.grouped_emitter_mask,
                           jgrp.grouped_emitter_mask)):
            assert np.array_equal(mine(cfg, ng).numpy(),
                                  np.asarray(ref(jcfg, ng)))
        assert np.array_equal(
            grp.grouped_lt_mask_fn(cfg)(torch.from_numpy(u)).numpy(),
            np.asarray(jgrp.grouped_lt_mask_fn(jcfg)(jnp.asarray(u))))


@pytest.fixture(scope="module")
def mc_reference():
    """The reference's plain-MC render of the 16x16 box, depth 3."""
    jfc = jfilm.make_film_config(16, 16, "box")
    return np.asarray(jfilm.develop(jfc, jax_render_pt(
        jax_cornell(16, 16), JPathConfig(max_depth=3, rr_depth=100),
        jax.random.PRNGKey(42), 16 * 16 * 64, jfc, mode="accum"),
        mode="accum"))


@pytest.mark.parametrize("kind", ["mira", "orbital"])
def test_render_drmlt_matches_pt(mc_reference, kind):
    """render_drmlt over the path twin of a 16x16 box, depth 3, 1,024
    chains x 16 steps with the acceptance map, against the reference's
    plain-MC render_pt (tests/test_mcmc.py's gate 0.15 on the channel
    means); the map's R and G sums are the steps' accept counts."""
    pcfg = PathConfig(max_depth=3, rr_depth=100)
    cfg = dr.DRMLTConfig(type=kind, n_chains=1024, n_bootstrap=8192,
                         acceptance_map=True)
    n_steps = 16
    img, aux = dr.render_drmlt(
        make_path_trace(cornell_box(16, 16), pcfg, "cpu"), cfg,
        film.make_film_config(16, 16, "box"), torch.Generator().manual_seed(3),
        pcfg.n_dims + pcfg.n_dims % 2, n_steps)
    img, ref = img.numpy(), mc_reference
    assert np.all(np.isfinite(img)) and aux["steps"] == n_steps
    err = np.abs(img.mean((0, 1)) - ref.mean((0, 1))).mean() / ref.mean()
    assert err < 0.15, err
    assert aux["stats"]["accept2"].shape == (n_steps,)
    n2 = float(aux["stats"]["n_accept2"].double().sum())
    assert n2 > (100 if kind == "orbital" else 0)
    am = aux["accmap"].double()
    assert float(am[..., 0].sum()) == float(
        aux["stats"]["n_accept1"].double().sum()) > 0
    assert float(am[..., 1].sum()) == n2


def test_grouped_generic_route_shares_one_accmap():
    """The grouped driver with the acceptance map runs every depth group
    through the generic step (8x8 box, max_depth 2): one map for all
    groups, whose R / G sums are the groups' accept counts, each group's
    image at b_k / (N_k steps_k / npixels); pssmlt=True raises there."""
    cfg = dr.DRMLTConfig(type="orbital", n_chains=256, n_bootstrap=100,
                         acceptance_map=True, fix_emitter_path=True)
    fc = film.make_film_config(8, 8, "box")
    img, aux = grp.render_drmlt_mmlt_grouped(
        cornell_box(8, 8), BDPTConfig(max_depth=2), cfg, fc,
        torch.Generator().manual_seed(2), 8)
    assert np.all(np.isfinite(img.numpy())) and float(img.sum()) > 0
    ran = [k for k, s in enumerate(aux["steps_per_group"], 1) if s > 0]
    assert sorted(aux["stats"]) == ran and len(ran) == 2
    am = aux["accmap"].double()
    for c, key in ((0, "n_accept1"), (1, "n_accept2")):
        assert float(am[..., c].sum()) == sum(
            float(aux["stats"][k][key].double().sum()) for k in ran)
    assert float(am[..., 0].sum()) > 0
    for k in ran:
        assert aux["stats"][k]["a1"].shape == (aux["steps_eff"][k],)
    with pytest.raises(ValueError, match="generic step"):
        grp.render_drmlt_mmlt_grouped(
            cornell_box(8, 8), BDPTConfig(max_depth=2), cfg, fc,
            torch.Generator().manual_seed(2), 8, pssmlt=True)
