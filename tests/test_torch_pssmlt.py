"""The kernel form of the port's PSSMLT vs the JAX reference: the chain
twin's pssmlt mode (ops/megadrmlt.py) against
the reference test-suite's pure-JAX loop `_reference_multistep(...,
pssmlt=True)` (tests/test_megadrmlt.py) on identical uniforms, over the
reference's XLA traces, with the tolerances of tests/test_torch_drmlt.py
(state u to 2e-5, lum rtol 2e-4, film scaled by its max to 5e-3); and the
grouped driver with pssmlt=True against the reference's pieces composed
the same way (as tests/test_torch_mmlt_grouped.py holds its DRMLT mode).
The host form is tested in tests/test_torch_pssmlt_host.py (each file runs
in at most 25 s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_megadrmlt import _reference_multistep
from test_torch_drmlt import _compare

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
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.core.rng import philox_uniforms
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    make_mmlt_trace_fixed, render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops.megatrace import make_tables
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

C = 512         # chains; every reference trace runs at this width
K = 2           # the MMLT group depth
W = H = 16
PATH_DEPTH = 2


def _to_jax(st):
    return JChainState(**{f: jnp.asarray(getattr(st, f).numpy())
                          for f in ("u", "lum", "pos", "value")})


def _starts(trace, n_dims, seed):
    """C starting states (every lum > 0) from the port's trace."""
    cand = torch.from_numpy(np.random.default_rng(seed).random(
        (8 * C, n_dims), dtype=np.float32))
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    assert u0.shape[0] == C
    return state_from_splats(u0, trace(u0))


@pytest.fixture(scope="module")
def techniques():
    """Per technique: the port's tables and starting states, and the
    reference's jitted XLA trace (compiled once, at C lanes)."""
    out = {}
    trace, _, n_dims, tables = make_mmlt_trace_fixed(cornell_box(W, H), K,
                                                     True, "cpu")
    out["mmlt"] = (tables, _starts(trace, n_dims, 5), jax.jit(
        jax_fixed_trace(jax_cornell(W, H), K, force_xla=True)[0]), n_dims)
    pcfg = PathConfig(max_depth=PATH_DEPTH, rr_depth=100)
    n = pcfg.n_dims + pcfg.n_dims % 2
    jcfg = JPathConfig(max_depth=PATH_DEPTH, rr_depth=100)
    jscene = jax_cornell(W, H)
    out["path"] = (make_tables(cornell_box(W, H), pcfg, "cpu"),
                   _starts(make_path_trace(cornell_box(W, H), pcfg, "cpu"),
                           n, 6),
                   jax.jit(lambda u: jax_trace(jscene, jcfg,
                                               u[:, :jcfg.n_dims])), n)
    return out


@pytest.mark.parametrize("tech,drtype,mode", [
    ("mmlt", "mira", "three"), ("mmlt", "green", "sampled"),
    ("path", "green", "three"), ("path", "mira", "sampled")])
def test_chain_twin_pssmlt_matches_reference_loop(techniques, tech, drtype,
                                                  mode):
    tables, st0, jtrace, D = techniques[tech]
    n_mut = 3
    cfg = DRMLTConfig(type=drtype, n_chains=C, splat_mode=mode)
    nr = MD.n_rand(cfg, D)
    assert nr == 3 + 4 * D + (mode == "sampled")   # DRMLT mode's draws
    uni = np.random.default_rng(7).random((n_mut * nr, C), dtype=np.float32)
    state = MD.pack_chain_state(st0)
    fm = torch.zeros((H, W, 3))
    stats = torch.zeros((6, C))
    MD.drmlt_chain_step(tables, cfg, n_mut, state, fm, stats, 0, 0,
                        torch.from_numpy(uni), pssmlt=True)
    ref_state, ref_film = _reference_multistep(
        jtrace, JDRMLTConfig(type=drtype, n_chains=C, splat_mode=mode),
        jfilm.make_film_config(W, H, "box"), K, _to_jax(st0),
        jnp.asarray(uni), n_mut, nr, splat_mode=mode,
        frozen0=tech == "mmlt", pssmlt=True)
    _compare(MD.unpack_chain_state(state, D), fm, ref_state.u, ref_state.lum,
             ref_film)
    s = stats.sum(1)
    assert float(s[1]) == 0.0 and float(s[3]) == 0.0      # no stage 2
    assert 0 < float(s[2]) == float(s[5]) < n_mut * C     # moves = accepts
    if mode == "three":
        # two states per mutation, weights 1 - a1 and a1
        np.testing.assert_allclose(float(fm.sum()), float(
            np.asarray(ref_film)[..., :3].sum()), rtol=1e-4)


def test_grouped_pssmlt_equals_reference_composition_and_mc(techniques):
    """16x16 box, C chains, depth K, pssmlt=True.  Exact: with the
    generator's draws replayed, the depth-K group equals the reference's
    pieces composed the same way (XLA fixed-depth trace for the bootstrap
    and the chain starts, jnp.searchsorted resampling, the reference step
    loop in pssmlt mode on the chain kernel's Philox stream, the scale
    b_k / (N_k steps_eff / npixels)).  Statistical: the image agrees with
    the reference's Monte-Carlo render (channel means to 0.15), and no
    group ran a stage 2."""
    _, _, jtrace, n_dims = techniques["mmlt"]
    n_steps, seed = 24, 7
    cfg = DRMLTConfig(type="mira", n_chains=C, n_bootstrap=16384,
                      splat_mode="sampled")
    img, aux = render_drmlt_mmlt_grouped(
        cornell_box(W, H), BDPTConfig(max_depth=K), cfg,
        film.make_film_config(W, H, "box"),
        torch.Generator().manual_seed(seed), n_steps, pssmlt=True)
    assert sorted(aux["images"]) == [1, 2]
    torch.testing.assert_close(img, sum(aux["images"].values()))
    for st in aux["stats"].values():
        assert float(st["a2"]) == 0.0 and float(st["accept2"]) == 0.0
    assert aux["steps_eff"][K] == 16

    g = torch.Generator().manual_seed(seed)
    boots = []
    for k in range(1, K + 1):
        n = 1 + (3 * k - 1) + 5 + 3 * max(0, k - 2)
        boots.append(torch.rand((8192, n + n % 2), generator=g).numpy())
    torch.rand(C, generator=g)                      # group 1's draws
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
    jfc = jfilm.make_film_config(W, H, "box")
    _, f_k = _reference_multistep(
        jtrace, JDRMLTConfig(type="mira", n_chains=C, splat_mode="sampled"),
        jfc, K, state0, jnp.asarray(uni), 16, nr, splat_mode="sampled",
        frozen0=True, pssmlt=True)
    ref_k = np.asarray(f_k)[..., :3] * (float(bk) / (C * 16 / (W * H)))
    got_k = aux["images"][K].numpy()
    scale = np.abs(ref_k).max()
    assert scale > 0
    np.testing.assert_allclose(got_k / scale, ref_k / scale, atol=5e-3)

    pt = np.asarray(jfilm.develop(jfc, jax_render_pt(
        jax_cornell(W, H), JPathConfig(max_depth=K, rr_depth=100),
        jax.random.PRNGKey(43), W * H * 256, jfc, mode="accum"),
        mode="accum")).mean((0, 1))
    got = img.numpy()
    assert np.all(np.isfinite(got))
    err = np.abs(got.mean((0, 1)) - pt).mean() / pt.mean()
    assert err < 0.15, err
