"""The port's chain twin on the kernels' full scene scope: the path-mode
chain step on the sphere + conductor + image-environment scene of
test_torch_scene_scope.py against the reference's step loop over the XLA
trace_paths on identical uniforms (tests/test_megadrmlt.py:
_reference_multistep).  In a file of its own so that each file runs in at
most 25 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_megadrmlt import _reference_multistep
from test_torch_scene_scope import jax_scene, port_scene

from drmlt_mitsuba_tpu.integrators.drmlt import DRMLTConfig as JDRMLTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mcmc import ChainState as JChainState
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT

torch.set_num_threads(1)

def test_chain_twin_matches_reference_loop_on_sphere_and_env():
    """The chain twin in path mode on the sphere + conductor + image
    environment scene (the reference's own path-mode kernel declines an
    image environment, megadrmlt.py:474, and leaves it to XLA) against
    the reference's step loop over the XLA trace_paths, on identical
    uniforms: states to 2e-5, lum to rtol 2e-4, film (scaled by its max)
    to 5e-3, as tests/test_torch_drmlt.py holds slice 1's scene."""
    C, W, H, n_mut = 64, 32, 32, 2
    jscene = jax_scene("image")
    kw = dict(max_depth=3, rr_depth=100)
    pcfg = PathConfig(**kw)
    D = pcfg.n_dims + pcfg.n_dims % 2
    scene = port_scene(jscene)
    trace = make_path_trace(scene, pcfg, "cpu")
    cand = torch.from_numpy(np.random.default_rng(5).random(
        (16 * C, D), dtype=np.float32))
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    st = state_from_splats(u0, trace(u0))
    jst0 = JChainState(u=jnp.asarray(st.u.numpy()),
                       lum=jnp.asarray(st.lum.numpy()),
                       pos=jnp.asarray(st.pos.numpy()),
                       value=jnp.asarray(st.value.numpy()))
    cfg = DRMLTConfig(type="orbital", n_chains=C, splat_mode="sampled")
    n_rand = MD.n_rand(cfg, D)
    uni = np.random.default_rng(6).random((n_mut * n_rand, C),
                                          dtype=np.float32)
    jcfg = JPathConfig(**kw)
    ref_state, ref_film = _reference_multistep(
        jax.jit(lambda x: jax_trace(jscene, jcfg, x[:, :jcfg.n_dims])),
        JDRMLTConfig(type="orbital", n_chains=C, splat_mode="sampled"),
        jfilm.make_film_config(W, H, "box"), 3, jst0, jnp.asarray(uni),
        n_mut, n_rand, splat_mode="sampled", frozen0=False)
    state = MD.pack_chain_state(st)
    film, stats = torch.zeros((H, W, 3)), torch.zeros((6, C))
    tables = MT.make_tables(scene, pcfg, "cpu")
    MD.drmlt_chain_step(tables, cfg, n_mut, state, film, stats, 0, 0,
                        torch.from_numpy(uni))
    got = MD.unpack_chain_state(state, D)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref_state.u),
                               atol=2e-5)
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(ref_state.lum),
                               rtol=2e-4, atol=1e-6)
    a, b = film.numpy(), np.asarray(ref_film)[..., :3]
    scale = np.abs(b).max() + 1e-8
    np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)
    assert float(stats[2].sum()) > 0              # some proposals accepted

