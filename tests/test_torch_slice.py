"""The whole slice: the port's render_drmlt_path against the JAX reference.

Exact: with the generator's draws replayed (bootstrap vectors, resampling
uniforms, the chain seed) and the chain kernel's Philox stream
regenerated, the reference's own pieces composed the same way — XLA
trace_paths for the bootstrap, jnp.searchsorted resampling, the reference
step loop `_reference_multistep` and the drmlt.py:440-441 scale — give the
same image.  Statistical: an own-RNG render converges to the reference's
Monte-Carlo render (MCMC-vs-MC, the oracle of tests/test_mcmc.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_megadrmlt import _reference_multistep

from drmlt_mitsuba_tpu.integrators.drmlt import DRMLTConfig as JDRMLTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mcmc import (
    state_from_splats as jax_state_from_splats,
)
from drmlt_mitsuba_tpu.integrators.path import render_pt as jax_render_pt
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.utils.exr import read_exr
from drmlt_mitsuba_tpu_torch.core.rng import philox_uniforms
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
    DRMLTConfig, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.utils import cli

torch.set_num_threads(1)


def test_render_equals_reference_composition():
    W = H = 32
    C, depth, seed = 64, 2, 3
    pcfg = PathConfig(max_depth=depth, rr_depth=100)
    jcfg = JPathConfig(max_depth=depth, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    cfg = DRMLTConfig(type="orbital", n_chains=C, n_bootstrap=100,
                      splat_mode="sampled")
    img, aux = render_drmlt_path(cornell_box(W, H), pcfg, cfg,
                                 film.make_film_config(W, H, "box"),
                                 torch.Generator().manual_seed(seed),
                                 n_steps=4)
    assert aux["steps"] == 16      # n_steps < 32 forces n_mut = 16

    # the generator's draws, in render_drmlt_path's order
    g = torch.Generator().manual_seed(seed)
    u_boot = torch.rand((8192, D), generator=g).numpy()
    u_pick = torch.rand(C, generator=g).numpy()
    chain_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))

    # the reference's pieces
    jscene = jax_cornell(W, H)
    jt = jax.jit(lambda u: jax_trace(jscene, jcfg, u[:, :jcfg.n_dims]))
    # bootstrap traced in chain-sized chunks: one compiled shape
    lums = jnp.concatenate([jt(jnp.asarray(u_boot[i:i + C])).lum
                            for i in range(0, 8192, C)])
    lums = jnp.where(jnp.isfinite(lums) & (lums >= 0), lums, 0.0)
    b = jnp.sum(lums) / 8192
    cdf = jnp.cumsum(lums)
    idx = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u_pick) * cdf[-1]),
                   0, 8191)
    u0 = jnp.asarray(u_boot)[idx]
    state0 = jax_state_from_splats(u0, jt(u0))
    n_rand = MD.n_rand(cfg, D)
    uni = torch.cat([philox_uniforms(chain_seed, 0, m, n_rand, C)
                     for m in range(16)]).numpy()
    # the reference loop one mutation a call, compiled once: its film is
    # the sum of the mutations' films
    one = jax.jit(lambda st, u: _reference_multistep(
        jt, JDRMLTConfig(type="orbital", n_chains=C, splat_mode="sampled"),
        jfilm.make_film_config(W, H, "box"), depth, st, u, 1, n_rand,
        splat_mode="sampled", frozen0=False))
    ref_film, st = 0.0, state0
    for m in range(16):
        st, f = one(st, jnp.asarray(uni[m * n_rand:(m + 1) * n_rand]))
        ref_film = ref_film + f
    ref_img = np.asarray(ref_film)[..., :3] * float(b) / (C * 16 / (W * H))

    np.testing.assert_allclose(float(aux["b"]), float(b), rtol=1e-5)
    got = img.numpy()
    scale = np.abs(ref_img).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, ref_img / scale, atol=5e-3)


def _mean_rel_err(img, ref):
    m = ref.mean()
    return np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).mean() / m


def test_render_converges_to_monte_carlo():
    """Own-RNG orbital render vs the reference's MC render of the same
    box (tests/test_mcmc.py thresholds: mean rel err < 0.15, orbital
    stage-2 acceptance > 0.02)."""
    W = H = 32
    pcfg = PathConfig(max_depth=3, rr_depth=100)
    cfg = DRMLTConfig(type="orbital", n_chains=512, n_bootstrap=16384)
    fc = film.make_film_config(W, H, "box")
    img, aux = render_drmlt_path(cornell_box(W, H), pcfg, cfg, fc,
                                 torch.Generator().manual_seed(11),
                                 n_steps=64)
    jfc = jfilm.make_film_config(W, H, "box")
    ref = np.asarray(jfilm.develop(jfc, jax_render_pt(
        jax_cornell(W, H), JPathConfig(max_depth=3, rr_depth=100),
        jax.random.PRNGKey(42), W * H * 64, jfc, mode="accum"),
        mode="accum"))
    img = img.numpy()
    assert aux["steps"] == 64
    assert np.all(np.isfinite(img))
    assert _mean_rel_err(img, ref) < 0.15
    assert float(aux["stats"]["accept2"]) > 0.02


def test_cli_cornell_writes_exr(tmp_path, capsys):
    out = tmp_path / "c.exr"
    rc = cli.main(["cornell", "-D", "variant=mira", "-D", "tallBox=mirror",
                   "-D", "maxDepth=2", "-D", "luminanceSamples=1000",
                   "-D", "splatMode=three", "--chains", "4096", "--spp", "1",
                   "-s", "5", "--device", "cpu", "-o", str(out)])
    assert rc == 0
    img = read_exr(str(out))
    assert img.shape == (256, 256, 3)
    assert np.all(np.isfinite(img)) and img.mean() > 0
    assert "b = " in capsys.readouterr().out
    # a scene XML outside the ported subset raises, naming the element
    xml = tmp_path / "disk.xml"
    xml.write_text('<scene version="0.6.0"><shape type="disk"/></scene>')
    with pytest.raises(NotImplementedError, match="disk"):
        cli.main([str(xml), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["cornell", "-D", "nope=1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown technique"):
        cli.main(["cornell", "-D", "technique=nope", "--device", "cpu"])


def test_cli_mmlt_writes_exr(tmp_path, capsys, monkeypatch):
    """-D technique=mmlt runs the depth-grouped driver (the reference CLI's
    default for drmlt + mmlt) on the built-in veach-door scene."""
    out = tmp_path / "v.exr"
    rc = cli.main(["veach", "-D", "technique=mmlt", "-D", "variant=orbital",
                   "-D", "maxDepth=2", "-D", "luminanceSamples=1000",
                   "-D", "fixEmitterPath=true", "--chains", "4096",
                   "--spp", "1", "-s", "3", "--device", "cpu", "-o",
                   str(out)])
    assert rc == 0
    img = read_exr(str(out))
    assert img.shape == (256, 256, 3)
    assert np.all(np.isfinite(img)) and img.mean() > 0
    assert "steps per depth group" in capsys.readouterr().out
    # grouped=false runs the generic loop over the pooled MMLT trace, its
    # depth dim pinned
    seen = {}

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(cli, "render_drmlt", stop)
    with pytest.raises(Stop):
        cli.main(["veach", "-D", "technique=mmlt", "-D", "grouped=false",
                  "--device", "cpu"])
    assert bool(seen["pinned_mask"][0]) and not bool(seen["pinned_mask"][1:]
                                                     .any())
