"""The bidirectional wavefront with a thin lens, and the CLI routes the
slice opens: integrator=bdpt, technique=bdpt under drmlt and pssmlt, and
MMLT (grouped and pooled) on a thin-lens scene.

The reference is compiled once for the module, at max_depth 2 on the
16x16 Cornell box seen through the thin lens of the reference's
tests/test_thinlens_bidir.py (aperture 25, focus on the back wall at
1073): trace_bdpt and its XLA trace_mmlt, the pair that file pins.  A
thin-lens light-tracing splat (t = 1) lands where the lens point's ray
through the focal plane projects through the lens centre, so its film
position is compared lane by lane, not by an image mean.  Tolerances as in
test_torch_bidir.py.  The CLI renders are port against port, without JAX:
BDPT against render_pt within an MC gate, the MCMC routes captured or
rendered tiny.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bidir import _splats, shared_subpaths

from drmlt_mitsuba_tpu.integrators import bidir as JB
from drmlt_mitsuba_tpu.scene import builders as jax_builders
from drmlt_mitsuba_tpu_torch.integrators import bidir as B
from drmlt_mitsuba_tpu_torch.integrators import mmlt_grouped as MG
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.integrators.path import render_pt
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene import builders
from drmlt_mitsuba_tpu_torch.scene.xml import RenderSettings
from drmlt_mitsuba_tpu_torch.utils import cli

torch.set_num_threads(1)

R = 1024
DEPTH = 2
W = H = 16
APERTURE, FOCUS = 25.0, 1073.0


def lens_box(size=W):
    sc = builders.cornell_box(size, size)
    return dataclasses.replace(sc, camera=dataclasses.replace(
        sc.camera, aperture_radius=torch.tensor(APERTURE),
        focus_distance=torch.tensor(FOCUS)))


@pytest.fixture(scope="module")
def lens():
    js = jax_builders.cornell_box(W, H)
    js = js.replace(camera=js.camera.replace(
        aperture_radius=jnp.float32(APERTURE),
        focus_distance=jnp.float32(FOCUS)))
    jcfg = JB.BDPTConfig(max_depth=DEPTH, thinlens=True)
    cfg = B.BDPTConfig(max_depth=DEPTH, thinlens=True)
    rng = np.random.default_rng(9)
    u = rng.random((R, 1 + cfg.n_dims), dtype=np.float32)
    depth = (1 + rng.integers(0, DEPTH, R)).astype(np.int32)

    @jax.jit
    def reference(x, d):
        with shared_subpaths(js, jcfg, x[:, 1:]):
            return (JB.trace_bdpt(js, jcfg, x[:, 1:]),
                    JB.trace_mmlt(js, jcfg, x, d))

    bdpt, mmlt = reference(jnp.asarray(u), jnp.asarray(depth))
    return dict(bdpt=bdpt, mmlt=mmlt, u=torch.from_numpy(u),
                depth=torch.from_numpy(depth), cfg=cfg,
                tables=B.make_bidir_tables(lens_box(), cfg, "cpu"))


def test_thinlens_bdpt_matches_reference(lens):
    """Every splat lane for lane; the light-image splats' film positions
    move with the lens point: against a pinhole projection of the same
    direction, by more than 1e-3 (100 times the positions' tolerance) on
    most lit lanes."""
    cfg, tb = lens["cfg"], lens["tables"]
    got = B.trace_bdpt(tb, cfg, lens["u"][:, 1:])
    _splats(lens["bdpt"], got)
    E, _ = B.eye_subpath(tb, cfg, lens["u"][:, 1:1 + cfg.eye_dims])
    L = B.light_subpath(tb, cfg, lens["u"][:, 1 + cfg.eye_dims:])
    d = E.p[:, 0] - L.p[:, 0]
    _, pin, _ = B.sensor_importance(tb, -d / d.norm(dim=-1, keepdim=True))
    lit = got.value[:, 1].abs().sum(-1) > 0
    shift = (got.pos[:, 1] - pin).abs().max(-1).values[lit]
    assert lit.sum() > R // 4 and (shift > 1e-3).float().mean() > 0.5


def test_thinlens_mmlt_wavefront_matches_reference(lens):
    got = B.trace_mmlt_wavefront(lens["tables"], lens["cfg"], lens["u"],
                                 lens["depth"])
    _splats(lens["mmlt"], got)


def test_thinlens_mmlt_takes_the_wavefront(monkeypatch):
    """The route is fixed on the host from the config: the pooled and the
    per-group MMLT traces of a thin-lens scene run the wavefront (D times
    its value for the pooled depth pmf) and never reach the MMLT kernel,
    which still refuses the lens by name."""
    def refuse(*a, **kw):
        raise AssertionError("the MMLT kernel route was taken")

    monkeypatch.setattr(MM, "mmlt_trace", refuse)
    scene = lens_box(8)
    cfg = B.BDPTConfig(max_depth=DEPTH, thinlens=True)
    u = torch.from_numpy(np.random.default_rng(2).random(
        (256, mmlt_n_dims(cfg)), dtype=np.float32))
    got = make_mmlt_trace(scene, cfg, "cpu")(u)
    depth = 1 + torch.clamp((u[:, 0] * DEPTH).long(), max=DEPTH - 1)
    want = B.trace_mmlt_wavefront(scene, cfg, u[:, 1:], depth)
    np.testing.assert_array_equal(got.value.numpy(),
                                  (want.value * DEPTH).numpy())
    trace, cfg_k, n_dims, tables = MG.make_mmlt_trace_fixed(
        scene, 2, True, "cpu", thinlens=True)
    assert tables is None and cfg_k.thinlens and n_dims % 2 == 0
    k2 = trace(u[:, 1:n_dims + 1])
    want = B.trace_mmlt_wavefront(scene, cfg_k, u[:, 1:n_dims + 1],
                                  torch.full((256,), 2))
    np.testing.assert_array_equal(k2.value.numpy(), want.value.numpy())
    with pytest.raises(NotImplementedError, match="thin-lens"):
        MM.make_mmlt_tables(scene, cfg, "cpu")


def _render(defs, scene, spp, chains=256):
    settings = RenderSettings(integrator={"type": defs.pop("integrator")},
                              width=W, height=H, filter_name="box", spp=spp)
    args = argparse.Namespace(D=[f"{k}={v}" for k, v in defs.items()],
                              chains=chains, spp=None, seed=1)
    return cli.render(args, scene, settings, torch.device("cpu"))


def test_cli_bdpt_matches_the_path_tracer():
    """-D integrator=bdpt (5 segments, light image on) on the box lit also
    by a constant environment through its open side, which the eye walks
    read on escape at weight 1: every splat of 2 x 8,192 samples in one
    film, against render_pt's channel means at the same depth; the repo's
    MCMC-vs-MC gate is 0.15 (tests/test_mcmc.py), two plain MC estimators
    stay within 0.03 here (both at about 0.5% noise)."""
    scene = builders.cornell_box(W, H)
    scene = dataclasses.replace(scene, emitters=dataclasses.replace(
        scene.emitters, env_radiance=torch.tensor(builders.SCOPE_ENV)))
    img, aux = _render(dict(integrator="bdpt"), scene, spp=64)
    assert aux["samples"] == 2 * 8192 and img.shape == (H, W, 3)
    fc = filmlib.make_film_config(W, H, "box")
    gen = torch.Generator().manual_seed(0)
    ref = filmlib.develop(fc, render_pt(
        scene, PathConfig(max_depth=5, rr_depth=100), gen, W * H * 128, fc,
        mode="accum"), mode="accum")
    err = ((img.mean((0, 1)) - ref.mean((0, 1))).abs()
           / ref.mean((0, 1))).max()
    assert float(err) < 0.03, float(err)


def test_cli_bdpt_technique_under_drmlt_and_pssmlt(monkeypatch):
    """technique=bdpt: the generic loop over trace_bdpt (maxDepth 8 by
    default, an even PSS dimension, nothing frozen or pinned), whose
    chains carry 1 + n_light splats; a tiny render of each, the drmlt one
    with its acceptance map, gives a finite, lit image."""
    scene = builders.cornell_box(W, H)
    for itype in ("drmlt", "pssmlt"):
        img, aux = _render(dict(integrator=itype, technique="bdpt",
                                maxDepth=3, luminanceSamples=1000,
                                acceptanceMap="true"), scene, spp=8)
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        assert aux["b"] > 0 and aux["steps"] == 8
    assert float(aux["accmap"].sum()) == 0     # pssmlt's map stays empty
    seen = {}

    def rec(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        raise RuntimeError("stop")

    monkeypatch.setattr(cli, "render_drmlt", rec)
    with pytest.raises(RuntimeError, match="stop"):
        _render(dict(integrator="drmlt", technique="bdpt"), scene, spp=1)
    trace, n_dims = seen["a"][0], seen["a"][4]
    cfg = B.BDPTConfig(max_depth=8)
    assert n_dims == cfg.n_dims + cfg.n_dims % 2
    assert seen["kw"]["frozen_mask"] is None
    assert seen["kw"]["pinned_mask"] is None
    sp = trace(torch.rand((64, n_dims)))
    assert sp.value.shape == (64, 1 + 8, 3)


def test_cli_thinlens_mmlt_grouped_and_pooled():
    """drmlt + mmlt on a thin-lens scene: the grouped driver's groups take
    the generic step over the wavefront trace, and grouped=false the
    pooled wavefront trace; both tiny renders are finite and lit."""
    scene = lens_box()
    for grouped in ("true", "false"):
        img, aux = _render(dict(integrator="drmlt", technique="mmlt",
                                maxDepth=3, luminanceSamples=1000,
                                grouped=grouped), scene, spp=4)
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        if grouped == "true":
            assert set(aux["stats"]) and all(
                "n_accept1" in st for st in aux["stats"].values())
        assert aux["mutations"] > 0
