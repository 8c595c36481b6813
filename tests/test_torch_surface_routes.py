"""The path-technique routes over the path wavefront: trace_paths_wavefront
against the reference's trace_paths on tests/data/daylight.xml (a baked
sun and sky with the image environment's MIS, a directional light, a thin
lens, min_depth), and against the path kernel's twin (held to the
reference by test_torch_path_trace.py) on the Cornell box with and
without NEE; render_drmlt_path on
tests/data/surfaces.xml at a 16x16 film, which takes the wavefront and
never a trace kernel, its image finite and its channel means within four
standard deviations of an MC render's (the CLI's routes:
test_torch_surface_cli.py).

Tolerances as in test_torch_surface_trace.py.  The MCMC gate's standard
deviation combines b's (the bootstrap's n samples), the chains' (counted
as one independent sample a chain, which overstates it) and the MC
image's, each from the per-sample spread of the path values.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.scene.xml import load_scene_xml as jax_load_xml
from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.integrators import drmlt as DR
from drmlt_mitsuba_tpu_torch.integrators import path as P
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops import megadrmlt
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from test_torch_surface_scene import DAYLIGHT, SURFACES
from test_torch_surface_trace import MEAN_RTOL, R, compare

torch.set_num_threads(1)

SIDE = 16
DEPTH = 3


@pytest.fixture
def wavefront_only(monkeypatch):
    """Count the wavefront's calls; fail if a trace or chain kernel (or
    its twin) runs."""
    calls = []
    real = P.trace_paths_wavefront

    def refuse(*a, **kw):
        raise AssertionError("a trace kernel ran on the wavefront's scope")

    monkeypatch.setattr(P, "trace_paths_wavefront",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(MT, "path_trace", refuse)
    monkeypatch.setattr(megadrmlt, "drmlt_chain_step", refuse)
    return calls


def test_wavefront_matches_reference_on_daylight():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc, _ = load_scene_xml(DAYLIGHT, {"res": "32"})
        jsc, _ = jax_load_xml(DAYLIGHT, {"res": "32"})
    lens = dataclasses.replace(sc, camera=dataclasses.replace(
        sc.camera, aperture_radius=torch.tensor(20.0),
        focus_distance=torch.tensor(900.0)))
    jlens = jsc.replace(camera=jsc.camera.replace(
        aperture_radius=np.float32(20.0), focus_distance=np.float32(900.0)))
    kw = dict(max_depth=DEPTH, thinlens=True, min_depth=2, rr_depth=2)
    cfg, jcfg = PathConfig(**kw), JPathConfig(**kw)
    u = np.random.default_rng(9).random((R, cfg.n_dims), dtype=np.float32)
    want = np.asarray(jax.jit(lambda s, u: jax_trace(s, jcfg, u).value)(
        jlens, u))[:, 0]
    got = P.trace_paths_wavefront(lens, cfg, torch.from_numpy(u)).value[
        :, 0].numpy()
    bad, m_rel = compare(want, got)
    assert bad <= R // 500 and m_rel <= MEAN_RTOL, (bad, m_rel)
    assert (got.sum(1) > 0).mean() > 0.5


@pytest.mark.parametrize("use_nee,min_depth", [(True, 2), (False, 1)])
def test_wavefront_matches_the_path_twin_on_the_box(use_nee, min_depth):
    """On a scene of the kernels' scope the wavefront computes what the
    path kernel's twin does (4R lanes: without NEE few paths reach the
    small light)."""
    sc = cornell_box(16, 16)
    cfg = PathConfig(max_depth=DEPTH, rr_depth=2, min_depth=min_depth,
                     use_nee=use_nee)
    n = 4 * R
    u = torch.from_numpy(np.random.default_rng(4).random(
        (n, cfg.n_dims), dtype=np.float32))
    want = P.trace_paths(sc, cfg, u).value[:, 0].numpy()
    got = P.trace_paths_wavefront(sc, cfg, u).value[:, 0].numpy()
    bad, m_rel = compare(want, got)
    assert bad <= n // 500 and m_rel <= MEAN_RTOL, (bad, m_rel)
    assert (got.sum(1) > 0).sum() >= 50


def test_render_drmlt_path_takes_the_wavefront(wavefront_only):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc, _ = load_scene_xml(SURFACES, {"res": str(SIDE)})
    cfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    fc = filmlib.make_film_config(SIDE, SIDE, "box")
    n_chains, n_boot, n_steps, n_mc = 512, 8192, 16, 8192
    dcfg = DR.DRMLTConfig(type="orbital", n_chains=n_chains,
                          n_bootstrap=n_boot)
    img, aux = DR.render_drmlt_path(sc, cfg, dcfg, fc,
                                    torch.Generator().manual_seed(1),
                                    n_steps)
    assert wavefront_only and torch.isfinite(img).all()
    assert aux["steps"] == n_steps
    # the MC render, and from its samples' spread the gate
    u = uniform((n_mc, cfg.n_dims), torch.Generator().manual_seed(2))
    v = P.trace_paths_wavefront(sc, cfg, u).value[:, 0]
    mc = filmlib.develop(fc, filmlib.splat(
        fc, filmlib.new_film(fc, "cpu"), u[:, 0:2] * SIDE, v, mode="accum"),
        mode="accum")
    v = v.double()
    lum = v @ v.new_tensor([0.212671, 0.715160, 0.072169])
    rel_sd = v.std(0) / v.mean(0)
    sd = torch.sqrt((lum.std() / lum.mean()) ** 2 / n_boot
                    + rel_sd ** 2 / n_chains + rel_sd ** 2 / n_mc)
    rel = (img.double().mean((0, 1)) / mc.double().mean((0, 1)) - 1).abs()
    assert (rel < 4 * sd).all(), (rel, sd)

