"""The port's reconstruction filters, its film at every footprint, its
two-stage importance map and the CLI routes they open, vs the JAX
reference.

Each of the six filters' eval1d, and film.splat in both modes with and
without per-splat weights, to 1e-6 against drmlt_mitsuba_tpu/render/
filters.py / film.py, on splats whose footprints cross the film's edges;
integrators/twostage.py against the reference's on one map (its bilinear
upsampling is F.interpolate's, the reference's jax.image.resize); and the
CLI on a 16x16 copy of tests/data/cornell.xml without its <rfilter> (the
loaders' gaussian default) through integrator=path, drmlt with useMixture
and with acceptanceMap over the pooled MMLT trace (grouped=false).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators import twostage as jts
from drmlt_mitsuba_tpu.integrators.path import Splats as JSplats
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.render import filters as jfilters
from drmlt_mitsuba_tpu_torch.integrators import twostage as ts
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats
from drmlt_mitsuba_tpu_torch.render import film, filters
from drmlt_mitsuba_tpu_torch.utils import cli
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr

torch.set_num_threads(1)

CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")
NAMES = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")


@pytest.mark.parametrize("name", NAMES)
def test_filter_and_film_match_reference(name):
    """eval1d on offsets across the support, then 3,000 splats of a 24x16
    film, a tenth of them off the film, through film.taps (N F^2 taps, F =
    ceil(2 r)) into film.splat in both modes."""
    f, jf = filters.make_filter(name), jfilters.make_filter(name)
    assert (f.radius, f.footprint) == (jf.radius, jf.footprint)
    x = np.linspace(-4.0, 4.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(f.eval1d(torch.from_numpy(x)).numpy(),
                               np.asarray(jf.eval1d(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(7)
    W, H, N = 24, 16, 3000
    pos = (rng.random((N, 2), dtype=np.float32) * np.float32([W + 4, H + 4])
           - np.float32(2))
    val = rng.random((N, 3), dtype=np.float32)
    w = rng.random(N, dtype=np.float32)
    fc = film.make_film_config(W, H, name)
    jfc = jfilm.make_film_config(W, H, name)
    py, px, vals = film.taps(fc, torch.from_numpy(pos), torch.from_numpy(val))
    F = f.footprint
    assert py.shape == px.shape == (N * F * F,) and vals.shape == (N * F * F,
                                                                   4)
    # splat mode divides by a footprint's total, clamped below at 1e-12:
    # the negative lobes of mitchell, catmullrom and lanczos make it 0 or
    # less where a footprint leaves the film, and the quotients there (1e10
    # and more in both) keep only the last bits of the sum's order; so the
    # films are compared on the splats whose total is at least a tenth of
    # their sum of |weight| (most of those that cross the edge too)
    # (and above 0.05); the first 2,000 of them, the same count for every
    # filter, so that the reference's eager ops compile once per footprint
    _, _, wx, wy = film._footprint(fc, torch.from_numpy(pos))
    w2 = wx[:, :, None] * wy[:, None, :]
    tot = w2.sum((1, 2))
    kept = ((tot >= 0.1 * w2.abs().sum((1, 2))) & (tot > 0.05)).numpy()
    kept = np.nonzero(kept)[0][:2000]
    assert kept.shape == (2000,)
    edge = ((pos < f.radius) | (pos > np.float32([W, H]) - f.radius)).any(1)
    assert edge[kept].sum() > 100
    for mode in ("splat", "accum"):
        for wt in (None, w[kept]):
            args = (pos[kept], val[kept], wt)
            got = film.splat(fc, film.new_film(fc, "cpu"),
                             *(None if a is None else torch.from_numpy(a)
                               for a in args), mode=mode)
            want = jfilm.splat(jfc, jfilm.new_film(jfc),
                              *(None if a is None else jnp.asarray(a)
                                for a in args), mode=mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    assert float(got[..., 3].sum()) > 0
    with pytest.raises(ValueError, match="unknown reconstruction filter"):
        filters.make_filter("sinc")


def test_twostage_matches_reference():
    """luminance_pass on one 4x3 image, upsampled to 64x48 (bilinear, half-
    pixel centres, clamped at the edges), the bilinear lookup, the divided
    splats and the develop's multiply, against the reference's."""
    rng = np.random.default_rng(11)
    low = rng.gamma(1.0, 1.0, (3, 4, 3)).astype(np.float32)
    low[0, 0] = 0.0                       # below the floor of 0.1 x mean
    fc = film.make_film_config(64, 48, "box")
    jfc = jfilm.make_film_config(64, 48, "box")
    imap = ts.luminance_pass(lambda w, h: torch.from_numpy(low), fc)
    jmap = jts.luminance_pass(lambda w, h: jnp.asarray(low), jfc)
    assert imap.shape == (48, 64)
    np.testing.assert_allclose(imap.numpy(), np.asarray(jmap), rtol=1e-6,
                               atol=1e-7)
    pos = rng.random((500, 1, 2), dtype=np.float32)
    pos[:5] = [[0.0, 0.0]], [[1.0, 1.0]], [[0.9999999, 0.0]], \
        [[0.5, 0.999]], [[0.001, 0.5]]
    np.testing.assert_allclose(
        ts.sample_importance(imap, torch.from_numpy(pos)).numpy(),
        np.asarray(jts.sample_importance(jmap, jnp.asarray(pos))), rtol=1e-6)
    val = rng.random((500, 1, 3), dtype=np.float32)
    sp = ts.with_importance_map(lambda u: Splats(
        pos=torch.from_numpy(pos), value=torch.from_numpy(val),
        lum=torch.zeros(500)), imap)(None)
    jsp = jts.with_importance_map(lambda u: JSplats(
        pos=jnp.asarray(pos), value=jnp.asarray(val), lum=jnp.zeros(500)),
        jmap)(None)
    np.testing.assert_allclose(sp.value.numpy(), np.asarray(jsp.value),
                               rtol=1e-6)
    np.testing.assert_allclose(sp.lum.numpy(), np.asarray(jsp.lum),
                               rtol=1e-6)
    img = rng.random((48, 64, 3), dtype=np.float32)
    np.testing.assert_allclose(
        ts.apply_importance_to_image(torch.from_numpy(img), imap).numpy(),
        np.asarray(jts.apply_importance_to_image(jnp.asarray(img), jmap)),
        rtol=1e-6)


@pytest.mark.parametrize("runs", [
    [["integrator=path"]],
    [["integrator=drmlt", "useMixture=true"],
     ["integrator=drmlt", "technique=mmlt", "grouped=false",
      "acceptanceMap=true", "fixEmitterPath=true", "type=orbital"]]],
    ids=["path", "drmlt"])
def test_cli_renders_a_scene_without_rfilter(tmp_path, capsys, runs):
    """A scene whose film has no <rfilter> splats with the gaussian filter
    (footprint 4): each route renders a finite image, and the acceptance
    map is written where asked for."""
    xml = tmp_path / "gauss.xml"
    text = open(CORNELL).read().replace('<rfilter type="box"/>', "")
    xml.write_text(text.replace('value="64"', 'value="16"'))
    _, settings = cli.load_scene(str(xml), {"integrator": "path"})
    assert settings.filter_name == "gaussian"
    for i, defs in enumerate(runs):
        out = tmp_path / f"out{i}.exr"
        argv = [str(xml), "--spp", "4", "--chains", "256", "--device",
                "cpu", "-o", str(out), "-D", "luminanceSamples=1000"]
        for kv in defs:
            argv += ["-D", kv]
        assert cli.main(argv) == 0
        img = read_exr(str(out))
        assert img.shape == (16, 16, 3)
        assert np.all(np.isfinite(img)) and img.mean() > 1e-4
        acc = tmp_path / f"out{i}_acceptance.exr"
        assert acc.exists() == ("acceptanceMap=true" in defs)
        if acc.exists():
            am = read_exr(str(acc))
            assert am.shape == (16, 16, 3) and np.all(np.isfinite(am))
            assert am[..., 0].sum() > 0 and am[..., 2].sum() == 0
        text = capsys.readouterr().out
        assert ("paths/s" if defs == ["integrator=path"]
                else "mutations/s") in text
