"""The CLI's flags and outputs, its forward routes, and the image and
scene tools, on a 16x16 copy of tests/data/cornell.xml at maxDepth 2.

-x returns before the scene is read; -t / -r act between blocks of the
generic MCMC loop (drmlt_mitsuba_tpu/utils/cli.py:567-579): their test
runs the loop over a cheap analytic trace (the path kernel's twin would
take ~15 ms a step here, and -t needs two blocks of 256 steps), so that
the stopped render, the partial EXRs and _time.csv are checked against
render_pssmlt called directly, bit for bit.  Without the flags the generic
loop's image is bit for bit render_pssmlt / render_drmlt called as before
the flags existed, on the path twin.  The forward routes
(ptracer, field, multichannel, motion, path under a sobol <sampler>) go
through cli.main and equal their renders called directly.  The tools
write what the JAX package's write, byte for byte where the format is
the same (dump_scene, the EXRs), value for value where it is not
(tonemap's 8-bit sRGB as .npy against the reference's PNG).
"""
import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

import drmlt_mitsuba_tpu.utils.heatmap as jheatmap
import drmlt_mitsuba_tpu.utils.imgtools as jimgtools
from drmlt_mitsuba_tpu.core.stats import Statistics as JaxStatistics
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.utils.exr import write_exr as jax_write_exr
from drmlt_mitsuba_tpu.utils.scene_dump import dump_scene as jax_dump_scene
from drmlt_mitsuba_tpu_torch.integrators import misc
from drmlt_mitsuba_tpu_torch.integrators import pssmlt as pss
from drmlt_mitsuba_tpu_torch.integrators import drmlt as dr
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig, path_splats
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, render_pt,
)
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.utils import cli, heatmap, imgtools
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr, write_exr
from drmlt_mitsuba_tpu_torch.utils.scene_dump import dump_scene

torch.set_num_threads(1)

CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")
EMPTY = ("  ------------------------------------------------------\n"
         "  ------------------------------------------------------\n")


@pytest.fixture
def xml16(tmp_path):
    """A 16x16 copy of cornell.xml at maxDepth 2; `sampler` swaps its
    <sampler> type."""
    def make(sampler="independent"):
        text = open(CORNELL).read().replace('value="64"', 'value="16"')
        text = text.replace('name="maxDepth" value="4"',
                            'name="maxDepth" value="2"')
        text = text.replace('<sampler type="independent">',
                            f'<sampler type="{sampler}">')
        path = tmp_path / f"cornell16_{sampler}.xml"
        path.write_text(text)
        return str(path)
    return make


def _main(xml, out, *extra):
    return cli.main([xml, "--device", "cpu", "-s", "3", "-o", str(out), "-q",
                     *extra])


def _analytic(scene, pcfg, device):
    """A trace whose splat is a function of u alone (pos u[:, :2], value
    u[:, 2:5] + 0.1): the generic loop's control, not its light."""
    return lambda u: path_splats(u, u[:, 2:5] + 0.1)


def test_skip_timeout_and_refresh_flags(xml16, tmp_path, monkeypatch):
    """-x returns 0 before the scene is read and leaves the output as it
    was.  Then 512 steps (16 x 16 x 2 mutations of one chain) run in two
    blocks of 256.  -t stops after the first: the image is
    render_pssmlt's at 256 steps (the scale of whole blocks), the report
    counts 256 mutations.  -r dumps after each block: <out>_0.exr,
    <out>_1.exr (the image of the steps done, half floats) and
    <out>_time.csv rewritten with a row a dump; the final image is the
    whole render's."""
    out = tmp_path / "out.exr"
    out.write_bytes(b"keep")
    assert cli.main([str(tmp_path / "missing.xml"), "-x", "-o",
                     str(out)]) == 0
    assert out.read_bytes() == b"keep"
    assert not (tmp_path / "out_stats.txt").exists()

    monkeypatch.setattr(cli, "make_path_trace", _analytic)
    seen = []
    real = pss.render_pssmlt

    def recorded(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(cli, "render_pssmlt", recorded)
    xml = xml16()
    d = ["-D", "integrator=pssmlt", "-D", "luminanceSamples=64",
         "--chains", "1", "--spp", "2"]
    assert _main(xml, tmp_path / "t.npy", *d, "-t", "1e-9") == 0
    assert _main(xml, tmp_path / "r.npy", *d, "-r", "1e-9") == 0
    (a, kw), _ = seen
    assert a[5] == 512

    def direct(n_steps):
        return real(*a[:3], torch.Generator().manual_seed(3), a[4], n_steps,
                    average_luminance=kw["average_luminance"],
                    pinned_mask=kw["pinned_mask"])

    img256, aux256 = direct(256)
    img512, _ = direct(512)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  img256.numpy())
    report = (tmp_path / "t_stats.txt").read_text()
    assert "  * Mutations: 256\n" in report
    ref = JaxStatistics()
    ref.record_mcmc({k: v.numpy() for k, v in aux256["stats"].items()}, 1)
    assert report == ref.report() + "\n"
    assert not (tmp_path / "t_0.exr").exists()

    np.testing.assert_array_equal(np.load(tmp_path / "r.npy"),
                                  img512.numpy())
    rows = (tmp_path / "r_time.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["0", "1"]
    assert all(float(r.split(",")[1]) > 0 for r in rows)
    for part, img in ((0, img256), (1, img512)):
        np.testing.assert_allclose(read_exr(str(tmp_path / f"r_{part}.exr")),
                                   img.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("route", ["pssmlt", "drmlt"])
def test_generic_loop_without_flags_is_the_direct_render(xml16, route):
    """cli.render's generic loop (pssmlt; drmlt with acceptanceMap) on the
    path twin, no -t / -r: bit for bit render_pssmlt / render_drmlt called
    as before the per-block hook, on the same trace and generator."""
    defs = [f"integrator={route}", "luminanceSamples=256", "chains=64"]
    if route == "drmlt":
        defs.append("acceptanceMap=true")
    args = argparse.Namespace(D=defs, chains=64, spp=1, seed=7)
    scene, settings = cli.load_scene(xml16(), dict(
        kv.split("=", 1) for kv in defs))
    img, aux = cli.render(args, scene, settings, torch.device("cpu"))
    fc = filmlib.make_film_config(16, 16, "box")
    pcfg = PathConfig(max_depth=2, rr_depth=100, min_depth=1)
    trace = make_path_trace(scene, pcfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    n_dims = pcfg.n_dims + pcfg.n_dims % 2
    if route == "pssmlt":
        ref, raux = pss.render_pssmlt(trace, pss.PSSMLTConfig(
            n_chains=64, n_bootstrap=256), fc, gen, n_dims, 4)
    else:
        ref, raux = dr.render_drmlt(trace, dr.DRMLTConfig(
            n_chains=64, n_bootstrap=256, acceptance_map=True), fc, gen,
            n_dims, 4)
        assert torch.equal(aux["accmap"], raux["accmap"])
    assert aux["steps"] == 4 and torch.equal(img, ref)
    ref_stats = JaxStatistics()
    ref_stats.record_mcmc({k: v.numpy() for k, v in raux["stats"].items()},
                          64)
    assert aux["statistics"].report() == ref_stats.report()


@pytest.mark.parametrize("route", ["ptracer", "field", "multichannel",
                                   "motion", "sobol"])
def test_forward_routes_through_main(xml16, tmp_path, capsys, route):
    """Each route's output (.npy, or EXR with the multichannel layers)
    equals its render called directly with the file's keys and the
    CLI's generator; _stats.txt holds the empty report, which is also
    printed."""
    spp = 2
    xml = xml16("sobol" if route == "sobol" else "independent")
    out = tmp_path / ("out.exr" if route == "multichannel" else "out.npy")
    integ = "path" if route == "sobol" else route
    extra = ["-D", "field=albedo"] if route == "field" else []
    assert _main(xml, out, "-D", f"integrator={integ}", "--spp", str(spp),
                 *extra) == 0
    scene, _ = cli.load_scene(xml, {})
    fc = filmlib.make_film_config(16, 16, "box")
    gen = torch.Generator().manual_seed(3)
    if route == "ptracer":
        ref = misc.render_ptracer(scene, fc, gen, 16 * 16 * spp, max_depth=2)
    elif route == "field":
        ref = misc.render_field(scene, fc, gen, "albedo", spp)
    elif route == "multichannel":
        ref = misc.render_multichannel(scene, fc, gen, radiance_spp=spp)
    elif route == "motion":
        ref = misc.render_motion_aov(scene, fc, gen, spp)
        assert float(ref.abs().max()) == 0.0       # the file is static
    else:
        ref = filmlib.develop(fc, render_pt(
            scene, PathConfig(max_depth=2, rr_depth=100), gen, 16 * 16 * spp,
            fc, mode="accum", sampler="sobol"), mode="accum")
    if route == "multichannel":
        got = read_exr(str(out))
        assert got.shape == (16, 16, 12)
        # the layers come back in the file's (alphabetical) channel order
        names = sorted(f"{c}.{x}" for c in ("radiance", "shnormal",
                                            "distance", "albedo")
                       for x in "RGB")
        order = [names.index(f"{c}.{x}") for c in ("radiance", "shnormal",
                                                   "distance", "albedo")
                 for x in "RGB"]
        np.testing.assert_allclose(got[..., order], ref.numpy(), rtol=1e-3,
                                   atol=1e-3)
    else:
        got = np.load(out)
        np.testing.assert_array_equal(got, ref.numpy())
    assert np.isfinite(got).all() and (route == "motion" or got.max() > 0)
    assert (tmp_path / "out_stats.txt").read_text() == EMPTY
    assert capsys.readouterr().out.endswith(EMPTY)


def test_tools_match_reference(tmp_path, capsys):
    """stages_heatmap and its main, imgtools avg / add / tonemap / rmse,
    and dump_scene against the JAX package's."""
    rng = np.random.default_rng(8)
    acc = rng.random((12, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(heatmap.stages_heatmap(acc, clip=(0.1, 0.8)),
                                  jheatmap.stages_heatmap(acc,
                                                          clip=(0.1, 0.8)))
    a, b = tmp_path / "a.exr", tmp_path / "b.exr"
    write_exr(str(a), acc)
    write_exr(str(b), acc[::-1] * 2.0)
    jax_write_exr(str(tmp_path / "ja.exr"), acc)
    assert a.read_bytes() == (tmp_path / "ja.exr").read_bytes()
    for mod, tag in ((heatmap, "port"), (jheatmap, "ref")):
        mod.main(["-t", str(a), "-c", "0.2", "0.9", "-o",
                  str(tmp_path / f"heat_{tag}.exr")])
    assert ((tmp_path / "heat_port.exr").read_bytes()
            == (tmp_path / "heat_ref.exr").read_bytes())
    with pytest.raises(NotImplementedError, match="PNG"):
        heatmap.main(["-t", str(a), "-o", str(tmp_path / "h.png")])
    for mod, tag in ((imgtools, "port"), (jimgtools, "ref")):
        mod.main(["avg", str(a), str(b), "-o",
                  str(tmp_path / f"avg_{tag}.exr")])
        mod.main(["add", str(a), str(b), "--weight-a", "0.5", "-o",
                  str(tmp_path / f"add_{tag}.exr")])
    for cmd in ("avg", "add"):
        assert ((tmp_path / f"{cmd}_port.exr").read_bytes()
                == (tmp_path / f"{cmd}_ref.exr").read_bytes()), cmd
    capsys.readouterr()
    imgtools.main(["rmse", str(a), str(b)])
    port_rmse = capsys.readouterr().out
    jimgtools.main(["rmse", str(a), str(b)])
    assert port_rmse == capsys.readouterr().out
    imgtools.main(["tonemap", str(b), "-e", "-1", "--reinhard", "-o",
                   str(tmp_path / "t.npy")])
    jimgtools.main(["tonemap", str(b), "-e", "-1", "--reinhard", "-o",
                    str(tmp_path / "t.png")])
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.asarray(Image.open(tmp_path / "t.png")))
    for tall in ("diffuse", "glass"):
        dump_scene(cornell_box(24, 16, tall_box_material=tall),
                   filmlib.make_film_config(24, 16), str(tmp_path / "p.bin"))
        jax_dump_scene(jax_cornell(24, 16, tall_box_material=tall),
                       jfilm.make_film_config(24, 16), str(tmp_path / "j.bin"))
        assert ((tmp_path / "p.bin").read_bytes()
                == (tmp_path / "j.bin").read_bytes()), tall
