"""The port's CLI reads the integrator options the reference CLI reads.

Every `-D key=value` is a `$key` substitution in the scene file and, unless
the file's integrator has that key, an integrator option
(drmlt_mitsuba_tpu/utils/cli.py:134-140).  The merged options are held to
the reference CLI's own, captured from its `dump_config` call right after
the merge (cli.py:147), on tests/data/cornell.xml; then to what reaches
the port's renders.  What the port cannot render yet raises naming it, and
each key the reference reads reaches its route.  Last, integrator=pssmlt renders the file on the
CPU at tiny size in both techniques (the reference's tests/test_cli.py:34).
"""
import argparse
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import drmlt_mitsuba_tpu.core.logger as jax_logger
from drmlt_mitsuba_tpu.utils import cli as jax_cli
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig
from drmlt_mitsuba_tpu_torch.ops import megammlt, megatrace
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.xml import RenderSettings
from drmlt_mitsuba_tpu_torch.utils import cli
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr

torch.set_num_threads(1)

CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")
DRMLT_D = ["integrator=drmlt", "splatMode=three", "pLarge=0.5",
           "chains=4096", "type=orbital", "maxDepth=7", "equalChains=false",
           "luminanceSamples=2000", "averageLuminance=0.25"]
PSSMLT_D = ["integrator=pssmlt", "technique=mmlt",
            "kelemenStyleMutation=false", "kelemenStyleWeights=false",
            "mutationSizeLow=0.002", "mutationSizeHigh=0.03", "sigma=0.02",
            "pLens=0.1", "pCaustic=0.05", "lensSigma=0.04", "causticDims=4",
            "pLarge=0.4", "chains=512", "averageLuminance=0.3"]


class _Captured(Exception):
    pass


def _reference_config(tmp_path, monkeypatch, defs):
    """The reference CLI's merged integrator config for `-D defs`."""
    got = {}

    def dump_config(log, name, cfg):
        got.update(cfg)
        raise _Captured

    monkeypatch.setattr(jax_logger, "dump_config", dump_config)
    argv = [CORNELL, "-o", str(tmp_path / "ref.exr"), "-q"]
    for kv in defs:
        argv += ["-D", kv]
    with pytest.raises(_Captured):
        jax_cli.main(argv)
    return got


def _port(defs, chains=16384):
    """(args, scene, settings) as the port's main makes them."""
    args = argparse.Namespace(D=defs, chains=chains, spp=1, seed=0)
    scene, settings = cli.load_scene(CORNELL, dict(
        kv.split("=", 1) for kv in defs))
    return args, scene, settings


class _Stop(Exception):
    pass


def _capture(monkeypatch, name):
    """Replace cli.<name> by a recorder that stops the render."""
    seen = {}

    def rec(*a, **kw):
        seen["args"], seen["kw"] = a, kw
        raise _Stop

    monkeypatch.setattr(cli, name, rec)
    return seen


@pytest.mark.parametrize("defs", [DRMLT_D, PSSMLT_D],
                         ids=["drmlt", "pssmlt"])
def test_merged_config_matches_reference(tmp_path, monkeypatch, defs):
    ref = _reference_config(tmp_path, monkeypatch, defs)
    args, scene, settings = _port(defs)
    icfg = cli.integrator_config(args, settings)
    assert icfg == ref
    assert icfg["maxDepth"] == 4                 # the file's key wins
    # the values reach the render
    if defs is DRMLT_D:
        seen = _capture(monkeypatch, "render_drmlt_path")
        with pytest.raises(_Stop):
            cli.render(args, scene, settings, torch.device("cpu"))
        pcfg, cfg = seen["args"][1], seen["args"][2]
        assert pcfg.max_depth == 4 and pcfg.rr_depth == 100
        assert (cfg.type, cfg.splat_mode, cfg.p_large, cfg.n_chains,
                cfg.n_bootstrap) == ("orbital", "three", 0.5, 4096, 2000)
        assert seen["args"][5] == 1          # n_steps: 64 x 64 x 1 / 4096
        assert seen["kw"]["average_luminance"] == 0.25
    else:
        seen = _capture(monkeypatch, "render_pssmlt")
        with pytest.raises(_Stop):
            cli.render(args, scene, settings, torch.device("cpu"))
        trace, mcfg, _, _, n_dims, n_steps = seen["args"]
        assert (mcfg.n_chains, mcfg.p_large, mcfg.kelemen_style_mutation,
                mcfg.kelemen_style_weights, mcfg.mutation_size_low,
                mcfg.mutation_size_high, mcfg.sigma, mcfg.p_lens,
                mcfg.p_caustic, mcfg.lens_sigma, mcfg.caustic_dims) == (
            512, 0.4, False, False, 0.002, 0.03, 0.02, 0.1, 0.05, 0.04, 4)
        # the pooled MMLT trace at the file's depth 4: 2 technique dims,
        # eye 11, light 11 (even); the depth dim pinned
        assert n_dims == 24 and n_steps == 64 * 64 // 512
        pinned = seen["kw"]["pinned_mask"]
        assert pinned.tolist() == [True] + [False] * 23
        assert seen["kw"]["average_luminance"] == 0.3


def test_file_keys_win_and_blocks_round_up(monkeypatch):
    """setdefault semantics on any settings; a pssmlt render's steps are
    whole blocks of min(256, n_steps) (cli.py:542-553)."""
    settings = RenderSettings(integrator=dict(type="pssmlt", pLarge=0.1,
                                              technique="path"),
                              width=40, height=40, filter_name="box", spp=7)
    args = argparse.Namespace(D=["pLarge=0.9", "chains=8", "type=drmlt"],
                              chains=3, spp=None, seed=0)
    assert cli.integrator_config(args, settings) == dict(
        type="pssmlt", pLarge=0.1, technique="path", chains="8")
    assert settings.integrator == dict(type="pssmlt", pLarge=0.1,
                                       technique="path")
    # the stand-in returns the steps and their per-step stats, which the
    # CLI's acceptance report reads
    monkeypatch.setattr(cli, "render_pssmlt", lambda *a, **kw: (None, dict(
        steps=a[5], stats=dict(accept=torch.zeros(a[5])))))
    # 40 x 40 x 7 / chains steps, rounded up to whole blocks
    for chains, want in ((8, 1536), (4, 2816), (4096, 2)):
        args.D[1] = f"chains={chains}"
        _, aux = cli.render(args, cornell_box(8, 8), settings,
                            torch.device("cpu"))
        assert aux["steps"] == want and aux["mutations"] == chains * want


def test_unported_keys_raise_naming_the_key(monkeypatch):
    dev = torch.device("cpu")
    cases = [(["integrator=erpt"], "erpt")]
    for defs, key in cases:
        args, scene, settings = _port(defs)
        with pytest.raises(NotImplementedError, match=key):
            cli.render(args, scene, settings, dev)
    with pytest.raises(NotImplementedError, match="PNG"):
        cli.main([CORNELL, "-o", "out.png", "--device", "cpu"])
    args, scene, settings = _port(["integrator=path"])
    settings.sampler = "nosuch"
    with pytest.raises(ValueError, match="unknown sampler 'nosuch'"):
        cli.render(args, scene, settings, dev)
    # a non-independent sampler reaches render_pt; ptracer its render
    for sampler, defs, name in (("ldsampler", ["integrator=path"],
                                 "render_pt"),
                                ("independent", ["integrator=ptracer"],
                                 "render_ptracer")):
        args, scene, settings = _port(defs)
        settings.sampler = sampler
        seen = _capture(monkeypatch, name)
        with pytest.raises(_Stop):
            cli.render(args, scene, settings, dev)
        if name == "render_pt":
            assert seen["kw"]["sampler"] == "ldsampler"
            assert seen["args"][3] == 64 * 64
        else:         # the reference's default depth 5: the file's 4 wins
            assert seen["kw"]["max_depth"] == 4 and seen["args"][3] == 64 * 64
        monkeypatch.undo()
    # the keys that raised before they were ported now reach their route:
    # the generic loop's render (render_drmlt / render_pssmlt), or its
    # first render_pt pass (twoStage's 4x4 luminance pass at 64 paths a
    # pixel, separateDirect's depth-2 pass at 16); a key set to false, or
    # one the reference does not read for the integrator (pssmlt ignores
    # useMixture), is no refusal either
    for defs, name in (
            (["integrator=drmlt", "acceptanceMap=true"], "render_drmlt"),
            (["integrator=drmlt", "useMixture=true"], "render_drmlt"),
            (["integrator=drmlt", "technique=mmlt", "grouped=false"],
             "render_drmlt"),
            (["integrator=drmlt", "technique=mmlt", "acceptanceMap=true"],
             "render_drmlt_mmlt_grouped"),
            (["integrator=pssmlt", "acceptanceMap=true"], "render_pssmlt"),
            (["integrator=drmlt", "twoStage=true"], "render_pt"),
            (["integrator=pssmlt", "twoStage=true"], "render_pt"),
            (["integrator=drmlt", "separateDirect=true"], "render_pt"),
            (["integrator=pssmlt", "separateDirect=true"], "render_pt"),
            (["integrator=direct"], "render_pt"),
            (["integrator=drmlt", "twoStage=false"], "render_drmlt_path"),
            (["integrator=pssmlt", "useMixture=true"], "render_pssmlt"),
            (["integrator=drmlt", "technique=bdpt"], "render_drmlt"),
            (["integrator=pssmlt", "technique=bdpt"], "render_pssmlt"),
            # last: its capture stands in for the bdpt routes' trace
            (["integrator=bdpt"], "make_bdpt_trace")):
        args, scene, settings = _port(defs)
        seen = _capture(monkeypatch, name)
        with pytest.raises(_Stop):
            cli.render(args, scene, settings, dev)
        a = seen["args"]
        if "grouped=false" in defs:
            # the pooled MMLT trace at the file's depth 4: 24 dims, the
            # depth dim pinned, the strategy dim frozen, fixEmitterPath's
            # masks over the 11 light dims
            assert a[4] == 24 and seen["kw"]["pinned_mask"].tolist() == (
                [True] + [False] * 23)
            assert seen["kw"]["frozen_mask"].tolist() == (
                [False, True] + [False] * 22)
            assert seen["kw"]["emitter_mask"].sum() == 11
        elif "technique=bdpt" in defs:
            # trace_bdpt at the file's depth 4: 11 eye and 11 light dims,
            # nothing pinned or frozen
            assert a[4] == 22 and seen["kw"]["pinned_mask"] is None
        elif name == "make_bdpt_trace":
            # integrator=bdpt at the file's depth 4, the light image on
            assert a[1] == BDPTConfig(max_depth=4, light_image=True)
        elif name == "render_drmlt":
            assert a[1].acceptance_map == ("acceptanceMap=true" in defs)
            assert not a[1].use_mixture     # cli.py:520-524 runs drmlt_step
        elif name == "render_drmlt_mmlt_grouped":
            assert a[2].acceptance_map
        elif name == "render_pt":
            n, fc = a[3], a[4]
            if "twoStage=true" in defs:
                assert (fc.width, fc.height, n) == (4, 4, 4 * 4 * 64)
                assert fc.filter.name == "box"
            else:
                assert a[1].max_depth == 2 and n == 64 * 64 * (
                    16 if "separateDirect=true" in defs else 1)
                assert fc.filter.name == "box"      # the file's filter


def _remember_traces(monkeypatch):
    """Make the path and MMLT twins return their earlier output for equal
    tables and inputs: a render with averageLuminance draws the same
    chains as one without, so it replays the first render's traces."""
    for mod, name in ((megatrace, "path_trace_reference"),
                      (megammlt, "mmlt_trace_reference")):
        twin, seen = getattr(mod, name), {}

        def remembered(tables, uT, work=None, twin=twin, seen=seen):
            if work is not None:
                return twin(tables, uT, work)
            h = hashlib.blake2b(digest_size=16)
            for f in dataclasses.fields(tables):
                v = getattr(tables, f.name)
                h.update(v.contiguous().numpy().tobytes()
                         if isinstance(v, torch.Tensor) else repr(v).encode())
            for v in (tables.nodes.node, tables.nodes.rec) if getattr(
                    tables, "nodes", None) is not None else ():
                h.update(v.numpy().tobytes())
            h.update(uT.contiguous().numpy().tobytes())
            key = (tuple(uT.shape), h.digest())
            if key not in seen:
                seen[key] = twin(tables, uT)
            return seen[key].clone()
        monkeypatch.setattr(mod, name, remembered)


def test_average_luminance_and_chains_reach_the_render(monkeypatch):
    """-D chains wins over --chains, and averageLuminance replaces b: the
    same render with it is the image scaled by averageLuminance / b, for
    the path driver (through the CLI) and the grouped driver."""
    _remember_traces(monkeypatch)
    dev = torch.device("cpu")
    out = {}
    for avg in (None, 0.5):
        defs = ["integrator=drmlt", "chains=256", "luminanceSamples=100",
                "type=orbital"] + ([f"averageLuminance={avg}"] if avg else [])
        args, scene, settings = _port(defs, chains=999)
        out[avg] = cli.render(args, scene, settings, dev)
    (img, aux), (img_a, aux_a) = out[None], out[0.5]
    assert aux["state"].shape[1] == 256 and float(aux_a["b"]) == 0.5
    torch.testing.assert_close(img_a, img * (0.5 / float(aux["b"])))

    fc = film.make_film_config(8, 8, "box")
    cfg = DRMLTConfig(type="orbital", n_chains=256, n_bootstrap=100)
    runs = [render_drmlt_mmlt_grouped(
        cornell_box(8, 8), BDPTConfig(max_depth=2), cfg, fc,
        torch.Generator().manual_seed(4), 16, average_luminance=avg)
        for avg in (None, 0.5)]
    (img, aux), (img_a, aux_a) = runs
    assert aux_a["b"] == 0.5 and aux_a["steps_per_group"] == aux[
        "steps_per_group"]
    np.testing.assert_allclose(aux_a["b_k"], np.asarray(aux["b_k"])
                               * (0.5 / aux["b"]), rtol=1e-6)
    torch.testing.assert_close(img_a, img * (0.5 / aux["b"]))


@pytest.mark.parametrize("tech", ["path", "mmlt"])
def test_cli_pssmlt_renders_cornell_xml(tmp_path, capsys, tech):
    out = tmp_path / "out.exr"
    rc = cli.main([CORNELL, "-D", "integrator=pssmlt", "-D",
                   f"technique={tech}", "-D", "luminanceSamples=1000",
                   "--spp", "4", "--chains", "256", "--device", "cpu",
                   "-o", str(out)])
    assert rc == 0
    img = read_exr(str(out))
    assert img.shape == (64, 64, 3)
    assert np.all(np.isfinite(img)) and img.mean() > 1e-4
    text = capsys.readouterr().out
    assert "mutations/s" in text and "64 steps" in text


def test_builtin_scene_keys():
    """A built-in scene's integrator options are its -D keys: the new ones
    are known, an unknown one still stops."""
    _, settings = cli.load_scene("cornell", {
        "integrator": "pssmlt", "kelemenStyleWeights": "false",
        "pLens": "0.1", "chains": "64", "averageLuminance": "0.2"})
    assert settings.integrator["type"] == "pssmlt"
    assert settings.integrator["pLens"] == "0.1"
    with pytest.raises(SystemExit, match="unknown -D keys"):
        cli.load_scene("cornell", {"kelemenStyle": "true"})
