"""The CLI's path-technique routes (utils/cli.py) on the surface scenes:
integrator=path|drmlt|pssmlt on tests/data/surfaces.xml and
integrator=path on tests/data/daylight.xml at a 16x16 film take the path
wavefront and never a trace or chain kernel, their images finite; and a
scene the trace kernels cover (tests/data/cornell.xml) keeps the path and
chain kernels, bit for bit the parent's routes.
"""
import argparse

import pytest
import torch

from drmlt_mitsuba_tpu_torch.integrators import drmlt as DR
from drmlt_mitsuba_tpu_torch.integrators import path as P
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops import megadrmlt
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from drmlt_mitsuba_tpu_torch.utils import cli
from test_torch_surface_routes import DEPTH, SIDE, wavefront_only  # noqa: F401
from test_torch_surface_scene import DAYLIGHT, SURFACES

torch.set_num_threads(1)

CORNELL = SURFACES.replace("surfaces.xml", "cornell.xml")


def test_kernel_scope_scene_keeps_the_kernels(monkeypatch):
    """cornell.xml stays on the path kernel (its twin on the CPU) and, in
    render_drmlt_path, on the chain kernel, bit for bit the parent's
    routes; the wavefront is never called."""
    sc, _ = load_scene_xml(CORNELL, {"integrator": "path"})
    cfg = PathConfig(max_depth=4, rr_depth=100)
    assert MT.mega_eligible(sc, cfg)

    def refuse(*a, **kw):
        raise AssertionError("the wavefront ran on a kernel-scope scene")

    monkeypatch.setattr(P, "trace_paths_wavefront", refuse)
    u = torch.rand((512, cfg.n_dims), generator=torch.Generator()
                   .manual_seed(4))
    tables = MT.make_tables(sc, cfg, "cpu")
    want = MT.path_trace(tables, u.T.contiguous()).T
    assert torch.equal(P.make_path_trace(sc, cfg, "cpu")(u).value[:, 0],
                       want)
    fc = filmlib.make_film_config(8, 8, "box")
    film = P.render_pt(sc, cfg, torch.Generator().manual_seed(5), 256, fc)
    g = torch.Generator().manual_seed(5)
    ref = filmlib.new_film(fc, "cpu")
    uu = torch.rand((256, cfg.n_dims), generator=g)
    ref = filmlib.splat(fc, ref, uu[:, 0:2] * 8,
                        MT.path_trace(tables, uu.T.contiguous()).T,
                        mode="accum")
    assert torch.equal(film, ref)
    steps = []
    real = megadrmlt.drmlt_chain_step
    monkeypatch.setattr(megadrmlt, "drmlt_chain_step",
                        lambda *a: steps.append(1) or real(*a))
    img, aux = DR.render_drmlt_path(
        sc, cfg, DR.DRMLTConfig(type="orbital", n_chains=64,
                                n_bootstrap=8192),
        fc, torch.Generator().manual_seed(6), 16)
    assert steps and torch.isfinite(img).all() and aux["steps"] == 16


@pytest.mark.parametrize("itype", ["path", "drmlt", "pssmlt"])
def test_cli_routes_take_the_wavefront(itype, wavefront_only):
    defs = [f"integrator={itype}", f"res={SIDE}", f"depth={DEPTH}",
            "luminanceSamples=8192", "variant=orbital"]
    sc, xs = cli.load_scene(SURFACES, dict(kv.split("=", 1) for kv in defs))
    args = argparse.Namespace(D=defs, chains=256, spp=4, seed=3)
    img, aux = cli.render(args, sc, xs, torch.device("cpu"))
    assert wavefront_only and img.shape == (SIDE, SIDE, 3)
    assert torch.isfinite(img).all() and float(img.mean()) > 0


def test_cli_renders_daylight(wavefront_only):
    defs = ["integrator=path", f"res={SIDE}", f"depth={DEPTH}"]
    sc, xs = cli.load_scene(DAYLIGHT, dict(kv.split("=", 1) for kv in defs))
    img, aux = cli.render(argparse.Namespace(D=defs, chains=256, spp=4,
                                             seed=4), sc, xs,
                          torch.device("cpu"))
    assert wavefront_only and aux["samples"] == SIDE * SIDE * 4
    assert torch.isfinite(img).all() and float(img.mean()) > 0
