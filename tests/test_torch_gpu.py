"""CUDA kernels vs their plain twins, on the card.

Marked `gpu`; each test skips itself when torch sees no CUDA device (the
decision is taken inside the test, never at import).  The machine with the
card has no JAX, and tests/conftest.py imports it, so run these there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

This file imports torch and the port only.  The library is built with
--fmad=false, so kernel and twin round alike; lanes may still differ where
the CUDA math library and PyTorch disagree in a last bit on an edge, so the
tolerances are the reference's own kernel-vs-XLA ones (0.2% of lanes,
channel means to 5e-3).
"""
import pytest
import torch

from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
    DRMLTConfig, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mcmc import state_from_splats
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    make_mmlt_trace_fixed, render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _scene(name):
    if name == "veach":
        return veach_door(64, 64)
    return cornell_box(64, 64, tall_box_material=name)


def _lanes_agree(k, t, atol=0.0, pos_rows=0):
    """Kernel vs twin outputs (n, R): at most 0.2% of lanes off by more
    than 1e-3 relative, channel means to 5e-3.  The last pos_rows rows are
    film positions, compared on lanes that carry light only (a zero-valued
    sample's position is arbitrary and never splatted with weight)."""
    n = k.shape[0] - pos_rows
    rel = (k - t).abs() / (t.abs() + 1e-3)
    bad = (rel[:n] > 1e-3).any(0)
    if pos_rows:
        bad = bad | ((rel[n:] > 1e-3).any(0) & (t[:n].abs() > 1e-7).any(0))
    assert float(bad.float().mean()) <= 0.002
    torch.testing.assert_close(k[:n].mean(1), t[:n].mean(1), rtol=5e-3,
                               atol=atol)
    assert bool(torch.isfinite(k).all())


@pytest.mark.parametrize("tall", ["diffuse", "mirror", "glass", "veach"])
def test_path_kernel_matches_twin(cuda, tall):
    cfg = PathConfig(max_depth=6, rr_depth=3)
    tables = MT.make_tables(_scene(tall), cfg, cuda)
    uT = torch.rand((cfg.n_dims, 16384), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    n0 = build.LAUNCHES["path_trace"]
    k = MT.path_trace(tables, uT)
    torch.cuda.synchronize()
    assert build.LAUNCHES["path_trace"] == n0 + 1
    _lanes_agree(k, MT.path_trace_reference(tables, uT))


@pytest.mark.parametrize("scene", ["diffuse", "mirror", "glass", "veach"])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_mmlt_kernel_matches_twin(cuda, scene, depth):
    cfg = BDPTConfig(max_depth=depth, light_image=depth != 3)
    tables = MM.make_mmlt_tables(_scene(scene), cfg, cuda)
    uT = torch.rand((tables.n_core, 16384), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(depth))
    n0 = build.LAUNCHES["mmlt_trace"]
    k = MM.mmlt_trace(tables, uT)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mmlt_trace"] == n0 + 1
    # atol: a channel mean over few lit lanes may sit near 0
    _lanes_agree(k, MM.mmlt_trace_reference(tables, uT), atol=1e-6,
                 pos_rows=2)


@pytest.mark.parametrize("drtype", ["orbital", "green", "mira"])
@pytest.mark.parametrize("mode", ["three", "sampled"])
@pytest.mark.parametrize("given", [True, False], ids=["uniforms", "philox"])
def test_chain_kernel_matches_twin(cuda, drtype, mode, given):
    C, W = 2048, 64
    pcfg = PathConfig(max_depth=4, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    scene = cornell_box(W, W)
    tables = MT.make_tables(scene, pcfg, cuda)
    trace = make_path_trace(scene, pcfg, cuda)
    g = torch.Generator(cuda).manual_seed(2)
    u = torch.rand((C, D), device=cuda, generator=g)
    state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    cfg = DRMLTConfig(type=drtype, splat_mode=mode)
    uni = (torch.rand((3 * MD.n_rand(cfg, D), C), device=cuda, generator=g)
           if given else None)
    out = []
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st, film, stats = (state0.clone(),
                           torch.zeros((W, W, 3), device=cuda),
                           torch.zeros((6, C), device=cuda))
        fn(tables, cfg, 3, st, film, stats, 17, 2, uni)
        out.append((st, film, stats))
    torch.cuda.synchronize()
    (sk, fk, tk), (sr, fr, tr) = out
    agree = ((sk[:D] - sr[:D]).abs().max(0).values <= 2e-5).float().mean()
    assert float(agree) >= 0.99
    assert float((fk - fr).abs().sum() / fr.abs().sum()) <= 1e-2
    torch.testing.assert_close(tk.sum(1), tr.sum(1), rtol=1e-2, atol=1.0)


@pytest.mark.parametrize("drtype", ["orbital", "green", "mira"])
@pytest.mark.parametrize("mode", ["three", "sampled"])
@pytest.mark.parametrize("given", [True, False], ids=["uniforms", "philox"])
def test_mmlt_chain_kernel_matches_twin(cuda, drtype, mode, given):
    C, W, k = 2048, 64, 4
    trace, _, D, tables = make_mmlt_trace_fixed(cornell_box(W, W), k, True,
                                                cuda)
    g = torch.Generator(cuda).manual_seed(5)
    u = torch.rand((4 * C, D), device=cuda, generator=g)
    u = u[torch.nonzero(trace(u).lum > 0)[:C, 0]]
    assert u.shape[0] == C
    state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    cfg = DRMLTConfig(type=drtype, splat_mode=mode,
                      fix_emitter_path=drtype == "green")
    uni = (torch.rand((3 * MD.n_rand(cfg, D), C), device=cuda, generator=g)
           if given else None)
    out = []
    n0 = build.LAUNCHES["drmlt_mmlt"]
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st, film, stats = (state0.clone(),
                           torch.zeros((W, W, 3), device=cuda),
                           torch.zeros((6, C), device=cuda))
        fn(tables, cfg, 3, st, film, stats, 19, 1, uni)
        out.append((st, film, stats))
    torch.cuda.synchronize()
    assert build.LAUNCHES["drmlt_mmlt"] == n0 + 1
    (sk, fk, tk), (sr, fr, tr) = out
    agree = ((sk[:D] - sr[:D]).abs().max(0).values <= 2e-5).float().mean()
    assert float(agree) >= 0.99
    assert float((fk - fr).abs().sum() / fr.abs().sum()) <= 1e-2
    torch.testing.assert_close(tk.sum(1), tr.sum(1), rtol=1e-2, atol=1.0)


@pytest.mark.parametrize("equal_chains", [True, False])
def test_grouped_render_runs_through_both_kernels(cuda, equal_chains):
    build.reset_launches()
    fc = filmlib.make_film_config(64, 64, "box")
    img, aux = render_drmlt_mmlt_grouped(
        veach_door(64, 64), BDPTConfig(max_depth=4),
        DRMLTConfig(type="orbital", n_chains=4096, n_bootstrap=8192,
                    splat_mode="sampled"), fc,
        torch.Generator(cuda).manual_seed(3), n_steps=64, min_group=1024,
        equal_chains=equal_chains)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mmlt_trace"] >= 2 * len(aux["images"])
    assert build.LAUNCHES["drmlt_mmlt"] >= len(aux["images"]) > 0
    assert build.LAUNCHES["path_trace"] == build.LAUNCHES["drmlt_path"] == 0
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0


def test_render_runs_through_both_kernels(cuda):
    build.reset_launches()
    fc = filmlib.make_film_config(64, 64, "box")
    img, aux = render_drmlt_path(
        cornell_box(64, 64), PathConfig(max_depth=4, rr_depth=100),
        DRMLTConfig(type="orbital", n_chains=4096, n_bootstrap=8192,
                    splat_mode="sampled"), fc,
        torch.Generator(cuda).manual_seed(3), n_steps=64)
    torch.cuda.synchronize()
    assert build.LAUNCHES["path_trace"] > 0
    assert build.LAUNCHES["drmlt_path"] == 1
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0
    assert float(aux["stats"]["accept2"]) > 0.02


def test_wrappers_reject_mismatched_devices(cuda):
    cfg = PathConfig(max_depth=2)
    tables = MT.make_tables(cornell_box(16, 16), cfg, cuda)
    with pytest.raises(ValueError, match="tables on"):
        MT.path_trace(tables, torch.rand((cfg.n_dims, 8)))
    mtab = MM.make_mmlt_tables(cornell_box(16, 16), BDPTConfig(max_depth=2),
                               cuda)
    with pytest.raises(ValueError, match="tables on"):
        MM.mmlt_trace(mtab, torch.rand((mtab.n_core, 8)))
    deep = MM.make_mmlt_tables(cornell_box(16, 16),
                               BDPTConfig(max_depth=MM.MAX_DEPTH + 1), cuda)
    with pytest.raises(ValueError, match="max_depth"):
        MM.mmlt_trace(deep, torch.rand((deep.n_core, 8), device=cuda))
