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
import dataclasses

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
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, make_path_trace_diff,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.ops import intersect as IX
from drmlt_mitsuba_tpu_torch.ops import splat as SP
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door
from drmlt_mitsuba_tpu_torch.scene.types import prepare_scene
from drmlt_mitsuba_tpu_torch.utils import raybench

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


def _compact_scene(name):
    """The scenes the compacting path kernel is held on: the 36-triangle
    box, the veach door (no path ends early), the full-scope const
    configuration, tests/data/cornell.xml (full scope) and
    cornell_large.xml (19,586 triangles, the walk)."""
    import os

    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
    from drmlt_mitsuba_tpu_torch.utils import cli
    data = os.path.join(os.path.dirname(__file__), "data")
    if name == "box":
        return cornell_box(256, 256)
    if name == "veach":
        return veach_door(256, 256)
    if name == "const":
        return cornell_scope(256, 256, "const")
    if name == "cornell_xml":
        return cli.load_scene(os.path.join(data, "cornell.xml"),
                              {"integrator": "drmlt"})[0]
    return cli.load_scene(os.path.join(data, "large", "cornell_large.xml"),
                          {"integrator": "drmlt"})[0]


@pytest.mark.parametrize("scene", ["box", "veach", "const", "cornell_xml",
                                   "large"])
@pytest.mark.parametrize("depth", [8, 6, 4])
def test_compacting_path_kernel_equals_one_path_per_thread(cuda, scene,
                                                           depth):
    """65,536 lanes: the kernel that compacts live paths into full warps
    between bounces returns, bit for bit, the rgb of one path per thread
    and of the twin."""
    cfg = PathConfig(max_depth=depth, rr_depth=100)
    tables = MT.make_tables(_compact_scene(scene), cfg, cuda)
    assert tables.full == (scene in ("const", "cornell_xml"))
    assert (tables.nodes is not None) == (scene == "large")
    uT = torch.rand((cfg.n_dims, 65536), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(depth))
    key = build.scope_key("path_trace", tables)
    n0 = build.LAUNCHES[key]
    k = MT.path_trace(tables, uT)
    lane = MT.path_trace(tables, uT, compact=False)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n0 + 2
    assert torch.equal(k.view(torch.int32), lane.view(torch.int32))
    t = MT.path_trace_reference(tables, uT)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))
    assert float((k.sum(0) > 0).float().mean()) > 0.01


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


@pytest.mark.parametrize("scene", ["diffuse", "glass"])
@pytest.mark.parametrize("depth", [1, 6])
@pytest.mark.parametrize("side", ["s0", "t1"])
def test_mmlt_kernel_one_sided_strategies(cuda, scene, depth, side):
    """Every lane on an s = 0 strategy (no light walk) or on t = 1 (no eye
    walk), over the pooled depths 1..max_depth: one side of the kernel's
    fused walk is empty on every lane."""
    cfg = BDPTConfig(max_depth=depth)
    tables = MM.make_mmlt_tables(_scene(scene), cfg, cuda)
    uT = torch.rand((tables.n_core, 16384), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(depth))
    # u(1) * (d + 1) below 1 picks s = 0, at or above d picks s = d
    # (t = 1), for every depth d <= 6
    uT[1] = uT[1] * 0.14 if side == "s0" else 1.0 - uT[1] * 0.14
    k = MM.mmlt_trace(tables, uT)
    torch.cuda.synchronize()
    _lanes_agree(k, MM.mmlt_trace_reference(tables, uT), atol=1e-6,
                 pos_rows=2)
    assert float(k[:3].sum()) > 0


# the chain kernel's blocks gather their stage-2 chains: 2,000 chains leave
# a last block part-empty, whose tail threads cross every barrier; timid
# runs stage 2 after large steps too
CHAIN_CASES = pytest.mark.parametrize("C,timid", [(2048, False),
                                                  (2000, True)],
                                      ids=["2048", "2000-timid"])


@CHAIN_CASES
@pytest.mark.parametrize("drtype", ["orbital", "green", "mira"])
@pytest.mark.parametrize("mode", ["three", "sampled"])
@pytest.mark.parametrize("given", [True, False], ids=["uniforms", "philox"])
def test_chain_kernel_matches_twin(cuda, drtype, mode, given, C, timid):
    W = 64
    pcfg = PathConfig(max_depth=4, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    scene = cornell_box(W, W)
    tables = MT.make_tables(scene, pcfg, cuda)
    trace = make_path_trace(scene, pcfg, cuda)
    g = torch.Generator(cuda).manual_seed(2)
    u = torch.rand((C, D), device=cuda, generator=g)
    state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    cfg = DRMLTConfig(type=drtype, splat_mode=mode, timid_after_large=timid)
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


@CHAIN_CASES
@pytest.mark.parametrize("drtype", ["orbital", "green", "mira"])
@pytest.mark.parametrize("mode", ["three", "sampled"])
@pytest.mark.parametrize("given", [True, False], ids=["uniforms", "philox"])
def test_mmlt_chain_kernel_matches_twin(cuda, drtype, mode, given, C, timid):
    W, k = 64, 4
    trace, _, D, tables = make_mmlt_trace_fixed(cornell_box(W, W), k, True,
                                                cuda)
    g = torch.Generator(cuda).manual_seed(5)
    u = torch.rand((4 * C, D), device=cuda, generator=g)
    u = u[torch.nonzero(trace(u).lum > 0)[:C, 0]]
    assert u.shape[0] == C
    state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    cfg = DRMLTConfig(type=drtype, splat_mode=mode,
                      fix_emitter_path=drtype == "green",
                      timid_after_large=timid)
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


# ---------------------------------------------------------------- slice 3
def test_splat_kernel_matches_twin(cuda):
    """The splat kernel against the exact scatter: per-pixel sums to rtol
    1e-5 (atomics add in no fixed order), the backward gather exact, and
    film.splat on a CUDA film launches the kernel."""
    fc = filmlib.make_film_config(64, 64, "box")
    g = torch.Generator(cuda).manual_seed(5)
    pos = torch.rand((20000, 2), generator=g, device=cuda) * 64
    val = torch.rand((20000, 3), generator=g, device=cuda)
    py, px, vals = filmlib.taps(fc, pos, val, mode="accum")
    film = filmlib.new_film(fc, cuda)
    k = SP.splat_add_(film.clone(), py, px, vals)
    t = SP.splat_add_reference_(film.clone(), py, px, vals)
    torch.testing.assert_close(k, t, rtol=1e-5, atol=0.0)
    before = build.LAUNCHES["splat_add"]
    img = filmlib.splat(fc, film, pos, val, mode="accum")
    assert img is film and build.LAUNCHES["splat_add"] == before + 1
    v = val.clone().requires_grad_()
    ct = torch.rand((64, 64, 4), generator=g, device=cuda)
    filmlib.splat(fc, filmlib.new_film(fc, cuda), pos, v,
                  mode="accum").backward(ct)
    v_cpu = val.cpu().requires_grad_()
    filmlib.splat(fc, filmlib.new_film(fc, "cpu"), pos.cpu(), v_cpu,
                  mode="accum").backward(ct.cpu())
    assert torch.equal(v.grad.cpu(), v_cpu.grad)


@pytest.mark.parametrize("fname", ["tent", "gaussian", "lanczos"])
def test_splat_kernel_matches_twin_at_wide_footprints(cuda, fname):
    """Footprints 2, 4 and 6 (tent, gaussian, lanczos) in splat mode, the
    splats a radius inside the film: per pixel within 1e-5 of the sum of
    |tap| landing there (atomics add in no fixed order, and lanczos' taps
    carry both signs)."""
    fc = filmlib.make_film_config(64, 64, fname)
    r = fc.filter.radius
    g = torch.Generator(cuda).manual_seed(8)
    pos = r + torch.rand((50000, 2), generator=g, device=cuda) * (64 - 2 * r)
    val = torch.rand((50000, 3), generator=g, device=cuda)
    w = torch.rand((50000,), generator=g, device=cuda)
    py, px, vals = filmlib.taps(fc, pos, val, w, mode="splat")
    F = fc.filter.footprint
    assert py.shape == (50000 * F * F,)
    k = SP.splat_add_(filmlib.new_film(fc, cuda), py, px, vals)
    t = SP.splat_add_reference_(filmlib.new_film(fc, cuda), py, px, vals)
    mag = SP.splat_add_reference_(filmlib.new_film(fc, cuda), py, px,
                                  vals.abs())
    assert float(((k - t).abs() / mag.clamp(min=1e-30)).max()) <= 1e-5


def test_generic_step_matches_twin(cuda):
    """One generic DRMLT step (orbital, acceptance map) of 4,096 chains
    through the path kernel and through its twin on the CPU, on the same
    starts and uniforms: >= 99% of chains with equal state, the film
    within 5e-3 of its max, the accmaps equal."""
    from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
        DRMLTUniforms, draw_drmlt_uniforms, drmlt_step_from_uniforms,
    )
    from drmlt_mitsuba_tpu_torch.integrators.mcmc import ChainState

    scene, pcfg = _scene("diffuse"), PathConfig(max_depth=6, rr_depth=100)
    D, C = pcfg.n_dims, 4096
    fc = filmlib.make_film_config(64, 64, "box")
    g = torch.Generator(cuda).manual_seed(9)
    trace = make_path_trace(scene, pcfg, cuda)
    cand = torch.rand((8 * C, D), generator=g, device=cuda)
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    st = state_from_splats(u0, trace(u0))
    draws = draw_drmlt_uniforms(g, C, D, "orbital")
    cfg = DRMLTConfig(type="orbital", n_chains=C, acceptance_map=True)
    out = []
    for dev, tr, s, d in (
            (cuda, trace, st, draws),
            ("cpu", make_path_trace(scene, pcfg, "cpu"),
             ChainState(st.u.cpu(), st.lum.cpu(), st.pos.cpu(),
                        st.value.cpu()),
             DRMLTUniforms(*(getattr(draws, f.name).cpu()
                             for f in dataclasses.fields(DRMLTUniforms))))):
        before = build.LAUNCHES["path_trace"]
        (s2, film, acc), _ = drmlt_step_from_uniforms(
            tr, cfg, fc, torch.zeros(D, dtype=torch.bool, device=dev),
            (s, filmlib.new_film(fc, dev), filmlib.new_film(fc, dev)), d)
        assert build.LAUNCHES["path_trace"] == before + (dev is cuda)
        out.append((s2, film, acc))
    (sk, fk, ak), (sr, fr, ar) = out
    ok = (sk.u.cpu() - sr.u).abs().max(1).values <= 2e-5
    assert float(ok.double().mean()) >= 0.99
    assert float((fk.cpu() - fr).abs().max() / fr.abs().max()) <= 5e-3
    assert float((ak.cpu() - ar).abs().sum()) <= 0.01 * float(ar.sum())


def test_splat_kernel_drops_out_of_range_taps(cuda):
    """Taps outside the film (negative, or at H / W and beyond) add nothing
    on the card, as in the twin and the reference's one-hot kernel, and
    touch no memory beside the film."""
    g = torch.Generator(cuda).manual_seed(6)
    H, W, N = 48, 64, 50000
    py = torch.randint(-5, H + 5, (N,), generator=g, device=cuda,
                       dtype=torch.int32)
    px = torch.randint(-5, W + 5, (N,), generator=g, device=cuda,
                       dtype=torch.int32)
    vals = torch.rand((N, 4), generator=g, device=cuda)
    guard = torch.zeros((3, H, W, 4), device=cuda)   # film between guards
    k = SP.splat_add_(guard[1], py, px, vals)
    t = SP.splat_add_reference_(torch.zeros((H, W, 4), device=cuda), py,
                                px, vals)
    torch.cuda.synchronize()
    assert float(guard[0].abs().sum()) == 0.0
    assert float(guard[2].abs().sum()) == 0.0
    torch.testing.assert_close(k, t, rtol=1e-5, atol=0.0)
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    assert 0 < int(inside.sum()) < N
    torch.testing.assert_close(float(k.sum()), float(vals[inside].sum()),
                               rtol=1e-4, atol=0.0)


def test_splat_kernel_on_hot_pixels(cuda):
    """65,536 taps on three pixels (one vector atomic per tap, all on the
    same few addresses) against the twin and the float64 sums: in float32
    the sum of n taps in any order lies within n * 2^-24 of the exact one
    relative to the sum of positive taps, so 1e-4 at ~22,000 taps a pixel
    holds with a wide margin where the typical error is ~1e-5."""
    g = torch.Generator(cuda).manual_seed(7)
    H = W = 64
    hot = torch.tensor([[0, 0], [17, 40], [63, 63]], device=cuda,
                       dtype=torch.int32)
    pick = torch.randint(0, 3, (65536,), generator=g, device=cuda)
    py, px = hot[pick, 0].contiguous(), hot[pick, 1].contiguous()
    vals = torch.rand((65536, 4), generator=g, device=cuda)
    before = build.LAUNCHES["splat_add"]
    k = SP.splat_add_(torch.zeros((H, W, 4), device=cuda), py, px, vals)
    t = SP.splat_add_reference_(torch.zeros((H, W, 4), device=cuda), py, px,
                                vals)
    torch.cuda.synchronize()
    assert build.LAUNCHES["splat_add"] == before + 1
    exact = torch.zeros((H * W, 4), dtype=torch.float64, device=cuda)
    exact.index_add_(0, (py * W + px).long(), vals.double())
    exact = exact.view(H, W, 4)
    torch.testing.assert_close(k.double(), exact, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(t.double(), exact, rtol=1e-4, atol=0.0)
    assert int((k != 0).any(-1).sum()) == 3


def test_splat_kernel_rejects_a_misaligned_film(cuda):
    """The kernel adds a tap as one 16-byte vector, in place: a film whose
    base is not 16-byte aligned raises (no copy can stand in for it); the
    twin takes it on the CPU."""
    store = torch.zeros(16 * 16 * 4 + 1, device=cuda)
    film = store[1:].view(16, 16, 4)
    assert film.data_ptr() % 16
    py = torch.zeros(4, dtype=torch.int32, device=cuda)
    vals = torch.ones((4, 4), device=cuda)
    before = build.LAUNCHES["splat_add"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        SP.splat_add_(film, py, py, vals)
    assert build.LAUNCHES["splat_add"] == before
    assert float(store.abs().sum()) == 0.0
    cpu = torch.zeros(16 * 16 * 4 + 1)[1:].view(16, 16, 4)
    SP.splat_add_(cpu, py.cpu(), py.cpu(), vals.cpu())
    assert float(cpu[0, 0, 0]) == 4.0


@pytest.mark.parametrize("mode", ["rad", "alb"])
@pytest.mark.parametrize("tall", ["diffuse", "mirror", "glass", "veach"])
def test_adjoint_kernel_matches_twin(cuda, mode, tall):
    """rgb rows bit-equal to the twin on >= 99.8% of lanes (the kernels and
    the twins round alike), the Jacobian rows to rtol 1e-5 there."""
    cfg = PathConfig(max_depth=6, rr_depth=5)
    tables = MT.make_tables(_scene(tall), cfg, cuda)
    g = torch.Generator(cuda).manual_seed(6)
    uT = torch.rand((cfg.n_dims, 8192), generator=g, device=cuda)
    fn, twin = ((MT.path_trace_rad, MT.path_trace_rad_reference)
                if mode == "rad" else
                (MT.path_trace_alb, MT.path_trace_alb_reference))
    before = build.LAUNCHES[f"path_trace_{mode}"]
    k = fn(tables, uT)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"path_trace_{mode}"] == before + 1
    t = twin(tables, uT)
    same = (k[:3] == t[:3]).all(0)
    assert float(same.float().mean()) >= 0.998
    torch.testing.assert_close(k[3:, same], t[3:, same], rtol=1e-5, atol=0.0)
    assert bool(torch.isfinite(k).all()) and float(k[3:].abs().sum()) > 0


def test_replay_gradient_matches_adjoint_kernels(cuda):
    """Without Russian roulette the replay (path kernel forward, autograd of
    the twin backward) and the adjoint kernels give the same gradients of
    mean(lum) in radiance and albedo, to rtol 1e-3."""
    scene = cornell_box(64, 64)
    cfg = PathConfig(max_depth=6, rr_depth=100)
    g = torch.Generator(cuda).manual_seed(7)
    u = torch.rand((8192, cfg.n_dims), generator=g, device=cuda)
    rad = scene.emitters.radiance.to(cuda)
    alb = scene.materials.albedo.to(cuda)
    r1, a1 = rad.clone().requires_grad_(), alb.clone().requires_grad_()
    before = build.LAUNCHES["path_trace"]
    sp = make_path_trace_diff(scene, cfg)(
        {"emitters.radiance": r1, "materials.albedo": a1}, u)
    assert build.LAUNCHES["path_trace"] == before + 1
    g_r, g_a = torch.autograd.grad(sp.lum.mean(), [r1, a1])
    r2, a2 = rad.clone().requires_grad_(), alb.clone().requires_grad_()
    w_r = torch.autograd.grad(
        MT.make_mega_trace_rad(scene, cfg)(r2, u).lum.mean(), r2)[0]
    w_a = torch.autograd.grad(
        MT.make_mega_trace_alb(scene, cfg)(a2, u).lum.mean(), a2)[0]
    torch.testing.assert_close(g_r, w_r, rtol=1e-3, atol=1e-9)
    torch.testing.assert_close(g_a, w_a, rtol=1e-3, atol=1e-9)


def test_inverse_rendering_runs_through_the_kernels(cuda):
    """The inverse-rendering loop (tests/test_gradients.py:55 bounds) on the
    card: the albedo adjoint and the splat kernel each launched per step."""
    scene = cornell_box(64, 64)
    cfg = PathConfig(max_depth=4, rr_depth=100)
    fc = filmlib.make_film_config(64, 64, "box")
    g = torch.Generator(cuda).manual_seed(8)
    u = torch.rand((16384, cfg.n_dims), generator=g, device=cuda)
    trace = MT.make_mega_trace_alb(scene, cfg)
    alb = scene.materials.albedo.to(cuda)
    scale = torch.tensor([64.0, 64.0], device=cuda)

    def image(a):
        sp = trace(a, u)
        return filmlib.splat(fc, filmlib.new_film(fc, cuda),
                             sp.pos[:, 0, :] * scale, sp.value[:, 0, :],
                             mode="accum")[..., :3]

    with torch.no_grad():
        target = image(alb)
    p = torch.zeros(3, device=cuda, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.25)
    build.reset_launches()
    losses = []
    for _ in range(40):
        opt.zero_grad()
        a = torch.cat([alb[:1], torch.sigmoid(p)[None], alb[2:]])
        loss = ((image(a) - target) ** 2).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.01 * losses[0]
    torch.testing.assert_close(torch.sigmoid(p).detach(), alb[1], rtol=0.0,
                               atol=0.08)
    assert build.LAUNCHES["path_trace_alb"] == 40
    assert build.LAUNCHES["splat_add"] == 40


def test_adjoint_wrappers_reject_bad_inputs(cuda):
    """Mismatched devices and bitmap albedos raise; a max_depth above 16
    (the cap of the kernel before per-material counts) does not."""
    deep = PathConfig(max_depth=17)
    tables = MT.make_tables(cornell_box(16, 16), deep, cuda)
    assert MT.path_trace_alb(tables, torch.rand((deep.n_dims, 8),
                                                device=cuda)).shape == (18, 8)
    with pytest.raises(ValueError, match="tables on"):
        MT.path_trace_rad(tables, torch.rand((deep.n_dims, 8)))
    with pytest.raises(ValueError, match="on cuda"):
        MT.make_mega_trace_diff(cornell_box(16, 16), PathConfig())(
            {}, torch.rand((8, PathConfig().n_dims)))
    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
    tex = MT.make_tables(cornell_scope(16, 16, "const"), PathConfig(), cuda)
    with pytest.raises(ValueError, match="constant albedos"):
        MT.path_trace_alb(tex, torch.rand((tex.n_dims, 8), device=cuda))


def _adjoint_tables(scene, mode, cfg, dev):
    """The tables of an adjoint case: the box (`diffuse`, `mirror`,
    `glass`), the veach door, or [full] (cornell_scope "const" for the
    radiance kernel, "kinds" for the albedo one, whose "const" has a
    bitmap albedo)."""
    if scene == "full":
        from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
        sc = cornell_scope(64, 64, "const" if mode == "rad" else "kinds")
    else:
        sc = _scene(scene)
    return MT.make_tables(sc, cfg, dev)


def _adjoint(mode):
    return ((MT.path_trace_rad, MT.path_trace_rad_reference) if mode == "rad"
            else (MT.path_trace_alb, MT.path_trace_alb_reference))


def _pad_tables(tables, mode, k):
    """The same scene with k more emitters (never picked: cdf 2) or
    materials (never hit): its rows and counts no longer fit in shared
    memory (path_trace_grad.cu:kGradShmWords)."""
    if mode == "rad":
        extra = tables.em[-1:].repeat(k, 1)
        extra[:, 5] = 2.0
        return dataclasses.replace(tables, em=torch.cat([tables.em, extra]))
    return dataclasses.replace(
        tables, mat=torch.cat([tables.mat, tables.mat[-1:].repeat(k, 1)]))


@pytest.mark.parametrize("mode", ["rad", "alb"])
@pytest.mark.parametrize("scene", ["diffuse", "mirror", "glass", "veach",
                                   "full"])
@pytest.mark.parametrize("R", [1, 33, 8193])
def test_compacting_adjoint_equals_one_path_per_thread(cuda, mode, scene, R):
    """The adjoint kernel that compacts live paths between bounces returns,
    bit for bit, the rgb and every Jacobian row of one path per thread
    (compact=False), at lane counts that leave a block and a warp part
    filled."""
    cfg = PathConfig(max_depth=6, rr_depth=5)
    tables = _adjoint_tables(scene, mode, cfg, cuda)
    assert tables.full == (scene == "full")
    uT = torch.rand((cfg.n_dims, R), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(R))
    fn, _ = _adjoint(mode)
    key = build.scope_key(f"path_trace_{mode}", tables)
    n0 = build.LAUNCHES[key]
    k = fn(tables, uT)
    lane = fn(tables, uT, compact=False)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n0 + 2
    assert torch.equal(k.view(torch.int32), lane.view(torch.int32))
    assert bool(torch.isfinite(k).all())
    if R > 1000:
        assert float(k[3:].abs().sum()) > 0


@pytest.mark.parametrize("mode", ["rad", "alb"])
@pytest.mark.parametrize("depth,pad", [(20, 0), (6, 16)])
def test_adjoint_kernel_deep_and_wide(cuda, mode, depth, pad):
    """Past the old depth cap (20 bounces, no Russian roulette before 18)
    and past the shared-memory cap (16 padded emitters or materials, whose
    rows stay in global memory): compacting kernel == one path per thread
    bit for bit, against the twin as test_adjoint_kernel_matches_twin, and
    the padded launch's rows are the unpadded launch's, bit for bit, with
    zeros in the padding."""
    cfg = PathConfig(max_depth=depth, rr_depth=18)
    base = _adjoint_tables("diffuse", mode, cfg, cuda)
    tables = _pad_tables(base, mode, pad) if pad else base
    uT = torch.rand((cfg.n_dims, 8192), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(depth))
    fn, twin = _adjoint(mode)
    k = fn(tables, uT)
    lane = fn(tables, uT, compact=False)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), lane.view(torch.int32))
    t = twin(tables, uT)
    same = (k[:3] == t[:3]).all(0)
    assert float(same.float().mean()) >= 0.998
    torch.testing.assert_close(k[3:, same], t[3:, same], rtol=1e-5, atol=0.0)
    assert bool(torch.isfinite(k).all()) and float(k[3:].abs().sum()) > 0
    if pad:
        n = fn(base, uT)
        assert torch.equal(k[:n.shape[0]].view(torch.int32),
                           n.view(torch.int32))
        assert not bool(k[n.shape[0]:].any())


# ---------------------------------------------------------------- slice 4
def _large():
    """cornell_box(64, 64, tessellate=12): 4,898 triangles, over
    BVH_MIN_TRIS, with its BVH."""
    return prepare_scene(cornell_box(64, 64, tessellate=12))


@pytest.mark.parametrize("mesh", ["sphere-brute", "sphere-bvh", "cornell",
                                  "cornell_large"])
def test_intersect_kernel_matches_twin(cuda, mesh):
    """Both modes of the intersection kernel against the plain sweep / walk
    on 65,536 rays: t bit-equal, id and any-hit equal on every ray; in BVH
    mode also the walk against the brute kernel."""
    if mesh == "cornell_large":
        scene = _compact_scene("large")
    elif mesh == "cornell":
        scene = _large()
    else:
        scene = prepare_scene(raybench.bumpy_sphere(
            3000 if mesh == "sphere-brute" else 20000))
    tables = IX.make_ray_tables(scene, cuda)
    assert (tables.nodes is None) == (mesh == "sphere-brute")
    o, d = raybench.rays(65536, cuda, seed=3)
    if mesh.startswith("cornell"):
        o = o * 90.0 + 278.0
    tmax = torch.rand(65536, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(4)) * 600
    n0 = build.LAUNCHES["intersect"]
    t, i = IX.closest(tables, o, d)
    hit = IX.any_hit(tables, o, d, tmax)
    torch.cuda.synchronize()
    assert build.LAUNCHES["intersect"] == n0 + 2
    rt, ri = IX.closest_reference(tables, o, d)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert torch.equal(i, ri)
    assert torch.equal(hit, IX.any_reference(tables, o, d, tmax))
    assert float((i >= 0).float().mean()) > 0.05
    if tables.nodes is not None:
        brute = IX.make_ray_tables(scene, cuda, walk=False)
        bt, bi = IX.closest(brute, o, d)
        assert torch.equal(bt.view(torch.int32), t.view(torch.int32))
        assert torch.equal(bi, i)
        assert torch.equal(IX.any_hit(brute, o, d, tmax), hit)


@pytest.mark.parametrize("T", [1, 36, 257, 3784, 4095])
def test_brute_sweep_matches_twin_at_edges(cuda, T):
    """The brute mode against the plain sweep at ray counts that leave a
    block, a thread's rays or a warp part-filled, and triangle counts
    below, at and one past a staged tile (257 = kBruteTile + 1): t
    bit-equal, id and any-hit equal on every ray, on raybench.edge_case's
    rays cut by tmax, rays parallel to triangles (det = 0) and duplicated
    triangles, whose tie the lower id wins."""
    for R in (1, 33, 1000, 65537):
        tables, o, d, tmax = raybench.edge_case(T, R, cuda, seed=T + R)
        n0 = build.LAUNCHES["intersect"]
        t, i = IX.closest(tables, o, d, tmax)
        hit = IX.any_hit(tables, o, d, tmax)
        torch.cuda.synchronize()
        assert build.LAUNCHES["intersect"] == n0 + 2
        rt, ri = IX.closest_reference(tables, o, d, tmax)
        assert torch.equal(t.view(torch.int32), rt.view(torch.int32)), R
        assert torch.equal(i, ri), R
        assert torch.equal(hit, IX.any_reference(tables, o, d, tmax)), R
        dup = torch.zeros(T, dtype=torch.bool, device=cuda)
        dup[1:] = (tables.tri[1:, :9] == tables.tri[:-1, :9]).all(1)
        assert not dup[i[i >= 0].long()].any(), R


def test_walk_in_trace_kernels_matches_twins(cuda):
    """The path, MMLT and adjoint kernels walk the BVH of a scene over
    BVH_MIN_TRIS, at the small-scene thresholds."""
    scene = _large()
    cfg = PathConfig(max_depth=6, rr_depth=3)
    tables = MT.make_tables(scene, cfg, cuda)
    assert tables.nodes is not None
    g = torch.Generator(cuda).manual_seed(8)
    uT = torch.rand((cfg.n_dims, 4096), device=cuda, generator=g)
    _lanes_agree(MT.path_trace(tables, uT),
                 MT.path_trace_reference(tables, uT))
    k = MT.path_trace_rad(tables, uT)
    t = MT.path_trace_rad_reference(tables, uT)
    same = (k[:3] == t[:3]).all(0)
    assert float(same.float().mean()) >= 0.998
    torch.testing.assert_close(k[3:, same], t[3:, same], rtol=1e-5, atol=0.0)
    mcfg = BDPTConfig(max_depth=4, light_image=True)
    mt = MM.make_mmlt_tables(scene, mcfg, cuda)
    assert mt.nodes is not None
    uM = torch.rand((mt.n_core, 4096), device=cuda, generator=g)
    _lanes_agree(MM.mmlt_trace(mt, uM), MM.mmlt_trace_reference(mt, uM),
                 atol=1e-6, pos_rows=2)


@pytest.mark.parametrize("technique", ["path", "mmlt"])
def test_walk_in_chain_kernel_matches_twin(cuda, technique):
    C, W = 1024, 64
    scene = _large()
    g = torch.Generator(cuda).manual_seed(9)
    cfg = DRMLTConfig(type="orbital", splat_mode="sampled")
    if technique == "path":
        pcfg = PathConfig(max_depth=4, rr_depth=100)
        tables = MT.make_tables(scene, pcfg, cuda)
        D = pcfg.n_dims + pcfg.n_dims % 2
        u = torch.rand((C, D), device=cuda, generator=g)
        state0 = MD.pack_chain_state(state_from_splats(
            u, make_path_trace(scene, pcfg, cuda)(u)))
    else:
        trace, _, D, tables = make_mmlt_trace_fixed(scene, 3, True, cuda)
        u = torch.rand((4 * C, D), device=cuda, generator=g)
        u = u[torch.nonzero(trace(u).lum > 0)[:C, 0]]
        assert u.shape[0] == C
        state0 = MD.pack_chain_state(state_from_splats(u, trace(u)))
    assert tables.nodes is not None
    out = []
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st, film, stats = (state0.clone(),
                           torch.zeros((W, W, 3), device=cuda),
                           torch.zeros((6, C), device=cuda))
        fn(tables, cfg, 2, st, film, stats, 17, 2)
        out.append((st, film, stats))
    torch.cuda.synchronize()
    (sk, fk, tk), (sr, fr, tr) = out
    agree = ((sk[:D] - sr[:D]).abs().max(0).values <= 2e-5).float().mean()
    assert float(agree) >= 0.99
    torch.testing.assert_close(tk.sum(1), tr.sum(1), rtol=1e-2, atol=1.0)


@pytest.mark.parametrize("tris", [3000, 20000])
def test_raybench_runs_in_both_modes(cuda, tris, capsys):
    assert raybench.main(["--tris", str(tris), "--rays", "65536",
                          "--iters", "2"]) == 0
    text = capsys.readouterr().out
    assert ("mode=bvh" if tris > 4096 else "mode=brute") in text
    assert "MRays/s" in text


# ---- slice 5: the trace kernels' full scene scope --------------------------
@pytest.mark.parametrize("variant", ["kinds", "const", "thinlens", "env64"])
def test_full_scope_trace_kernels_match_twins(cuda, variant):
    """The full-scope instantiations (spheres, conductor / rough conductor /
    null, bitmap albedo, constant and image environments, thin lens) of the
    path kernel, both adjoints (the albedo one on constant albedos) and the
    MMLT kernel (not with a thin lens) against their twins."""
    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
    sc = cornell_scope(64, 64, variant)
    thin = variant == "thinlens"
    cfg = PathConfig(max_depth=6, rr_depth=3, thinlens=thin)
    tables = MT.make_tables(sc, cfg, cuda)
    assert tables.full
    g = torch.Generator(device=cuda).manual_seed(19)
    uT = torch.rand((cfg.n_dims, 16384), generator=g, device=cuda)
    n0 = build.LAUNCHES["path_trace[full]"]
    _lanes_agree(MT.path_trace(tables, uT), MT.path_trace_reference(tables,
                                                                    uT))
    assert build.LAUNCHES["path_trace[full]"] == n0 + 1
    for fn, twin in ((MT.path_trace_rad, MT.path_trace_rad_reference),
                     (MT.path_trace_alb, MT.path_trace_alb_reference)):
        if fn is MT.path_trace_alb and tables.tex_shape is not None:
            with pytest.raises(ValueError, match="constant albedos"):
                fn(tables, uT)
            continue
        k, t = fn(tables, uT), twin(tables, uT)
        same = (k[:3] == t[:3]).all(0)
        assert float(same.float().mean()) >= 0.998
        torch.testing.assert_close(k[3:, same], t[3:, same], rtol=1e-5,
                                   atol=0.0)
    if thin:
        with pytest.raises(NotImplementedError, match="thin-lens"):
            MM.make_mmlt_tables(sc, BDPTConfig(max_depth=3), cuda)
        return
    for depth in (1, 4):
        mt = MM.make_mmlt_tables(sc, BDPTConfig(max_depth=depth), cuda)
        uM = torch.rand((mt.n_core, 16384), generator=g, device=cuda)
        _lanes_agree(MM.mmlt_trace(mt, uM), MM.mmlt_trace_reference(mt, uM),
                     atol=1e-5, pos_rows=2)


@pytest.mark.parametrize("drtype,C,timid", [("orbital", 2048, False),
                                            ("green", 2000, True)],
                         ids=["orbital", "green-2000-timid"])
@pytest.mark.parametrize("technique", ["path", "mmlt"])
def test_full_scope_chain_kernel_matches_twin(cuda, technique, drtype, C,
                                              timid):
    """The chain kernel's full-scope instantiation, both modes, on the
    image-environment configuration: 2,048 chains (or 2,000, a part-empty
    last block) x 2 mutations, given uniforms, against its twin."""
    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
    sc = cornell_scope(64, 64, "env64")
    g = torch.Generator(device=cuda).manual_seed(23)
    if technique == "path":
        pcfg = PathConfig(max_depth=6, rr_depth=100)
        tables = MT.make_tables(sc, pcfg, cuda)
        trace = make_path_trace(sc, pcfg, cuda)
        D = pcfg.n_dims + pcfg.n_dims % 2
        cand = torch.rand((8 * C, D), generator=g, device=cuda)
        u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
        state0 = MD.pack_chain_state(state_from_splats(u0, trace(u0)))
    else:
        trace, _, D, tables = make_mmlt_trace_fixed(sc, 4, True, cuda)
        cand = torch.rand((16 * C, D), generator=g, device=cuda)
        u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
        state0 = MD.pack_chain_state(state_from_splats(u0, trace(u0)))
    assert tables.full and state0.shape[1] == C
    cfg = DRMLTConfig(type=drtype, splat_mode="sampled", n_chains=C,
                      timid_after_large=timid)
    uni = torch.rand((2 * MD.n_rand(cfg, state0.shape[0] - 6), C),
                     generator=g, device=cuda)
    outs = []
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st, film = state0.clone(), torch.zeros((64, 64, 3), device=cuda)
        stats = torch.zeros((6, C), device=cuda)
        fn(tables, cfg, 2, st, film, stats, 1, 0, uni)
        outs.append((st, film, stats))
    (sk, fk, tk), (sr, fr, tr) = outs
    D = sk.shape[0] - 6
    agree = (sk[:D] - sr[:D]).abs().max(0).values <= 2e-5
    assert float(agree.float().mean()) >= 0.99
    torch.testing.assert_close(tk.sum(1), tr.sum(1), rtol=1e-2, atol=1.0)


def test_cli_renders_cornell_xml_on_the_card(cuda, tmp_path):
    """tests/data/cornell.xml through the CLI in both techniques, on the
    full-scope kernels (its rough-conductor analytic sphere)."""
    import os

    from drmlt_mitsuba_tpu_torch.utils import cli
    from drmlt_mitsuba_tpu_torch.utils.exr import read_exr
    xml = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")
    for tech in ("path", "mmlt"):
        build.reset_launches()
        out = tmp_path / f"{tech}.exr"
        assert cli.main([xml, "-D", "integrator=drmlt", "-D",
                         f"technique={tech}", "-D", "type=orbital",
                         "--chains", "16384", "--spp", "64", "-o",
                         str(out)]) == 0
        img = read_exr(str(out))
        assert img.shape == (64, 64, 3) and img.mean() > 0
        trace = "path_trace[full]" if tech == "path" else "mmlt_trace[full]"
        assert build.LAUNCHES[trace] > 0
        assert build.LAUNCHES[f"drmlt_{tech}[full]"] > 0


def _chain_case(cuda, technique, scope, C=2048):
    """(tables, starting state) of a chain-kernel comparison: the path
    technique at depth 4 or a depth-4 MMLT group, on the 36-triangle box
    ("box") or the full-scope const configuration ("full")."""
    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_scope
    sc = (cornell_box(64, 64) if scope == "box"
          else cornell_scope(64, 64, "const"))
    g = torch.Generator(device=cuda).manual_seed(29)
    if technique == "path":
        pcfg = PathConfig(max_depth=4, rr_depth=100)
        tables = MT.make_tables(sc, pcfg, cuda)
        trace = make_path_trace(sc, pcfg, cuda)
        D = pcfg.n_dims + pcfg.n_dims % 2
    else:
        trace, _, D, tables = make_mmlt_trace_fixed(sc, 4, True, cuda)
    cand = torch.rand((16 * C, D), generator=g, device=cuda)
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:C, 0]]
    assert u0.shape[0] == C and tables.full == (scope == "full")
    return tables, MD.pack_chain_state(state_from_splats(u0, trace(u0)))


@pytest.mark.parametrize("scope", ["box", "full"])
@pytest.mark.parametrize("technique", ["path", "mmlt"])
@pytest.mark.parametrize("drtype,mode,given,C", [
    ("mira", "three", True, 2048), ("green", "sampled", False, 2048),
    ("orbital", "three", False, 2048), ("orbital", "sampled", True, 2000)],
    ids=["mira-three-True", "green-sampled-False", "orbital-three-False",
         "orbital-sampled-True-2000"])
def test_pssmlt_chain_kernel_matches_twin(cuda, technique, scope, drtype,
                                          mode, given, C):
    """The chain kernel's pssmlt mode, every instantiated trace body in
    both scene scopes: 2,048 chains x 3 mutations against its twin, no
    stage-2 mass, one launch counted under its own key; 2,000 chains leave
    the mode's last block part-empty."""
    tables, state0 = _chain_case(cuda, technique, scope, C)
    C, D = state0.shape[1], state0.shape[0] - 6
    cfg = DRMLTConfig(type=drtype, splat_mode=mode, n_chains=C)
    g = torch.Generator(device=cuda).manual_seed(31)
    uni = (torch.rand((3 * MD.n_rand(cfg, D), C), generator=g, device=cuda)
           if given else None)
    key = build.scope_key(f"drmlt_{technique}_pssmlt", tables)
    n0, n_drmlt = build.LAUNCHES[key], build.LAUNCHES[
        build.scope_key(f"drmlt_{technique}", tables)]
    outs = []
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st, film = state0.clone(), torch.zeros((64, 64, 3), device=cuda)
        stats = torch.zeros((6, C), device=cuda)
        fn(tables, cfg, 3, st, film, stats, 7, 1, uni, pssmlt=True)
        outs.append((st, film, stats))
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == n0 + 1
    assert build.LAUNCHES[build.scope_key(f"drmlt_{technique}",
                                          tables)] == n_drmlt
    (sk, fk, tk), (sr, fr, tr) = outs
    agree = (sk[:D] - sr[:D]).abs().max(0).values <= 2e-5
    assert float(agree.float().mean()) >= 0.99
    assert float((fk - fr).abs().sum() / fr.abs().sum()) <= 1e-2
    torch.testing.assert_close(tk.sum(1), tr.sum(1), rtol=1e-2, atol=1.0)
    assert float(tk[1].sum()) == 0.0 and float(tk[3].sum()) == 0.0
    assert float(tk[2].sum()) > 0


def test_pssmlt_renders_run_through_the_kernels(cuda):
    """The grouped render with pssmlt=True launches the MMLT kernel and
    the chain kernel's pssmlt mode only; render_pssmlt over the path
    kernel launches it and the splat kernel."""
    from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (
        PSSMLTConfig, render_pssmlt,
    )
    fc = filmlib.make_film_config(64, 64, "box")
    build.reset_launches()
    img, aux = render_drmlt_mmlt_grouped(
        cornell_box(64, 64), BDPTConfig(max_depth=4),
        DRMLTConfig(type="mira", n_chains=4096, n_bootstrap=8192,
                    splat_mode="sampled"), fc,
        torch.Generator(cuda).manual_seed(3), n_steps=64, pssmlt=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["drmlt_mmlt_pssmlt"] >= len(aux["images"]) > 0
    assert build.LAUNCHES["drmlt_mmlt"] == 0
    assert build.LAUNCHES["mmlt_trace"] > 0
    assert all(float(s["accept2"]) == 0 for s in aux["stats"].values())
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0

    build.reset_launches()
    pcfg = PathConfig(max_depth=4, rr_depth=100)
    img, aux = render_pssmlt(
        make_path_trace(cornell_box(64, 64), pcfg, cuda),
        PSSMLTConfig(n_chains=4096, n_bootstrap=8192), fc,
        torch.Generator(cuda).manual_seed(4), pcfg.n_dims, n_steps=16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["path_trace"] >= 16
    assert build.LAUNCHES["splat_add"] == 32
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    assert 0.1 < float(aux["stats"]["accept"].mean()) < 0.9


def test_cli_pssmlt_renders_cornell_xml_on_the_card(cuda, tmp_path,
                                                    capsys):
    """integrator=pssmlt on tests/data/cornell.xml in both techniques, on
    the full-scope trace kernels."""
    import os

    from drmlt_mitsuba_tpu_torch.utils import cli
    from drmlt_mitsuba_tpu_torch.utils.exr import read_exr
    xml = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")
    for tech, trace in (("path", "path_trace[full]"),
                        ("mmlt", "mmlt_trace[full]")):
        build.reset_launches()
        out = tmp_path / f"{tech}.exr"
        assert cli.main([xml, "-D", "integrator=pssmlt", "-D",
                         f"technique={tech}", "--chains", "16384", "--spp",
                         "64", "-o", str(out)]) == 0
        img = read_exr(str(out))
        assert img.shape == (64, 64, 3) and img.mean() > 0
        assert build.LAUNCHES[trace] > 16 and build.LAUNCHES["splat_add"] > 0
    assert "mutations/s" in capsys.readouterr().out
