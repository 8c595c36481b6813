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
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, make_path_trace_diff,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.ops import splat as SP
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
    filmlib.splat(fc, filmlib.new_film(fc), pos.cpu(), v_cpu,
                  mode="accum").backward(ct.cpu())
    assert torch.equal(v.grad.cpu(), v_cpu.grad)


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
    deep = PathConfig(max_depth=MT.MAX_GRAD_DEPTH + 1)
    tables = MT.make_tables(cornell_box(16, 16), deep, cuda)
    with pytest.raises(ValueError, match="max_depth"):
        MT.path_trace_alb(tables, torch.rand((deep.n_dims, 8), device=cuda))
    with pytest.raises(ValueError, match="tables on"):
        MT.path_trace_rad(tables, torch.rand((deep.n_dims, 8)))
    with pytest.raises(ValueError, match="on cuda"):
        MT.make_mega_trace_diff(cornell_box(16, 16), PathConfig())(
            {}, torch.rand((8, PathConfig().n_dims)))
