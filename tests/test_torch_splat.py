"""The port's film splat (the plain twin of its CUDA splat kernel) vs the
JAX reference on identical taps, and the image loss of inverse rendering
through it.

`ops/splat.py:splat_add_` on a CPU film is the exact f32 scatter of the
reference's film.py:102-105, so the port's `film.splat` must equal the
reference's `film.splat` (its XLA scatter on the CPU) to float32 rounding;
its backward, the gather g[py, px], must equal `jax.vjp` of the reference's
Pallas `splat_add` (interpret mode, as tests/test_film.py runs it) exactly,
since a gather has no rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.ops.pallas.splat_kernel import splat_add as jax_splat_add
from drmlt_mitsuba_tpu.render import film as jax_film
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.ops import splat as SP
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

H, W = 32, 64


def _taps(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, [W + 0.5, H + 0.5], size=(n, 2)).astype(np.float32)
    val = rng.gamma(1.0, 2.0, size=(n, 3)).astype(np.float32)
    weight = rng.uniform(0, 1, size=n).astype(np.float32)
    return pos, val, weight


@pytest.mark.parametrize("mode", ["accum", "splat"])
def test_film_splat_matches_reference(mode):
    """Box-filter splats, out-of-image positions included, with and
    without per-splat weights: the port's film equals the reference's."""
    pos, val, weight = _taps(1, 4000)
    fc = filmlib.make_film_config(W, H, "box")
    jfc = jax_film.make_film_config(W, H, "box")
    for w in (None, weight):
        got = filmlib.splat(fc, filmlib.new_film(fc, "cpu"), torch.from_numpy(pos),
                            torch.from_numpy(val),
                            None if w is None else torch.from_numpy(w),
                            mode=mode)
        want = jax.jit(lambda p, v, wt: jax_film.splat(
            jfc, jax_film.new_film(jfc), p, v, wt, mode=mode))(
            jnp.asarray(pos), jnp.asarray(val),
            None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert float(got[..., 3].sum()) > 0


def test_splat_add_and_its_gather_match_the_pallas_kernel():
    """splat_add (out of place, differentiable) against the reference's
    Pallas splat_add in interpret mode: the forward to the kernel's bf16
    hi/lo precision (its own test's 5e-3), the backward (gather) exactly,
    and the forward against the exact scatter to f32 rounding."""
    rng = np.random.default_rng(7)
    N = 3000
    py = rng.integers(0, H, N).astype(np.int32)
    px = rng.integers(0, W, N).astype(np.int32)
    vals = rng.gamma(1.0, 2.0, size=(N, 4)).astype(np.float32)
    film0 = rng.uniform(0, 1, size=(H, W, 4)).astype(np.float32)
    ct = rng.normal(size=(H, W, 4)).astype(np.float32)

    want, vjp = jax.vjp(lambda f, v: jax_splat_add(f, jnp.asarray(py),
                                                  jnp.asarray(px), v),
                        jnp.asarray(film0), jnp.asarray(vals))
    g_film, g_vals = vjp(jnp.asarray(ct))

    f = torch.from_numpy(film0).requires_grad_()
    v = torch.from_numpy(vals).requires_grad_()
    got = SP.splat_add(f, torch.from_numpy(py), torch.from_numpy(px), v)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=5e-3, atol=5e-3)
    exact = film0.reshape(-1, 4).copy()
    np.add.at(exact, py.astype(np.int64) * W + px, vals)
    np.testing.assert_allclose(got.detach().numpy(),
                               exact.reshape(H, W, 4), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(g_vals))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(g_film))
    assert torch.equal(torch.from_numpy(film0), f.detach())   # untouched


def test_out_of_range_taps_are_dropped_as_by_the_pallas_kernel():
    """Taps up to 3 pixels outside the film on every side: the reference's
    Pallas splat_add (interpret mode) drops them, since their one-hot rows
    match no pixel, and so does the port's twin; the gather gives them a
    zero gradient and the taps inside their exact g[py, px]."""
    rng = np.random.default_rng(9)
    N = 800
    py = rng.integers(-3, H + 3, N).astype(np.int32)
    px = rng.integers(-3, W + 3, N).astype(np.int32)
    vals = rng.gamma(1.0, 2.0, size=(N, 4)).astype(np.float32)
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    assert 0.1 < 1 - inside.mean() < 0.5
    want = jax_splat_add(jnp.zeros((H, W, 4)), jnp.asarray(py),
                         jnp.asarray(px), jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    got = SP.splat_add(torch.zeros((H, W, 4)), torch.from_numpy(py),
                       torch.from_numpy(px), v)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=5e-3, atol=5e-3)
    exact = np.zeros((H * W, 4), np.float32)
    np.add.at(exact, (py * W + px)[inside], vals[inside])
    np.testing.assert_allclose(got.detach().numpy(), exact.reshape(H, W, 4),
                               rtol=1e-6, atol=1e-6)
    ct = rng.normal(size=(H, W, 4)).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    g = v.grad.numpy()
    assert not g[~inside].any()
    np.testing.assert_array_equal(g[inside], ct[py[inside], px[inside]])


def test_wrapper_runs_twin_on_cpu_and_checks_inputs():
    film = torch.zeros((H, W, 4))
    py = torch.tensor([0, 3, 3])
    px = torch.tensor([1, 2, 2])
    vals = torch.ones((3, 4))
    before = dict(build.LAUNCHES)
    out = SP.splat_add_(film, py, px, vals)
    assert out is film and build.LAUNCHES == before
    assert float(film[3, 2, 0]) == 2.0 and float(film.sum()) == 12.0
    with pytest.raises(ValueError, match="vals"):
        SP.splat_add_(film, py, px, vals[:, :3])
    with pytest.raises(ValueError, match="film"):
        SP.splat_add_(film.double(), py, px, vals.double())
    with pytest.raises(ValueError, match="py and px"):
        SP.splat_add_(film, py[:2], px, vals)
    with pytest.raises(ValueError, match="integer"):
        SP.splat_add_(film, py.float(), px, vals)
    with pytest.raises(NotImplementedError, match="meta"):
        SP.splat_add_(film.to("meta"), py.to("meta"), px.to("meta"),
                      vals.to("meta"))


def test_film_splat_adds_in_place_unless_autograd_records():
    """Without a gradient the splat updates the film in place (render_pt's
    use); with one it returns a new film, differentiable in the values,
    and leaves the film as it was."""
    pos, val, _ = _taps(3, 500)
    fc = filmlib.make_film_config(W, H, "box")
    film = filmlib.new_film(fc, "cpu")
    out = filmlib.splat(fc, film, torch.from_numpy(pos),
                        torch.from_numpy(val), mode="accum")
    assert out is film and float(film.sum()) > 0
    v = torch.from_numpy(val).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(H, W, 4)).astype(np.float32))
    base = film.clone()
    img = filmlib.splat(fc, film, torch.from_numpy(pos), v, mode="accum")
    assert img is not film and torch.equal(film, base)
    assert torch.equal(img.detach(), filmlib.splat(
        fc, base.clone(), torch.from_numpy(pos), torch.from_numpy(val),
        mode="accum"))
    (img * w).sum().backward()
    # box filter: each value lands on one pixel (or none, outside)
    xi = np.floor(pos[:, 0]).astype(np.int64)
    yi = np.floor(pos[:, 1]).astype(np.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    want = np.where(inside[:, None], w.numpy()[np.clip(yi, 0, H - 1),
                                               np.clip(xi, 0, W - 1), :3],
                    0.0)
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def _image(fc, sp):
    scale = torch.tensor([fc.width, fc.height], dtype=torch.float32)
    film = filmlib.splat(fc, filmlib.new_film(fc, "cpu"), sp.pos[:, 0, :] * scale,
                         sp.value[:, 0, :], mode="accum")
    return film[..., :3]


@pytest.mark.parametrize("param", ["albedo", "radiance"])
def test_inverse_rendering_through_the_film(param):
    """The reference's inverse-rendering loop (tests/test_gradients.py:55,
    40 Adam steps at lr 0.25, its bounds) through the port's adjoint twins,
    with a per-pixel image loss through the film splat: the red wall's
    albedo through sigmoid(param) from 0.5, or the light's radiance scale
    from 0.5."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    u = torch.from_numpy(np.random.default_rng(2).random(
        (2048, cfg.n_dims), dtype=np.float32))
    if param == "albedo":
        trace = MT.make_mega_trace_alb(scene, cfg, "cpu")
        base = scene.materials.albedo
        truth = base[1].clone()

        def leaf(p):
            return torch.cat([base[:1], torch.sigmoid(p)[None], base[2:]])

        def value(p):
            return torch.sigmoid(p)
        p = torch.zeros(3, requires_grad=True)          # albedo 0.5
    else:
        trace = MT.make_mega_trace_rad(scene, cfg, "cpu")
        base = scene.emitters.radiance
        truth = torch.tensor(1.0)

        def leaf(p):
            return base * p

        def value(p):
            return p
        p = torch.tensor(0.5, requires_grad=True)
    with torch.no_grad():
        target = _image(fc, trace(base, u))
    opt = torch.optim.Adam([p], lr=0.25)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        loss = ((_image(fc, trace(leaf(p), u)) - target) ** 2).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.01, losses[::8]
    np.testing.assert_allclose(value(p).detach().numpy(), truth.numpy(),
                               atol=0.08)
