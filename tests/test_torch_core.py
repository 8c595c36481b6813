"""Port core pieces vs the JAX reference on identical numpy inputs:
transition kernels, the PSS wrap, frames and warps, the box-filter film,
and the Philox stream the chain kernel draws from."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.core import frame as jframe
from drmlt_mitsuba_tpu.core import warp as jwarp
from drmlt_mitsuba_tpu.core.rng import pss_wrap as jax_wrap
from drmlt_mitsuba_tpu.integrators import kernels as jk
from drmlt_mitsuba_tpu.ops.pallas import megadrmlt as jmd
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu_torch.core import frame, warp
from drmlt_mitsuba_tpu_torch.core.rng import (
    philox4x32_10, philox_uniforms, pss_wrap,
)
from drmlt_mitsuba_tpu_torch.integrators import kernels as tk
from drmlt_mitsuba_tpu_torch.render import film

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_kelemen_matches_reference():
    rng = np.random.default_rng(20261016)
    for s1, s2 in ((1 / 1024, 1 / 64), (1.9 / 1024, 1.9 / 64)):
        u = rng.random((513, 2), dtype=np.float32)
        ref, got = jk.Kelemen(s1, s2), tk.Kelemen(s1, s2)
        np.testing.assert_allclose(got.sample(T(u)).numpy(),
                                   np.asarray(ref.sample(jnp.asarray(u))),
                                   rtol=1e-6)
        du = np.linspace(-0.03, 0.03, 601, dtype=np.float32)
        np.testing.assert_allclose(got.log_pdf(T(du)).numpy(),
                                   np.asarray(ref.log_pdf(jnp.asarray(du))),
                                   rtol=1e-6)


def test_gaussian_matches_reference():
    rng = np.random.default_rng(20261016)
    u = rng.random((513, 2), dtype=np.float32)
    ref, got = jk.Gaussian(0.1 / 64), tk.Gaussian(0.1 / 64)
    np.testing.assert_allclose(got.sample(T(u)).numpy(),
                               np.asarray(ref.sample(jnp.asarray(u))),
                               rtol=1e-5, atol=1e-9)
    du = np.linspace(-0.01, 0.01, 101, dtype=np.float32)
    np.testing.assert_allclose(got.log_pdf(T(du)).numpy(),
                               np.asarray(ref.log_pdf(jnp.asarray(du))),
                               rtol=1e-5)


def test_wrapped_cauchy_matches_reference():
    rng = np.random.default_rng(20261016)
    u = rng.random((1025, 2), dtype=np.float32)
    ref, got = jk.WrappedCauchy(), tk.WrappedCauchy()
    th_got = got.sample(T(u)).numpy()
    th_ref = np.asarray(ref.sample(jnp.asarray(u)))
    # arccos turns a last-bit difference of cos(2 pi x) near |c| = 1 into
    # ~1e-4 rad, so the angle is held loosely and its cos / sin more
    # tightly; the (cos, sin) form the chain kernel consumes is held to
    # 1e-6 below
    np.testing.assert_allclose(th_got, th_ref, atol=2e-4)
    np.testing.assert_allclose(np.cos(th_got), np.cos(th_ref), atol=1e-5)
    np.testing.assert_allclose(np.sin(th_got), np.sin(th_ref), atol=1e-5)
    th = np.linspace(-math.pi, math.pi, 201, dtype=np.float32)
    np.testing.assert_allclose(got.log_pdf(T(th)).numpy(),
                               np.asarray(ref.log_pdf(jnp.asarray(th))),
                               rtol=1e-5)
    # the arccos-free (cos, sin) form the chain kernel uses; near
    # cos(2 pi x) = -1 the map (v + disp) / (1 + disp v) amplifies a
    # last-bit difference of the cosine by up to (1 + disp) / (1 - disp)
    # ~ 65, hence 1e-5 (the reference's own orbital check uses 1e-5)
    c, s = got.cos_sin(T(u[:, 0]))
    rc, rs = jmd._wrapped_cauchy_cos_sin(jnp.asarray(u[:, 0]), ref.rho)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)


def test_pss_wrap_matches_reference():
    """Floor-mod wrap (sign of the divisor) on [-3, 3], with the exact
    integers, half-integers and values just around them.  Denormals are
    left out: XLA flushes them to zero."""
    rng = np.random.default_rng(20261016)
    ints = np.float32([-3, -2, -1, 1, 2, 3])
    y = np.concatenate([
        rng.uniform(-3, 3, 4001).astype(np.float32),
        np.arange(-3.0, 3.01, 0.5, dtype=np.float32),
        np.nextafter(ints, np.float32(9)),
        np.nextafter(ints, np.float32(-9)),
        np.float32([-1e-9, 1e-9, -0.0]),
    ])
    got = pss_wrap(T(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_wrap(jnp.asarray(y))))
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_array_equal(pss_wrap(T(np.float32([-0.25, 2.25, 1.5,
                                                         -1.5]))).numpy(),
                                  np.float32([0.25, 0.25, 0.5, 0.5]))


def test_frame_and_warps_match_reference():
    rng = np.random.default_rng(20261016)
    n = rng.normal(size=(257, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = (0, 0, -1)
    n[1] = (0, 0, 1)
    v = rng.normal(size=(257, 3)).astype(np.float32)
    u = rng.random((257, 2), dtype=np.float32)
    u[0] = (0.5, 0.5)
    ref = jax.jit(lambda a, b, c: (        # the reference, one program
        jframe.to_local(a, b), jwarp.square_to_cosine_hemisphere(c),
        jwarp.square_to_uniform_triangle(c)))(
        jnp.asarray(n), jnp.asarray(v), jnp.asarray(u))
    loc = frame.to_local(T(n), T(v))
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(frame.to_world(T(n), loc).numpy(), v,
                               atol=1e-5)
    np.testing.assert_allclose(
        warp.square_to_cosine_hemisphere(T(u)).numpy(), np.asarray(ref[1]),
        atol=1e-6)
    np.testing.assert_allclose(
        warp.square_to_uniform_triangle(T(u)).numpy(), np.asarray(ref[2]),
        atol=1e-7)


@pytest.mark.parametrize("mode", ["splat", "accum"])
def test_box_film_matches_reference(mode):
    """Exact box-filter scatter, including positions of exactly W and H
    (dropped, not clamped) and exactly 0."""
    rng = np.random.default_rng(20261016)
    W, H, N = 24, 16, 3000
    pos = rng.random((N, 2), dtype=np.float32) * np.float32([W, H])
    pos[:40, 0] = W            # right edge: out of the image
    pos[40:80, 1] = H          # bottom edge: out of the image
    pos[80:120] = 0.0
    val = rng.random((N, 3), dtype=np.float32)
    w = rng.random(N, dtype=np.float32)
    jfc = jfilm.make_film_config(W, H, "box")
    fc = film.make_film_config(W, H, "box")

    @jax.jit
    def reference(p, v, wt):
        """The reference's splat and develop, in one program."""
        f = jfilm.splat(jfc, jfilm.new_film(jfc), p, v, weight=wt, mode=mode)
        return f, jfilm.develop(jfc, f, mode=mode, scale=0.5)

    ref, ref_img = reference(jnp.asarray(pos), jnp.asarray(val),
                             jnp.asarray(w))
    got = film.splat(fc, film.new_film(fc, "cpu"), T(pos), T(val), weight=T(w),
                     mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        film.develop(fc, got, mode=mode, scale=0.5).numpy(),
        np.asarray(ref_img), rtol=1e-5, atol=1e-5)
    # the edge splats were dropped: total weight is that of in-image splats
    np.testing.assert_allclose(got[..., 3].sum().item(), w[80:].sum(),
                               rtol=1e-4)


def test_philox_known_answers_and_uniforms():
    """Random123's philox4x32_10 known-answer vectors, and the chain
    kernel's uniform stream: 23-bit values in [0, 1), distinct per chain,
    mutation and launch."""
    rng = np.random.default_rng(20261016)
    z = [torch.zeros(1, dtype=torch.int64)] * 4
    assert [int(w) for w in philox4x32_10(*z, 0, 0)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = [torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)] * 4
    assert [int(w) for w in philox4x32_10(*f, 0xFFFFFFFF, 0xFFFFFFFF)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    u = philox_uniforms(12345, 3, 1, 195, 256)
    assert u.shape == (195, 256) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert np.all(np.round(u.numpy() * 2 ** 23) == u.numpy() * 2 ** 23)
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u, philox_uniforms(12345, 4, 1, 195, 256))
    assert not torch.equal(u, philox_uniforms(12345, 3, 2, 195, 256))
    assert not torch.equal(u[:, :128], u[:, 128:])
