"""The port's sample generators (render/sampler.py, render/sobol.py)
against the JAX package's on the same indices, with the reference's own
randomisation passed in: its Cranley-Patterson shifts and stratified
jitter from jax.random.uniform, its digital shifts from jax.random.bits,
on the key the reference draws them from.  Every generator is bit for bit
the reference's.  Then render_pt under each sampler on the path twin
equals the twin trace over that sampler's matrix, splatted the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.render import sampler as jsampler
from drmlt_mitsuba_tpu.render import sobol as jsobol
from drmlt_mitsuba_tpu_torch.integrators.path import render_pt, trace_paths
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.render import sampler, sobol
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(20261018)
# indices past 2^20, so every base's digits and all 32 Sobol' bits matter
IDX = np.concatenate([np.arange(0, 1000),
                      np.random.default_rng(4).integers(0, 2 ** 31 - 1,
                                                        3096)])
D = 12   # dimensions: bases 2..37, Joe-Kuo's table only below 22


def T(a):
    return torch.from_numpy(np.array(a))


BASES = (2, 3, 5, 7, 37, 383, 941)


def test_radical_inverse_bit_for_bit():
    refs = jax.jit(lambda i: [jsampler.radical_inverse(i, b)   # one program
                              for b in BASES])(jnp.asarray(IDX))
    for base, ref in zip(BASES, refs):
        ref = np.asarray(ref)
        got = sampler.radical_inverse(T(IDX), base).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32), err_msg=str(base))
    np.testing.assert_array_equal(
        sampler.radical_inverse(torch.arange(8), 2).numpy(),
        np.float32([0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]))


def test_halton_and_hammersley_bit_for_bit():
    """Hammersley rotates dimensions 1.. twice (halton's shift, then its
    own over every dimension), as the reference does."""
    n_total = 2 ** 31 - 1
    ref_h, ref_m = (np.asarray(r) for r in jax.jit(lambda i: (
        jsampler.halton(KEY, i, D),
        jsampler.hammersley(KEY, i, n_total, D)))(jnp.asarray(IDX)))
    shift = T(jax.random.uniform(KEY, (D,)))
    shift_h = T(jax.random.uniform(KEY, (D - 1,)))
    np.testing.assert_array_equal(
        sampler.halton(T(IDX), D, shift).numpy(), ref_h)
    np.testing.assert_array_equal(
        sampler.hammersley(T(IDX), n_total, D, shift_h, shift).numpy(),
        ref_m)


def test_sobol_and_ld02_bit_for_bit():
    """40 dimensions: Joe-Kuo's rows and the GF(2) search's; the canonical
    sequence, the digital shift of the reference's key, and ldsampler's
    shifted (0, 2) pairs (an odd count of dimensions)."""
    n = 40
    ref, ref0, ref_ld = (np.asarray(r) for r in jax.jit(lambda i: (
        jsobol.sobol(KEY, i, n), jsobol.sobol(KEY, i, n, scramble=False),
        jsobol.ld02(KEY, i, n - 1)))(jnp.asarray(IDX)))
    shift = T(np.asarray(jax.random.bits(KEY, (n,), jnp.uint32)).astype(
        np.int64))
    np.testing.assert_array_equal(sobol.sobol(T(IDX), n, shift).numpy(), ref)
    np.testing.assert_array_equal(sobol.sobol(T(IDX), n).numpy(), ref0)
    shift_ld = T(np.asarray(jax.random.bits(KEY, (n // 2, 2),
                                            jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(
        sobol.ld02(T(IDX), n - 1, shift_ld).numpy(), ref_ld)
    np.testing.assert_array_equal(sobol._vectors(n), jsobol._vectors(n))


def test_stratified_and_make_sampler():
    """stratified on the reference's jitter; make_sampler's samples index
    globally, draw their shifts once and raise on an unknown kind."""
    n_total = 4096 * 7
    idx = IDX[:1000]
    k1, _ = jax.random.split(KEY)
    u = np.asarray(jax.random.uniform(k1, (idx.shape[0], D)))
    ref = np.asarray(jsampler.stratified(KEY, jnp.asarray(idx), n_total, D))
    np.testing.assert_array_equal(
        sampler.stratified(T(idx), n_total, T(u)).numpy(), ref)
    for kind in ("halton", "hammersley", "sobol", "ldsampler"):
        fn = sampler.make_sampler(kind, torch.Generator().manual_seed(3), D)
        whole = fn(0, 300, 300)
        np.testing.assert_array_equal(
            torch.cat([fn(0, 100, 300), fn(100, 200, 300)]).numpy(),
            whole.numpy(), err_msg=kind)
        assert whole.min() >= 0 and whole.max() < 1, kind
        assert abs(float(whole.mean()) - 0.5) < 0.05, kind
    with pytest.raises(ValueError, match="unknown sampler 'nope'"):
        sampler.make_sampler("nope", torch.Generator(), D)


@pytest.mark.parametrize("kind", ["stratified", "halton", "hammersley",
                                  "ldsampler", "sobol"])
def test_render_pt_under_a_sampler_is_the_twin_over_its_matrix(kind):
    """render_pt(sampler=kind) on the CPU (the path twin) equals trace_paths
    over the sampler's rows for the same generator, in chunks, splatted in
    accum mode; its image is finite and lit."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    fc = filmlib.make_film_config(16, 16, "box")
    n, chunk = 16 * 16 * 4, 384
    film = render_pt(scene, cfg, torch.Generator().manual_seed(9), n, fc,
                     mode="accum", chunk=chunk, sampler=kind)
    fn = sampler.make_sampler(kind, torch.Generator().manual_seed(9),
                              cfg.n_dims)
    ref = filmlib.new_film(fc, "cpu")
    scale = torch.tensor([16.0, 16.0])
    for start in range(0, n, chunk):
        sp = trace_paths(scene, cfg, fn(start, min(chunk, n - start), n))
        ref = filmlib.splat(fc, ref, sp.pos[:, 0] * scale, sp.value[:, 0],
                            mode="accum")
    torch.testing.assert_close(film, ref, rtol=0, atol=0)
    img = filmlib.develop(fc, film, mode="accum")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 1e-3
