"""The lat-long image environment of the port (render/emitter.py: the
lookup, the solid-angle pdf, the NEE sample by inverting the row and
column cdfs; scene/types.py:build_emitters' tables) and its EXR reader
(utils/exr.py:read_exr) against the JAX package's render/emitter.py,
scene/types.py:build_emitters and utils/exr.py on identical inputs.

The tables are equal bit for bit.  Lookups and pdfs agree to float32
rounding (rtol 1e-5); the port sums the four bilinear corners in its
kernels' order, and a direction within rounding of a pixel edge may pick
the neighbouring pixel (at most 0.1% of lanes here).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.render import emitter as jem
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.utils.exr import read_exr as jax_read_exr
from drmlt_mitsuba_tpu_torch.ops.megatrace import pack_mega_tables_torch
from drmlt_mitsuba_tpu_torch.render import emitter as em
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr, write_exr

torch.set_num_threads(1)

R = 8192
DATA = os.path.join(os.path.dirname(__file__), "data")


def _image(he, we, seed=3):
    img = np.random.default_rng(seed).random((he, we, 3)).astype(np.float32)
    img[he // 4:he // 3, we // 5:we // 3] *= 30.0
    return img


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port emitter table, port packed tables) of the Cornell
    box lit by an 16 x 32 image environment too."""
    img = _image(16, 32)
    js = jax_cornell(16, 16)
    jem_t = jst.build_emitters(js.tris, np.asarray(js.emitters.radiance),
                               env_image=img)
    js = js.replace(emitters=jem_t)
    ps = cornell_box(16, 16)
    pem = st.build_emitters(ps.tris, ps.emitters.radiance.numpy(),
                            env_image=img)
    st.set_emitter_rows(ps.tris, pem)
    ps.emitters = pem
    return js, pem, pack_mega_tables_torch(ps)


def test_env_tables_match_reference(scenes):
    js, pem, tabs = scenes
    for f in ("kind", "tri_idx", "radiance", "area", "pmf", "cdf",
              "env_radiance", "env_image", "env_row_cdf", "env_col_cdf",
              "env_pmf"):
        a, b = getattr(pem, f).numpy(), np.asarray(getattr(js.emitters, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    from drmlt_mitsuba_tpu.ops.pallas.megatrace import pack_mega_tables
    for a, b in zip(tabs[7:], jax.jit(lambda: pack_mega_tables(js)[7:])()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(pem.kind[-1]) == st.EMITTER_ENV


def test_lookup_and_pdf_match_reference(scenes):
    js, pem, tabs = scenes
    env_tab = tabs[7]
    shape = tuple(pem.env_image.shape[:2])
    d = np.random.default_rng(1).normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dj, dt = jnp.asarray(d), torch.from_numpy(d)

    @jax.jit
    def reference(x):
        """The reference's lookup, pdf and inverse map, in one program."""
        uv = jem.env_dir_to_uv(x)
        return (uv, jem.env_lookup(js.emitters, x), jem.env_pdf_dir(js, x),
                jem.env_uv_to_dir(uv))

    uv_j, rad_j, pdf_j, back_j = (np.asarray(a) for a in reference(dj))
    u, v = em.env_dir_to_uv(dt)
    np.testing.assert_allclose(u.numpy(), uv_j[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), uv_j[:, 1], rtol=1e-6, atol=1e-6)
    rad = em.env_bilinear(env_tab, shape, u, v).numpy()
    close = np.isclose(rad, rad_j, rtol=1e-5, atol=1e-6).all(-1)
    assert close.mean() >= 0.999
    pick = float(pem.pmf[pem.kind == st.EMITTER_ENV].sum())
    pdf = (em.env_pdf_sa(env_tab, shape, u, v, dt[:, 1]) * pick).numpy()
    close = np.isclose(pdf, pdf_j, rtol=1e-5, atol=1e-8)
    assert close.mean() >= 0.999
    # the uv -> direction map, the inverse of the lookup's
    back = em.env_uv_to_dir(u, v).numpy()
    np.testing.assert_allclose(back, d, atol=2e-5)
    np.testing.assert_allclose(back, back_j, atol=1e-6)


def test_nee_sample_matches_reference(scenes):
    """The environment row's NEE sample (render/emitter.py:147-186):
    direction, solid-angle pdf with the row's pick pmf, radiance."""
    js, pem, tabs = scenes
    rng = np.random.default_rng(2)
    cdf = pem.cdf.numpy()
    lo = float(cdf[-2])                          # the env row is the last
    u3 = rng.random((R, 3), dtype=np.float32)
    u3[:, 0] = lo + (1.0 - lo) * u3[:, 0] * 0.999
    p = np.full((R, 3), 278.0, np.float32)
    ds = jax.jit(lambda a, b: jem.sample_emitter_direct(js, a, b))(
        jnp.asarray(p), jnp.asarray(u3))
    shape = tuple(pem.env_image.shape[:2])
    d, pdf, rad = em.env_sample(tabs[7], tabs[8], tabs[9].reshape(-1), shape,
                                torch.from_numpy(u3[:, 1]),
                                torch.from_numpy(u3[:, 2]))
    assert (em.pick_row(tabs[2], torch.from_numpy(u3[:, 0]))
            == pem.kind.shape[0] - 1).all()
    pick = float(pem.pmf[-1])
    np.testing.assert_allclose(d.numpy(), np.asarray(ds.d), atol=2e-6)
    np.testing.assert_allclose((pdf * pick).numpy(), np.asarray(ds.pdf),
                               rtol=1e-5)
    close = np.isclose(rad.numpy(), np.asarray(ds.radiance), rtol=1e-5,
                       atol=1e-6).all(-1)
    assert close.mean() >= 0.999
    assert not bool(np.asarray(ds.delta).any())
    # importance sampling puts more samples where the image is bright
    u, v = em.env_dir_to_uv(d)
    hot = ((v * shape[0]).long() // 1 >= shape[0] // 4) & (
        (v * shape[0]).long() < shape[0] // 3)
    assert float(hot.double().mean()) > 0.2


@pytest.mark.parametrize("name", ["openexr_zip_16x8.exr",
                                  "openexr_zips_16x8.exr"])
def test_read_exr_matches_reference(name, tmp_path):
    path = os.path.join(DATA, name)
    got, want = read_exr(path), jax_read_exr(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and what the port writes, in each compression, reads back
    img = _image(9, 13)
    for comp in ("none", "zip", "zips"):
        out = str(tmp_path / f"w_{comp}.exr")
        write_exr(out, img, half=False, compression=comp)
        np.testing.assert_array_equal(read_exr(out), img)
        np.testing.assert_array_equal(jax_read_exr(out), img)
