"""The BSDF kinds beyond slices 1-4 (smooth conductor, rough conductor
with GGX visible-normal sampling, null) and the GGX functions of the port
(render/bsdf.py, render/microfacet.py) against the JAX package's
render/bsdf.py and render/microfacet.py on identical inputs.

The port evaluates in its kernels' order (sqrt-and-divide normalisation,
the reference kernel's clamps, megatrace.py:202-278, 1602-1795), so values
agree to float32 rounding, rtol 1e-4 (1e-3 where the GGX distribution of a
grazing half vector amplifies a last-bit difference); a sampled
direction's lanes where the two normalisations flip r.z > 0 at the horizon
are at most 0.2%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.core.math import fresnel_conductor as jax_fresnel
from drmlt_mitsuba_tpu.render import bsdf as jbsdf
from drmlt_mitsuba_tpu.render import microfacet as jmf
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu_torch.ops.megatrace import pack_mat_table
from drmlt_mitsuba_tpu_torch.render import bsdf, microfacet
from drmlt_mitsuba_tpu_torch.scene import types as st

torch.set_num_threads(1)

R = 4096
MATS = [dict(kind=st.BSDF_CONDUCTOR, eta=(0.2, 0.924, 1.102),
             k=(3.912, 2.448, 2.138), spec_refl=(0.9, 0.8, 1.0)),
        dict(kind=st.BSDF_ROUGH_CONDUCTOR, eta=(0.143, 0.375, 1.442),
             k=(3.983, 2.386, 1.603), roughness=0.15),
        dict(kind=st.BSDF_ROUGH_CONDUCTOR, eta=(1.345, 0.965, 0.617),
             k=(7.475, 6.4, 5.303), roughness=0.6),
        dict(kind=st.BSDF_NULL)]


def _dirs(rng, n, upper=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_ggx_functions_match_reference():
    rng = np.random.default_rng(0)
    wi = _dirs(rng, R, upper=True)
    m = _dirs(rng, R, upper=True)
    alpha = rng.uniform(0.05, 0.9, R).astype(np.float32)
    u = rng.random((R, 2), dtype=np.float32)
    a_j, a_t = jnp.asarray(alpha), _T(alpha)
    pairs = [
        (jmf.ggx_ndf(jnp.asarray(m), a_j),
         microfacet.ggx_ndf(_T(m[:, 2]), a_t)),
        (jmf.ggx_lambda(jnp.asarray(wi), a_j),
         microfacet.ggx_lambda(_T(wi[:, 2]), a_t)),
        (jmf.ggx_g1(jnp.asarray(wi), a_j),
         microfacet.ggx_g1(_T(wi[:, 2]), a_t)),
        (jmf.ggx_g2(jnp.asarray(wi), jnp.asarray(m), a_j),
         microfacet.ggx_g2(_T(wi[:, 2]), _T(m[:, 2]), a_t)),
        (jmf.ggx_vndf_pdf(jnp.asarray(wi), jnp.asarray(m), a_j),
         microfacet.ggx_vndf_pdf(_T(wi), _T(m), a_t)),
        (jmf.ggx_sample_vndf(jnp.asarray(wi), a_j, jnp.asarray(u)),
         microfacet.ggx_sample_vndf(_T(wi), a_t, _T(u[:, 0]), _T(u[:, 1]))),
    ]
    for i, (ref, got) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=f"function {i}")


def test_fresnel_conductor_matches_reference():
    rng = np.random.default_rng(1)
    ci = rng.uniform(-0.2, 1.2, R).astype(np.float32)
    eta = rng.uniform(0.1, 3.0, (R, 3)).astype(np.float32)
    k = rng.uniform(0.0, 8.0, (R, 3)).astype(np.float32)
    ref = jax_fresnel(jnp.asarray(ci), jnp.asarray(eta), jnp.asarray(k))
    got = bsdf.fresnel_conductor(_T(ci), _T(eta), _T(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("mi", range(len(MATS)),
                         ids=["conductor", "roughconductor-0.15",
                              "roughconductor-0.6", "null"])
def test_kind_eval_sample_pdf_match_reference(mi):
    """eval (f |cos|, pdf), sample (direction, weight, pdf, delta) and the
    pdf of the sampled direction, on both sides of the surface."""
    rng = np.random.default_rng(10 + mi)
    table_j = jst.make_material_table(MATS)
    mats = pack_mat_table(st.make_material_table(MATS))
    mid = np.full(R, mi, np.int32)
    wi, wo = _dirs(rng, R), _dirs(rng, R)
    u3 = rng.random((R, 3), dtype=np.float32)
    alb = jnp.zeros((R, 3))
    m = bsdf.material_rows(mats, _T(mid), frozenset(d["kind"] for d in MATS))
    f_j, pdf_j = jbsdf.eval_bsdf(table_j, jnp.asarray(mid), alb,
                                 jnp.asarray(wi), jnp.asarray(wo))
    f_t, pdf_t = bsdf.eval_bsdf(m, _T(wi), _T(wo))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-3,
                               atol=1e-6)
    if MATS[mi]["kind"] == st.BSDF_ROUGH_CONDUCTOR:
        assert (np.asarray(pdf_j) > 0).mean() > 0.2
    s_j = jbsdf.sample_bsdf(table_j, jnp.asarray(mid), alb, jnp.asarray(wi),
                            jnp.asarray(u3))
    s_t = bsdf.sample_bsdf(m, _T(wi), _T(u3[:, 0]), _T(u3[:, 1:3]))
    np.testing.assert_array_equal(s_t.delta.numpy(), np.asarray(s_j.delta))
    wo_ok = np.abs(s_t.wo.numpy() - np.asarray(s_j.wo)).max(-1) < 1e-4
    agree = wo_ok & np.isclose(s_t.pdf.numpy(), np.asarray(s_j.pdf),
                               rtol=1e-3, atol=1e-6).astype(bool)
    agree &= np.isclose(s_t.weight.numpy(), np.asarray(s_j.weight),
                        rtol=1e-3, atol=1e-6).all(-1)
    assert agree.mean() >= 0.998, f"{1 - agree.mean():.4f} of lanes differ"
    np.testing.assert_array_equal(s_t.eta.numpy(), np.asarray(s_j.eta))
    # the pdf of the sampled direction equals the sample's pdf
    _, pdf_s = bsdf.eval_bsdf(m, _T(wi), s_t.wo)
    live = s_t.pdf.numpy() > 0
    np.testing.assert_allclose(pdf_s.numpy()[live], s_t.pdf.numpy()[live],
                               rtol=1e-3)


def test_supported_kinds_are_the_reference_kernels():
    from drmlt_mitsuba_tpu.ops.pallas.megatrace import (
        SUPPORTED_KINDS as JAX_KINDS,
    )
    assert set(bsdf.SUPPORTED_KINDS) == set(JAX_KINDS)
    kinds = torch.tensor([0, 1, 2, 3, 8, 9, 12])
    np.testing.assert_array_equal(
        bsdf.is_delta(kinds).numpy(),
        np.isin(kinds.numpy(), jbsdf.DELTA_KINDS))
