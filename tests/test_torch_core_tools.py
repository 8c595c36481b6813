"""The rest of the port's core (warps, quad, sh, chisquare, logger, stats)
against the JAX package's on identical numpy inputs, and the port's
chi-square test on its own warps and BSDF sampling: step 1 of the repo's
oracle ladder, as the reference's tests/test_chisquare.py runs it
(significance 0.0025).

Elementwise functions agree to float32 rounding (atol 1e-6, rtol 1e-5;
the warps' transcendentals and the reference's fused multiply-adds under
jit differ in the last bits; a direction's z = sqrt(1 - x^2 - y^2)
cancels near the rim, so its square is held instead); quadrature nodes
are the same numpy values.
The chi-square statistic of one direction array agrees to rtol 1e-6 (the
cell index of a direction on a cell boundary could flip on the last bit
of arccos / arctan2, which none does here: dof and pooled cells match
exactly); the report is the reference's text character for character.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.core import chisquare as jchi
from drmlt_mitsuba_tpu.core import logger as jlogger
from drmlt_mitsuba_tpu.core import quad as jquad
from drmlt_mitsuba_tpu.core import sh as jsh
from drmlt_mitsuba_tpu.core import stats as jstats
from drmlt_mitsuba_tpu.core import warp as jwarp
from drmlt_mitsuba_tpu_torch.core import chisquare, logger, quad, sh, stats
from drmlt_mitsuba_tpu_torch.core import warp
from drmlt_mitsuba_tpu_torch.ops.megatrace import pack_mat_table
from drmlt_mitsuba_tpu_torch.render import bsdf
from drmlt_mitsuba_tpu_torch.scene import types as st

torch.set_num_threads(1)

N = 400_000
# the cone's edge on a theta cell boundary of the default 10 x 20 grid:
# the midpoint quadrature then integrates its step exactly
COS_CUT, KAPPA = float(np.cos(0.3 * np.pi)), 5.0
WARPS = ("square_to_uniform_sphere", "square_to_uniform_hemisphere",
         "square_to_cosine_hemisphere")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_warps_and_pdfs_match_reference():
    rng = np.random.default_rng(14)
    u = rng.random((4099, 2), dtype=np.float32)
    u[:3] = ((0.0, 0.0), (0.5, 0.25), (0.999999, 0.999999))
    d = rng.normal(size=(4099, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def ref_fn(u, d):                # the reference, one program
        out = [getattr(jwarp, w)(u) for w in WARPS]
        out += [jwarp.square_to_uniform_cone(u, COS_CUT),
                jwarp.square_to_std_normal(u),
                jwarp.interval_to_tent(u[:, 0]),
                jwarp.square_to_vmf(u, KAPPA),
                jwarp.square_to_uniform_sphere_pdf(d),
                jwarp.square_to_uniform_hemisphere_pdf(d),
                jwarp.square_to_cosine_hemisphere_pdf(d),
                jwarp.square_to_vmf_pdf(d, KAPPA)]
        return out

    ref = jax.jit(ref_fn)(jnp.asarray(u), jnp.asarray(d))
    tu, td = T(u), T(d)
    got = [getattr(warp, w)(tu) for w in WARPS]
    got += [warp.square_to_uniform_cone(tu, COS_CUT),
            warp.square_to_std_normal(tu), warp.interval_to_tent(tu[:, 0]),
            warp.square_to_vmf(tu, KAPPA),
            warp.square_to_uniform_sphere_pdf(td),
            warp.square_to_uniform_hemisphere_pdf(td),
            warp.square_to_cosine_hemisphere_pdf(td),
            warp.square_to_vmf_pdf(td, KAPPA)]
    for i, (r, g) in enumerate(zip(ref, got)):
        g, r = g.numpy(), np.asarray(r)
        if g.ndim == 2 and g.shape[1] == 3:
            # z = sqrt(1 - x^2 - y^2) near the rim cancels: hold z^2
            np.testing.assert_allclose(g[:, 2] ** 2, r[:, 2] ** 2, atol=1e-6,
                                       err_msg=f"output {i}")
            g, r = g[:, :2], r[:, :2]
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                   err_msg=f"output {i}")
    assert np.isclose(warp.square_to_uniform_cone_pdf(COS_CUT),
                      jwarp.square_to_uniform_cone_pdf(COS_CUT), rtol=1e-7)


def test_quad_matches_reference():
    for n in (2, 5, 16):
        for jf, tf in ((jquad.gauss_legendre, quad.gauss_legendre),
                       (jquad.gauss_lobatto, quad.gauss_lobatto)):
            for r, g in zip(jf(n), tf(n)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        quad.gauss_lobatto(1)
    rng = np.random.default_rng(3)
    xs = np.linspace(0.0, 2.0, 17, dtype=np.float32)
    ys = rng.random(17, dtype=np.float32)
    x = rng.uniform(-0.2, 2.2, 1000).astype(np.float32)
    c = rng.uniform(0.1, 0.9, 64).astype(np.float32)

    def f_t(v):
        return v ** 3 + v - T(c) * 1.5

    def f_j(v):
        return v ** 3 + v - jnp.asarray(c) * 1.5

    integral, spline, ref = jax.jit(lambda: (    # the reference, one program
        jquad.integrate(jnp.cos, 0.0, 1.5),
        jquad.catmull_rom(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(ys)),
        jquad.brent(f_j, jnp.zeros(64), jnp.ones(64))))()
    np.testing.assert_allclose(float(quad.integrate(torch.cos, 0.0, 1.5)),
                               float(integral), rtol=1e-6)
    np.testing.assert_allclose(float(quad.integrate(torch.cos, 0.0, 1.5)),
                               np.sin(1.5), rtol=1e-6)
    np.testing.assert_allclose(quad.catmull_rom(T(x), T(xs), T(ys)).numpy(),
                               np.asarray(spline), rtol=1e-5, atol=1e-6)
    root = quad.brent(f_t, np.zeros(64, np.float32), np.ones(64, np.float32))
    np.testing.assert_allclose(root.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert float(f_t(root).abs().max()) < 1e-5


def test_sh_matches_reference():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    vals = (1.0 + d[:, 2] * d[:, 0]).astype(np.float32)
    vals2 = np.stack([vals, d[:, 1] ** 2], -1).astype(np.float32)
    ref = jax.jit(lambda d, v, v2: (jsh.eval_sh(d), jsh.project(v, d),
                                    jsh.project(v2, d)))(
        jnp.asarray(d), jnp.asarray(vals), jnp.asarray(vals2))
    np.testing.assert_allclose(sh.eval_sh(T(d)).numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-6)
    for v, r in ((vals, ref[1]), (vals2, ref[2])):
        c = sh.project(T(v), T(d))
        np.testing.assert_allclose(c.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(
            sh.reconstruct(c, T(d)).numpy(),
            np.asarray(jsh.reconstruct(jnp.asarray(r), jnp.asarray(d))),
            rtol=1e-4, atol=1e-5)


def test_chi2_matches_reference_on_one_direction_array():
    """Both harnesses on the same directions (cosine-hemisphere samples,
    some rows zeroed as rejected) and each package's own pdf."""
    rng = np.random.default_rng(9)
    d = warp.square_to_cosine_hemisphere(
        T(rng.random((200_000, 2), dtype=np.float32))).numpy()
    d[::97] = 0.0
    ref = jchi.chi2_test(lambda key, n: jnp.asarray(d),
                         jwarp.square_to_cosine_hemisphere_pdf, n_samples=0,
                         res_theta=12, res_phi=24)
    got = chisquare.chi2_test(lambda g, n: T(d),
                              warp.square_to_cosine_hemisphere_pdf,
                              n_samples=0, res_theta=12, res_phi=24)
    assert (got.passed, got.dof, got.pooled_cells) == (
        ref.passed, ref.dof, ref.pooled_cells)
    np.testing.assert_allclose(got.statistic, ref.statistic, rtol=1e-6)
    np.testing.assert_allclose(got.p_value, ref.p_value, rtol=1e-5)
    assert got.passed and got.pooled_cells > 0


def test_chi2_passes_on_the_ports_warps():
    def uni(g, n):
        return torch.rand((n, 2), generator=g)

    cases = [
        (lambda g, n: warp.square_to_cosine_hemisphere(uni(g, n)),
         warp.square_to_cosine_hemisphere_pdf),
        (lambda g, n: warp.square_to_uniform_sphere(uni(g, n)),
         warp.square_to_uniform_sphere_pdf),
        (lambda g, n: warp.square_to_uniform_hemisphere(uni(g, n)),
         warp.square_to_uniform_hemisphere_pdf),
        (lambda g, n: warp.square_to_uniform_cone(uni(g, n), COS_CUT),
         lambda d: torch.where(d[:, 2] >= COS_CUT,
                               warp.square_to_uniform_cone_pdf(COS_CUT), 0.0)),
        (lambda g, n: warp.square_to_vmf(uni(g, n), KAPPA),
         lambda d: warp.square_to_vmf_pdf(d, KAPPA)),
    ]
    for i, (sample, pdf) in enumerate(cases):
        r = chisquare.chi2_test(sample, pdf, n_samples=N)
        assert r.passed, f"warp {i}: {r}"
    # a wrong pdf fails
    r = chisquare.chi2_test(cases[0][0], warp.square_to_uniform_hemisphere_pdf,
                            n_samples=N)
    assert not r.passed


MATS = {
    "diffuse": dict(kind=st.BSDF_DIFFUSE, albedo=(0.8, 0.8, 0.8)),
    "oren_nayar": dict(kind=st.BSDF_ROUGH_DIFFUSE, albedo=(0.8, 0.8, 0.8),
                       roughness=0.4),
    "rough_conductor": dict(kind=st.BSDF_ROUGH_CONDUCTOR, roughness=0.25,
                            eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14)),
}


@pytest.mark.parametrize("name", list(MATS))
def test_chi2_passes_on_the_ports_bsdf_sampling(name):
    """render/bsdf.py's sampling against its pdf at a fixed incident
    direction (the reference's tests/test_chisquare.py:_bsdf_case)."""
    table = pack_mat_table(st.make_material_table([MATS[name]]))
    wi = torch.tensor([0.35, -0.2, 0.916])
    wi = wi / wi.norm()

    def rows(n):
        return bsdf.material_rows(table, torch.zeros(n, dtype=torch.int32),
                                  frozenset({MATS[name]["kind"]}))

    def sample_fn(g, n):
        u3 = torch.rand((n, 3), generator=g)
        s = bsdf.sample_bsdf(rows(n), wi.expand(n, 3), u3[:, 0], u3[:, 1:3])
        return torch.where((s.pdf > 1e-7)[:, None], s.wo, 0.0)

    def pdf_fn(d):
        return bsdf.eval_bsdf(rows(d.shape[0]), wi.expand(d.shape[0], 3),
                              d)[1]

    r = chisquare.chi2_test(sample_fn, pdf_fn, n_samples=N, res_theta=12,
                            res_phi=24)
    assert r.passed, f"{name}: {r}"


def test_stats_report_and_logger_match_reference(caplog):
    """Statistics.report() on the same series is the reference's text,
    for a DRMLT stats dict (torch tensors in the port) and a PSSMLT one;
    dump_config logs the reference's lines."""
    rng = np.random.default_rng(2)
    drmlt = {k: rng.random(37).astype(np.float32)
             for k in ("a1", "a2", "accept1", "accept2", "large",
                       "n_accept1")}
    pss = {k: rng.random(12).astype(np.float32) for k in ("accept", "large")}
    for series, chains in ((drmlt, 4096), (pss, 512)):
        ref, got = jstats.Statistics(), stats.Statistics()
        ref.record_mcmc(series, chains)
        got.record_mcmc({k: T(v) for k, v in series.items()}, chains)
        assert got.report() == ref.report()
        assert got.as_dict() == ref.as_dict()
    assert stats.Statistics().report() == jstats.Statistics().report()

    cfg = {"type": "pssmlt", "maxDepth": 4, "pLarge": "0.3"}
    lines = {}
    for mod, name in ((jlogger, "drmlt_tpu"), (logger, logger.LOGGER)):
        log = mod.setup_logging("debug", quiet=True)
        assert log.name == name and log.level == logging.DEBUG
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            mod.dump_config(log, "pssmlt", cfg)
        lines[name] = [r.getMessage() for r in caplog.records]
    assert lines["drmlt_tpu"] == lines[logger.LOGGER]
    assert lines[logger.LOGGER][1] == "   type = pssmlt"
