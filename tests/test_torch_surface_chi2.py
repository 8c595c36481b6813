"""The path wavefront's BSDF sampling (render/bsdf.py:sample_bsdf_table)
through the port's chi-square test (core/chisquare.py, step 1 of the
oracle ladder) against its own pdf (eval_bsdf_table), for the rough
plastic, rough dielectric, phong, ward and hk kinds and a two-link
mixture (the reference's tests/test_chisquare.py cases).  Pure port: the
kinds' agreement with the reference is test_torch_surface_bsdf.py's.
"""
import pytest
import torch

from drmlt_mitsuba_tpu_torch.core import chisquare
from drmlt_mitsuba_tpu_torch.render import bsdf
from test_torch_surface_bsdf import MATS, _port_table

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["roughplastic", "roughdielectric", "phong",
                                  "ward", "hk", "mixture"])
def test_sampling_passes_chi_square(name):
    """sample_bsdf_table's non-Dirac samples follow eval_bsdf_table's pdf
    at a fixed incident direction (the reference's tests/test_chisquare.py
    cases, 400,000 samples).  As there, the rough dielectric is tested at
    50,000 samples and alpha 0.3: its pdf is the single-branch Walter pdf,
    which underestimates near the refraction fold, while its sampling
    weights are the exact visible-normal ones."""
    mats = [MATS[name]]
    n = 400_000
    if name == "roughdielectric":
        mats, n = [dict(MATS[name], roughness=0.3)], 50_000
    if name == "mixture":
        mats = [dict(MATS["mixture"], mix_other=1),
                dict(MATS["roughconductor"], mix_other=2, mix_weight=0.375),
                MATS["phong"]]
    tab = _port_table(mats)
    wi = torch.tensor([0.35, -0.2, 0.916])
    wi = wi / wi.norm()

    def ids(n):
        return torch.zeros(n, dtype=torch.int64)

    def alb(n):
        return tab.mat[ids(n), 1:4]

    def sample_fn(g, n):
        s = bsdf.sample_bsdf_table(tab, ids(n), alb(n), wi.expand(n, 3),
                                   torch.rand((n, 3), generator=g))
        return torch.where((s.pdf > 1e-7)[:, None], s.wo, 0.0)

    def pdf_fn(d):
        n = d.shape[0]
        return bsdf.eval_bsdf_table(tab, ids(n), alb(n), wi.expand(n, 3),
                                    d)[1]

    r = chisquare.chi2_test(sample_fn, pdf_fn, n_samples=n,
                            res_theta=12, res_phi=24)
    assert r.passed, f"{name}: {r}"
