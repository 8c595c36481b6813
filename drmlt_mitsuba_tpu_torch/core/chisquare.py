"""Chi-square goodness-of-fit test of directional sampling routines
(counterpart of drmlt_mitsuba_tpu/core/chisquare.py, the reference's
test_chisquare): histogram the samples over a (theta, phi) grid, integrate
the claimed pdf over the same cells, pool the cells whose expected count
is low, and test at a significance level (0.0025, as the reference).

The samples come from torch; the histogram, the pdf's midpoint quadrature
over a finer subgrid (sub x sub points a cell) and the pooling are numpy,
and the p-value is scipy's chi-square survival function.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ChiSquareResult:
    passed: bool
    statistic: float
    dof: int
    p_value: float
    pooled_cells: int


def _cell_index(d, res_theta, res_phi):
    """The grid cell of each unit direction d (N, 3), a float32 array."""
    theta = np.arccos(np.clip(d[:, 2], -1.0, 1.0))
    phi = np.arctan2(d[:, 1], d[:, 0]) % np.float32(2.0 * np.pi)
    it = np.clip((theta / np.float32(np.pi) * res_theta).astype(np.int32),
                 0, res_theta - 1)
    ip = np.clip((phi / np.float32(2 * np.pi) * res_phi).astype(np.int32),
                 0, res_phi - 1)
    return it * res_phi + ip


def chi2_test(sample_fn, pdf_fn, n_samples: int = 1_000_000,
              res_theta: int = 10, res_phi: int = 20,
              significance: float = 0.0025, min_exp_count: float = 5.0,
              generator=None, sub: int = 8) -> ChiSquareResult:
    """Test that sample_fn(generator, n) -> (n, 3) unit directions follow
    pdf_fn(dirs (m, 3)) -> (m,) solid-angle pdf.  Rows of length below 0.5
    (a sampler's rejected samples) are dropped, and the expectation is
    renormalised to the samples kept.  `generator` defaults to a CPU one
    seeded 7; pdf_fn gets its directions on the generator's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(7)
    d = sample_fn(generator, n_samples).detach().cpu().numpy()
    d = d[np.linalg.norm(d, axis=-1) > 0.5]
    n_eff = len(d)
    counts = np.bincount(_cell_index(d, res_theta, res_phi),
                         minlength=res_theta * res_phi).astype(np.float64)

    ft, fp = res_theta * sub, res_phi * sub
    th = (np.arange(ft) + 0.5) / ft * np.pi
    ph = (np.arange(fp) + 0.5) / fp * 2 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH),
                     np.cos(TH)], -1).reshape(-1, 3).astype(np.float32)
    pdf = pdf_fn(torch.from_numpy(dirs).to(generator.device))
    pdf = np.asarray(torch.as_tensor(pdf).detach().cpu().numpy()).reshape(
        ft, fp)
    d_area = (np.pi / ft) * (2 * np.pi / fp) * np.sin(TH)
    cell_prob = (pdf * d_area).reshape(res_theta, sub, res_phi,
                                       sub).sum(axis=(1, 3)).reshape(-1)
    expected = cell_prob * n_eff
    # a sampler may discard part of its mass (reflections below the
    # horizon, Dirac lobes): test the shape of what it keeps
    total_p = expected.sum()
    if total_p > 0:
        expected = expected * (n_eff / total_p)

    pooled_c = pooled_e = stat = 0.0
    dof = pooled_cells = 0
    for i in np.argsort(expected)[::-1]:
        if expected[i] >= min_exp_count:
            stat += (counts[i] - expected[i]) ** 2 / expected[i]
            dof += 1
        else:
            pooled_c += counts[i]
            pooled_e += expected[i]
            pooled_cells += 1
    if pooled_e > min_exp_count:
        stat += (pooled_c - pooled_e) ** 2 / pooled_e
        dof += 1
    dof = max(dof - 1, 1)
    from scipy.stats import chi2   # seconds to import: paid by a test only

    p = float(chi2.sf(stat, dof))
    return ChiSquareResult(passed=p >= significance, statistic=float(stat),
                           dof=dof, p_value=p, pooled_cells=pooled_cells)
