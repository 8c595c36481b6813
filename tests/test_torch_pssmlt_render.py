"""render_pssmlt (integrators/pssmlt.py) over the path technique's twin
against a plain-MC render of the JAX reference, as the reference's
tests/test_mcmc.py:108-128 gates its own: 512 chains, 8,192 bootstrap
samples, 400 steps on cornell_box(32, 32) at depth 3, channel means to
0.15, acceptance in (0.1, 0.9).  A file of its own so that each file runs
in at most 25 s.
"""
import hashlib

import jax
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import render_pt as jax_render_pt
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (
    PSSMLTConfig, render_pssmlt,
)
from drmlt_mitsuba_tpu_torch.render import film
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box

torch.set_num_threads(1)

PCFG = PathConfig(max_depth=3, rr_depth=100)


@pytest.fixture(scope="module")
def box_trace():
    """The path twin of the 32x32 box, remembering what it traced.  The
    weights change only the splats, not the chain: from the same seed the
    Veach and Kelemen renders trace the same vectors, so the second takes
    the first's results (the same tensors) instead of tracing again."""
    trace = make_path_trace(cornell_box(32, 32), PCFG, "cpu")
    seen = {}

    def remembered(u):
        key = (tuple(u.shape), hashlib.blake2b(
            u.contiguous().numpy().tobytes(), digest_size=16).digest())
        if key not in seen:
            seen[key] = trace(u)
        return seen[key]
    return remembered


@pytest.fixture(scope="module")
def mc_reference():
    """The reference's plain-MC render of the 32x32 box, depth 3
    (tests/test_mcmc.py's cornell_small)."""
    jfc = jfilm.make_film_config(32, 32, "box")
    return np.asarray(jfilm.develop(jfc, jax_render_pt(
        jax_cornell(32, 32), JPathConfig(max_depth=3, rr_depth=100),
        jax.random.PRNGKey(42), 32 * 32 * 64, jfc, mode="accum"),
        mode="accum"))


@pytest.mark.parametrize("kelemen", [False, True], ids=["veach", "kelemen"])
def test_render_pssmlt_matches_mc(mc_reference, box_trace, kelemen):
    """render_pssmlt over the path technique's twin: 512 chains, 8192
    bootstrap samples, 400 steps, as tests/test_mcmc.py:108-128."""
    cfg = PSSMLTConfig(n_chains=512, n_bootstrap=8192,
                       kelemen_style_weights=kelemen)
    img, aux = render_pssmlt(box_trace, cfg,
                             film.make_film_config(32, 32, "box"),
                             torch.Generator().manual_seed(1), PCFG.n_dims,
                             n_steps=400)
    img = img.numpy()
    assert np.all(np.isfinite(img)) and aux["steps"] == 400
    ref = mc_reference
    err = (np.abs(img.mean((0, 1)) - ref.mean((0, 1))).mean()
           / ref.mean())
    assert err < 0.15, err
    acc = float(aux["stats"]["accept"].mean())
    assert 0.1 < acc < 0.9
    assert aux["stats"]["large"].shape == (400,)
