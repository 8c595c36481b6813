"""The path wavefront's BSDF sampling (render/bsdf.py:sample_bsdf_table)
against the reference's sample_bsdf on every kind and wrapper, on the
directions and uniforms of test_torch_surface_bsdf.py (its tolerance: each
output within 1e-4 relative, floor 1e-3, on all but R/500 lanes in all;
the Dirac flags equal on all but R/500).
"""
import jax
import numpy as np
import torch

from drmlt_mitsuba_tpu.render import bsdf as jb
from drmlt_mitsuba_tpu_torch.render import bsdf
from test_torch_surface_bsdf import R, _check, case

torch.set_num_threads(1)


def test_sample_matches_reference():
    c = case()
    ref = jax.jit(lambda *a: jb.sample_bsdf(c["jt"], *a))(*c["np"], c["u3"])
    s = bsdf.sample_bsdf_table(c["tab"], *c["args"],
                               torch.from_numpy(c["u3"]))
    for f in ("wo", "weight", "pdf", "eta"):
        _check(f, getattr(ref, f), getattr(s, f), c["mid"])
    assert (np.asarray(ref.delta) != s.delta.numpy()).sum() <= R // 500
