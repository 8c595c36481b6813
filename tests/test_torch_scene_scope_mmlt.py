"""The port's MMLT twin on the reference megakernels' whole scene scope
(the scenes of test_torch_scene_scope.py less the thin lens, which the
reference's MMLT kernel does not take either): `mmlt_trace_reference`
against the XLA `trace_mmlt` with the allowances stated there.  In a file
of its own so that each file runs in at most 25 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene_scope import R, TOL, _check, jax_scene, port_scene

from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPTConfig
from drmlt_mitsuba_tpu.integrators.mmlt import make_mmlt_trace as jax_mmlt
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM

torch.set_num_threads(1)


@pytest.mark.parametrize("name,depth", [("kinds", 4), ("texture", 3),
                                        ("image", 4)])
def test_mmlt_twin_matches_trace_mmlt(name, depth):
    """The MMLT twin against the XLA trace_mmlt (through the reference's
    pooled [depth, strategy, eye..., light...] interface), the allowance of
    the path scenes; film positions to 1e-5 on the agreeing lanes that
    carry light in both (a dark sample's position is never splatted)."""
    jscene = jax_scene(name)
    cfg = BDPTConfig(max_depth=depth)
    u = np.random.default_rng(depth).random((R, mmlt_n_dims(cfg)),
                                            dtype=np.float32)
    ref = jax.jit(jax_mmlt(jscene, JBDPTConfig(max_depth=depth),
                           force_xla=True))(jnp.asarray(u))
    va, pa = np.asarray(ref.value[:, 0]), np.asarray(ref.pos[:, 0])
    scene = port_scene(jscene)
    assert MM.make_mmlt_tables(scene, cfg, "cpu").full
    got = make_mmlt_trace(scene, cfg, "cpu")(torch.from_numpy(u))
    vb, pb = got.value[:, 0].numpy(), got.pos[:, 0].numpy()
    _check(va, vb, name, lit=0.01)
    rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
    lit = ((np.abs(va) > 1e-7).any(-1) & (np.abs(vb) > 1e-7).any(-1)
           & ~(rel > TOL[name][0]).any(-1))
    np.testing.assert_allclose(pb[lit], pa[lit], atol=1e-5)
