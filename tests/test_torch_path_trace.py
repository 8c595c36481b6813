"""The port's path trace (the plain twin of its CUDA path kernel) vs the
JAX reference on identical PSS vectors.

`path_trace_reference` must agree with the reference wavefront tracer
`trace_paths` (XLA) and with the reference Pallas megakernel in interpret
mode, lane for lane: the same tolerance the reference holds its own
kernel to against trace_paths (tests/test_megatrace.py): per-lane rtol
1e-3 (with a 1e-3 floor) on at least 99% of lanes, channel means to 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.ops.pallas.megatrace import make_mega_trace
from drmlt_mitsuba_tpu.scene import builders as jax_builders
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, trace_paths,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door

torch.set_num_threads(1)

R = 512
DEPTH = 3


def _u(seed, n_dims):
    return np.random.default_rng(seed).random((R, n_dims), dtype=np.float32)


def _check(va, vb):
    rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
    bad = (rel > 1e-3).any(-1).mean()
    assert bad <= 0.01, f"{bad:.4f} of lanes diverge"
    np.testing.assert_allclose(vb.mean(0), va.mean(0), rtol=5e-3)


@pytest.mark.parametrize("tall", ["diffuse", "mirror", "glass"])
def test_twin_matches_trace_paths(tall):
    cfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    u = _u(3, cfg.n_dims)
    ref = jax_trace(jax_cornell(32, 32, tall_box_material=tall),
                    JPathConfig(max_depth=DEPTH, rr_depth=100),
                    jnp.asarray(u))
    got = trace_paths(cornell_box(32, 32, tall_box_material=tall), cfg,
                      torch.from_numpy(u))
    va = np.asarray(ref.value[:, 0, :])
    _check(va, got.value[:, 0, :].numpy())
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(ref.lum),
                               rtol=1e-3, atol=1e-6)
    assert (va.sum(-1) > 0).mean() > 0.3      # the box is lit


def test_twin_matches_interpret_megakernel():
    """The reference Pallas path kernel itself (interpret mode, depth 2 to
    keep its trace cheap), with Russian roulette on from depth 1 so its
    dims are exercised too."""
    cfg = PathConfig(max_depth=2, rr_depth=1)
    u = _u(5, cfg.n_dims)
    mega = make_mega_trace(jax_cornell(32, 32, tall_box_material="glass"),
                           JPathConfig(max_depth=2, rr_depth=1),
                           interpret=True)
    va = np.asarray(mega(jnp.asarray(u)).value[:, 0, :])
    got = trace_paths(cornell_box(32, 32, tall_box_material="glass"), cfg,
                      torch.from_numpy(u))
    _check(va, got.value[:, 0, :].numpy())


def test_wrapper_runs_twin_on_cpu_and_counts_no_launch():
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=2, rr_depth=100, use_nee=False)
    tables = MT.make_tables(scene, cfg, "cpu")
    uT = torch.from_numpy(_u(7, cfg.n_dims).T.copy())
    before = dict(build.LAUNCHES)
    out = MT.path_trace(tables, uT)
    assert build.LAUNCHES == before
    assert out.shape == (3, R)
    assert torch.equal(out, MT.path_trace_reference(tables, uT))
    sp = make_path_trace(scene, cfg, "cpu")(uT.T)
    assert torch.equal(sp.value[:, 0, :], out.T)
    with pytest.raises(ValueError, match="dims"):
        MT.path_trace(tables, uT[:3])


def test_no_nee_and_min_depth_match_trace_paths():
    kw = dict(max_depth=DEPTH, rr_depth=100, use_nee=False, min_depth=2)
    cfg = PathConfig(**kw)
    u = _u(9, cfg.n_dims)
    va = np.asarray(jax_trace(jax_cornell(32, 32), JPathConfig(**kw),
                              jnp.asarray(u)).value[:, 0, :])
    _check(va, trace_paths(cornell_box(32, 32), cfg, torch.from_numpy(u))
           .value[:, 0, :].numpy())


def test_twin_matches_trace_paths_veach_door():
    """Rough diffuse (Oren-Nayar) on the veach-door scene, as the
    reference holds its kernel there (tests/test_megatrace.py:41-55: depth
    5, Russian roulette from depth 3).  The door panel is two coplanar
    quads facing opposite ways; a ray that hits it ties between them, and
    the winner, whose normal orients the shading frame of the next sampled
    direction, flips on the last bit of the ray direction, where the
    reference's rsqrt normalization and the port's sqrt-and-divide differ.
    So up to 1% of lanes may follow another path; every other lane agrees
    to 1e-3, and their means to 5e-3."""
    kw = dict(max_depth=5, rr_depth=3)
    cfg = PathConfig(**kw)
    u = _u(0, cfg.n_dims)
    jscene = jax_builders.veach_door(64, 64)
    ref = jax.jit(lambda x: jax_trace(jscene, JPathConfig(**kw), x))
    va = np.asarray(ref(jnp.asarray(u)).value[:, 0, :])
    vb = trace_paths(veach_door(64, 64), cfg,
                     torch.from_numpy(u)).value[:, 0, :].numpy()
    rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
    bad = (rel > 1e-3).any(-1)
    assert bad.mean() <= 0.01, f"{bad.mean():.4f} of lanes diverge"
    np.testing.assert_allclose(vb[~bad].mean(0), va[~bad].mean(0),
                               rtol=5e-3)
    assert (va[~bad].sum(-1) > 0).mean() > 0.02     # the door gap is lit
    assert MT.mega_eligible(veach_door(8, 8), cfg)
