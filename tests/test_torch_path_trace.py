"""The port's path trace (the plain twin of its CUDA path kernel) vs the
JAX reference on identical PSS vectors.

`path_trace_reference` must agree with the reference wavefront tracer
`trace_paths` (XLA) and with the reference Pallas megakernel in interpret
mode, lane for lane: the same tolerance the reference holds its own
kernel to against trace_paths (tests/test_megatrace.py): per-lane rtol
1e-3 (with a 1e-3 floor) on at least 99% of lanes, channel means to 5e-3.
"""
import dataclasses

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
    jscene = jax_cornell(32, 32, tall_box_material=tall)
    ref = jax.jit(lambda x: jax_trace(           # the reference, one program
        jscene, JPathConfig(max_depth=DEPTH, rr_depth=100), x))(
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
    jscene = jax_cornell(32, 32)
    va = np.asarray(jax.jit(lambda x: jax_trace(jscene, JPathConfig(**kw),
                                                x))(jnp.asarray(u))
                    .value[:, 0, :])
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


def test_twin_counts_the_warp_bounces_compaction_saves():
    """The twin's live masks on the box at depth 8 (65,536 lanes, uniform
    dims from torch's CPU generator seeded 0): one path per thread runs
    16,384 warp-bounces (every warp has a lane that lasts eight bounces)
    for 9,823 warps' worth of path bounces; compacted into full warps of
    128- or 256-thread blocks between bounces (csrc/path_trace.cu), the
    kernel runs 11,413 or 10,643.  NEE adds radiance and never ends a
    path, so the masks are those of the kernels' configuration (NEE on,
    checked on the first 4,096 lanes) and the count runs without NEE,
    which skips its shadow sweeps."""
    uT = torch.rand((PathConfig(max_depth=8).n_dims, 65536),
                    generator=torch.Generator().manual_seed(0))
    masks = {}
    for nee, lanes in ((True, 4096), (False, 65536)):
        cfg = PathConfig(max_depth=8, rr_depth=100, use_nee=nee)
        tables = MT.make_tables(cornell_box(256, 256), cfg, "cpu")
        masks[nee] = []
        MT.path_trace_reference(tables, uT[:, :lanes].contiguous(),
                                live=masks[nee])
    assert all(torch.equal(m, n[:4096]) for m, n in zip(*masks.values()))
    a = masks[False]
    assert len(a) == 8
    assert int(torch.stack(a).sum()) // 32 == 9823
    assert [MT.warp_bounces(a, b) for b in (None, 128, 256)] == [
        16384, 11413, 10643]


def test_adjoint_twins_take_depths_above_16():
    """The adjoint wrappers take any max_depth (the albedo kernel keeps a
    power count per material, not a list of its bounces): on the CPU, at
    depth 18 on the veach door, where every lane lives to the last bounce,
    the radiance and albedo rows, weighted by a cotangent, equal autograd
    of the path twin in the emitters' radiance and the materials' albedo
    (no Russian roulette: the rows are exact there), and the rgb rows are
    the twin's bit for bit."""
    cfg = PathConfig(max_depth=18, rr_depth=100)
    tables = MT.make_tables(veach_door(16, 16), cfg, "cpu")
    rng = np.random.default_rng(18)
    n = 128
    uT = torch.from_numpy(rng.random((cfg.n_dims, n), dtype=np.float32))
    w = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
    live = []
    MT.path_trace_reference(tables, uT, live=live)
    assert bool(live[-1].all())
    for fn, leaf, cols in ((MT.path_trace_rad, "em", slice(0, 3)),
                           (MT.path_trace_alb, "mat", slice(1, 4))):
        out = fn(tables, uT)
        tab = getattr(tables, leaf).clone().requires_grad_()
        value = MT.path_trace_reference(
            dataclasses.replace(tables, **{leaf: tab}), uT)
        assert torch.equal(out[:3], value.detach())
        (g,) = torch.autograd.grad((value.T * w).sum(), tab)
        K = out.shape[0] // 3 - 1
        got = torch.einsum("kcr,rc->kc", out[3:].view(K, 3, n), w)
        np.testing.assert_allclose(got.numpy(), g[:, cols].numpy(), rtol=1e-5,
                                   atol=0.0)
        assert float(g[:, cols].abs().max()) > 0
