"""The port's MMLT trace (the plain twin of its CUDA MMLT kernel) vs the JAX
reference on identical PSS vectors.

`mmlt_trace_reference` is held to the reference's XLA `trace_mmlt` (through
`make_mmlt_trace(force_xla=True)`, the pooled [depth, strategy, eye...,
light...] interface the MMLT kernel has), with the allowance the reference
grants its own kernel against that trace (tests/test_megammlt.py:22-39): at
most R/250 lanes with a relative error above 1e-3, channel means to rtol
5e-3, film positions of the lit lanes to 1e-5.  The reference suite pins
its XLA trace to its kernel lane for lane, so the interpret-mode kernel is
not run here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPTConfig
from drmlt_mitsuba_tpu.integrators.bidir import eye_subpath, light_subpath
from drmlt_mitsuba_tpu.integrators.mmlt import make_mmlt_trace as jax_mmlt
from drmlt_mitsuba_tpu.integrators.mmlt import mmlt_n_dims as jax_n_dims
from drmlt_mitsuba_tpu.scene import builders as jax_builders
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig, trace_mmlt
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megammlt
from drmlt_mitsuba_tpu_torch.scene import builders

torch.set_num_threads(1)

R = 1024


def _compare(va, vb, pa, pb):
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    bad = (rel > 1e-3).any(-1)
    assert bad.sum() <= R // 250, f"{bad.sum()} lanes diverge"
    np.testing.assert_allclose(vb.mean(0), va.mean(0), rtol=5e-3, atol=1e-5)
    lit = (np.abs(va) > 1e-7).any(-1) & ~bad
    assert lit.sum() >= 5      # lanes that carry light
    np.testing.assert_allclose(pb[lit], pa[lit], atol=1e-5)


@pytest.mark.parametrize("scene,kw,depth,light_image", [
    ("cornell_box", dict(tall_box_material="diffuse"), 1, True),
    ("cornell_box", dict(tall_box_material="mirror"), 4, False),
    ("cornell_box", dict(tall_box_material="glass"), 6, True),
    ("veach_door", dict(), 5, True),
], ids=["diffuse-1", "mirror-4-no-light-image", "glass-6", "veach-5"])
def test_twin_matches_xla_trace_mmlt(scene, kw, depth, light_image):
    size = 64 if scene == "veach_door" else 32
    jscene = getattr(jax_builders, scene)(size, size, **kw)
    pscene = getattr(builders, scene)(size, size, **kw)
    jcfg = JBDPTConfig(max_depth=depth, light_image=light_image)
    cfg = BDPTConfig(max_depth=depth, light_image=light_image)
    n = mmlt_n_dims(cfg)
    assert n == jax_n_dims(jcfg)
    u = np.random.default_rng(depth).random((R, n), dtype=np.float32)
    ref = jax.jit(jax_mmlt(jscene, jcfg, force_xla=True))(jnp.asarray(u))
    va, pa = np.asarray(ref.value[:, 0]), np.asarray(ref.pos[:, 0])

    n0 = build.LAUNCHES["mmlt_trace"]
    got = make_mmlt_trace(pscene, cfg, "cpu")(torch.from_numpy(u))
    assert build.LAUNCHES["mmlt_trace"] == n0      # the twin, not a kernel
    _compare(va, got.value[:, 0].numpy(), pa, got.pos[:, 0].numpy())
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(ref.lum),
                               rtol=1e-3, atol=1e-5)

    # bidir.trace_mmlt: [strategy, eye..., light...] with a per-lane depth
    # and the n_strats scaling only, i.e. the pooled value / max_depth
    d = 1 + np.minimum((u[:, 0] * depth).astype(np.int32), depth - 1)
    sp = trace_mmlt(pscene, cfg, torch.from_numpy(u[:, 1:]),
                    torch.from_numpy(d))
    _compare(va / depth, sp.value[:, 0].numpy(), pa, sp.pos[:, 0].numpy())


def _walk_length(sp):
    """Per lane, the surface slots a subpath walk reaches: its hits, and
    the slot where it left the scene (the sweeps its walk takes)."""
    return sp.valid[:, 1:].sum(1) + sp.escaped[:, 1:].sum(1)


def test_twin_sweeps_stop_at_the_selected_slots(monkeypatch):
    """Each lane's walks stop at the slots its strategy selects, as the
    kernel's fused walk does, on the box at the pinned depth 6 and over the
    pooled depths 1-6 (s = 0 and t = 1 included): the twin sweeps
    min(eye walk length, t - 1) + min(light walk length, max(s - 1, 0))
    times per lane, each length the reference's own subpath's on the same
    dims (the slots it reaches, the one where it leaves the scene
    included), and `work` counts those sweeps.  Its outputs still match
    the XLA trace_mmlt.  The glass box is left out: its bottom face lies
    on the floor, and a light walk that refracts down through it meets
    both at once, a tie that the reference's walk and the twin break
    apart, so their walk lengths differ on some lanes (seed 11: 16 of
    1,024) for a reason that is not the stop at the selected slot."""
    K = 6
    jscene = jax_builders.cornell_box(32, 32)
    jcfg, cfg = JBDPTConfig(max_depth=K), BDPTConfig(max_depth=K)
    tables = megammlt.make_mmlt_tables(builders.cornell_box(32, 32), cfg,
                                       "cpu")
    lbase = 2 + cfg.eye_dims
    xla_trace = jax_mmlt(jscene, jcfg, force_xla=True)

    @jax.jit
    def reference(x):
        """The walks' lengths and the trace, compiled as one program."""
        eye = eye_subpath(jscene, jcfg, x[:, 2:lbase])[0]
        light = light_subpath(jscene, jcfg, x[:, lbase:])
        return _walk_length(eye), _walk_length(light), xla_trace(x)

    count = megammlt.count_sweeps
    sweeps, closest = torch.zeros(R, dtype=torch.int64), []

    def spy(work, tri, mask, o, d, tmax=None, nodes=None):
        n0 = work.get("tri_tests", 0)
        count(work, tri, mask, o, d, tmax, nodes)
        if tmax is None:            # a walk's closest-hit sweep
            sweeps.add_(mask.long())
            closest.append(work["tri_tests"] - n0)

    monkeypatch.setattr(megammlt, "count_sweeps", spy)
    rng = np.random.default_rng(11)
    for pinned in (True, False):
        u = rng.random((R, tables.n_core), dtype=np.float32)
        if pinned:
            u[:, 0] = np.float32(1.0 - 0.5 / K)
        # the strategy (s, t) in float32, as mmlt_trace.cuh picks it
        depth = np.minimum(np.floor(u[:, 0] * np.float32(K)), K - 1) + 1
        s = np.minimum(np.floor(u[:, 1] * (depth + 1)), depth)
        t = depth + 1 - s
        assert {0.0, 1.0} <= set(s) and 1.0 in set(t)
        le, ll, ref = reference(jnp.asarray(u))
        want = (np.minimum(np.asarray(le), t - 1)
                + np.minimum(np.asarray(ll), np.maximum(s - 1, 0)))

        sweeps.zero_()
        closest.clear()
        got = megammlt.mmlt_trace_reference(
            tables, torch.from_numpy(u.T.copy()), {})
        np.testing.assert_array_equal(sweeps.numpy(), want.astype(np.int64))
        assert sum(closest) == tables.tri.shape[0] * int(want.sum())
        _compare(np.asarray(ref.value[:, 0]), got[:3].T.numpy(),
                 np.asarray(ref.pos[:, 0]), got[3:].T.numpy())


def test_config_layout_and_wrapper_checks():
    for k in range(1, 8):
        for li in (True, False):
            a, b = BDPTConfig(max_depth=k, light_image=li), JBDPTConfig(
                max_depth=k, light_image=li)
            assert (a.eye_dims, a.light_dims, a.n_dims, a.n_eye,
                    a.n_light) == (b.eye_dims, b.light_dims, b.n_dims,
                                   b.n_eye, b.n_light)
    with pytest.raises(NotImplementedError, match="thin-lens"):
        BDPTConfig(thinlens=True)
    tables = megammlt.make_mmlt_tables(builders.cornell_box(8, 8),
                                       BDPTConfig(max_depth=2), "cpu")
    assert tables.n_core == 2 + 5 + 5
    with pytest.raises(ValueError, match="reads 12"):
        megammlt.mmlt_trace(tables, torch.zeros((11, 4)))
    with pytest.raises(ValueError, match="max_depth 17"):
        megammlt.check_depth(17)
