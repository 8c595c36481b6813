"""Differentiable rendering in the port vs the JAX reference, on the CPU.

The port's adjoint twins (`ops/megatrace.py:path_trace_rad_reference` /
`path_trace_alb_reference`, the plain versions of its CUDA adjoint
kernels) must give the same per-lane Jacobian rows as `jax.jacfwd` of the
reference's XLA `trace_paths`, and the port's three differentiable entry
points (`make_mega_trace_rad`, `_alb`, `_diff`, through their twins here)
the same gradients of mean(lum) as it (the lane mean of those
`jax.jacfwd` rows, the derivative `jax.grad` gives in reverse mode; one
compile serves both), at the reference's own tolerance
for its kernels (tests/test_gradients.py:286-361: rtol 5e-3).  The albedo
rows detach Russian-roulette survival, as the reference's kernel does, so
they are held to the reference at rr_depth > max_depth only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.ops.pallas.megatrace import (
    pack_mega_tables as jax_pack, pack_mega_tables_jnp as jax_pack_jnp,
)
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.builders import veach_door as jax_veach
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace_diff, trace_paths,
)
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door
from drmlt_mitsuba_tpu_torch.scene.convert import replace_leaves

torch.set_num_threads(1)

R = 512
LUM_W = np.asarray([0.212671, 0.715160, 0.072169], np.float32)
# (rr_depth, the leaf the rows are taken against)
ROWS = {"rad": (3, "radiance"), "alb": (100, "albedo")}


def _u(seed, n, n_dims):
    return np.random.default_rng(seed).random((n, n_dims), dtype=np.float32)


def _jax_jacfwd(rr, leaves, u):
    """Per leaf of `leaves` ("radiance", "albedo"), jax.jacfwd (R, 3, K, 3)
    of the reference's value (R, 3) on the Cornell box 32x32 at depth 4,
    one compile for them all; and the leaves' values."""
    scene = jax_cornell(32, 32)
    cfg = JPathConfig(max_depth=4, rr_depth=rr)

    def f(*ps):
        kw = dict(zip(leaves, ps))
        s = scene
        if "radiance" in kw:
            s = s.replace(emitters=s.emitters.replace(radiance=kw["radiance"]))
        if "albedo" in kw:
            s = s.replace(materials=s.materials.replace(albedo=kw["albedo"]))
        return jax_trace(s, cfg, jnp.asarray(u)).value[:, 0, :]

    p0 = [scene.emitters.radiance if leaf == "radiance"
          else scene.materials.albedo for leaf in leaves]
    J = jax.jit(jax.jacfwd(f, argnums=tuple(range(len(leaves)))))(*p0)
    return [np.asarray(j) for j in J], [np.asarray(p) for p in p0]


def test_torch_packer_matches_numpy_packer():
    """pack_mega_tables_torch equals the reference's numpy packer and its
    traceable jnp twin byte for byte on the Cornell box with each tall box
    and on the veach door, and carries the gradient of the leaves it
    packs."""
    for scene, ref in [(cornell_box(48, 32, tall_box_material=t),
                        jax_cornell(48, 32, tall_box_material=t))
                       for t in ("diffuse", "mirror", "glass")] + [
                           (veach_door(64, 48), jax_veach(64, 48))]:
        got = MT.pack_mega_tables_torch(scene)
        for want in (jax_pack(ref)[:4], jax_pack_jnp(ref)[:4]):
            for a, b in zip(want, got):
                a = np.asarray(a)
                assert b.dtype == torch.float32 and b.shape == a.shape
                np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                              a.view(np.uint32))
    scene = cornell_box(16, 16)
    scene.materials.albedo.requires_grad_(True)
    scene.tris.v0.requires_grad_(True)
    tri, mat, em, cam = MT.pack_mega_tables_torch(scene)[:4]
    (g_alb,) = torch.autograd.grad(mat[:, 1:4].sum(), scene.materials.albedo)
    assert torch.equal(g_alb, torch.ones_like(g_alb))
    (g_v0,) = torch.autograd.grad(em[:, 6:9].sum() + tri[:, 0:3].sum(),
                                  scene.tris.v0)
    assert float(g_v0.sum()) == tri.shape[0] * 3 + em.shape[0] * 3


@pytest.fixture(scope="module")
def jacobians():
    """Per mode: the lanes u, the per-lane jax.jacfwd (R, 3, K, 3) of the
    reference's value with respect to the mode's leaf at the mode's
    rr_depth, and the leaf, on the Cornell box 32x32 at depth 4; under
    "alb_rr3" the albedo's at rr_depth 3, from the radiance's compile."""
    u = _u(11, R, PathConfig(max_depth=4).n_dims)
    (j_rad, j_alb3), (rad, alb) = _jax_jacfwd(ROWS["rad"][0],
                                              ("radiance", "albedo"), u)
    (j_alb,), _ = _jax_jacfwd(ROWS["alb"][0], ("albedo",), u)
    return {"rad": (u, j_rad, rad), "alb": (u, j_alb, alb),
            "alb_rr3": (u, j_alb3, alb)}


@pytest.mark.parametrize("mode", sorted(ROWS))
def test_adjoint_twin_rows_match_jacfwd(mode, jacobians):
    """Cornell box 32x32, 512 lanes, depth 4: the rgb rows equal
    path_trace_reference bit for bit, and the Jacobian rows equal the
    per-lane jax.jacfwd of the reference's trace_paths to rtol 1e-4 on at
    least 99.8% of lanes (the path kernel's lane allowance); radiance and
    albedo act channel by channel, so the off-diagonal block is zero."""
    rr, _ = ROWS[mode]
    cfg = PathConfig(max_depth=4, rr_depth=rr)
    u, J, p0 = jacobians[mode]
    tables = MT.make_tables(cornell_box(32, 32), cfg, "cpu")
    uT = torch.from_numpy(u.T.copy())
    twin = (MT.path_trace_rad_reference if mode == "rad"
            else MT.path_trace_alb_reference)
    out = twin(tables, uT).numpy()
    assert torch.equal(torch.from_numpy(out[:3]),
                       MT.path_trace_reference(tables, uT))
    K = J.shape[2]
    rows = out[3:].reshape(K, 3, R).transpose(2, 0, 1)     # (R, K, 3)
    diag = np.stack([J[:, c, :, c] for c in range(3)], -1)
    rel = np.abs(rows - diag) / (np.abs(diag) + 1e-6)
    bad = (rel > 1e-4).any((1, 2))
    assert bad.mean() <= 0.002, f"{bad.mean():.4f} of lanes differ"
    off = J.copy()
    for c in range(3):
        off[:, c, :, c] = 0.0
    assert np.abs(off).max() == 0.0
    assert (np.abs(rows).sum((1, 2)) > 0).mean() > 0.3     # lit lanes
    if mode == "rad":     # linear: value = sum_e rows * radiance
        np.testing.assert_allclose(np.einsum("rec,ec->rc", rows, p0),
                                   out[:3].T, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def jax_grad_rr3(jacobians):
    """The reference's d mean(lum) / d (radiance, albedo) of trace_paths
    (depth 4, rr_depth 3) on the lanes of `jacobians`: the lane mean of
    its luminance-weighted jax.jacfwd (the derivative jax.grad takes in
    reverse mode)."""
    assert ROWS["rad"][0] == 3
    return tuple(np.einsum("rckd,c->kd", jacobians[k][1], LUM_W) / R
                 for k in ("rad", "alb_rr3"))


@pytest.mark.parametrize("entry", ["rad", "alb", "diff"])
def test_entry_point_gradients_match_jax_grad(entry, jacobians, jax_grad_rr3):
    """d mean(lum) / d radiance and / d albedo through the port's entry
    points (their twins on the CPU) against the reference's derivative of
    trace_paths, rtol 5e-3 (tests/test_gradients.py:286-361), the lane
    mean of its luminance-weighted jax.jacfwd: at rr_depth 3 for the
    radiance adjoint and for the replay, which differentiates Russian
    roulette too, in both leaves; for the albedo adjoint RR-free (rr_depth
    100)."""
    scene = cornell_box(32, 32)
    rr = ROWS["alb"][0] if entry == "alb" else 3
    cfg = PathConfig(max_depth=4, rr_depth=rr)
    g_rad, g_alb = jax_grad_rr3
    u_np, J, _ = jacobians["alb"]
    u = torch.from_numpy(u_np)
    rad = scene.emitters.radiance.clone().requires_grad_()
    alb = scene.materials.albedo.clone().requires_grad_()
    if entry == "rad":
        sp = MT.make_mega_trace_rad(scene, cfg, "cpu")(rad, u)
        pairs = [(rad, g_rad)]
    elif entry == "alb":
        sp = MT.make_mega_trace_alb(scene, cfg, "cpu")(alb, u)
        pairs = [(alb, np.einsum("rckd,c->kd", J, LUM_W) / R)]
    else:
        sp = MT.make_mega_trace_diff(scene, cfg, "cpu")(
            {"emitters.radiance": rad, "materials.albedo": alb}, u)
        pairs = [(rad, g_rad), (alb, g_alb)]
    grads = torch.autograd.grad(sp.lum.mean(), [p for p, _ in pairs])
    for g, (_, want) in zip(grads, pairs):
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-3, atol=1e-7)
        assert np.abs(want).max() > 0


def test_replay_matches_finite_differences():
    """The replay gradient against central differences of the port's own
    forward (tests/test_gradients.py:159: the red channel of the white
    walls' albedo, rtol 0.05) and against autograd straight through the
    twin (trace_paths), and the radiance gradient of mean(lum) is
    mean(lum) itself (radiance enters linearly)."""
    scene = cornell_box(32, 32)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    mega = make_path_trace_diff(scene, cfg, "cpu")

    def trace(leaves, u):
        return trace_paths(replace_leaves(scene, leaves), cfg, u)

    u = torch.from_numpy(_u(0, 2048, cfg.n_dims))
    base = scene.materials.albedo

    def loss(fn, a):
        alb = torch.cat([torch.stack([a, base[0, 1], base[0, 2]])[None],
                         base[1:]])
        return fn({"materials.albedo": alb}, u).value[:, 0, 0].mean()

    a = torch.tensor(0.7, requires_grad=True)
    (g,) = torch.autograd.grad(loss(mega, a), a)
    eps = 1e-2
    with torch.no_grad():
        fd = (loss(mega, torch.tensor(0.7 + eps))
              - loss(mega, torch.tensor(0.7 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=0.05)
    assert float(g) > 0
    (g2,) = torch.autograd.grad(loss(trace, a), a)
    np.testing.assert_allclose(float(g2), float(g), rtol=1e-5)

    s = torch.tensor(1.0, requires_grad=True)
    lum = mega({"emitters.radiance": scene.emitters.radiance * s}, u).lum
    (gs,) = torch.autograd.grad(lum.mean(), s)
    np.testing.assert_allclose(float(gs), float(lum.mean().detach()),
                               rtol=1e-4)


def test_replay_chunks_sum_to_one_chunk(monkeypatch):
    """The replay backward in chunks of 256 lanes (four here, the last one
    short) gives the gradients of one chunk, in a material, an emitter and
    a geometry leaf: each chunk's table gradients are summed, then taken
    through the packer once."""
    scene = cornell_box(16, 16)
    cfg = PathConfig(max_depth=3, rr_depth=2)
    u = torch.from_numpy(_u(8, 1000, cfg.n_dims))
    trace = make_path_trace_diff(scene, cfg, "cpu")
    names = ("materials.albedo", "emitters.radiance", "tris.v0")

    def grads():
        leaves = {k: getattr(getattr(scene, k.split(".")[0]),
                             k.split(".")[1]).clone().requires_grad_()
                  for k in names}
        sp = trace(leaves, u)
        return torch.autograd.grad(sp.lum.mean(), list(leaves.values()))

    one = grads()
    monkeypatch.setattr(MT, "REPLAY_CHUNK", 256)
    chunked = grads()
    for k, a, b in zip(names, one, chunked):
        scale = float(a.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6 * scale,
                                   msg=k)


def test_geometry_and_camera_gradients_are_finite():
    """Interior derivatives with respect to geometry and the camera are
    finite and not all zero (the visibility-discontinuity part is out of
    scope), on the Cornell box with each tall box and on the veach door:
    the reverse-mode NaN traps of tests/test_gradients.py:135-156 (a miss
    distance, 1/max(dist^2, eps), sqrt at 0) stay closed."""
    cfg = PathConfig(max_depth=3, rr_depth=100)
    u = torch.from_numpy(_u(5, 1024, cfg.n_dims))
    scenes = [cornell_box(16, 16, tall_box_material=t)
              for t in ("diffuse", "mirror", "glass")] + [veach_door(16, 16)]
    for scene in scenes:
        trace = make_path_trace_diff(scene, cfg, "cpu")
        leaves = {k: getattr(getattr(scene, k.split(".")[0]),
                             k.split(".")[1]).clone().requires_grad_()
                  for k in ("tris.v0", "tris.e1", "tris.e2",
                            "camera.to_world")}
        sp = trace(leaves, u)
        grads = torch.autograd.grad(sp.value.mean(), list(leaves.values()))
        for k, g in zip(leaves, grads):
            assert bool(torch.isfinite(g).all()), k
        assert float(grads[0].abs().sum()) > 0
        assert float(grads[3].abs().sum()) > 0
