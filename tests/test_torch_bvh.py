"""The BVH and the ray-intersection layer: the port's binned-SAH builder
against the reference's, the plain BVH walk against the plain sweep, and
ops/intersect.py's Hit records against the reference's ops/intersect.py
(its XLA `_tri_sweep`, the function its Pallas sweeps compute).

Tolerances: the walk must return the sweep's (t, id) bit for bit (it
tests with the same expressions and breaks ties towards the lower id);
the Hit records agree with the reference's as _assert_hits_equal states
(XLA rounds the sums otherwise in the last bit).
"""
import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.ops import intersect as jax_ix
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.bvh import build_bvh_native, validate_bvh
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import intersect as ix
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.bvh import build_bvh, pack_nodes
from drmlt_mitsuba_tpu_torch.scene.convert import scene_from_arrays
from drmlt_mitsuba_tpu_torch.scene.types import BVH, prepare_scene
from drmlt_mitsuba_tpu_torch.utils.raybench import (
    bumpy_sphere, edge_case, rays,
)
from test_torch_scene import _subset, jax_leaves
from test_torch_xml import large_scenes

torch.set_num_threads(1)

R = 4096


def _arrays(scene):
    return [np.ascontiguousarray(getattr(scene.tris, f).numpy())
            for f in ("v0", "e1", "e2")]


def _native_tree(lib_path, v0, e1, e2, max_leaf):
    """The reference builder's C entry point in `lib_path` (the port's
    build_bvh, called on another library)."""
    lib = ctypes.CDLL(str(lib_path))
    n = len(v0)
    mx = 2 * n
    nmin, nmax = np.zeros((mx, 3), np.float32), np.zeros((mx, 3), np.float32)
    first, count, skip = (np.zeros(mx, np.int32) for _ in range(3))
    order = np.zeros(n, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    f, i = (lambda a: a.ctypes.data_as(fp)), (lambda a: a.ctypes.data_as(ip))
    nn = lib.drmlt_build_bvh(f(v0), f(e1), f(e2), n, max_leaf, f(nmin),
                             f(nmax), i(first), i(count), i(skip), i(order),
                             mx)
    return (nmin[:nn], nmax[:nn], first[:nn], count[:nn], skip[:nn], order)


def test_bvh_matches_reference_builder(tmp_path):
    """The port's copy of the builder, compiled with its fixed flags, gives
    the reference source's tree exactly when that source is compiled with
    the same flags.  The reference's own library (-O3 -march=native, so
    a*b+c may contract to an FMA) can round a bin edge differently and
    split elsewhere: its tree may differ, but it is valid, and walking it
    gives the same hit records."""
    v0, e1, e2 = _arrays(cornell_box(32, 32, tessellate=12))
    got = build_bvh(v0, e1, e2, max_leaf=8)
    lib = tmp_path / "libref.so"
    subprocess.run(["g++", *build.HOST_FLAGS, "-o", str(lib),
                    "native/bvh_builder.cpp"], check=True)
    want = _native_tree(lib, v0, e1, e2, 8)
    for a, b in zip((got.nodes_min, got.nodes_max, got.first, got.count,
                     got.skip, got.order), want):
        np.testing.assert_array_equal(a.numpy(), b)
    ref = build_bvh_native(v0, e1, e2, max_leaf=8)
    assert ref is not None
    jb, jorder = ref
    assert validate_bvh(jb, jorder, v0, e1, e2)
    mine = BVH(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                  for k in ("nodes_min", "nodes_max", "first", "count",
                            "skip")},
               order=torch.from_numpy(jorder))
    assert validate_bvh(
        type(jb)(**{k: jnp.asarray(getattr(got, k).numpy()) for k in
                    ("nodes_min", "nodes_max", "first", "count", "skip")}),
        got.order.numpy(), v0, e1, e2)
    tri = ix.pack_tri_table(cornell_box(32, 32, tessellate=12).tris, "cpu")
    o, d = _cornell_rays(1024, 1)
    a = ix.walk_closest(pack_nodes(mine, tri), o, d)
    nodes = pack_nodes(got, tri)
    b = ix.walk_closest(nodes, o, d)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the 32-byte node records and the leaf-ordered triangle records give
    # back the tree's first / count / skip and the triangle ids, and each
    # record holds its triangle's v0, e1, e2 bits
    assert (got.count < 16).all() and nodes.node.shape == (len(got.skip), 8)
    for x, y in zip(nodes.unpack(), (got.first, got.count, got.skip,
                                     got.order)):
        assert torch.equal(x, y.to(torch.int32))
    rec = nodes.rec.view(torch.int32)
    rows = tri[got.order.long()].view(torch.int32)
    for c in range(3):
        assert torch.equal(rec[:, 4 * c:4 * c + 3], rows[:, 3 * c:3 * c + 3])
    assert not rec[:, [7, 11]].any()


def test_edge_case_meets_the_sweeps_edge_cases():
    """raybench.edge_case, which the GPU tests and the A/B script hold the
    brute kernel on: through the plain sweep, some rays tie on a
    duplicated triangle (the lower id wins), rays parallel to the z-planar
    triangles never hit them (det = 0), and tmax cuts some hits."""
    tables, o, d, tmax = edge_case(40, 3000, "cpu", seed=1)
    tri = tables.tri
    t, i = ix.closest_reference(tables, o, d)
    tc, ic = ix.closest_reference(tables, o, d, tmax)
    hit = i >= 0
    dup = torch.zeros(40, dtype=torch.bool)
    dup[1:] = (tri[1:, :9] == tri[:-1, :9]).all(1)
    assert dup.sum() == 5 and not dup[i[hit].long()].any()
    assert dup[(i[hit] + 1).clamp(max=39).long()].any()     # ties happened
    planar = (tri[:, 5] == 0) & (tri[:, 8] == 0)
    flat = d[:, 2] == 0
    assert flat.sum() == 500 and (flat & hit).any()
    assert not planar[i[flat & hit].long()].any()
    assert ((ic < 0) & hit).any() and torch.equal(ic >= 0, hit & (t < tmax))
    assert torch.equal(ix.any_reference(tables, o, d, tmax), ic >= 0)
    # the pairs the brute kernel tests past b1, as the twins count them
    # (any hit: up to each ray's first occluder in index order)
    tt, h, near = ix.moller_trumbore(tri[None, :, 0:3], tri[None, :, 3:6],
                                     tri[None, :, 6:9], o[:, None],
                                     d[:, None], near=True)
    occ = h & (tt < tmax[:, None])
    stop = torch.where(occ.any(1), occ.to(torch.int8).argmax(1) + 1, 40)
    wc, wa = {}, {}
    ix.sweep_closest(tri, o, d, wc)
    ix.sweep_any(tri, o, d, tmax, wa)
    assert wc == {"tri_tests": 3000 * 40, "tri_past_b1": int(near.sum())}
    assert wa == {"tri_tests": int(stop.sum()), "tri_past_b1": int(
        (near & (torch.arange(40) < stop[:, None])).sum())}
    assert 0 < wa["tri_past_b1"] < wc["tri_past_b1"]


def _cornell_rays(n, seed):
    """Rays from inside the box in every direction, and camera-like rays
    from outside it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(1.0, 555.0, (n, 3)).astype(np.float32)
    o[: n // 4] = np.float32([278.0, 273.0, -800.0])
    d = rng.normal(size=(n, 3))
    d[: n // 4, 2] = np.abs(d[: n // 4, 2]) * 3
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("which", ["cornell", "sphere"])
def test_walk_equals_sweep(which):
    """On 4,096 rays; the scenes are kept under BVH_MIN_TRIS so that the
    plain sweep stays cheap here, and their BVH is built explicitly."""
    if which == "cornell":
        scene = cornell_box(32, 32, tessellate=7)         # 1,668 triangles
        o, d = _cornell_rays(R, 2)
        tmax = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 900, R).astype(np.float32))
    else:
        scene = bumpy_sphere(1800)                        # 1,740 triangles
        o, d = rays(R, "cpu", seed=4)
        tmax = torch.from_numpy(np.random.default_rng(5).uniform(
            0, 6, R).astype(np.float32))
    brute = ix.make_ray_tables(scene, "cpu")
    assert brute.nodes is None
    walk = ix.RayTables(tri=brute.tri, nodes=pack_nodes(
        build_bvh(*_arrays(scene)), brute.tri))
    wk, sw = {}, {}
    t_w, i_w = ix.walk_closest(walk.nodes, o, d, wk)
    t_s, i_s = ix.sweep_closest(brute.tri, o, d, sw)
    assert (i_s >= 0).float().mean() > 0.05
    np.testing.assert_array_equal(t_w.numpy().view(np.uint32),
                                  t_s.numpy().view(np.uint32))
    assert torch.equal(i_w, i_s)
    assert wk["tri_tests"] < sw["tri_tests"] / 20
    any_w = ix.walk_any(walk.nodes, o, d, tmax)
    any_s = ix.sweep_any(brute.tri, o, d, tmax)
    assert torch.equal(any_w, any_s)
    assert 0.01 < float(any_s.float().mean()) < 0.99
    # the wrappers on CPU tensors run these twins and launch nothing
    before = dict(build.LAUNCHES)
    t_x, i_x = ix.closest(walk, o, d, tmax)
    assert build.LAUNCHES == before
    assert torch.equal(i_x, torch.where(t_w < tmax, i_w, -1).int())
    assert torch.equal(ix.any_hit(brute, o, d, tmax), any_s)


def _jax_rays(o, d):
    return jnp.asarray(o.numpy()), jnp.asarray(d.numpy())


# the reference's functions compiled whole (op by op its triangle scan
# takes seconds longer to trace here)
jax_intersect = jax.jit(jax_ix.intersect)
jax_intersect_and_occluded = jax.jit(jax_ix.intersect_and_occluded)


def _assert_hits_equal(hit, ref):
    """The reference's XLA sweep rounds Moller-Trumbore's sums otherwise
    than the port's written-out order (XLA may contract a*b + c), so t
    differs in the last bit on ~5% of rays and a near tie at a shared edge
    can go to the neighbouring triangle: the triangle and sphere ids agree
    on >= 99% of rays (the path twin's lane rule), and there every field
    agrees, floats to rtol 1e-5 with an absolute floor of 1e-6 of the
    scene's size (1e-3 units on the 556-unit box) for t and p, 1e-5 for
    the unit normals and 1e-4 for the barycentrics (a grazing ray's
    barycentrics carry its last-bit differences amplified)."""
    same = (hit.prim.numpy() == np.asarray(ref.prim))
    assert same.mean() >= 0.99, f"{1 - same.mean():.4f} of rays differ"
    for f in ("valid", "mat_id", "emitter_id"):
        a, b = getattr(hit, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a[same], b[same], err_msg=f)
    for f in ("t", "p", "ng", "ns", "uv", "tex_uv"):
        a, b = getattr(hit, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        atol = {"t": 1e-3, "p": 1e-3, "uv": 1e-4, "tex_uv": 1e-4}.get(f, 1e-5)
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=atol,
                                   err_msg=f)


def test_hits_equal_reference_with_spheres():
    """Cornell box with an analytic sphere (the reference builder's
    sphere_material), converted to the port: intersect, occluded and
    intersect_and_occluded give the reference's records."""
    ref_scene = jax_cornell(32, 32, sphere_material="diffuse")
    scene = scene_from_arrays(_subset(jax_leaves(ref_scene)))
    o, d = _cornell_rays(1024, 6)
    tmax = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 900, 1024).astype(np.float32))
    jo, jd = _jax_rays(o, d)
    hit, blocked = ix.intersect_and_occluded(scene, o, d, o, d, tmax)
    ref, jblocked = jax_intersect_and_occluded(ref_scene, jo, jd, jo, jd,
                                               jnp.asarray(tmax.numpy()))
    _assert_hits_equal(hit, ref)
    assert bool((hit.prim < 0).any())                # some rays hit the sphere
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(jblocked))
    assert torch.equal(ix.occluded(scene, o, d, tmax), blocked)
    _assert_hits_equal(ix.intersect(scene, o, d, t_max=tmax),
                       jax_intersect(ref_scene, jo, jd,
                                     jnp.asarray(tmax.numpy())))


def test_hits_equal_reference_on_large_scene():
    """cornell_large.xml (19,586 triangles): the port walks its BVH, the
    reference sweeps every triangle; the records are equal.  The walk
    over the node and triangle records returns the port's sweep's (t, id)
    bit for bit, and makes the box and triangle tests the walk over the
    separate box / link / order tables made before them (counted on these
    rays), so the kernels' bounds do not move."""
    (scene, _), (ref_scene, _) = large_scenes()
    scene = prepare_scene(scene)
    assert scene.bvh is not None
    o, d = _cornell_rays(512, 8)
    tables = ix.make_ray_tables(scene, "cpu")
    hit = ix.intersect(scene, o, d, tables=tables)
    _assert_hits_equal(hit, jax_intersect(ref_scene, *_jax_rays(o, d)))
    assert float(hit.valid.float().mean()) > 0.5
    wc, wa = {}, {}
    t_w, i_w = ix.walk_closest(tables.nodes, o, d, wc)
    t_s, i_s = ix.sweep_closest(tables.tri, o, d)
    assert torch.equal(t_w.view(torch.int32), t_s.view(torch.int32))
    assert torch.equal(i_w, i_s)
    tmax = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 900, 512).astype(np.float32))
    assert torch.equal(ix.walk_any(tables.nodes, o, d, tmax, wa),
                       ix.sweep_any(tables.tri, o, d, tmax))
    assert wc == {"node_tests": 15750, "tri_tests": 2305}
    assert wa == {"node_tests": 8511, "tri_tests": 1119}
