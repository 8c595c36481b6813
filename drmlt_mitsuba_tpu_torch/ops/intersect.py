"""Ray-scene intersection (counterpart of drmlt_mitsuba_tpu/ops/intersect.py):
the intersection kernel, its plain twins, and the `Hit` record.

`closest(tables, o, d, tmax)` and `any_hit(tables, o, d, tmax)` launch
`csrc/intersect.cu`, the port of the reference's three Pallas sweeps: the
brute Moller-Trumbore closest hit `intersect_kernel.py:sweep_closest` (#1)
and `sweep_closest_v2` (#2, the same function in another table layout), and
the BVH-clustered `bvh_kernel.py:sweep_clusters` (#3).  One kernel serves
all three: it sweeps every triangle below BVH_MIN_TRIS and walks the BVH
(csrc/bvh.cuh, the walk every trace kernel takes) above it.  Both modes
call the trace kernels' own device functions, so a hit record here is the
one those kernels see.

The twins, in plain PyTorch: `sweep_closest` / `sweep_any`, a brute sweep
chunked over TRI_CHUNK triangles, and `walk_closest` / `walk_any`, a
vectorised skip-pointer walk over the same node table as the kernel's.
Both test triangles with the kernels' expressions in their order and
break a tie in t towards the lower triangle id, so the walk and the sweep
give the same (t, id) bit for bit.  The wrappers take a twin only for a
tensor on the CPU; a CUDA tensor launches the kernel or raises.

`intersect`, `occluded` and `intersect_and_occluded` (the reference's
:240, :448, :406) return the `Hit` record: spheres are tested in plain
PyTorch, as the reference tests them in XLA, and the hit is assembled with
PyTorch's gathers (the reference's one-hot row fetch is a TPU device).
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cross, dot, normalize, safe_sqrt,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.scene.bvh import NodeTable, pack_nodes
from drmlt_mitsuba_tpu_torch.scene.types import Scene, prepare_scene

INF = 3.0e38
TRI_CHUNK = 256            # triangles per step of the brute twin
RAY_CHUNK = 65536          # and rays: (RAY_CHUNK, TRI_CHUNK) temporaries

# Work the kernels do, as the twins count it for a roofline bound: a
# ray-triangle test (Moller-Trumbore: two crosses, four dots, the
# reciprocal, the origin shift, the barycentric and t products and the
# b1 + b2 sum) is 46 FP32 operations; a ray-box test (two slab products
# of three subtractions and three multiplies each, three min, three max,
# three max for the entry, two min for the exit, the robust factor, the
# cap and the compare) is 26.
FLOP_PER_TRI_TEST = 46
FLOP_PER_NODE_TEST = 26

# csrc/bvh.cuh: a slab exit is widened by 1 + 2 gamma(3) (Ize, "Robust BVH
# ray traversal"), and a direction component below 1e-12 in magnitude is
# clamped to +-1e-12, as the reference's cluster kernel does
# (bvh_kernel.py:88-93)
SLAB_ROBUST = 1.0000004
DIR_EPS = 1e-12


def pack_tri_table(tris, device):
    """The (T, 20) triangle table of the reference's pack_mega_tables
    (megatrace.py:280): v0 e1 e2 n0 n1 n2 mat_id emitter_row, float32, an
    invalid triangle's edges zeroed; differentiable in the float leaves."""
    def f(x):
        return x.to(device=device, dtype=torch.float32)

    valid = tris.valid.to(device=device, dtype=torch.bool)[:, None]
    return torch.cat([
        f(tris.v0), torch.where(valid, f(tris.e1), 0.0),
        torch.where(valid, f(tris.e2), 0.0),
        f(tris.n0), f(tris.n1), f(tris.n2),
        f(tris.mat_id)[:, None], f(tris.emitter_id)[:, None],
    ], 1)


def scene_nodes(scene: Scene, device) -> NodeTable | None:
    """The node table of the scene's BVH (built by prepare_scene above
    BVH_MIN_TRIS triangles), or None below it: the kernels then sweep."""
    scene = prepare_scene(scene)
    return None if scene.bvh is None else pack_nodes(scene.bvh, device)


def node_args(nodes: NodeTable | None):
    """(box, link, order, N) as the C entry points take a node table;
    (NULL, NULL, NULL, 0) without one."""
    if nodes is None:
        return None, None, None, 0
    return (nodes.box.data_ptr(), nodes.link.data_ptr(),
            nodes.order.data_ptr(), nodes.n_nodes)


@dataclasses.dataclass(frozen=True)
class RayTables:
    """What the intersection kernel reads: the triangle table and, above
    BVH_MIN_TRIS triangles, the node table."""
    tri: torch.Tensor            # (T, 20)
    nodes: NodeTable | None

    @property
    def device(self):
        return self.tri.device


def make_ray_tables(scene: Scene, device, walk: bool = True) -> RayTables:
    """The scene's tables on `device`; walk=False drops the BVH, so that
    the kernel sweeps every triangle (brute mode at any size)."""
    return RayTables(tri=pack_tri_table(scene.tris, device).contiguous(),
                     nodes=scene_nodes(scene, device) if walk else None)


# ---------------------------------------------------------------- twins
def moller_trumbore(v0, e1, e2, o, d):
    """Hit distance and hit mask (tt > RAY_EPS) of rays (o, d) against
    triangles (v0, e1, e2), broadcast over the leading axes, in the
    kernels' evaluation order (csrc/path_trace.cuh:tri_hit)."""
    p = cross(d, e2)
    det = dot(e1, p)
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    t = o - v0
    b1 = dot(t, p) * inv
    q = cross(t, e1)
    b2 = dot(d, q) * inv
    tt = dot(e2, q) * inv
    hit = (ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
           & (tt > RAY_EPS))
    return tt, hit


def _add(work, key, n):
    if work is not None:
        work[key] = work.get(key, 0) + int(n)


def _chunk_tests(tri, o, d, start):
    rows = tri[None, start:start + TRI_CHUNK]
    return moller_trumbore(rows[..., 0:3], rows[..., 3:6], rows[..., 6:9],
                           o[:, None, :], d[:, None, :])


@torch.no_grad()
def sweep_closest(tri, o, d, work=None):
    """(t (R,), id (R,) int64, -1 on a miss) over every triangle, TRI_CHUNK
    at a time (RAY_CHUNK rays at a time); the lowest id wins a tie, as in
    the kernel's ordered loop."""
    R, T = o.shape[0], tri.shape[0]
    best_t = torch.full((R,), INF, device=o.device)
    best = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    for r0 in range(0, R, RAY_CHUNK):
        rs = slice(r0, r0 + RAY_CHUNK)
        bt, bi = best_t[rs], best[rs]
        for start in range(0, T, TRI_CHUNK):
            tt, hit = _chunk_tests(tri, o[rs], d[rs], start)
            t_m = torch.where(hit, tt, INF)
            m = t_m.min(1).values
            j = (hit & (t_m == m[:, None])).to(torch.int8).argmax(1)
            better = m < bt
            bi = torch.where(better, start + j, bi)
            bt = torch.where(better, m, bt)
        best_t[rs], best[rs] = bt, bi
    _add(work, "tri_tests", R * T)
    return best_t, best


@torch.no_grad()
def sweep_any(tri, o, d, tmax, work=None):
    """(R,) bool: any hit with RAY_EPS < t < tmax.  With `work`, counts the
    tests of the kernel's loop, which stops at the first occluder."""
    R, T = o.shape[0], tri.shape[0]
    blocked = torch.zeros(R, dtype=torch.bool, device=o.device)
    tests = torch.full((R,), T, dtype=torch.int64, device=o.device)
    for r0 in range(0, R, RAY_CHUNK):
        rs = slice(r0, r0 + RAY_CHUNK)
        bl, ts = blocked[rs], tests[rs]
        for start in range(0, T, TRI_CHUNK):
            tt, hit = _chunk_tests(tri, o[rs], d[rs], start)
            occ = hit & (tt < tmax[rs][:, None])
            first = start + occ.to(torch.int8).argmax(1) + 1
            ts = torch.where(~bl & occ.any(1), first, ts)
            bl = bl | occ.any(1)
        blocked[rs], tests[rs] = bl, ts
    _add(work, "tri_tests", tests.sum())
    return blocked


def _inv_dir(d):
    dd = torch.where(torch.abs(d) < DIR_EPS, torch.copysign(
        torch.full_like(d, DIR_EPS), d), d)
    return 1.0 / dd


def _box_hit(box, o, inv, cap):
    """Slab test of rays against node boxes (R', 8), as csrc/bvh.cuh:
    entered at or before min(exit * SLAB_ROBUST, cap), entry clamped to 0."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 4:7] - o) * inv
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    tnear = torch.clamp(torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]),
                                      tn[:, 2]), min=0.0)
    tfar = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    return tnear <= torch.minimum(tfar * SLAB_ROBUST, cap)


def _leaf_tests(tri, nodes, o, d, lanes, link):
    """Moller-Trumbore of rays `lanes` against the triangles of their
    current leaves: (tt, hit, ids) (R', K), K the largest leaf."""
    first, cnt = link[:, 0].long(), link[:, 1].long()
    K = int(cnt.max())
    k = torch.arange(K, device=o.device)
    slot = torch.clamp(first[:, None] + k, max=nodes.order.shape[0] - 1)
    ids = nodes.order[slot].long()
    rows = tri[ids]
    tt, hit = moller_trumbore(rows[..., 0:3], rows[..., 3:6], rows[..., 6:9],
                              o[lanes][:, None, :], d[lanes][:, None, :])
    return tt, hit & (k < cnt[:, None]), ids


def _walk(tri, nodes: NodeTable, o, d, tmax, closest, work):
    """The kernel's stackless walk for every ray at once: each step tests
    every live ray's current node; a hit inner node goes to the next node,
    a leaf or a missed box to its skip pointer, -1 ends the ray."""
    R = o.shape[0]
    dev = o.device
    inv = _inv_dir(d)
    best_t = torch.full((R,), INF, device=dev) if closest else tmax
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(R, dtype=torch.bool, device=dev)
    lanes = torch.arange(R, device=dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    n_node = n_tri = 0
    while lanes.numel():
        link = nodes.link[node]
        hitb = _box_hit(nodes.box[node], o[lanes], inv[lanes], best_t[lanes])
        n_node += lanes.numel()
        leaf = hitb & (link[:, 1] > 0)
        done = torch.zeros_like(leaf)
        if bool(leaf.any()):
            ll = lanes[leaf]
            tt, hit, ids = _leaf_tests(tri, nodes, o, d, ll, link[leaf])
            n_tri += int(link[leaf, 1].sum())
            if closest:
                bt, bi = best_t[ll], best[ll]
                for j in range(ids.shape[1]):   # the kernel's order in a leaf
                    tj, ij = tt[:, j], ids[:, j]
                    take = hit[:, j] & ((tj < bt) | ((tj == bt) & (ij < bi)))
                    bt = torch.where(take, tj, bt)
                    bi = torch.where(take, ij, bi)
                best_t[ll], best[ll] = bt, bi
            else:
                occ = (hit & (tt < tmax[ll][:, None])).any(1)
                blocked[ll] = occ
                done[leaf] = occ
        nxt = torch.where(hitb & (link[:, 1] == 0), node + 1,
                          link[:, 2].long())
        keep = (nxt >= 0) & ~done
        lanes, node = lanes[keep], nxt[keep]
    _add(work, "node_tests", n_node)
    _add(work, "tri_tests", n_tri)
    return (best_t, best) if closest else blocked


@torch.no_grad()
def walk_closest(tri, nodes: NodeTable, o, d, work=None):
    """(t, id) of the BVH walk; equal to sweep_closest's bit for bit."""
    return _walk(tri, nodes, o, d, None, True, work)


@torch.no_grad()
def walk_any(tri, nodes: NodeTable, o, d, tmax, work=None):
    """Any hit with RAY_EPS < t < tmax by the BVH walk."""
    return _walk(tri, nodes, o, d, tmax, False, work)


def closest_reference(tables: RayTables, o, d, tmax=None, work=None):
    """Twin of the kernel's closest mode: (t (R,) f32, INF on a miss;
    id (R,) int32, -1 on a miss), hits at t >= tmax dropped."""
    if tables.nodes is None:
        t, i = sweep_closest(tables.tri, o, d, work)
    else:
        t, i = walk_closest(tables.tri, tables.nodes, o, d, work)
    if tmax is not None:
        ok = t < tmax
        t, i = torch.where(ok, t, INF), torch.where(ok, i, -1)
    return t, i.to(torch.int32)


def any_reference(tables: RayTables, o, d, tmax, work=None):
    """Twin of the kernel's any-hit mode: (R,) bool."""
    if tables.nodes is None:
        return sweep_any(tables.tri, o, d, tmax, work)
    return walk_any(tables.tri, tables.nodes, o, d, tmax, work)


# ---------------------------------------------------------------- kernel
def _rays(tables: RayTables, o, d, tmax):
    R = o.shape[0]
    for name, x, shape in (("o", o, (R, 3)), ("d", d, (R, 3)),
                           ("tmax", tmax, (R,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}")
        if x.device != tables.device:
            raise ValueError(f"{name} on {x.device}, tables on "
                             f"{tables.device}")
    return o.contiguous(), d.contiguous(), tmax.contiguous()


def _launch(tables: RayTables, o, d, tmax, any_mode, out_t, out_i):
    lib = build.load()
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = lib.intersect_launch(
        tables.tri.data_ptr(), tables.tri.shape[0], *node_args(tables.nodes),
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), o.shape[0],
        int(any_mode), out_t.data_ptr() if out_t is not None else None,
        out_i.data_ptr(), stream)
    build.check(rc, "intersect_kernel")
    build.LAUNCHES["intersect"] += 1


def closest(tables: RayTables, o, d, tmax=None):
    """(t (R,) f32, INF on a miss; id (R,) int32, -1 on a miss) of the
    closest hit with RAY_EPS < t < tmax (default INF).  A CUDA tensor
    launches intersect_kernel; a CPU tensor runs closest_reference."""
    if tmax is None:
        tmax = torch.full((o.shape[0],), INF, device=o.device)
    o, d, tmax = _rays(tables, o, d, tmax)
    if o.device.type == "cpu":
        return closest_reference(tables, o, d, tmax)
    if o.device.type != "cuda":
        raise NotImplementedError(f"no intersection kernel for {o.device}")
    t = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    i = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
    _launch(tables, o, d, tmax, False, t, i)
    return t, i


def any_hit(tables: RayTables, o, d, tmax):
    """(R,) bool: a hit with RAY_EPS < t < tmax.  A CUDA tensor launches
    intersect_kernel; a CPU tensor runs any_reference."""
    o, d, tmax = _rays(tables, o, d, tmax)
    if o.device.type == "cpu":
        return any_reference(tables, o, d, tmax)
    if o.device.type != "cuda":
        raise NotImplementedError(f"no intersection kernel for {o.device}")
    out = torch.empty(o.shape[0], dtype=torch.uint8, device=o.device)
    _launch(tables, o, d, tmax, True, None, out)
    return out.bool()


# ---------------------------------------------------------------- Hit
@dataclasses.dataclass
class Hit:
    """Surface interaction record (the reference's Hit, intersect.py:37)."""
    valid: torch.Tensor       # (R,) bool
    t: torch.Tensor           # (R,)
    p: torch.Tensor           # (R, 3) hit position
    ng: torch.Tensor          # (R, 3) geometric normal (unit)
    ns: torch.Tensor          # (R, 3) shading normal (unit)
    uv: torch.Tensor          # (R, 2) barycentrics (triangle) or (theta,
    #                           phi) / pi (sphere)
    tex_uv: torch.Tensor      # (R, 2) interpolated texture coordinates
    mat_id: torch.Tensor      # (R,) int32
    emitter_id: torch.Tensor  # (R,) int32 (-1 = none)
    prim: torch.Tensor        # (R,) int32 triangle id, or ~sphere id


def _sphere_hits(spheres, o, d, t_max):
    """Closest analytic sphere hit (t (R,), INF on a miss; index (R,))."""
    c = spheres.center.to(o.device)
    oc = o[:, None, :] - c[None]
    b = (oc * d[:, None, :]).sum(-1)
    cc = (oc * oc).sum(-1) - spheres.radius.to(o.device)[None] ** 2
    disc = b * b - cc
    ok = (disc >= 0.0) & spheres.valid.to(o.device)[None]
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > RAY_EPS, t0, t1)
    hit = ok & (t > RAY_EPS) & (t < t_max[:, None])
    t = torch.where(hit, t, INF)
    m = t.min(1)
    return m.values, m.indices.to(torch.int32)


def _barycentrics(tris, ti, o, d):
    """b1, b2 of rays against triangles ti by the sweep's expressions."""
    e1, e2, v0 = tris.e1[ti], tris.e2[ti], tris.v0[ti]
    p = cross(d, e2)
    det = dot(e1, p)
    inv = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    t = o - v0
    return dot(t, p) * inv, dot(d, cross(t, e1)) * inv


def _assemble_hit(scene: Scene, o, d, t_max, tri_t, tri_idx) -> Hit:
    """The reference's _assemble_hit_packed (:330) with PyTorch gathers."""
    dev = o.device
    tris = dataclasses.replace(scene.tris, **{
        f.name: getattr(scene.tris, f.name).to(dev)
        for f in dataclasses.fields(scene.tris)})
    sph = scene.spheres
    hit_tri = tri_idx >= 0
    ti = torch.clamp(tri_idx.long(), 0, tris.v0.shape[0] - 1)
    b1, b2 = _barycentrics(tris, ti, o, d)
    b1 = torch.where(hit_tri, torch.clamp(b1, 0.0, 1.0), 0.0)
    b2 = torch.where(hit_tri, torch.clamp(b2, 0.0, 1.0), 0.0)
    sph_t, sph_idx = _sphere_hits(sph, o, d, t_max)
    use_sph = sph_t < tri_t
    t = torch.where(use_sph, sph_t, tri_t)
    valid = t < INF

    v0, e1, e2 = tris.v0[ti], tris.e1[ti], tris.e2[ti]
    p_tri = v0 + b1[:, None] * e1 + b2[:, None] * e2
    ng_tri = normalize(cross(e1, e2))
    w = 1.0 - b1 - b2
    ns_tri = normalize(w[:, None] * tris.n0[ti] + b1[:, None] * tris.n1[ti]
                       + b2[:, None] * tris.n2[ti])
    tex_tri = (w[:, None] * tris.uv0[ti] + b1[:, None] * tris.uv1[ti]
               + b2[:, None] * tris.uv2[ti])

    si = sph_idx.long()
    # a ray that misses every sphere carries t = INF: a safe t keeps the
    # masked sphere fields finite
    t_sph = torch.where(use_sph, sph_t, 1.0)
    p_sph = o + t_sph[:, None] * d
    ng_sph = normalize(p_sph - sph.center.to(dev)[si])
    uv_sph = torch.stack([
        torch.arccos(torch.clamp(ng_sph[..., 2], -1, 1)) / torch.pi,
        torch.arctan2(ng_sph[..., 1], ng_sph[..., 0]) / (2 * torch.pi) + 0.5,
    ], -1)
    us = use_sph[:, None]
    mat = torch.where(use_sph, sph.mat_id.to(dev)[si], tris.mat_id[ti])
    emit = torch.where(use_sph, sph.emitter_id.to(dev)[si],
                       tris.emitter_id[ti])
    return Hit(
        valid=valid, t=torch.where(valid, t, INF),
        p=torch.where(us, p_sph, p_tri), ng=torch.where(us, ng_sph, ng_tri),
        ns=torch.where(us, ng_sph, ns_tri),
        uv=torch.where(us, uv_sph, torch.stack([b1, b2], -1)),
        tex_uv=torch.where(us, uv_sph, tex_tri),
        mat_id=torch.where(valid, mat, 0).to(torch.int32),
        emitter_id=torch.where(valid, emit, -1).to(torch.int32),
        prim=torch.where(use_sph, ~sph_idx, tri_idx).to(torch.int32))


def intersect(scene: Scene, o, d, t_max=None, tables=None) -> Hit:
    """Closest hit of rays (R, 3) against the triangles (the intersection
    kernel on a CUDA tensor) and spheres.  `tables` (make_ray_tables) may
    be passed to reuse the packed tables."""
    R = o.shape[0]
    if t_max is None:
        t_max = torch.full((R,), INF, device=o.device)
    tables = tables if tables is not None else make_ray_tables(scene,
                                                               o.device)
    tri_t, tri_idx = closest(tables, o, d, t_max)
    return _assemble_hit(scene, o, d, t_max, tri_t, tri_idx)


def occluded(scene: Scene, o, d, t_max, tables=None):
    """Any hit with RAY_EPS < t < t_max (t_max already shortened by the
    caller's epsilon), triangles or spheres."""
    tables = tables if tables is not None else make_ray_tables(scene,
                                                               o.device)
    sph_t, _ = _sphere_hits(scene.spheres, o, d, t_max)
    return any_hit(tables, o, d, t_max) | (sph_t < INF)


def intersect_and_occluded(scene: Scene, o, d, so, sd, s_tmax, tables=None):
    """A closest-hit query (o, d) and a shadow query (so, sd, s_tmax):
    (Hit, blocked)."""
    tables = tables if tables is not None else make_ray_tables(scene,
                                                               o.device)
    return (intersect(scene, o, d, tables=tables),
            occluded(scene, so, sd, s_tmax, tables=tables))
