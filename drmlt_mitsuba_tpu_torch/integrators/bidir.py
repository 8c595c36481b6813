"""Bidirectional path layer: subpath walks, (s, t) connections, MIS, BDPT
and the selected-strategy MMLT trace (counterpart of
drmlt_mitsuba_tpu/integrators/bidir.py, surfaces only).

`BDPTConfig` fixes the primary-sample layout of an eye subpath and a light
subpath of at most max_depth segments.  Two forms of the MMLT trace:

  * `trace_mmlt` launches the MMLT kernel (ops/megammlt.py) on a CUDA
    device and runs its plain twin on the CPU: pinhole scenes;
  * `trace_mmlt_wavefront` is the reference's XLA `trace_mmlt` as a
    PyTorch wavefront: both subpaths walked batch-wide, then each lane's
    one strategy gathered from them.  It serves the scenes the kernel
    excludes (a thin lens); `trace_mmlt_dense` is its oracle.

The wavefront (`eye_subpath`, `light_subpath`, `_strategies`,
`trace_bdpt` and the two MMLT forms) is plain PyTorch over the port's
intersection kernel: every closest hit goes through
ops/intersect.py:intersect and every shadow ray through `occluded`, which
launch csrc/intersect.cu on a CUDA tensor and run their plain twins on a
CPU tensor.  Subpaths are vertex SoAs (R, V, ...) built slot by slot; each
bounce is one intersection call on all R lanes, dead lanes masked.

Conventions (joined path x_0 .. x_{n-1}, x_0 on the light, x_{n-1} the
camera):
  * strategy s: the light walk makes x_0..x_{s-1}, the eye walk
    x_{n-1}..x_s; t = n - s >= 1 (t = 1 light tracing, s = 0 the eye path
    alone).
  * pdf_fwd / pdf_rev: area pdfs of a vertex from its own chain and from
    the next vertex of the same chain; the balance-heuristic weight is the
    ratio recursion over them, skipping junctions next to Dirac vertices.
  * beta: the throughput arriving at a vertex (importance transport on the
    eye side with the shading-normal correction).

As in the reference, the walks apply no Russian roulette: max_depth alone
bounds them, so the PSS layout stays fixed.  Scope: area emitters start
light walks; an environment row makes an invalid light subpath (its walk
never starts, as the MMLT kernel's does not); point, spot and collimated
emitters, emissive spheres, media and normal maps are not in the port's
scene scope and raise by name.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.frame import (
    coordinate_system, to_local, to_world,
)
from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cdiv, cross, dot, normalize, safe_div,
)
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.core.warp import (
    square_to_cosine_hemisphere, square_to_uniform_triangle,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats
from drmlt_mitsuba_tpu_torch.ops.intersect import (
    intersect, make_ray_tables, occluded,
)
from drmlt_mitsuba_tpu_torch.ops.megatrace import (
    ENV_CONSTANT, mega_eligible, pack_mega_tables_torch, scope_fields,
)
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    eval_bsdf, is_delta, material_rows, sample_bsdf,
)
from drmlt_mitsuba_tpu_torch.render.emitter import (
    env_bilinear, env_dir_to_uv, pick_row,
)
from drmlt_mitsuba_tpu_torch.render.sensor import camera_rays
from drmlt_mitsuba_tpu_torch.render.texture import tex_albedo
from drmlt_mitsuba_tpu_torch.scene.types import (
    EMITTER_AREA, Scene, prepare_scene,
)

EYE_BOUNCE_DIMS = 3    # bsdf component + 2D
LIGHT_START_DIMS = 5   # emitter pick + surface 2D + direction 2D
LIGHT_BOUNCE_DIMS = 3


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """max_depth = max number of segments in a full path (the reference
    bdpt maxDepth).  A full path of n vertices has n-1 segments.  thinlens:
    the camera vertex is a sampled lens point (2 more eye dims).  The
    participating medium is not ported."""
    max_depth: int = 5
    light_image: bool = True   # include t=1 (light tracing) strategies
    thinlens: bool = False
    medium: bool = False

    def __post_init__(self):
        if self.medium:
            raise NotImplementedError(
                "media are not ported to the bidirectional layer")

    @property
    def bounce_dims(self):
        return EYE_BOUNCE_DIMS

    @property
    def n_eye(self):    # camera vertex + surface vertices
        return self.max_depth + 1

    @property
    def n_light(self):  # light-surface vertex + bounce vertices
        return self.max_depth

    @property
    def eye_dims(self):
        # the final walk step samples no direction
        return (2 + (2 if self.thinlens else 0)
                + self.bounce_dims * (self.n_eye - 2))

    @property
    def light_dims(self):
        # the start ray makes bounce vertex 1; BSDF sampling happens at
        # bounce vertices 1..n_light-2 (the last vertex samples nothing)
        return LIGHT_START_DIMS + self.bounce_dims * max(0,
                                                         self.n_light - 2)

    @property
    def n_dims(self):
        return self.eye_dims + self.light_dims

    @property
    def n_splats(self):
        """1 pixel splat + one light-image splat per light-tracing strategy
        (s = 1..n_light)."""
        return 1 + (self.n_light if self.light_image else 0)


# ---------------------------------------------------------------------------
# Scene tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BidirTables:
    """What the wavefront reads, on one device: the scene with its leaves
    there (ops/intersect.py assembles hits from it), the intersection
    kernel's tables, and the packed material, emitter, camera, texture and
    environment tables of ops/megatrace.py."""
    scene: Scene
    rays: object                 # ops/intersect.py:RayTables
    mat: torch.Tensor            # (M, 18)
    em: torch.Tensor             # (E, 20)
    cam: torch.Tensor            # (24,)
    tex: torch.Tensor
    tex_shape: tuple | None
    env_tab: torch.Tensor
    env_shape: tuple | None
    env_mode: int
    kinds: frozenset             # the material table's BSDF kinds

    @property
    def device(self):
        return self.cam.device


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    return x


def make_bidir_tables(scene: Scene, cfg: BDPTConfig, device) -> BidirTables:
    """Check the scene scope (the trace kernels' subset, a thin lens
    included), attach the BVH above BVH_MIN_TRIS triangles and move every
    table to `device`."""
    mega_eligible(scene, cfg)
    scene = prepare_scene(scene)
    tabs = pack_mega_tables_torch(scene, device)
    sf = scope_fields(scene, tabs, cfg.thinlens)
    dscene = dataclasses.replace(
        _to(dataclasses.replace(scene, bvh=None), device), bvh=scene.bvh)
    return BidirTables(
        scene=dscene, rays=make_ray_tables(scene, device),
        mat=tabs[1].contiguous(), em=tabs[2].contiguous(),
        cam=tabs[3].reshape(-1), tex=sf["tex"], tex_shape=sf["tex_shape"],
        env_tab=sf["env_tab"], env_shape=sf["env_shape"],
        env_mode=sf["env_mode"], kinds=sf["kinds"])


def _tables(scene, cfg: BDPTConfig, device) -> BidirTables:
    """`scene` itself when it is already a BidirTables, else its tables on
    `device`."""
    if isinstance(scene, BidirTables):
        return scene
    return make_bidir_tables(scene, cfg, device)


def _camera(tb: BidirTables):
    """(origin, left, up, forward) (3,) each: the camera-to-world columns
    of the packed camera row."""
    c = tb.cam
    return (c[9:12], torch.stack([c[0], c[3], c[6]]),
            torch.stack([c[1], c[4], c[7]]), torch.stack([c[2], c[5], c[8]]))


# ---------------------------------------------------------------------------
# Subpath SoA and pdf helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SubpathSoA:
    """One side's vertices including its endpoint at index 0.

    Eye side: index 0 = camera vertex (positional Dirac).
    Light side: index 0 = emitter-surface vertex.
    """
    valid: torch.Tensor      # (R, V) bool
    p: torch.Tensor          # (R, V, 3)
    ns: torch.Tensor         # (R, V, 3)
    ng: torch.Tensor         # (R, V, 3)
    wi: torch.Tensor         # (R, V, 3) unit dir toward previous vertex
    beta: torch.Tensor       # (R, V, 3)
    pdf_fwd: torch.Tensor    # (R, V) area pdf from own chain
    pdf_rev: torch.Tensor    # (R, V) area pdf of vertex i from vertex i+1
    delta: torch.Tensor      # (R, V) bool
    mat_id: torch.Tensor     # (R, V) int32
    emitter_id: torch.Tensor  # (R, V) int32
    # slot i escaped: the segment leaving vertex i-1 left the scene; wi
    # holds -d of that segment and beta the arriving throughput (valid is
    # False there)
    escaped: torch.Tensor    # (R, V) bool
    uv: torch.Tensor         # (R, V, 2) texture coordinates (0 at ends)


def _sa_to_area(pdf_sa, p_from, p_to, n_to):
    d = p_to - p_from
    dist2 = dot(d, d)
    w = d / torch.sqrt(torch.clamp(dist2, min=1e-20))[..., None]
    cos_to = torch.abs(dot(w, n_to))
    return pdf_sa * safe_div(cos_to, dist2)


def _albedo_uv(tb: BidirTables, mat_id, uv):
    """Material rows (render/bsdf.py:material_rows) with the bitmap albedo
    at texture coordinates uv (R, 2) where the material has a page; uv
    None reads the constant albedo."""
    if tb.tex_shape is None or uv is None:
        return material_rows(tb.mat, mat_id, tb.kinds)
    mid = mat_id.to(torch.int64)
    tid = tb.mat[mid, 17]
    albedo = torch.where(
        (tid >= 0)[:, None],
        tex_albedo(tb.tex, tb.tex_shape, tid, uv[:, 0], uv[:, 1]),
        tb.mat[mid, 1:4])
    return material_rows(tb.mat, mat_id, tb.kinds, albedo)


def _local2(n, a, b):
    """a and b (world) in the local frame of n, one frame for both."""
    s, t = coordinate_system(n)
    return (torch.stack([dot(a, s), dot(a, t), dot(a, n)], -1),
            torch.stack([dot(b, s), dot(b, t), dot(b, n)], -1))


def _edge(tb: BidirTables, mat_id, ns, wi_world, wo_world, uv=None):
    """A vertex's side of a connection edge: (raw f toward wo, the
    solid-angle pdf of wo given wi, and of wi given wo), the reference's
    _edge_shading both ways from one frame and one material lookup (a pdf
    does not read the albedo)."""
    wi, wo = _local2(ns, wi_world, wo_world)
    m = _albedo_uv(tb, mat_id, uv)
    val_cos, pdf = eval_bsdf(m, wi, wo)
    _, pdf_rev = eval_bsdf(m, wo, wi)
    f = val_cos / torch.clamp(torch.abs(wo[..., 2]), min=1e-9)[..., None]
    return f, pdf, pdf_rev


def _bsdf_eval_pdf(tb: BidirTables, mat_id, wi_world, wo_world, ns,
                   uv=None):
    """Raw BSDF f (no cosine) and solid-angle pdf for world directions;
    `uv` reads the textured albedo."""
    f, pdf, _ = _edge(tb, mat_id, ns, wi_world, wo_world, uv)
    return f, pdf


def _bsdf_pdf_sa(tb: BidirTables, mat_id, wi_world, wo_world, ns):
    return _edge(tb, mat_id, ns, wi_world, wo_world)[1]


# ---------------------------------------------------------------------------
# Random walks
# ---------------------------------------------------------------------------

def _walk(tb: BidirTables, o0, d0, beta0, pdf0_sa, src_p, src_ns, n_surface,
          u_bounce, importance_mode: bool, active0=None):
    """Walk out up to n_surface surface vertices from a start ray, one
    intersection call per slot on every lane.

    u_bounce: (R, n_surface, 3) direction dims.  active0: the lanes whose
    walk starts (default all).  Returns a dict of stacked per-vertex
    fields, each (R, n_surface, ...), and src_rev (R,): the area pdf of the
    SOURCE vertex as seen from vertex 1."""
    R = o0.shape[0]
    dev = o0.device
    o, d, beta, pdf_sa = o0, d0, beta0, pdf0_sa
    active = (torch.ones(R, dtype=torch.bool, device=dev) if active0 is None
              else active0)
    prev_p, prev_ns = src_p, src_ns
    vs, prev_revs = [], []
    for step in range(n_surface):
        ub = u_bounce[:, step]
        hit = intersect(tb.scene, o, d, tables=tb.rays)
        wi_world = -d
        valid = active & hit.valid
        p_v, ns_v, ng_v = hit.p, hit.ns, hit.ng
        pdf_area = _sa_to_area(pdf_sa, prev_p, p_v, ng_v)
        m = _albedo_uv(tb, hit.mat_id, hit.tex_uv)
        vs.append(dict(
            valid=valid, p=p_v, ns=ns_v, ng=ng_v, wi=wi_world,
            # beta masked by the walk's activity only (not hit validity):
            # an escaped slot keeps the throughput along the escaping
            # segment for the environment
            beta=torch.where(active[:, None], beta, 0.0),
            pdf_fwd=torch.where(valid, pdf_area, 0.0),
            delta=is_delta(m["kind"]), mat_id=hit.mat_id,
            emitter_id=hit.emitter_id, escaped=active & ~hit.valid,
            uv=hit.tex_uv))

        wi = to_local(ns_v, wi_world)
        bs = sample_bsdf(m, wi, ub[:, 0], ub[:, 1:3])
        wo_world = to_world(ns_v, bs.wo)
        # reverse pdf of the previous vertex: sample wi from wo here; a
        # Dirac bounce stores the same discrete 1 as the forward side
        _, pdf_rev_sa = eval_bsdf(m, bs.wo, wi)
        pdf_rev_sa = torch.where(bs.delta, 1.0, pdf_rev_sa)
        prev_rev = _sa_to_area(pdf_rev_sa, p_v, prev_p, prev_ns)
        prev_revs.append(torch.where(valid, prev_rev, 0.0))

        beta_next = beta * bs.weight
        if importance_mode:
            # shading-normal correction for importance transport (Veach
            # 5.17)
            num = torch.abs(dot(wi_world, ns_v)) * torch.abs(dot(wo_world,
                                                                 ng_v))
            den = torch.abs(dot(wi_world, ng_v)) * torch.abs(dot(wo_world,
                                                                 ns_v))
            beta_next = beta_next * safe_div(num, den, 1.0)[..., None]

        cont = (valid & (luminance(beta_next) > 0)
                & ((bs.pdf > 0) | bs.delta))
        o_next = p_v + wo_world * (RAY_EPS * torch.clamp(hit.t, min=1.0)
                                   )[:, None]
        va = valid[:, None]
        o = torch.where(va, o_next, o)
        d = torch.where(va, wo_world, d)
        beta = torch.where(cont[:, None], beta_next, 0.0)
        pdf_sa = torch.where(bs.delta, 1.0, bs.pdf)
        active = cont
        prev_p = torch.where(va, p_v, prev_p)
        prev_ns = torch.where(va, ns_v, prev_ns)

    if n_surface == 0:
        # a zero-step walk (a depth-1 light subpath) has no vertex 1 to
        # compute the endpoint's reverse pdf from
        empty = dict(valid=torch.zeros((R, 0), dtype=torch.bool, device=dev),
                     pdf_fwd=torch.zeros((R, 0), device=dev),
                     pdf_rev=torch.zeros((R, 0), device=dev))
        return empty, torch.zeros(R, device=dev)
    out = {k: torch.stack([v[k] for v in vs], 1) for k in vs[0]}
    # vertex i's reverse pdf was computed at step i + 1
    out["pdf_rev"] = torch.stack(prev_revs[1:]
                                 + [torch.zeros(R, device=dev)], 1)
    return out, prev_revs[0]


def _cat(a, b):
    return torch.cat([a[:, None], b], 1)


def eye_subpath(scene, cfg: BDPTConfig, u_eye):
    """Camera vertex + up to max_depth surface vertices.  u_eye:
    (R, eye_dims).  Returns (SubpathSoA, film uv (R, 2))."""
    tb = _tables(scene, cfg, u_eye.device)
    R = u_eye.shape[0]
    dev = u_eye.device
    uv = u_eye[:, 0:2]
    o, d = camera_rays(tb.cam, uv[:, 0], uv[:, 1],
                       u_eye[:, 2:4] if cfg.thinlens else None)
    pdf_dir = sensor_pdf_dir(tb, d)
    n_surf = cfg.n_eye - 1
    b0 = 2 + (2 if cfg.thinlens else 0)
    B = cfg.bounce_dims
    u_steps = u_eye[:, b0:b0 + B * (n_surf - 1)].reshape(R, n_surf - 1, B)
    u_b = torch.cat([u_steps, torch.zeros((R, 1, B), device=dev)], 1)
    cam_dir = _camera(tb)[3].expand(R, 3)
    ones3 = torch.ones((R, 3), device=dev)
    walk, _ = _walk(tb, o, d, ones3, pdf_dir, o, cam_dir, n_surf, u_b,
                    importance_mode=True)
    tbool = torch.ones(R, dtype=torch.bool, device=dev)
    soa = SubpathSoA(
        valid=_cat(tbool, walk["valid"]), p=_cat(o, walk["p"]),
        ns=_cat(cam_dir, walk["ns"]), ng=_cat(cam_dir, walk["ng"]),
        wi=_cat(-cam_dir, walk["wi"]), beta=_cat(ones3, walk["beta"]),
        pdf_fwd=_cat(torch.ones(R, device=dev), walk["pdf_fwd"]),
        pdf_rev=_cat(torch.zeros(R, device=dev), walk["pdf_rev"]),
        delta=_cat(tbool, walk["delta"]),
        mat_id=_cat(torch.zeros(R, dtype=torch.int32, device=dev),
                    walk["mat_id"]),
        emitter_id=_cat(torch.full((R,), -1, dtype=torch.int32, device=dev),
                        walk["emitter_id"]),
        escaped=_cat(~tbool, walk["escaped"]),
        uv=_cat(torch.zeros((R, 2), device=dev), walk["uv"]))
    return soa, uv


def light_subpath(scene, cfg: BDPTConfig, u_light):
    """Emitter vertex + up to max_depth-1 bounce vertices: a uniform point
    on an area emitter and a cosine-lobe direction (vertex.cpp
    PathVertex::sampleNext over the emitter supernode).  An environment
    row gives an invalid subpath: its walk does not start."""
    tb = _tables(scene, cfg, u_light.device)
    R = u_light.shape[0]
    dev = u_light.device
    em = tb.em
    row = pick_row(em, u_light[:, 0])
    g = em[row]
    is_area = g[:, 18] == EMITTER_AREA
    b = square_to_uniform_triangle(u_light[:, 1:3])
    p_area = g[:, 6:9] + b[:, 0:1] * g[:, 9:12] + b[:, 1:2] * g[:, 12:15]
    n_area = normalize(cross(g[:, 9:12], g[:, 12:15]))
    zup = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(R, 3)
    p0 = torch.where(is_area[:, None], p_area, 0.0)
    n0 = torch.where(is_area[:, None], n_area, zup)
    pmf, area = g[:, 4], g[:, 3]
    pdf_pos = torch.where(is_area, pmf / torch.clamp(area, min=1e-20), pmf)
    le = g[:, 0:3]
    valid0 = (pmf > 0) & is_area

    d_local = square_to_cosine_hemisphere(u_light[:, 3:5])
    d0 = to_world(n0, d_local)
    pdf_dir = torch.clamp(cdiv(d_local[..., 2], math.pi), min=1e-12)
    cos0 = torch.clamp(d_local[..., 2], min=0.0)
    beta1 = le * safe_div(cos0, pdf_pos * pdf_dir)[:, None]

    n_surf = cfg.n_light - 1
    B = cfg.bounce_dims
    if n_surf >= 1:
        u_rest = u_light[:, LIGHT_START_DIMS:]
        u_steps = u_rest[:, :B * (n_surf - 1)].reshape(R, n_surf - 1, B)
        u_b = torch.cat([u_steps, torch.zeros((R, 1, B), device=dev)], 1)
    else:
        u_b = torch.zeros((R, 0, B), device=dev)
    o0 = p0 + d0 * (RAY_EPS * 10.0)
    walk, src_rev = _walk(tb, o0, d0, beta1, pdf_dir, p0, n0, n_surf, u_b,
                          importance_mode=False, active0=valid0)
    if n_surf == 0:
        z3 = torch.zeros((R, 0, 3), device=dev)
        walk.update(p=z3, ns=z3, ng=z3, wi=z3, beta=z3,
                    delta=walk["valid"], escaped=walk["valid"],
                    mat_id=torch.zeros((R, 0), dtype=torch.int32,
                                       device=dev),
                    emitter_id=torch.zeros((R, 0), dtype=torch.int32,
                                           device=dev),
                    uv=torch.zeros((R, 0, 2), device=dev))
    fbool = torch.zeros(R, dtype=torch.bool, device=dev)
    return SubpathSoA(
        valid=_cat(valid0, walk["valid"]), p=_cat(p0, walk["p"]),
        ns=_cat(n0, walk["ns"]), ng=_cat(n0, walk["ng"]),
        wi=_cat(n0, walk["wi"]),   # unused for the endpoint
        beta=_cat(torch.where(valid0[:, None],
                              le / torch.clamp(pdf_pos, min=1e-20)[:, None],
                              0.0), walk["beta"]),
        pdf_fwd=_cat(pdf_pos, walk["pdf_fwd"]),
        # the emitter endpoint's reverse-chain pdf (from bounce vertex 1)
        # comes back as src_rev; bounce vertex i's sits at walk slot i
        pdf_rev=_cat(src_rev, walk["pdf_rev"]),
        delta=_cat(fbool, walk["delta"]),
        mat_id=_cat(torch.zeros(R, dtype=torch.int32, device=dev),
                    walk["mat_id"]),
        emitter_id=_cat(row.to(torch.int32), walk["emitter_id"]),
        escaped=_cat(fbool, walk["escaped"]),
        uv=_cat(torch.zeros((R, 2), device=dev), walk["uv"]))


# ---------------------------------------------------------------------------
# Sensor importance (perspective: pinhole or thin lens)
# ---------------------------------------------------------------------------

def _film_area(tb: BidirTables):
    return 4.0 * tb.cam[12] * tb.cam[13]


def sensor_pdf_dir(tb: BidirTables, d_world):
    """Solid-angle pdf of a camera ray through a uniform film point:
    p(w) = 1/(A cos^3)."""
    cos = dot(d_world, _camera(tb)[3].expand_as(d_world))
    a = _film_area(tb)
    c = torch.clamp(cos, min=1e-6)
    return torch.where(cos > 1e-6, 1.0 / (a * (c * c * c)), 0.0)


def sensor_importance(tb: BidirTables, d_world, origin=None):
    """(We, film_uv, inside) for a world direction leaving the camera.

    origin: the camera vertex (the sampled lens point of a thin lens);
    None = the camera centre (pinhole).  With the focal-plane film
    mapping, the directional density from any lens point is the pinhole's
    1/(A cos^3), so We keeps the pinhole form and only the film uv moves
    with the lens point: the focal-plane point of the ray is projected
    through the lens centre (src/sensors/thinlens.cpp eval/sampleDirect)."""
    c_o, left, up, fwd = (v.expand_as(d_world) for v in _camera(tb))
    cos = dot(d_world, fwd)
    inv_cos = 1.0 / torch.clamp(cos, min=1e-6)
    if origin is None:
        x_cam = dot(d_world, left) * inv_cos
        y_cam = dot(d_world, up) * inv_cos
    else:
        o_rel = origin - c_o
        ox, oy, oz = dot(o_rel, left), dot(o_rel, up), dot(o_rel, fwd)
        f = torch.clamp(tb.cam[15], min=1e-6)
        t = (f - oz) * inv_cos
        x_cam = (ox + dot(d_world, left) * t) / f
        y_cam = (oy + dot(d_world, up) * t) / f
    u = (x_cam / tb.cam[12] + 1.0) * 0.5
    v = (1.0 - y_cam / tb.cam[13]) * 0.5
    inside = (cos > 1e-6) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    c = torch.clamp(cos, min=1e-6)
    c2 = c * c
    we = torch.where(inside, 1.0 / (_film_area(tb) * (c2 * c2)), 0.0)
    return we, torch.stack([u, v], -1), inside


# ---------------------------------------------------------------------------
# MIS weight (balance heuristic over all (s', t') of the same joined path)
# ---------------------------------------------------------------------------

def _ratio(p_num, p_den):
    return safe_div(torch.where(p_num > 0, p_num, 1.0),
                    torch.where(p_den > 0, p_den, 1.0))


def _mis_weight(cfg: BDPTConfig, L: SubpathSoA, E: SubpathSoA, s: int,
                t: int, pL_jn, pE_jn):
    """Balance-heuristic weight for strategy (s, t) on the joined path.

    pL_jn: the junction-region light-chain area pdfs: 's' (x_s from
    x_{s-1}, the light chain crossing the junction) and 's+1' (x_{s+1}
    from x_s).  pE_jn likewise: 't' (x_{s-1} from x_s as eye chain) and
    't+1' (x_{s-2} from x_{s-1})."""
    R = L.p.shape[0]
    dev = L.p.device
    fbool = torch.zeros(R, dtype=torch.bool, device=dev)
    sum_ri = torch.zeros(R, device=dev)

    # junction toward the light (strategies s' < s): moving it from i + 1
    # to i multiplies by pE[i] / pL[i]
    ri = torch.ones(R, device=dev)
    for i in range(s - 1, -1, -1):
        if i == s - 1:
            pE_i = pE_jn["t"]
        elif i == s - 2:
            pE_i = pE_jn["t+1"]
        else:
            pE_i = L.pdf_rev[:, i]
        ri = ri * _ratio(pE_i, L.pdf_fwd[:, i])
        # the light endpoint's delta flag (positional delta-ness) never
        # blocks the s' = 1 connection, so it never enters as d_lo
        d_lo = L.delta[:, i - 1] if i >= 2 else fbool
        ok = ~(d_lo | L.delta[:, i])
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)

    # junction toward the camera (strategies s' > s); the camera vertex 0
    # cannot be generated by the light chain
    ri = torch.ones(R, device=dev)
    for j in range(t - 1, 0, -1):
        if j == t - 1:
            pL_j = pL_jn["s"]
        elif j == t - 2:
            pL_j = pL_jn["s+1"]
        else:
            pL_j = E.pdf_rev[:, j]
        ri = ri * _ratio(pL_j, E.pdf_fwd[:, j])
        # t' = 1 (light tracing) is valid: the camera vertex is the
        # endpoint, not a junction crossing
        d_hi = E.delta[:, j - 1] if j - 1 >= 1 else fbool
        ok = ~(E.delta[:, j] | d_hi)
        if j == 1 and not cfg.light_image:
            ok = fbool
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------------------------------
# Connections
# ---------------------------------------------------------------------------

def _emission_dir_pdf_area(p_l, n_l, p_to, n_to):
    """Area pdf at p_to of an area emitter's cosine-lobe direction
    sampling from p_l (every emitter row that starts a light walk has
    that lobe)."""
    d = p_to - p_l
    dist = torch.sqrt(torch.clamp(dot(d, d), min=1e-20))
    w = d / dist[..., None]
    cos_l = torch.clamp(dot(w, n_l), min=0.0)
    return _sa_to_area(cdiv(cos_l, math.pi), p_l, p_to, n_to)


def _emitter_pos_pdf(tb: BidirTables, emitter_row):
    em = tb.em
    g = em[torch.clamp(emitter_row, 0, em.shape[0] - 1).to(torch.int64)]
    pdf = g[:, 4] / torch.clamp(g[:, 3], min=1e-20)
    return torch.where(emitter_row >= 0, pdf, 0.0)


def _radiance(tb: BidirTables, row):
    em = tb.em
    return em[torch.clamp(row, 0, em.shape[0] - 1).to(torch.int64), 0:3]


def eval_env(tb: BidirTables, d_world):
    """Environment radiance (R, 3) along escaped directions: the constant
    radiance or the lat-long image (zero without an environment)."""
    if tb.env_mode == ENV_CONSTANT:
        return tb.cam[16:19].expand_as(d_world)
    u, v = env_dir_to_uv(d_world)
    return env_bilinear(tb.env_tab, tb.env_shape, u, v)


def _occluded(tb: BidirTables, o, d, t_max):
    return occluded(tb.scene, o, d, t_max, tables=tb.rays)


def _strategies(tb: BidirTables, cfg: BDPTConfig, L: SubpathSoA,
                E: SubpathSoA, uv, mis: bool = True, only=None):
    """Evaluate every (s, t) connection strategy for the whole batch.

    Yields (s, t, pos (R, 2) film uv, val (R, 3) MIS-weighted
    contribution).  Each strategy alone (mis=False) is an unbiased
    estimator of its path-length transport; only=(s, t) evaluates that
    strategy alone."""
    R = uv.shape[0]
    dev = uv.device
    zero = torch.zeros(R, device=dev)
    one = torch.ones(R, device=dev)

    # ---------------- s = 0: eye path hits an emitter ---------------------
    for t in range(2, cfg.n_eye + 1):
        if only is not None and only != (0, t):
            continue
        ev = t - 1
        hit_row = E.emitter_id[:, ev]
        ok = (E.valid[:, ev] & (hit_row >= 0)
              & (dot(E.wi[:, ev], E.ng[:, ev]) > 0))
        contrib = E.beta[:, ev] * _radiance(tb, hit_row)
        if not mis:
            w = one
        else:
            pL_jn = dict(s=_emitter_pos_pdf(tb, hit_row))
            pL_jn["s+1"] = (_emission_dir_pdf_area(
                E.p[:, ev], E.ng[:, ev], E.p[:, ev - 1], E.ng[:, ev - 1])
                if t >= 3 else zero)
            w = _mis_weight(cfg, L, E, 0, t, pL_jn, {})
        val = torch.where(ok[:, None], contrib * w[:, None], 0.0)
        # the environment on escape, at weight 1: the eye walk is the only
        # strategy that makes environment-terminated paths
        if tb.env_mode:
            le_env = eval_env(tb, -E.wi[:, ev])
            val = val + torch.where(E.escaped[:, ev, None],
                                    E.beta[:, ev] * le_env, 0.0)
        yield 0, t, uv, val

    # ---------------- s >= 1, t >= 2: connections -------------------------
    for s in range(1, cfg.n_light + 1):
        for t in range(2, cfg.n_eye + 1):
            if (s + t - 1) > cfg.max_depth:
                continue
            if only is not None and only != (s, t):
                continue
            lv, ev = s - 1, t - 1
            pl, pe = L.p[:, lv], E.p[:, ev]
            nl, ne = L.ns[:, lv], E.ns[:, ev]
            ngl, nge = L.ng[:, lv], E.ng[:, ev]
            dvec = pe - pl
            dist2 = dot(dvec, dvec)
            dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
            w_le = dvec / dist[..., None]

            # the light endpoint (s = 1) is the exact sampled light point
            l_deltab = L.delta[:, lv] if s > 1 else torch.zeros_like(
                L.valid[:, 0])
            ok = (L.valid[:, lv] & E.valid[:, ev] & ~l_deltab
                  & ~E.delta[:, ev] & (dist2 > 1e-12))
            cos_l = torch.abs(dot(w_le, ngl))
            cos_e = torch.abs(dot(w_le, nge))
            g = safe_div(cos_l * cos_e, dist2)

            if s == 1:
                # the area emitter's endpoint "BSDF": its front face
                f_l = torch.where(dot(w_le, ngl) > 0, 1.0, 0.0)[:, None] \
                    .expand(R, 3)
            else:
                f_l, pdf_l, pdf_l_rev = _edge(tb, L.mat_id[:, lv], nl,
                                              L.wi[:, lv], w_le, L.uv[:, lv])
            f_e, pdf_e, pdf_e_rev = _edge(tb, E.mat_id[:, ev], ne,
                                          E.wi[:, ev], -w_le, E.uv[:, ev])
            contrib = L.beta[:, lv] * f_l * f_e * E.beta[:, ev] * g[:, None]
            ok = ok & (luminance(contrib) > 0)
            sh_o = pl + w_le * (RAY_EPS * torch.clamp(dist, min=1.0))[:, None]
            ok = ok & ~_occluded(tb, sh_o, w_le, dist * (1.0 - 1e-3))

            if mis:
                if s == 1:
                    pL_s = _emission_dir_pdf_area(pl, ngl, pe, nge)
                else:
                    pL_s = _sa_to_area(pdf_l, pl, pe, nge)
                pL_s1 = (_sa_to_area(pdf_e_rev, pe, E.p[:, ev - 1],
                                     E.ng[:, ev - 1]) if t >= 3 else zero)
                pE_t = _sa_to_area(pdf_e, pe, pl, ngl)
                pE_t1 = (_sa_to_area(pdf_l_rev, pl, L.p[:, lv - 1],
                                     L.ng[:, lv - 1]) if s >= 2 else zero)
                w = _mis_weight(cfg, L, E, s, t, {"s": pL_s, "s+1": pL_s1},
                                {"t": pE_t, "t+1": pE_t1})
            else:
                w = one
            yield s, t, uv, torch.where(ok[:, None], contrib * w[:, None],
                                        0.0)

    # ---------------- t = 1: light tracing --------------------------------
    if cfg.light_image:
        cam_p = E.p[:, 0]
        cam_fwd = _camera(tb)[3].expand(R, 3)
        for s in range(1, cfg.n_light + 1):
            if s > cfg.max_depth:
                continue
            if only is not None and only != (s, 1):
                continue
            lv = s - 1
            pl = L.p[:, lv]
            dvec = cam_p - pl
            dist2 = dot(dvec, dvec)
            dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
            w_lc = dvec / dist[..., None]

            we, film_uv, inside = sensor_importance(tb, -w_lc, cam_p)
            ok = L.valid[:, lv] & ~L.delta[:, lv] & inside & (dist2 > 1e-12)
            cos_l = torch.abs(dot(w_lc, L.ng[:, lv]))
            cos_c = torch.abs(dot(w_lc, cam_fwd))
            g = safe_div(cos_l * cos_c, dist2)

            if s == 1:
                f_l = torch.where(dot(w_lc, L.ng[:, 0]) > 0, 1.0,
                                  0.0)[:, None].expand(R, 3)
            else:
                f_l, _, pdf_l_rev = _edge(tb, L.mat_id[:, lv], L.ns[:, lv],
                                          L.wi[:, lv], w_lc, L.uv[:, lv])
            contrib = L.beta[:, lv] * f_l * (g * we)[:, None]
            ok = ok & (luminance(contrib) > 0)
            sh_o = pl + w_lc * (RAY_EPS * torch.clamp(dist, min=1.0))[:, None]
            ok = ok & ~_occluded(tb, sh_o, w_lc, dist * (1.0 - 1e-3))

            if mis:
                pE_t = _sa_to_area(sensor_pdf_dir(tb, -w_lc), cam_p, pl,
                                   L.ng[:, lv])
                pE_t1 = (_sa_to_area(pdf_l_rev, pl, L.p[:, lv - 1],
                                     L.ng[:, lv - 1]) if s >= 2 else zero)
                w = _mis_weight(cfg, L, E, s, 1, {},
                                {"t": pE_t, "t+1": pE_t1})
            else:
                w = one
            yield s, 1, film_uv, torch.where(ok[:, None],
                                             contrib * w[:, None], 0.0)


def _subpaths(tb: BidirTables, cfg: BDPTConfig, u_eye, u_light):
    E, uv = eye_subpath(tb, cfg, u_eye)
    return E, uv, light_subpath(tb, cfg, u_light)


def trace_bdpt(scene, cfg: BDPTConfig, u, mis: bool = True,
               only=None) -> Splats:
    """Full BDPT estimator for a batch of primary samples u (R, n_dims).

    Splat 0 is the pixel splat (every s >= 0, t >= 2 strategy at the
    sample's own pixel); splats 1..n_light are the light-image splats
    (t = 1) for s = 1..n_light (BDPTWorkResult tile + lightImage,
    bdpt_wr.h).  A light-image splat that misses the film carries zero
    value and may carry a position outside [0, 1): film.splat drops it.
    `scene` is a Scene or its BidirTables (make_bdpt_trace builds them
    once).  mis=False / only=(s, t) are the reference's debug hooks."""
    tb = _tables(scene, cfg, u.device)
    R = u.shape[0]
    E, uv, L = _subpaths(tb, cfg, u[:, :cfg.eye_dims], u[:, cfg.eye_dims:])
    pix_val = torch.zeros((R, 3), device=u.device)
    light = ({s: (torch.zeros((R, 2), device=u.device),
                  torch.zeros((R, 3), device=u.device))
              for s in range(1, cfg.n_light + 1)} if cfg.light_image else {})
    for s, t, pos, val in _strategies(tb, cfg, L, E, uv, mis, only):
        if t == 1:
            light[s] = (pos, light[s][1] + val)
        else:
            pix_val = pix_val + val
    pos = torch.stack([uv] + [light[s][0] for s in sorted(light)], 1)
    vals = torch.stack([pix_val] + [light[s][1] for s in sorted(light)], 1)
    return Splats(pos=pos, value=vals, lum=luminance(vals.sum(1)))


def make_bdpt_trace(scene: Scene, cfg: BDPTConfig, device):
    """trace(u) -> Splats of trace_bdpt over u[:, :n_dims] (extra dims,
    the even pad of orbital, are ignored), its tables built once."""
    tb = make_bidir_tables(scene, cfg, device)

    def trace(u):
        return trace_bdpt(tb, cfg, u[:, :cfg.n_dims])

    return trace


def trace_mmlt_dense(scene, cfg: BDPTConfig, u, depth) -> Splats:
    """Every (s, t) strategy batch-wide, masked to each lane's selection
    (the reference's oracle of the selected-strategy trace).

    u (R, 1 + n_dims) = [strategy, eye..., light...]; depth (R,) integer
    path lengths in [1, cfg.max_depth]."""
    tb = _tables(scene, cfg, u.device)
    R = u.shape[0]
    E, uv, L = _subpaths(tb, cfg, u[:, 1:1 + cfg.eye_dims],
                         u[:, 1 + cfg.eye_dims:])
    depth = depth.to(torch.int64)
    n_strats = (depth + 1).to(torch.float32)
    s_pick = torch.minimum((u[:, 0] * n_strats).to(torch.int64), depth)
    pos_out = uv
    val_out = torch.zeros((R, 3), device=u.device)
    for s, t, pos, val in _strategies(tb, cfg, L, E, uv):
        sel = (s_pick == s) & (depth == (s + t - 1))
        val_out = val_out + torch.where(sel[:, None],
                                        val * n_strats[:, None], 0.0)
        if t == 1:
            pos_out = torch.where(sel[:, None], pos, pos_out)
    return Splats(pos=pos_out[:, None, :], value=val_out[:, None, :],
                  lum=luminance(val_out))


def trace_mmlt_wavefront(scene, cfg: BDPTConfig, u, depth) -> Splats:
    """Multiplexed MLT technique (PathSampler::EMMLT, pathsampler.cpp:
    84-320) on the wavefront: each lane evaluates the single (s, t)
    strategy its strategy dim selects for its depth, scaled by nStrats =
    depth + 1 (uniform strategy pmf).  The reference's XLA trace_mmlt.

    u (R, 1 + n_dims) = [strategy, eye..., light...]; depth (R,) integer
    path lengths in [1, cfg.max_depth].  Both subpaths are walked whole;
    the lane's vertices are then gathered (torch indexing), one connection
    made and one shadow ray traced for the batch, and the MIS recursion
    masked over the vertex slots."""
    tb = _tables(scene, cfg, u.device)
    R = u.shape[0]
    dev = u.device
    E, uv, L = _subpaths(tb, cfg, u[:, 1:1 + cfg.eye_dims],
                         u[:, 1 + cfg.eye_dims:])
    depth = depth.to(torch.int64)
    n_strats = (depth + 1).to(torch.float32)
    s_pick = torch.minimum((u[:, 0] * n_strats).to(torch.int64), depth)
    t_pick = depth + 1 - s_pick
    case_hit = s_pick == 0            # (0, depth+1): eye path hits emitter
    case_lt = t_pick == 1             # (depth, 1):   light tracing
    case_conn = ~case_hit & ~case_lt  # general connection

    lanes = torch.arange(R, device=dev)
    lv = torch.clamp(s_pick - 1, 0, cfg.n_light - 1)
    lv0 = torch.clamp(s_pick - 2, 0, cfg.n_light - 1)
    ev = torch.clamp(t_pick - 1, 0, cfg.n_eye - 1)
    ev0 = torch.clamp(t_pick - 2, 0, cfg.n_eye - 1)

    def col(a, idx):
        return a[lanes, idx]

    Lp, Lns, Lng = col(L.p, lv), col(L.ns, lv), col(L.ng, lv)
    Lwi, Lbeta, Lmat = col(L.wi, lv), col(L.beta, lv), col(L.mat_id, lv)
    Lvalid, Ldelta, Luv = col(L.valid, lv), col(L.delta, lv), col(L.uv, lv)
    Lp0, Lng0 = col(L.p, lv0), col(L.ng, lv0)
    Ep, Ens, Eng = col(E.p, ev), col(E.ns, ev), col(E.ng, ev)
    Ewi, Ebeta, Emat = col(E.wi, ev), col(E.beta, ev), col(E.mat_id, ev)
    Evalid, Edelta, Euv = col(E.valid, ev), col(E.delta, ev), col(E.uv, ev)
    Eesc, Ehit_row = col(E.escaped, ev), col(E.emitter_id, ev)
    Ep0, Eng0 = col(E.p, ev0), col(E.ng, ev0)

    # ---- case s = 0: the eye path's vertex IS the emitter ---------------
    ok_hit = (case_hit & Evalid & (Ehit_row >= 0) & (dot(Ewi, Eng) > 0))
    contrib_hit = Ebeta * _radiance(tb, Ehit_row)

    # ---- connection geometry (conn and light tracing share it; for t = 1
    # the "eye vertex" is the camera endpoint at slot 0) ------------------
    dvec = Ep - Lp
    dist2 = dot(dvec, dvec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    w_le = dvec / dist[..., None]
    g = safe_div(torch.abs(dot(w_le, Lng)) * torch.abs(dot(w_le, Eng)),
                 dist2)

    # light end: the area emitter's front face for s = 1, the BSDF else
    is_s1 = s_pick == 1
    f_l_ep = torch.where(dot(w_le, Lng) > 0, 1.0, 0.0)
    f_l_bsdf, pdf_l_fwd_sa, pdf_l_rev_sa = _edge(tb, Lmat, Lns, Lwi, w_le,
                                                 Luv)
    f_l = torch.where(is_s1[:, None], f_l_ep[:, None].expand(R, 3), f_l_bsdf)

    # eye end: the BSDF (t >= 2) or the sensor importance (t = 1)
    f_e_bsdf, pdf_e_fwd_sa, pdf_e_rev_sa = _edge(tb, Emat, Ens, Ewi, -w_le,
                                                 Euv)
    we, film_uv, inside = sensor_importance(tb, -w_le, Ep)
    f_e = torch.where(case_lt[:, None], we[:, None].expand(R, 3), f_e_bsdf)
    contrib_conn = Lbeta * f_l * f_e * Ebeta * g[:, None]

    l_deltab = Ldelta & ~is_s1
    ok_conn = (case_conn & Lvalid & Evalid & ~l_deltab & ~Edelta
               & (dist2 > 1e-12))
    ok_lt = (case_lt & bool(cfg.light_image) & Lvalid & ~Ldelta & inside
             & (dist2 > 1e-12))
    ok_c = (ok_conn | ok_lt) & (luminance(contrib_conn) > 0)

    # one shadow ray for the whole batch (s = 0 lanes get tmax 0)
    sh_o = Lp + w_le * (RAY_EPS * torch.clamp(dist, min=1.0))[:, None]
    ok_c = ok_c & ~_occluded(tb, sh_o, w_le,
                             torch.where(ok_c, dist * (1.0 - 1e-3), 0.0))

    # ---- junction pdfs for the MIS recursion ----------------------------
    pL_s = torch.where(
        case_hit, _emitter_pos_pdf(tb, Ehit_row),
        torch.where(is_s1,
                    _emission_dir_pdf_area(Lp, Lng, Ep, Eng),
                    _sa_to_area(pdf_l_fwd_sa, Lp, Ep, Eng)))
    pL_s1_hit = _emission_dir_pdf_area(Ep, Eng, Ep0, Eng0)
    pL_s1_bsdf = _sa_to_area(pdf_e_rev_sa, Ep, Ep0, Eng0)
    pL_s1 = torch.where(t_pick >= 3,
                        torch.where(case_hit, pL_s1_hit, pL_s1_bsdf), 0.0)
    pE_t = torch.where(
        case_lt, _sa_to_area(sensor_pdf_dir(tb, -w_le), Ep, Lp, Lng),
        _sa_to_area(pdf_e_fwd_sa, Ep, Lp, Lng))
    pE_t1 = torch.where(
        s_pick >= 2,
        _sa_to_area(pdf_l_rev_sa, Lp, Lp0, Lng0),
        0.0)

    # ---- balance-heuristic MIS, mask-controlled over the vertex slots ---
    fbool = torch.zeros(R, dtype=torch.bool, device=dev)
    sum_ri = torch.zeros(R, device=dev)
    ri = torch.ones(R, device=dev)
    for i in reversed(range(cfg.n_light)):      # junction -> light
        pE_i = torch.where(i == s_pick - 1, pE_t,
                           torch.where(i == s_pick - 2, pE_t1,
                                       L.pdf_rev[:, i]))
        in_range = i <= s_pick - 1
        ri = torch.where(in_range, ri * _ratio(pE_i, L.pdf_fwd[:, i]), ri)
        d_lo = L.delta[:, i - 1] if i >= 2 else fbool
        sum_ri = sum_ri + torch.where(in_range & ~(d_lo | L.delta[:, i]),
                                      ri, 0.0)
    rj = torch.ones(R, device=dev)
    for j in reversed(range(1, cfg.n_eye)):     # junction -> camera
        pL_j = torch.where(j == t_pick - 1, pL_s,
                           torch.where(j == t_pick - 2, pL_s1,
                                       E.pdf_rev[:, j]))
        in_range = j <= t_pick - 1
        rj = torch.where(in_range, rj * _ratio(pL_j, E.pdf_fwd[:, j]), rj)
        d_hi = E.delta[:, j - 1] if j - 1 >= 1 else fbool
        ok_j = in_range & ~(E.delta[:, j] | d_hi)
        if not cfg.light_image and j == 1:
            ok_j = fbool
        sum_ri = sum_ri + torch.where(ok_j, rj, 0.0)
    w_mis = 1.0 / (1.0 + sum_ri)

    # ---- combine --------------------------------------------------------
    val = torch.where(ok_hit[:, None], contrib_hit * w_mis[:, None], 0.0)
    if tb.env_mode:
        # the environment on escape, at weight 1 (see _strategies)
        val = val + torch.where((case_hit & Eesc)[:, None],
                                Ebeta * eval_env(tb, -Ewi), 0.0)
    val = val + torch.where(ok_c[:, None], contrib_conn * w_mis[:, None],
                            0.0)
    val = val * n_strats[:, None]
    pos = torch.where(case_lt[:, None], film_uv, uv)
    return Splats(pos=pos[:, None, :], value=val[:, None, :],
                  lum=luminance(val))


def trace_mmlt(scene, cfg: BDPTConfig, u, depth):
    """Selected-strategy MMLT trace (PathSampler::EMMLT) through the MMLT
    kernel: each lane evaluates the one (s, t) strategy its strategy dim
    selects for its depth, scaled by nStrats = depth + 1.

    u (R, 1 + eye_dims + light_dims) = [strategy, eye..., light...];
    depth (R,) integer path lengths in [1, cfg.max_depth].  Returns Splats.
    The kernel's depth dim is set so that it selects `depth`, and its
    uniform depth-pmf factor max_depth is divided out.  The kernel covers
    pinhole scenes; trace_mmlt_wavefront is the same function for any."""
    from drmlt_mitsuba_tpu_torch.ops import megammlt

    D = cfg.max_depth
    tables = megammlt.make_mmlt_tables(scene, cfg, u.device)
    u_depth = ((depth.to(torch.float32) - 0.5) / D)[:, None]
    out = megammlt.mmlt_trace(
        tables, torch.cat([u_depth, u[:, :tables.n_core - 1]], 1)
        .T.contiguous())
    return megammlt.to_splats(out, 1.0 / D)
