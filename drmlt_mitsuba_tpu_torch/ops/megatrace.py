"""One whole unidirectional path per lane: the path-trace kernel and its
plain twin.

`path_trace(tables, uT)` launches `csrc/path_trace.cu:path_trace_kernel`,
the port of the reference's Pallas megakernel `megatrace.py:_mega_kernel`
(with its trace body `path_trace_tile`, :832).  `path_trace_reference` is
the same computation in plain PyTorch; the wrapper takes it only for a
tensor on the CPU.  Both consume the primary-sample vectors dim-major,
uT (n_dims, R), in the PSS layout of integrators/layout.py, and return the
path radiance as (3, R).

Semantics follow the reference kernel exactly (which follows
integrators/path.py:trace_paths): pinhole camera ray, closest hit (a brute
sweep, or above BVH_MIN_TRIS triangles the walk of the scene's BVH; the
lower triangle index wins a tie in either), NEE to one
area-light sample with an immediate shadow sweep, power-heuristic MIS,
BSDF sampling, Russian roulette after rr_depth.

`pack_mega_tables_torch` packs the tri, mat, em and cam tables of the
reference's host-side packing (megatrace.py:280-387), column for column,
with torch ops, so they carry the gradient of the scene leaves; it serves
every kernel of the port.

Differentiable rendering (the reference's megatrace.py:1798-2370):
`path_trace_rad` / `path_trace_alb` launch the adjoint kernels of
`csrc/path_trace_grad.cu` (twins `path_trace_rad_reference` /
`path_trace_alb_reference`), which add to each lane's radiance its
Jacobian rows with respect to the emitters' radiance or the materials'
albedo; `make_mega_trace_rad` / `make_mega_trace_alb` wrap them in
autograd Functions whose backward is one einsum, and
`make_mega_trace_diff` runs the path kernel forward and replays the twin
under autograd backward, for any float scene leaf.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cdiv, cross, dot, mis_power, normalize, safe_sqrt,
)
from drmlt_mitsuba_tpu_torch.core.frame import to_local, to_world
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.layout import (
    BOUNCE_DIMS, OFF_BSDF_CMP, OFF_BSDF_U, OFF_LIGHT_PICK, OFF_LIGHT_U,
    OFF_RR, SENSOR_DIMS, path_splats,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops.intersect import (
    FLOP_PER_NODE_TEST, FLOP_PER_TRI_TEST, INF, node_args, pack_tri_table,
    scene_nodes, sweep_any, sweep_closest, tri_ptr, walk_any, walk_closest,
)
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    EXTRA_KINDS, SUPPORTED_KINDS, eval_bsdf, is_delta, material_rows,
    sample_bsdf,
)
from drmlt_mitsuba_tpu_torch.render.emitter import (
    DIR_DIST, env_bilinear, env_dir_to_uv, env_pdf_sa, env_sample,
    hit_emission, pick_row, sample_direct,
)
from drmlt_mitsuba_tpu_torch.render.sensor import camera_rays
from drmlt_mitsuba_tpu_torch.render.texture import tex_albedo
from drmlt_mitsuba_tpu_torch.scene.bvh import NodeTable
from drmlt_mitsuba_tpu_torch.scene.convert import replace_leaves
from drmlt_mitsuba_tpu_torch.scene.types import (
    BSDF_DIFFUSE, BSDF_ROUGH_DIFFUSE, CAMERA_PERSPECTIVE, EMITTER_AREA,
    EMITTER_ENV, Scene,
)

# packed table column layouts (same as the reference)
_TRI_COLS = 20   # v0 e1 e2 n0 n1 n2 mat_id erow
_MAT_COLS = 18   # kind albedo eta k rough spec_refl spec_trans tex_id
_EM_COLS = 20    # rad area pmf cdf v0 e1 e2 ng kind
_CAM_COLS = 24   # R00..R22 t0..t2 thx thy aperture focus env_rgb pad
_SPH_COLS = 8    # center radius mat_id emitter_id valid pad
_TRI_EXT_COLS = 28   # _TRI_COLS, uv0 uv1 uv2, pad
_TEX_COLS = 4    # rgb pad (texels); rgb pmf (environment pixels)

# environment modes of the kernels (csrc/path_trace.cuh: SceneExt)
ENV_NONE, ENV_CONSTANT, ENV_IMAGE = 0, 1, 2

# the path kernel's block (csrc/path_trace.cu:kPathBlock), the unit over
# which it compacts live paths (warp_bounces)
PATH_BLOCK = 256


# ---------------------------------------------------------------- packing
def pack_mega_tables_torch(scene: Scene, device=None):
    """The ten tables of the reference's pack_mega_tables (megatrace.py:280):
    tri, mat, em, cam, sph, tri_ext, tex, env_tab, env_col, env_row, built
    with torch ops on the live scene leaves (counterpart of its
    pack_mega_tables_jnp, :390) on `device` (default: the CPU), equal to
    the reference's byte for byte and differentiable in the float leaves
    (tris.v0 / e1 / e2 / n0-n2 / uv0-uv2, materials.*, emitters.radiance /
    area / pmf / cdf, the sphere, texture and environment leaves,
    camera.to_world and the camera scalars), wherever those live.  tri_ext
    has one row per triangle: the reference pads it to a multiple of 512
    rows for its chunked sweeps, which the port does not have."""
    def f(x):
        return x.to(device=device, dtype=torch.float32)

    tris = scene.tris
    T = tris.v0.shape[0]
    tri = pack_tri_table(tris, device)
    dev = tri.device

    mat = pack_mat_table(scene.materials, device)

    em = scene.emitters
    ti = torch.clamp(em.tri_idx.to(device=device, dtype=torch.int64), 0,
                     T - 1)
    v0e, e1e, e2e = f(tris.v0)[ti], f(tris.e1)[ti], f(tris.e2)[ti]
    ng = cross(e1e, e2e)
    # |ng| as numpy's norm computes it, with a backward free of inf at 0
    n2 = dot(ng, ng)
    norm = torch.where(n2 > 0, torch.sqrt(torch.where(n2 > 0, n2, 1.0)), 0.0)
    ng = ng / torch.clamp(norm, min=1e-20)[:, None]
    E = ti.shape[0]
    emt = torch.cat([
        f(em.radiance), f(em.area)[:, None], f(em.pmf)[:, None],
        f(em.cdf)[:, None], v0e, e1e, e2e, ng, f(em.kind)[:, None],
        torch.zeros((E, _EM_COLS - 19), dtype=torch.float32, device=dev),
    ], 1)

    cam_ = scene.camera
    c2w = f(cam_.to_world)
    cam = torch.cat([
        c2w[:3, :3].reshape(9), c2w[:3, 3],
        f(cam_.tan_half_fov_x).reshape(1), f(cam_.tan_half_fov_y).reshape(1),
        f(cam_.aperture_radius).reshape(1),
        f(cam_.focus_distance).reshape(1), f(em.env_radiance).reshape(3),
        torch.zeros(_CAM_COLS - 19, dtype=torch.float32, device=c2w.device),
    ]).reshape(1, _CAM_COLS)

    sp = scene.spheres
    S = sp.valid.shape[0]
    if S:
        sph = torch.cat([
            f(sp.center), f(sp.radius)[:, None], f(sp.mat_id)[:, None],
            f(sp.emitter_id)[:, None], f(sp.valid)[:, None],
            torch.zeros((S, _SPH_COLS - 7), dtype=torch.float32, device=dev),
        ], 1)
    else:
        sph = torch.zeros((1, _SPH_COLS), dtype=torch.float32, device=dev)

    tri_ext = torch.cat([
        tri, f(tris.uv0), f(tris.uv1), f(tris.uv2),
        torch.zeros((T, _TRI_EXT_COLS - _TRI_COLS - 6), dtype=torch.float32,
                    device=dev)], 1)

    if scene.textures is not None:
        flat = f(scene.textures.data).reshape(-1, 3)
        tex = torch.cat([flat, torch.zeros((flat.shape[0], _TEX_COLS - 3),
                                           dtype=torch.float32, device=dev)],
                        1)
    else:
        tex = torch.zeros((1, _TEX_COLS), dtype=torch.float32, device=dev)

    if em.env_image is not None:
        env_tab = torch.cat([f(em.env_image).reshape(-1, 3),
                             f(em.env_pmf).reshape(-1, 1)], 1)
        env_col = f(em.env_col_cdf)
        env_row = f(em.env_row_cdf)[:, None]
    else:
        env_tab = torch.zeros((1, _TEX_COLS), dtype=torch.float32, device=dev)
        env_col = torch.zeros((1, 1), dtype=torch.float32, device=dev)
        env_row = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    return tri, mat, emt, cam, sph, tri_ext, tex, env_tab, env_col, env_row


def pack_mat_table(mats, device=None):
    """The (M, 18) material table: kind albedo eta k roughness (at least
    1e-3) spec_refl spec_trans tex_id, float32."""
    def f(x):
        return x.to(device=device, dtype=torch.float32)

    return torch.cat([
        f(mats.kind)[:, None], f(mats.albedo), f(mats.eta), f(mats.k),
        torch.clamp(f(mats.roughness), min=1e-3)[:, None],
        f(mats.spec_refl), f(mats.spec_trans), f(mats.tex_id)[:, None],
    ], 1)


def mega_eligible(scene: Scene, cfg) -> bool:
    """True when the port's trace kernels cover this scene and config (the
    reference megakernels' subset, megatrace.py:502-566, without its
    table-size caps); otherwise raises NotImplementedError naming what is
    not yet ported."""
    missing = []
    if getattr(cfg, "motion", False):
        missing.append("motion blur")
    if scene.camera.kind != CAMERA_PERSPECTIVE:
        missing.append(f"camera kind {scene.camera.kind}")
    if (float(scene.camera.aperture_radius) > 0
            and not getattr(cfg, "thinlens", False)):
        missing.append("a lens aperture without PathConfig(thinlens=True)")
    sp = scene.spheres
    if bool((sp.valid & (sp.emitter_id >= 0)).any()):
        missing.append("emissive analytic spheres")
    ekinds = set(int(k) for k in scene.emitters.kind.unique())
    if not ekinds <= {EMITTER_AREA, EMITTER_ENV}:
        missing.append(f"emitter kinds {sorted(ekinds - {0, 4})} (point, "
                       f"spot, directional)")
    if (EMITTER_ENV in ekinds) != (scene.emitters.env_image is not None):
        missing.append("an environment row without its image")
    tex_ids = scene.materials.tex_id
    if bool((tex_ids >= 0).any()) and (
            scene.textures is None
            or int(tex_ids.max()) >= scene.textures.data.shape[0]):
        missing.append("texture ids outside the texture atlas")
    if bool((tex_ids < -1).any()):
        missing.append("per-vertex colors")
    kinds = set(int(k) for k in scene.materials.kind.unique())
    if not kinds.issubset(SUPPORTED_KINDS):
        missing.append(f"BSDF kinds {sorted(kinds - set(SUPPORTED_KINDS))}")
    if missing:
        raise NotImplementedError(
            "not yet ported to the CUDA trace kernels: " + ", ".join(missing))
    return True


def scope_fields(scene: Scene, tables, thinlens: bool) -> dict:
    """The scene-scope fields of TraceTables / MmltTables from the packed
    tables (pack_mega_tables_torch): the six extra tables, their static
    shapes and modes, and `full`, which picks the kernels' full-scope
    instantiation: spheres, bitmap albedo, an environment, a thin lens or
    a BSDF kind beyond slices 1-4 (conductor, rough conductor, null).
    A scene without any of them runs the instantiation of slices 1-4.
    `kinds`, the material table's BSDF kinds, tells the plain BSDF
    (render/bsdf.py) which lobes to evaluate."""
    sph, tri_ext, tex, env_tab, env_col, env_row = (
        t.contiguous() for t in tables[4:])
    em = scene.emitters
    n_sphs = sph.shape[0] if bool(scene.spheres.valid.any()) else 0
    tex_shape = (tuple(scene.textures.data.shape[:3])
                 if scene.textures is not None
                 and bool((scene.materials.tex_id >= 0).any()) else None)
    if em.env_image is not None:
        env_mode, env_shape = ENV_IMAGE, tuple(em.env_image.shape[:2])
        env_row_pick = float(em.pmf[em.kind == EMITTER_ENV].sum())
    else:
        env_mode = (ENV_CONSTANT if float(torch.abs(em.env_radiance).sum())
                    > 0 else ENV_NONE)
        env_shape, env_row_pick = None, 0.0
    kinds = set(int(k) for k in scene.materials.kind.unique())
    full = bool(n_sphs or tex_shape or env_mode or thinlens
                or kinds & set(EXTRA_KINDS))
    return dict(sph=sph, tri_ext=tri_ext, tex=tex, env_tab=env_tab,
                env_col=env_col, env_row=env_row.reshape(-1), n_sphs=n_sphs,
                tex_shape=tex_shape, env_shape=env_shape, env_mode=env_mode,
                env_row_pick=env_row_pick, thinlens=bool(thinlens), full=full,
                kinds=frozenset(kinds))


@dataclasses.dataclass(frozen=True)
class TraceTables:
    """Device-resident packed scene tables plus the static path config;
    `nodes` is the BVH's node table above BVH_MIN_TRIS triangles (the
    kernels and twins walk it), else None (they sweep every triangle).
    The scene-scope fields (scope_fields) carry spheres, the texture
    atlas, the environment and the thin lens."""
    tri: torch.Tensor    # (T, 20)
    mat: torch.Tensor    # (M, 18)
    em: torch.Tensor     # (E, 20)
    cam: torch.Tensor    # (24,)
    max_depth: int
    min_depth: int
    rr_depth: int
    use_nee: bool
    kinds: frozenset     # the material table's BSDF kinds
    nodes: NodeTable | None = None
    sph: torch.Tensor | None = None       # (S, 8)
    tri_ext: torch.Tensor | None = None   # (T, 28)
    tex: torch.Tensor | None = None       # (N * H * W, 4)
    env_tab: torch.Tensor | None = None   # (He * We, 4)
    env_col: torch.Tensor | None = None   # (He, We)
    env_row: torch.Tensor | None = None   # (He,)
    n_sphs: int = 0
    tex_shape: tuple | None = None        # (N, H, W)
    env_shape: tuple | None = None        # (He, We)
    env_mode: int = ENV_NONE
    env_row_pick: float = 0.0
    thinlens: bool = False
    full: bool = False

    technique = "path"

    @property
    def n_dims(self) -> int:
        return SENSOR_DIMS + self.max_depth * BOUNCE_DIMS

    @property
    def device(self):
        return self.tri.device


# the tensors of TraceTables / MmltTables, in the order the packer makes them
TABLE_FIELDS = ("tri", "mat", "em", "cam", "sph", "tri_ext", "tex", "env_tab",
                "env_col", "env_row")


def make_tables(scene: Scene, cfg, device) -> TraceTables:
    """Check eligibility, pack (pack_mega_tables_torch: the tables carry
    the gradient of any scene leaf that requires one) and move the tables
    to `device`, with the node table of the scene's BVH above
    BVH_MIN_TRIS triangles (built here unless prepare_scene attached it)."""
    mega_eligible(scene, cfg)
    tabs = pack_mega_tables_torch(scene, device)
    tri, mat, emt, cam = (t.contiguous() for t in tabs[:4])
    return TraceTables(tri=tri, mat=mat, em=emt, cam=cam.reshape(-1),
                       max_depth=cfg.max_depth, min_depth=cfg.min_depth,
                       rr_depth=cfg.rr_depth, use_nee=bool(cfg.use_nee),
                       nodes=scene_nodes(scene, tri),
                       **scope_fields(scene, tabs,
                                      getattr(cfg, "thinlens", False)))


def scene_args(tables):
    """The scene tables as the C entry points take them: tri, T, mat, M,
    em, E, cam, the node table (node, rec, N; N = 0 without a BVH),
    then the scene scope (sph, S, tri_ext, tex, pages, height, width,
    env_tab, env_col, env_row, He, We, env_mode, env_row_pick, thinlens,
    full; S = 0 without spheres, pages = 0 without bitmap albedo)."""
    pages, th, tw = tables.tex_shape or (0, 0, 0)
    he, we = tables.env_shape or (0, 0)
    return (tri_ptr(tables.tri), tables.tri.shape[0],
            tables.mat.data_ptr(), tables.mat.shape[0],
            tables.em.data_ptr(), tables.em.shape[0],
            tables.cam.data_ptr(), *node_args(tables.nodes),
            tables.sph.data_ptr(), tables.n_sphs, tables.tri_ext.data_ptr(),
            tables.tex.data_ptr(), pages, th, tw, tables.env_tab.data_ptr(),
            tables.env_col.data_ptr(), tables.env_row.data_ptr(), he, we,
            tables.env_mode, tables.env_row_pick, int(tables.thinlens),
            int(tables.full))


def table_args(tables: TraceTables):
    """The tables and path config as path_trace_launch takes them."""
    return (*scene_args(tables), tables.max_depth, tables.min_depth,
            tables.rr_depth, int(tables.use_nee))


# ---------------------------------------------------------------- twin
def closest_hit(tri, o, d, nodes=None):
    """(best_t (R,), best_id (R,) int64, -1 on a miss): the BVH walk when
    `nodes` is given, else the sweep of every triangle (ops/intersect.py;
    the two agree bit for bit).

    The search runs without autograd; when autograd records (a table, o or
    d requires grad), the winner's distance is recomputed from its row by
    the same expressions, so its value is the search's and only (R,)
    tensors are kept for the backward."""
    with torch.no_grad():
        if nodes is None:
            best_t, best_id = sweep_closest(tri, o, d)
        else:
            best_t, best_id = walk_closest(nodes, o, d)
    if torch.is_grad_enabled() and (tri.requires_grad or o.requires_grad
                                    or d.requires_grad):
        w = tri[torch.clamp(best_id, min=0)]
        p = cross(d, w[:, 6:9])
        det = dot(w[:, 3:6], p)
        inv = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
        tt_w = dot(w[:, 6:9], cross(o - w[:, 0:3], w[:, 3:6])) * inv
        best_t = torch.where(best_id >= 0, tt_w, INF)
    return best_t, best_id


@torch.no_grad()
def occluded(tri, o, d, tmax, nodes=None):
    """Any hit with RAY_EPS < t < tmax: the walk when `nodes` is given."""
    if nodes is None:
        return sweep_any(tri, o, d, tmax)
    return walk_any(nodes, o, d, tmax)


@torch.no_grad()
def count_sweeps(work, tri, mask, o, d, tmax=None, nodes=None):
    """Add to work["tri_tests"] (and, walking, work["node_tests"]) the
    tests the kernels make for the lanes in `mask`: a closest-hit search
    (tmax None) or a shadow ray, which stops at its first occluder."""
    if work is None:
        return
    o, d = o[mask], d[mask]
    if tmax is None:
        if nodes is None:
            work["tri_tests"] = work.get("tri_tests", 0) + o.shape[0] \
                * tri.shape[0]
        else:
            walk_closest(nodes, o, d, work)
    elif nodes is None:
        sweep_any(tri, o, d, tmax[mask], work)
    else:
        walk_any(nodes, o, d, tmax[mask], work)


def warp_bounces(active, block=None) -> int:
    """Warp-bounces a path kernel issues for the lanes live at each bounce,
    `active` a list of (R,) bool masks (path_trace_reference's `live`).
    block None:
    one path per thread to its end, so a warp runs every bounce that any
    of its 32 lanes runs; else paths compacted into full warps of
    `block`-thread blocks between bounces, so a block runs ceil(live / 32)
    warps at each bounce (csrc/path_trace.cu)."""
    a = torch.stack(active)
    size = 32 if block is None else block
    a = torch.nn.functional.pad(a, (0, -a.shape[1] % size))
    a = a.reshape(a.shape[0], -1, size)
    if block is None:
        return int(a.any(2).sum())
    return int(((a.sum(2) + 31) // 32).sum())


def work_flop(work) -> int:
    """FP32 operations of the tests counted in `work`."""
    return (work.get("tri_tests", 0) * FLOP_PER_TRI_TEST
            + work.get("node_tests", 0) * FLOP_PER_NODE_TEST)


# gradient modes of the twin (the kernels' kGradEmit / kGradAlbedo)
GRAD_EMIT = "emit"
GRAD_ALBEDO = "albedo"


def _albedo_rows(al, pw, mask, c):
    """d c / d albedo of contributions c (R, 3) with albedo powers pw
    (R, M): c * pw / al where al > 1e-12, else 0 (R, M, 3), masked."""
    g = torch.where(al > 1e-12, pw[:, :, None] / torch.clamp(al, min=1e-12),
                    0.0)
    return torch.where(mask[:, None, None], c[:, None, :] * g, 0.0)


def path_trace_reference(tables: TraceTables, uT, work=None, live=None):
    """Plain-PyTorch twin of path_trace_kernel: uT (n_dims, R) -> (3, R).
    With a dict `work`, adds the kernel's ray-triangle tests to it; with a
    list `live`, appends each bounce's mask of the lanes that run it.
    Differentiable in the tables (the replay backward of
    make_mega_trace_diff); its backward is free of inf and NaN."""
    return _trace_reference(tables, uT, work, live=live)[0].T.contiguous()


def path_trace_rad_reference(tables: TraceTables, uT):
    """Plain-PyTorch twin of path_trace_rad_kernel: (3 + 3E, R), the
    radiance and, in row 3 + 3e + c, d radiance[c] / d em[e, c]."""
    L, rows = _trace_reference(tables, uT, grad=GRAD_EMIT)
    return torch.cat([L.T, rows.permute(1, 2, 0).reshape(-1, L.shape[0])])


def path_trace_alb_reference(tables: TraceTables, uT):
    """Plain-PyTorch twin of path_trace_alb_kernel: (3 + 3M, R), the
    radiance and, in row 3 + 3m + c, d radiance[c] / d albedo[m, c]
    (Russian-roulette survival detached; 0 for a black channel)."""
    L, rows = _trace_reference(tables, uT, grad=GRAD_ALBEDO)
    return torch.cat([L.T, rows.permute(1, 2, 0).reshape(-1, L.shape[0])])


def sphere_closest(sph, n_sphs, o, d, best_t):
    """(t, sphere index, -1 where no sphere is closer than best_t) of the
    analytic spheres, in the kernels' order (megatrace.py:1058)."""
    idx = torch.full_like(best_t, -1, dtype=torch.int64)
    bt = best_t
    for si in range(n_sphs):
        t, ok = _sphere_t(sph[si], o, d)
        hit = ok & (t < bt)
        bt = torch.where(hit, t, bt)
        idx = torch.where(hit, si, idx)
    return bt, idx


def sphere_blocked(sph, n_sphs, o, d, tmax):
    """Any analytic sphere with RAY_EPS < t < tmax (megatrace.py:1089)."""
    blocked = torch.zeros_like(tmax, dtype=torch.bool)
    for si in range(n_sphs):
        t, ok = _sphere_t(sph[si], o, d)
        blocked = blocked | (ok & (t < tmax))
    return blocked


def _sphere_t(row, o, d):
    """Hit distance of rays against one sphere row (center, radius, mat,
    emitter, valid): the near root above RAY_EPS, else the far one."""
    oc = o - row[0:3]
    bq = dot(oc, d)
    cq = dot(oc, oc) - row[3] * row[3]
    disc = bq * bq - cq
    sq = safe_sqrt(disc)
    t0 = -bq - sq
    t1 = -bq + sq
    t = torch.where(t0 > RAY_EPS, t0, t1)
    return t, (disc >= 0.0) & (row[6] > 0.5) & (t > RAY_EPS)


def sphere_uv(n):
    """Lat-long texture coordinates of unit sphere normals (R, 3)
    (ops/intersect.py:uv_sph): (acos(n.z) / pi, atan2(n.y, n.x) / 2pi +
    1/2)."""
    return (cdiv(torch.arccos(torch.clamp(n[:, 2], -1.0, 1.0)), math.pi),
            cdiv(torch.arctan2(n[:, 1], n[:, 0]), 2.0 * math.pi) + 0.5)


def materials_at(tables, mat_id, tu, tv):
    """Per-lane material rows (render/bsdf.py:material_rows), the albedo
    from the texture atlas at (tu, tv) where the material has a page."""
    if tables.tex_shape is None:
        return material_rows(tables.mat, mat_id, tables.kinds)
    mid = mat_id.to(torch.int64)
    tid = tables.mat[mid, 17]
    albedo = torch.where(
        (tid >= 0)[:, None],
        tex_albedo(tables.tex, tables.tex_shape, tid, tu, tv),
        tables.mat[mid, 1:4])
    return material_rows(tables.mat, mat_id, tables.kinds, albedo)


def _trace_reference(tables: TraceTables, uT, work=None, grad=None, live=None):
    """The path trace of every lane, in the kernels' evaluation order:
    (L (R, 3), Jacobian rows (R, K, 3) in a gradient mode, else None).

    Lanes that have left the path (a miss, a dead throughput) keep being
    evaluated under masks; every value they feed is finite (a miss
    distance of 1, guarded divisions and square roots), so the backward
    through the masks multiplies zeros by finite numbers only.  The
    scene-scope features (spheres, bitmap albedo, the environment, the
    thin lens) are evaluated only for tables that carry them."""
    tri, mat, em, cam = tables.tri, tables.mat, tables.em, tables.cam
    R = uT.shape[1]
    dev = uT.device
    max_depth, min_depth = tables.max_depth, tables.min_depth

    # ---- camera ray (pinhole, or thin lens on dims 2-3) -----------------
    one = torch.ones(R, device=dev)
    o, d = camera_rays(cam, uT[0], uT[1], torch.stack([uT[2], uT[3]], -1)
                       if tables.thinlens else None)

    tp = torch.ones((R, 3), device=dev)
    L = torch.zeros((R, 3), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(R, device=dev)
    prev_delta = torch.ones(R, dtype=torch.bool, device=dev)
    eta_scale = torch.ones(R, device=dev)
    rows = None
    if grad == GRAD_EMIT:
        rows = torch.zeros((R, em.shape[0], 3), device=dev)
        e_ids = torch.arange(em.shape[0], device=dev)
    elif grad == GRAD_ALBEDO:
        rows = torch.zeros((R, mat.shape[0], 3), device=dev)
        m_ids = torch.arange(mat.shape[0], device=dev)
        al = mat[:, 1:4].detach()
        pw = torch.zeros((R, mat.shape[0]), device=dev)

    for depth in range(1, max_depth + 1):
        base = SENSOR_DIMS + (depth - 1) * BOUNCE_DIMS
        best_t, best_id = closest_hit(tri, o, d, tables.nodes)
        count_sweeps(work, tri, active, o, d, nodes=tables.nodes)
        if live is not None:
            live.append(active)
        if tables.n_sphs:
            best_t, s_id = sphere_closest(tables.sph, tables.n_sphs, o, d,
                                          best_t)
            use_sph = s_id >= 0
        hit_valid = best_t < INF
        # every use of the distance on a miss is masked; 1 keeps hp finite
        t_hit = torch.where(hit_valid, best_t, 1.0)
        av = torch.where((best_id >= 0)[:, None],
                         tri[torch.clamp(best_id, min=0)], 0.0)
        erow = torch.where(hit_valid, av[:, 19], -1.0).to(torch.int64)
        e1, e2 = av[:, 3:6], av[:, 6:9]

        # hit point, barycentrics, normals
        hp = o + t_hit[:, None] * d
        p = cross(d, e2)
        det = dot(e1, p)
        inv = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
        t = o - av[:, 0:3]
        b1 = torch.clamp(dot(t, p) * inv, 0.0, 1.0)
        b2 = torch.clamp(dot(d, cross(t, e1)) * inv, 0.0, 1.0)
        w0 = 1.0 - b1 - b2
        ng = normalize(cross(e1, e2))
        ns = normalize(w0[:, None] * av[:, 9:12] + b1[:, None] * av[:, 12:15]
                       + b2[:, None] * av[:, 15:18])
        mat_id = av[:, 18].to(torch.int64)
        if tables.n_sphs:
            # an analytic sphere: ng = ns = (hp - center) / radius
            srow = tables.sph[torch.clamp(s_id, min=0)]
            sng = (hp - srow[:, 0:3]) * (
                1.0 / torch.clamp(srow[:, 3], min=1e-20))[:, None]
            ng = torch.where(use_sph[:, None], sng, ng)
            ns = torch.where(use_sph[:, None], sng, ns)
            mat_id = torch.where(use_sph, srow[:, 4].to(torch.int64), mat_id)
            erow = torch.where(use_sph, srow[:, 5].to(torch.int64), erow)
        if tables.tex_shape is not None:
            ext = tables.tri_ext[torch.clamp(best_id, min=0)]
            tu = w0 * ext[:, 20] + b1 * ext[:, 22] + b2 * ext[:, 24]
            tv = w0 * ext[:, 21] + b1 * ext[:, 23] + b2 * ext[:, 25]
            if tables.n_sphs:
                su, sv = sphere_uv(ng)
                tu = torch.where(use_sph, su, tu)
                tv = torch.where(use_sph, sv, tv)
        else:
            tu = tv = None
        m = materials_at(tables, mat_id, tu, tv)
        kind = m["kind"]

        # ---- emission at the hit, MIS'd against NEE at the previous vertex
        e_rad, front, nee_pdf_hit = hit_emission(em, erow, d, ng, t_hit)
        if tables.use_nee:
            w_bsdf = torch.where(prev_delta, 1.0,
                                 mis_power(prev_pdf, nee_pdf_hit))
        else:
            w_bsdf = one
        hit_emitter = (active & hit_valid & (erow >= 0) & front
                       & (depth >= min_depth))
        L = L + torch.where(hit_emitter[:, None],
                            tp * e_rad * w_bsdf[:, None], 0.0)
        if grad == GRAD_EMIT:
            m_e = hit_emitter[:, None] & (erow[:, None] == e_ids)
            rows = rows + torch.where(m_e[:, :, None],
                                      (tp * w_bsdf[:, None])[:, None, :], 0.0)
        elif grad == GRAD_ALBEDO:
            rows = rows + _albedo_rows(al, pw, hit_emitter,
                                       tp * e_rad * w_bsdf[:, None])

        # ---- the environment on escape (constant: no NEE row, weight 1)
        if tables.env_mode:
            escaped = active & ~hit_valid & (depth >= min_depth)
            if tables.env_mode == ENV_CONSTANT:
                c = tp * cam[16:19]
            else:
                eu, ev = env_dir_to_uv(d)
                w_env = one
                if tables.use_nee:
                    e_pdf = env_pdf_sa(tables.env_tab, tables.env_shape, eu,
                                       ev, d[:, 1]) * tables.env_row_pick
                    w_env = torch.where(prev_delta, 1.0,
                                        mis_power(prev_pdf, e_pdf))
                c = tp * env_bilinear(tables.env_tab, tables.env_shape, eu,
                                      ev) * w_env[:, None]
            L = L + torch.where(escaped[:, None], c, 0.0)
            if grad == GRAD_ALBEDO:
                rows = rows + _albedo_rows(al, pw, escaped, c)
        active = active & hit_valid

        wi = to_local(ns, -d)
        if grad == GRAD_ALBEDO:
            # this vertex's albedo enters its NEE term and every later one
            dlike = ((kind == BSDF_DIFFUSE) | (kind == BSDF_ROUGH_DIFFUSE)) \
                & active
            pw = pw + (dlike[:, None] & (mat_id[:, None] == m_ids)).to(
                pw.dtype)

        # ---- NEE with an immediate shadow sweep ---------------------------
        if tables.use_nee:
            u_pick = uT[base + OFF_LIGHT_PICK]
            u_l1, u_l2 = uT[base + OFF_LIGHT_U], uT[base + OFF_LIGHT_U + 1]
            ld, dist, ds_pdf, l_rad = sample_direct(em, hp, u_pick, u_l1,
                                                    u_l2)
            row = pick_row(em, u_pick)
            area_row = None
            if tables.env_mode == ENV_IMAGE:
                # the environment row: the image's importance sampling
                is_env = em[row, 18] == EMITTER_ENV
                area_row = ~is_env
                ed, epdf, erad = env_sample(tables.env_tab, tables.env_col,
                                            tables.env_row, tables.env_shape,
                                            u_l1, u_l2)
                ld = torch.where(is_env[:, None], ed, ld)
                dist = torch.where(is_env, DIR_DIST, dist)
                ds_pdf = torch.where(is_env, em[row, 4] * epdf, ds_pdf)
                l_rad = torch.where(is_env[:, None], erad, l_rad)
            f, f_pdf = eval_bsdf(m, wi, to_local(ns, ld))
            delta_m = is_delta(kind)
            nee_ok = active & ~delta_m & (ds_pdf > 0) & (luminance(f) > 0)
            if not (min_depth <= depth + 1 <= max_depth):
                nee_ok = torch.zeros_like(nee_ok)
            eps_sh = RAY_EPS * torch.clamp(t_hit, min=1.0)
            sh_o = hp + ld * eps_sh[:, None]
            sh_tmax = torch.where(nee_ok, dist * (1.0 - 1e-3) - RAY_EPS, 0.0)
            blocked = occluded(tri, sh_o, ld, sh_tmax, tables.nodes)
            count_sweeps(work, tri, nee_ok, sh_o, ld, sh_tmax, tables.nodes)
            if tables.n_sphs:
                blocked = blocked | sphere_blocked(tables.sph, tables.n_sphs,
                                                   sh_o, ld, sh_tmax)
            w_nee = mis_power(ds_pdf, f_pdf)
            inv_pdf = torch.where(
                ds_pdf > 0, w_nee / torch.clamp(ds_pdf, min=1e-20), 0.0)
            add = nee_ok & ~blocked
            L = L + torch.where(add[:, None],
                                tp * f * l_rad * inv_pdf[:, None], 0.0)
            if grad == GRAD_EMIT:
                # an environment row's radiance is the image's, not its
                # radiance column: no row for it
                m_e = add[:, None] & (row[:, None] == e_ids)
                if area_row is not None:
                    m_e = m_e & area_row[:, None]
                rows = rows + torch.where(
                    m_e[:, :, None], (tp * f * inv_pdf[:, None])[:, None, :],
                    0.0)
            elif grad == GRAD_ALBEDO:
                rows = rows + _albedo_rows(al, pw, add,
                                           tp * f * l_rad * inv_pdf[:, None])

        # ---- BSDF sampling --------------------------------------------------
        bs = sample_bsdf(m, wi, uT[base + OFF_BSDF_CMP],
                         torch.stack([uT[base + OFF_BSDF_U],
                                      uT[base + OFF_BSDF_U + 1]], -1))
        wo = to_world(ns, bs.wo)
        tp = tp * bs.weight
        eta_scale = eta_scale * bs.eta
        alive = active & (luminance(tp) > 0)
        if depth + 1 > max_depth:
            alive = torch.zeros_like(alive)

        # ---- Russian roulette ----------------------------------------------
        if depth >= tables.rr_depth:
            q = torch.clamp(tp.max(-1).values * eta_scale * eta_scale,
                            max=0.95)
            survive = uT[base + OFF_RR] < q
            inv_q = 1.0 / torch.clamp(q, min=1e-8)
            tp = torch.where(survive[:, None], tp * inv_q[:, None], tp)
            alive = alive & survive

        eps_n = RAY_EPS * torch.clamp(t_hit, min=1.0)
        o = torch.where(active[:, None], hp + wo * eps_n[:, None], o)
        d = torch.where(active[:, None], wo, d)
        tp = torch.where(alive[:, None], tp, 0.0)
        prev_pdf = bs.pdf
        prev_delta = bs.delta
        active = alive
    return L, rows


# ---------------------------------------------------------------- kernel
def _check_u(tables: TraceTables, uT):
    if uT.dtype != torch.float32 or uT.dim() != 2:
        raise ValueError("uT must be a 2-D float32 tensor (n_dims, R)")
    if uT.shape[0] < tables.n_dims:
        raise ValueError(f"uT has {uT.shape[0]} dims, the path config "
                         f"reads {tables.n_dims}")
    if uT.device != tables.device:
        raise ValueError(f"uT on {uT.device}, tables on {tables.device}")


def path_trace(tables: TraceTables, uT, compact: bool = True):
    """Path radiance (3, R) of the PSS vectors uT (n_dims, R).

    A CUDA tensor launches path_trace_kernel, which compacts a block's
    live paths into full warps between bounces, or on a scene with a BVH
    one path per thread to its end (compact=False: that on any scene, the
    design the compacting launch is held to bit for bit); a CPU tensor
    runs path_trace_reference."""
    _check_u(tables, uT)
    if uT.device.type == "cpu":
        return path_trace_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no path kernel for {uT.device}")
    uT = uT.contiguous()
    R = uT.shape[1]
    out = torch.empty((3, R), dtype=torch.float32, device=uT.device)
    lib = build.load()
    stream = torch.cuda.current_stream(uT.device).cuda_stream
    rc = lib.path_trace_launch(*table_args(tables), int(compact),
                               uT.data_ptr(), R, out.data_ptr(), stream)
    build.check(rc, "path_trace_kernel")
    build.LAUNCHES[build.scope_key("path_trace", tables)] += 1
    return out



def _grad_launch(tables: TraceTables, uT, K, entry, kernel, compact,
                 counts):
    """Launch an adjoint kernel: (3 + 3K, R), with a (K, R) scratch for the
    albedo kernel's power counts (`counts`), which it uses one path per
    thread and where a lane's rows and counts do not fit in its block's
    shared memory."""
    uT = uT.contiguous()
    R = uT.shape[1]
    out = torch.empty((3 + 3 * K, R), dtype=torch.float32, device=uT.device)
    scratch = (torch.empty((K, R), dtype=torch.float32, device=uT.device)
               if counts else None)
    lib = build.load()
    stream = torch.cuda.current_stream(uT.device).cuda_stream
    rc = getattr(lib, entry)(*table_args(tables), int(compact), uT.data_ptr(),
                             R, out.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             stream)
    build.check(rc, kernel)
    build.LAUNCHES[build.scope_key(kernel.removesuffix("_kernel"), tables)] += 1
    return out


def path_trace_rad(tables: TraceTables, uT, compact: bool = True):
    """(3 + 3E, R): path radiance and its Jacobian rows with respect to
    each emitter's radiance.  A CUDA tensor launches path_trace_rad_kernel,
    which compacts a block's live paths between bounces, or on a scene
    with a BVH one path per thread (compact=False: that on any scene, bit
    for bit the same); a CPU tensor runs path_trace_rad_reference."""
    _check_u(tables, uT)
    if uT.device.type == "cpu":
        return path_trace_rad_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no path kernel for {uT.device}")
    return _grad_launch(tables, uT, tables.em.shape[0],
                        "path_trace_rad_launch", "path_trace_rad_kernel",
                        compact, counts=False)


def path_trace_alb(tables: TraceTables, uT, compact: bool = True):
    """(3 + 3M, R): path radiance and its Jacobian rows with respect to
    each material's albedo, at any max_depth.  A CUDA tensor launches
    path_trace_alb_kernel (compact as path_trace_rad); a CPU tensor runs
    path_trace_alb_reference."""
    _check_u(tables, uT)
    if tables.tex_shape is not None:
        raise ValueError("the albedo adjoint takes constant albedos only")
    if uT.device.type == "cpu":
        return path_trace_alb_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no path kernel for {uT.device}")
    return _grad_launch(tables, uT, tables.mat.shape[0],
                        "path_trace_alb_launch", "path_trace_alb_kernel",
                        compact, counts=True)


# ------------------------------------------------------ differentiable traces
class _AdjointTrace(torch.autograd.Function):
    """value (R, 3) of u through an adjoint kernel; the backward is one
    einsum of the cotangent with the forward's Jacobian rows.  The callers
    take lum outside it (path_splats), so autograd folds the luminance
    weights into the cotangent of value."""

    @staticmethod
    def forward(ctx, param, u, tables, column, launch):
        K = param.shape[0]
        if column == "em":
            em = tables.em.clone()
            em[:, 0:3] = param.detach()
            tables = dataclasses.replace(tables, em=em)
        else:
            mat = tables.mat.clone()
            mat[:, 1:4] = param.detach()
            tables = dataclasses.replace(tables, mat=mat)
        out = launch(tables, u[:, :tables.n_dims].T.contiguous())
        R = out.shape[1]
        ctx.save_for_backward(out[3:].view(K, 3, R))
        ctx.param_device = param.device
        return out[:3].T.contiguous()

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        grad = torch.einsum("rc,kcr->kc", g, rows).to(ctx.param_device)
        return grad, None, None, None, None


def make_mega_trace_rad(scene: Scene, cfg, device="cuda"):
    """trace(radiance (E, 3), u (R, n_dims)) -> Splats, differentiable in
    radiance with an exact backward (counterpart of the reference's
    make_mega_trace_rad, megatrace.py:1825).

    Radiance enters the estimator linearly (emitter hits and NEE; the
    sampling pmf / cdf are separate leaves), so the kernel accumulates the
    per-lane coefficient rows during the forward and the backward is one
    einsum: no replay."""
    tables = make_tables(scene, cfg, device)

    def trace(radiance, u):
        return path_splats(u, _AdjointTrace.apply(radiance, u, tables, "em",
                                                  path_trace_rad))

    return trace


def make_mega_trace_alb(scene: Scene, cfg, device="cuda"):
    """trace(albedo (M, 3), u (R, n_dims)) -> Splats, differentiable in the
    materials' constant albedos (counterpart of the reference's
    make_mega_trace_alb, megatrace.py:1970).

    Contributions are polynomials in each albedo (a diffuse-like bounce
    multiplies the throughput by it), so d value[c] / d al_m[c] = sum over
    contributions of contrib[c] * power_m / al_m[c], accumulated per lane
    in the forward.  Exact for al > 1e-12 (a black channel's derivative is
    lost) and with Russian-roulette survival detached, so equal to the
    derivative of trace_paths only when rr_depth > max_depth."""
    tables = make_tables(scene, cfg, device)
    if tables.tex_shape is not None:
        raise ValueError("the albedo adjoint takes constant albedos only")

    def trace(albedo, u):
        return path_splats(u, _AdjointTrace.apply(albedo, u, tables, "mat",
                                                  path_trace_alb))

    return trace


# lanes per chunk of the replay backward.  closest_hit keeps only the
# winner's (R,) distance for the backward, so a bounce saves a few (R, 3)
# tensors: 8,192 lanes at depth 6 peaked at 50.6 MiB on an H100
# (chip_smoke phase 13), so the 65,536 lanes of a call fit in one chunk,
# and a chunk costs the same host-bound ~0.13 s whatever its size
REPLAY_CHUNK = 65536


class _ReplayTrace(torch.autograd.Function):
    """value (R, 3) of u through the path kernel; the backward replays the
    twin on the same u, chunk by chunk, and differentiates it with
    autograd (the reference replays its XLA trace under jax.vjp,
    megatrace.py:2358-2370)."""

    @staticmethod
    def forward(ctx, u, scene0, cfg, names, *leaves):
        scene = replace_leaves(scene0, {n: v.detach()
                                        for n, v in zip(names, leaves)})
        tables = make_tables(scene, cfg, u.device)
        ctx.scene0, ctx.cfg, ctx.names = scene0, cfg, names
        ctx.save_for_backward(u, *leaves)
        return path_trace(tables, u[:, :cfg.n_dims].T.contiguous()).T \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        u, *leaves = ctx.saved_tensors
        want = [i for i, _ in enumerate(leaves)
                if ctx.needs_input_grad[4 + i]]
        grads = [None] * len(leaves)
        if not want:
            return (None, None, None, None, *grads)
        cfg = ctx.cfg
        with torch.enable_grad():
            live = {n: v.detach().requires_grad_(i in want)
                    for i, (n, v) in enumerate(zip(ctx.names, leaves))}
            tables = make_tables(replace_leaves(ctx.scene0, live), cfg,
                                 u.device)
            # the chunks differentiate with respect to the tables; one
            # backward through the packer then takes the summed table
            # gradients to the leaves
            fields = [f for f in TABLE_FIELDS
                      if getattr(tables, f).requires_grad]
            packed = [getattr(tables, f) for f in fields]
            inputs = [t.detach().requires_grad_() for t in packed]
            chunk_tables = dataclasses.replace(tables,
                                               **dict(zip(fields, inputs)))
            if packed:        # else no wanted leaf reaches the tables
                g_tables = [torch.zeros_like(t) for t in packed]
                for start in range(0, u.shape[0], REPLAY_CHUNK):
                    sl = slice(start, start + REPLAY_CHUNK)
                    L = path_trace_reference(
                        chunk_tables, u[sl, :cfg.n_dims].T.contiguous())
                    part = torch.autograd.grad((L.T * g[sl]).sum(), inputs,
                                               allow_unused=True)
                    for gt, p in zip(g_tables, part):
                        if p is not None:
                            gt += p
                part = torch.autograd.grad(
                    packed, [live[ctx.names[i]] for i in want], g_tables,
                    allow_unused=True)
                for i, gi in zip(want, part):
                    grads[i] = gi
        for i in want:
            if grads[i] is None:
                grads[i] = torch.zeros_like(leaves[i])
        return (None, None, None, None, *grads)


def make_mega_trace_diff(scene: Scene, cfg, device="cuda"):
    """trace(leaves, u) -> Splats, differentiable in any float scene leaf
    (counterpart of the reference's make_mega_trace_diff,
    megatrace.py:2252): the forward runs the path kernel, the backward
    replays path_trace_reference on the same u under autograd.

    `leaves` maps dotted leaf names ("materials.albedo",
    "emitters.radiance", "tris.v0", "camera.to_world", ...) to the live
    tensors that replace `scene`'s; an autograd Function routes gradients
    only to its tensor arguments, so they are passed explicitly."""
    mega_eligible(scene, cfg)
    device = torch.device(device)

    def trace(leaves, u):
        if u.device.type != device.type:
            raise ValueError(f"u on {u.device}, the trace on {device}")
        names = sorted(leaves)
        value = _ReplayTrace.apply(u, scene, cfg, tuple(names),
                                   *(leaves[n] for n in names))
        return path_splats(u, value)

    return trace
