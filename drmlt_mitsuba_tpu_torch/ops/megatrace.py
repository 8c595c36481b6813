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
integrators/path.py:trace_paths): pinhole camera ray, brute closest-hit
sweep (strict `<`, so the lower triangle index wins a tie), NEE to one
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

import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cross, dot, mis_power, normalize,
)
from drmlt_mitsuba_tpu_torch.core.frame import to_local, to_world
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.layout import (
    BOUNCE_DIMS, OFF_BSDF_CMP, OFF_BSDF_U, OFF_LIGHT_PICK, OFF_LIGHT_U,
    OFF_RR, SENSOR_DIMS, path_splats,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    SUPPORTED_KINDS, eval_bsdf, is_delta, sample_bsdf,
)
from drmlt_mitsuba_tpu_torch.render.emitter import (
    hit_emission, pick_row, sample_direct,
)
from drmlt_mitsuba_tpu_torch.scene.convert import replace_leaves
from drmlt_mitsuba_tpu_torch.scene.types import (
    BSDF_DIFFUSE, BSDF_ROUGH_DIFFUSE, EMITTER_AREA, Scene,
)

INF = 3.0e38
MAX_TRIS = 4096   # above this the reference switches to clustered traversal

# packed table column layouts (same as the reference)
_TRI_COLS = 20   # v0 e1 e2 n0 n1 n2 mat_id erow
_MAT_COLS = 18   # kind albedo eta k rough spec_refl spec_trans tex_id
_EM_COLS = 20    # rad area pmf cdf v0 e1 e2 ng kind
_CAM_COLS = 24   # R00..R22 t0..t2 thx thy aperture focus env_rgb pad


# ---------------------------------------------------------------- packing
def pack_mega_tables_torch(scene: Scene, device=None):
    """The tri, mat, em and cam tables of the reference's pack_mega_tables
    (megatrace.py:280), built with torch ops on the live scene leaves
    (counterpart of its pack_mega_tables_jnp, :390) on `device` (default:
    the CPU): equal to the reference's tables byte for byte, and
    differentiable in the float leaves (tris.v0 / e1 / e2 / n0-n2,
    materials.*, emitters.radiance / area / pmf / cdf, camera.to_world and
    the camera scalars), wherever those live.  The reference's other six
    tables (spheres, triangle attributes, textures, environment) hold
    nothing the port's kernels read."""
    def f(x):
        return x.to(device=device, dtype=torch.float32)

    tris = scene.tris
    T = tris.v0.shape[0]
    valid = tris.valid.to(device=device, dtype=torch.bool)[:, None]
    tri = torch.cat([
        f(tris.v0), torch.where(valid, f(tris.e1), 0.0),
        torch.where(valid, f(tris.e2), 0.0),
        f(tris.n0), f(tris.n1), f(tris.n2),
        f(tris.mat_id)[:, None], f(tris.emitter_id)[:, None],
    ], 1)

    mats = scene.materials
    mat = torch.cat([
        f(mats.kind)[:, None], f(mats.albedo), f(mats.eta), f(mats.k),
        torch.clamp(f(mats.roughness), min=1e-3)[:, None],
        f(mats.spec_refl), f(mats.spec_trans), f(mats.tex_id)[:, None],
    ], 1)

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
        torch.zeros((E, _EM_COLS - 19), dtype=torch.float32,
                    device=ti.device),
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
    return tri, mat, emt, cam


def mega_eligible(scene: Scene, cfg) -> bool:
    """True when the port's path kernel covers this scene and PathConfig;
    otherwise raises NotImplementedError naming what is not yet ported."""
    missing = []
    if getattr(cfg, "motion", False):
        missing.append("motion blur")
    if getattr(cfg, "thinlens", False) or float(
            scene.camera.aperture_radius) > 0:
        missing.append("thin-lens camera")
    if float(torch.abs(scene.emitters.env_radiance).sum()) > 0:
        missing.append("environment emitter")
    if bool((scene.emitters.kind != EMITTER_AREA).any()):
        missing.append("non-area emitters")
    if bool(scene.spheres.valid.any()):
        missing.append("analytic spheres")
    if bool((scene.materials.tex_id >= 0).any()):
        missing.append("bitmap textures")
    kinds = set(int(k) for k in scene.materials.kind.unique())
    if not kinds.issubset(SUPPORTED_KINDS):
        missing.append(f"BSDF kinds {sorted(kinds - set(SUPPORTED_KINDS))}")
    if scene.tris.v0.shape[0] > MAX_TRIS:
        missing.append(f"BVH traversal (> {MAX_TRIS} triangles)")
    if missing:
        raise NotImplementedError(
            "not yet ported to the CUDA path kernel: " + ", ".join(missing))
    return True


@dataclasses.dataclass(frozen=True)
class TraceTables:
    """Device-resident packed scene tables plus the static path config."""
    tri: torch.Tensor    # (T, 20)
    mat: torch.Tensor    # (M, 18)
    em: torch.Tensor     # (E, 20)
    cam: torch.Tensor    # (24,)
    max_depth: int
    min_depth: int
    rr_depth: int
    use_nee: bool

    technique = "path"

    @property
    def n_dims(self) -> int:
        return SENSOR_DIMS + self.max_depth * BOUNCE_DIMS

    @property
    def device(self):
        return self.tri.device


def make_tables(scene: Scene, cfg, device) -> TraceTables:
    """Check eligibility, pack (pack_mega_tables_torch: the tables carry
    the gradient of any scene leaf that requires one) and move the tables
    to `device`."""
    mega_eligible(scene, cfg)
    tri, mat, emt, cam = (t.contiguous()
                          for t in pack_mega_tables_torch(scene, device))
    return TraceTables(tri=tri, mat=mat, em=emt, cam=cam.reshape(-1),
                       max_depth=cfg.max_depth, min_depth=cfg.min_depth,
                       rr_depth=cfg.rr_depth, use_nee=bool(cfg.use_nee))


def scene_args(tables):
    """The scene tables (tri, T, mat, M, em, E, cam) as the C entry points
    take them."""
    return (tables.tri.data_ptr(), tables.tri.shape[0],
            tables.mat.data_ptr(), tables.mat.shape[0],
            tables.em.data_ptr(), tables.em.shape[0],
            tables.cam.data_ptr())


def table_args(tables: TraceTables):
    """The tables and path config as path_trace_launch takes them."""
    return (*scene_args(tables), tables.max_depth, tables.min_depth,
            tables.rr_depth, int(tables.use_nee))


# ---------------------------------------------------------------- twin
def _sweep(tri, o, d):
    """Möller-Trumbore over every triangle: (R, T) hit distance and hit
    mask (tt > RAY_EPS), in the kernel's evaluation order."""
    v0, e1, e2 = tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9]
    d = d[:, None, :]
    p = cross(d, e2)
    det = dot(e1, p)
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    t = o[:, None, :] - v0
    b1 = dot(t, p) * inv
    q = cross(t, e1)
    b2 = dot(d, q) * inv
    tt = dot(e2, q) * inv
    hit = (ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
           & (tt > RAY_EPS))
    return tt, hit


def closest_hit(tri, o, d):
    """(best_t (R,), best_id (R,) int64, -1 on a miss).

    The sweep runs without autograd; when autograd records (a table, o or
    d requires grad), the winner's distance is recomputed from its row by
    the same expressions, so its value is the sweep's and only (R,)
    tensors, not (R, T) ones, are kept for the backward."""
    with torch.no_grad():
        tt, hit = _sweep(tri, o, d)
        hit = hit & (tt < INF)
        t_m = torch.where(hit, tt, INF)
        best_t = t_m.min(1).values
        first = (hit & (t_m == best_t[:, None])).to(torch.int8).argmax(1)
        best_id = torch.where(best_t < INF, first, -1)
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
def occluded(tri, o, d, tmax):
    tt, hit = _sweep(tri, o, d)
    return (hit & (tt < tmax[:, None])).any(1)


# Work the kernels do, as the twins can count it for a roofline bound:
# ray-triangle tests (Moller-Trumbore: two crosses, four dots, the
# reciprocal, the origin shift, the barycentric and t products and the
# b1 + b2 sum are 46 FP32 operations).  A closest-hit sweep tests every
# triangle; a shadow ray stops at its first occluder, as the kernels'
# loops do.
FLOP_PER_TRI_TEST = 46


def count_sweeps(work, tri, mask, o=None, d=None, tmax=None):
    """Add to work["tri_tests"] the tests the kernels make for the lanes
    in `mask`: every triangle for a closest-hit sweep (tmax None), up to
    the first occluder for a shadow ray."""
    if work is None:
        return
    T = tri.shape[0]
    if tmax is None:
        n = int(mask.sum()) * T
    else:
        tt, hit = _sweep(tri, o, d)
        occ = hit & (tt < tmax[:, None])
        first = occ.to(torch.int8).argmax(1) + 1
        n = int(torch.where(occ.any(1), first, T)[mask].sum())
    work["tri_tests"] = work.get("tri_tests", 0) + n


# gradient modes of the twin (the kernels' kGradEmit / kGradAlbedo)
GRAD_EMIT = "emit"
GRAD_ALBEDO = "albedo"


def _albedo_rows(al, pw, mask, c):
    """d c / d albedo of contributions c (R, 3) with albedo powers pw
    (R, M): c * pw / al where al > 1e-12, else 0 (R, M, 3), masked."""
    g = torch.where(al > 1e-12, pw[:, :, None] / torch.clamp(al, min=1e-12),
                    0.0)
    return torch.where(mask[:, None, None], c[:, None, :] * g, 0.0)


def path_trace_reference(tables: TraceTables, uT, work=None):
    """Plain-PyTorch twin of path_trace_kernel: uT (n_dims, R) -> (3, R).
    With a dict `work`, adds the kernel's ray-triangle tests to it.
    Differentiable in the tables (the replay backward of
    make_mega_trace_diff); its backward is free of inf and NaN."""
    return _trace_reference(tables, uT, work)[0].T.contiguous()


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


def _trace_reference(tables: TraceTables, uT, work=None, grad=None):
    """The path trace of every lane, in the kernels' evaluation order:
    (L (R, 3), Jacobian rows (R, K, 3) in a gradient mode, else None).

    Lanes that have left the path (a miss, a dead throughput) keep being
    evaluated under masks; every value they feed is finite (a miss
    distance of 1, guarded divisions and square roots), so the backward
    through the masks multiplies zeros by finite numbers only."""
    tri, mat, em, cam = tables.tri, tables.mat, tables.em, tables.cam
    R = uT.shape[1]
    dev = uT.device
    max_depth, min_depth = tables.max_depth, tables.min_depth

    # ---- camera ray (pinhole perspective) ------------------------------
    x = (2.0 * uT[0] - 1.0) * cam[12]
    y = (1.0 - 2.0 * uT[1]) * cam[13]
    one = torch.ones(R, device=dev)
    dc = torch.stack([x, y, one], -1)
    d = normalize(torch.stack([dot(cam[0:3].expand(R, 3), dc),
                               dot(cam[3:6].expand(R, 3), dc),
                               dot(cam[6:9].expand(R, 3), dc)], -1))
    o = cam[9:12].expand(R, 3)

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
        best_t, best_id = closest_hit(tri, o, d)
        count_sweeps(work, tri, active)
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
        m = mat[mat_id]
        kind = m[:, 0].to(torch.int64)
        albedo, eta, rough = m[:, 1:4], m[:, 4:7], m[:, 10]
        spec_refl, spec_trans = m[:, 11:14], m[:, 14:17]

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
        active = active & hit_valid

        wi = to_local(ns, -d)
        delta_m = is_delta(kind)
        if grad == GRAD_ALBEDO:
            # this vertex's albedo enters its NEE term and every later one
            dlike = ((kind == BSDF_DIFFUSE) | (kind == BSDF_ROUGH_DIFFUSE)) \
                & active
            pw = pw + (dlike[:, None] & (mat_id[:, None] == m_ids)).to(
                pw.dtype)

        # ---- NEE with an immediate shadow sweep ---------------------------
        if tables.use_nee:
            u_pick = uT[base + OFF_LIGHT_PICK]
            ld, dist, ds_pdf, l_rad = sample_direct(
                em, hp, u_pick, uT[base + OFF_LIGHT_U],
                uT[base + OFF_LIGHT_U + 1])
            f, f_pdf = eval_bsdf(kind, albedo, rough, wi,
                                 to_local(ns, ld))
            nee_ok = active & ~delta_m & (ds_pdf > 0) & (luminance(f) > 0)
            if not (min_depth <= depth + 1 <= max_depth):
                nee_ok = torch.zeros_like(nee_ok)
            eps_sh = RAY_EPS * torch.clamp(t_hit, min=1.0)
            sh_o = hp + ld * eps_sh[:, None]
            sh_tmax = torch.where(nee_ok, dist * (1.0 - 1e-3) - RAY_EPS, 0.0)
            blocked = occluded(tri, sh_o, ld, sh_tmax)
            count_sweeps(work, tri, nee_ok, sh_o, ld, sh_tmax)
            w_nee = mis_power(ds_pdf, f_pdf)
            inv_pdf = torch.where(
                ds_pdf > 0, w_nee / torch.clamp(ds_pdf, min=1e-20), 0.0)
            add = nee_ok & ~blocked
            L = L + torch.where(add[:, None],
                                tp * f * l_rad * inv_pdf[:, None], 0.0)
            if grad == GRAD_EMIT:
                m_e = add[:, None] & (pick_row(em, u_pick)[:, None] == e_ids)
                rows = rows + torch.where(
                    m_e[:, :, None], (tp * f * inv_pdf[:, None])[:, None, :],
                    0.0)
            elif grad == GRAD_ALBEDO:
                rows = rows + _albedo_rows(al, pw, add,
                                           tp * f * l_rad * inv_pdf[:, None])

        # ---- BSDF sampling --------------------------------------------------
        bs = sample_bsdf(kind, albedo, rough, eta, spec_refl, spec_trans, wi,
                         uT[base + OFF_BSDF_CMP],
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


def path_trace(tables: TraceTables, uT):
    """Path radiance (3, R) of the PSS vectors uT (n_dims, R).

    A CUDA tensor launches path_trace_kernel; a CPU tensor runs
    path_trace_reference."""
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
    rc = lib.path_trace_launch(*table_args(tables), uT.data_ptr(), R,
                               out.data_ptr(), stream)
    build.check(rc, "path_trace_kernel")
    build.LAUNCHES["path_trace"] += 1
    return out



# Diffuse-like bounces the albedo kernel keeps per lane
# (csrc/path_trace.cuh:kMaxGradDepth)
MAX_GRAD_DEPTH = 16


def _grad_launch(tables: TraceTables, uT, n_rows, entry, kernel):
    uT = uT.contiguous()
    R = uT.shape[1]
    out = torch.empty((3 + n_rows, R), dtype=torch.float32, device=uT.device)
    lib = build.load()
    stream = torch.cuda.current_stream(uT.device).cuda_stream
    rc = getattr(lib, entry)(*table_args(tables), uT.data_ptr(), R,
                             out.data_ptr(), stream)
    build.check(rc, kernel)
    build.LAUNCHES[kernel.removesuffix("_kernel")] += 1
    return out


def path_trace_rad(tables: TraceTables, uT):
    """(3 + 3E, R): path radiance and its Jacobian rows with respect to
    each emitter's radiance.  A CUDA tensor launches path_trace_rad_kernel;
    a CPU tensor runs path_trace_rad_reference."""
    _check_u(tables, uT)
    if uT.device.type == "cpu":
        return path_trace_rad_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no path kernel for {uT.device}")
    return _grad_launch(tables, uT, 3 * tables.em.shape[0],
                        "path_trace_rad_launch", "path_trace_rad_kernel")


def path_trace_alb(tables: TraceTables, uT):
    """(3 + 3M, R): path radiance and its Jacobian rows with respect to
    each material's albedo.  A CUDA tensor launches path_trace_alb_kernel;
    a CPU tensor runs path_trace_alb_reference."""
    _check_u(tables, uT)
    if tables.max_depth > MAX_GRAD_DEPTH:
        raise ValueError(f"max_depth {tables.max_depth}: the albedo kernel "
                         f"keeps at most {MAX_GRAD_DEPTH} bounces")
    if uT.device.type == "cpu":
        return path_trace_alb_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no path kernel for {uT.device}")
    return _grad_launch(tables, uT, 3 * tables.mat.shape[0],
                        "path_trace_alb_launch", "path_trace_alb_kernel")


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
    if bool((scene.materials.tex_id >= 0).any()):
        raise ValueError("the albedo adjoint takes constant albedos only")
    tables = make_tables(scene, cfg, device)

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
            fields = [f for f in ("tri", "mat", "em", "cam")
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
