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

`pack_mega_tables` is a numpy copy of the reference's host-side packing
(megatrace.py:280-387), with the same column layouts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cross, dot, mis_power, normalize,
)
from drmlt_mitsuba_tpu_torch.core.frame import to_local, to_world
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.layout import (
    BOUNCE_DIMS, OFF_BSDF_CMP, OFF_BSDF_U, OFF_LIGHT_PICK, OFF_LIGHT_U,
    OFF_RR, SENSOR_DIMS,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    SUPPORTED_KINDS, eval_bsdf, is_delta, sample_bsdf,
)
from drmlt_mitsuba_tpu_torch.render.emitter import hit_emission, sample_direct
from drmlt_mitsuba_tpu_torch.scene.types import EMITTER_AREA, Scene

INF = 3.0e38
MAX_TRIS = 4096   # above this the reference switches to clustered traversal

# packed table column layouts (same as the reference)
_TRI_COLS = 20   # v0 e1 e2 n0 n1 n2 mat_id erow
_MAT_COLS = 18   # kind albedo eta k rough spec_refl spec_trans tex_id
_EM_COLS = 20    # rad area pmf cdf v0 e1 e2 ng kind
_CAM_COLS = 24   # R00..R22 t0..t2 thx thy aperture focus env_rgb pad
_SPH_COLS = 8    # center radius mat_id emitter_id valid pad
_TRI_EXT_COLS = 28  # _TRI_COLS attrs + uv0 uv1 uv2 + pad
_TEX_COLS = 4    # rgb + pad


# ---------------------------------------------------------------- packing
def pack_mega_tables(scene: Scene):
    """Host-side tables (numpy): tri, mat, emt, cam, sph, tri_ext, tex,
    env_tab, env_col, env_row.  The port's scenes carry no textures and no
    image environment, so those four are the reference's zero
    placeholders."""
    tris = scene.tris
    v0 = tris.v0.numpy().astype(np.float32)
    e1 = tris.e1.numpy().astype(np.float32)
    e2 = tris.e2.numpy().astype(np.float32)
    valid = tris.valid.numpy().astype(bool)
    T = v0.shape[0]
    tri = np.zeros((T, _TRI_COLS), np.float32)
    tri[:, 0:3] = v0
    tri[:, 3:6] = e1
    tri[:, 6:9] = e2
    tri[:, 9:12] = tris.n0.numpy()
    tri[:, 12:15] = tris.n1.numpy()
    tri[:, 15:18] = tris.n2.numpy()
    tri[:, 18] = tris.mat_id.numpy().astype(np.float32)
    tri[:, 19] = tris.emitter_id.numpy().astype(np.float32)
    tri[~valid, 3:9] = 0.0      # degenerate edges: det 0, never hit

    mats = scene.materials
    M = mats.kind.shape[0]
    mat = np.zeros((M, _MAT_COLS), np.float32)
    mat[:, 0] = mats.kind.numpy().astype(np.float32)
    mat[:, 1:4] = mats.albedo.numpy()
    mat[:, 4:7] = mats.eta.numpy()
    mat[:, 7:10] = mats.k.numpy()
    mat[:, 10] = np.maximum(mats.roughness.numpy().astype(np.float32), 1e-3)
    mat[:, 11:14] = mats.spec_refl.numpy()
    mat[:, 14:17] = mats.spec_trans.numpy()
    mat[:, 17] = mats.tex_id.numpy().astype(np.float32)

    em = scene.emitters
    E = em.kind.shape[0]
    emt = np.zeros((E, _EM_COLS), np.float32)
    emt[:, 0:3] = em.radiance.numpy()
    emt[:, 3] = em.area.numpy()
    emt[:, 4] = em.pmf.numpy()
    emt[:, 5] = em.cdf.numpy()
    ti = np.clip(em.tri_idx.numpy(), 0, T - 1)
    emt[:, 6:9] = v0[ti]
    emt[:, 9:12] = e1[ti]
    emt[:, 12:15] = e2[ti]
    ng = np.cross(e1[ti], e2[ti])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    emt[:, 15:18] = ng
    emt[:, 18] = em.kind.numpy().astype(np.float32)

    cam = np.zeros((1, _CAM_COLS), np.float32)
    c2w = scene.camera.to_world.numpy().astype(np.float32)
    cam[0, 0:9] = c2w[:3, :3].reshape(9)
    cam[0, 9:12] = c2w[:3, 3]
    cam[0, 12] = float(scene.camera.tan_half_fov_x)
    cam[0, 13] = float(scene.camera.tan_half_fov_y)
    cam[0, 14] = float(scene.camera.aperture_radius)
    cam[0, 15] = float(scene.camera.focus_distance)
    cam[0, 16:19] = em.env_radiance.numpy()

    sp = scene.spheres
    sv = sp.valid.numpy().astype(bool)
    sph = np.zeros((max(1, sv.shape[0]), _SPH_COLS), np.float32)
    if sv.shape[0]:
        sph[:sv.shape[0], 0:3] = sp.center.numpy()
        sph[:sv.shape[0], 3] = sp.radius.numpy()
        sph[:sv.shape[0], 4] = sp.mat_id.numpy().astype(np.float32)
        sph[:sv.shape[0], 5] = sp.emitter_id.numpy().astype(np.float32)
        sph[:sv.shape[0], 6] = sv.astype(np.float32)

    Tp = -(-T // 512) * 512
    tri_ext = np.zeros((Tp, _TRI_EXT_COLS), np.float32)
    tri_ext[:T, :_TRI_COLS] = tri
    tri_ext[:T, 20:22] = tris.uv0.numpy()
    tri_ext[:T, 22:24] = tris.uv1.numpy()
    tri_ext[:T, 24:26] = tris.uv2.numpy()

    tex = np.zeros((1, _TEX_COLS), np.float32)
    env_tab = np.zeros((1, _TEX_COLS), np.float32)
    env_col = np.zeros((1, 1), np.float32)
    env_row = np.zeros((1, 1), np.float32)
    return tri, mat, emt, cam, sph, tri_ext, tex, env_tab, env_col, env_row


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
    """Check eligibility, pack and move the tables to `device`."""
    mega_eligible(scene, cfg)
    tri, mat, emt, cam = pack_mega_tables(scene)[:4]

    def dev(a):
        return torch.from_numpy(a).to(device).contiguous()

    return TraceTables(tri=dev(tri), mat=dev(mat), em=dev(emt),
                       cam=dev(cam.reshape(-1)), max_depth=cfg.max_depth,
                       min_depth=cfg.min_depth, rr_depth=cfg.rr_depth,
                       use_nee=bool(cfg.use_nee))


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
    """(best_t (R,), best_id (R,) int64, -1 on a miss)."""
    tt, hit = _sweep(tri, o, d)
    hit = hit & (tt < INF)
    t_m = torch.where(hit, tt, INF)
    best_t = t_m.min(1).values
    first = (hit & (t_m == best_t[:, None])).to(torch.int8).argmax(1)
    best_id = torch.where(best_t < INF, first, -1)
    return best_t, best_id


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


def path_trace_reference(tables: TraceTables, uT, work=None):
    """Plain-PyTorch twin of path_trace_kernel: uT (n_dims, R) -> (3, R).
    With a dict `work`, adds the kernel's ray-triangle tests to it."""
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

    for depth in range(1, max_depth + 1):
        base = SENSOR_DIMS + (depth - 1) * BOUNCE_DIMS
        best_t, best_id = closest_hit(tri, o, d)
        count_sweeps(work, tri, active)
        hit_valid = best_t < INF
        t_hit = torch.where(hit_valid, best_t, INF)
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

        m = mat[av[:, 18].to(torch.int64)]
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
        active = active & hit_valid

        wi = to_local(ns, -d)
        delta_m = is_delta(kind)

        # ---- NEE with an immediate shadow sweep ---------------------------
        if tables.use_nee:
            ld, dist, ds_pdf, l_rad = sample_direct(
                em, hp, uT[base + OFF_LIGHT_PICK], uT[base + OFF_LIGHT_U],
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
    return L.T.contiguous()


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

