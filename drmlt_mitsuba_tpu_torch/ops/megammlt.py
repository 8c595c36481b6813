"""The selected-strategy MMLT trace per lane: the MMLT kernel and its plain
twin.

`mmlt_trace(tables, uT)` launches `csrc/mmlt_trace.cu:mmlt_trace_kernel`,
the port of the reference's Pallas kernel `megammlt.py:_mega_mmlt_kernel`
(trace body `mmlt_trace_tile`, :242).  `mmlt_trace_reference` is the same
computation in plain PyTorch; the wrapper takes it only for a tensor on the
CPU.  Both read the PSS vectors dim-major, uT (n_core, R) with
u = [depth, strategy, eye..., light...] (integrators/mmlt.py), and return
(5, R): value r, g, b scaled by n_strats * max_depth (the strategy and
depth pmfs), then the film position x, y.

Per lane (megammlt.py:262-929): depth and strategy (s, t) from dims 0-1;
the eye walk from the pinhole camera and the light walk from an area
emitter, each keeping per-slot pdf_fwd / pdf_rev / delta / valid and the
two vertices the strategy selects (ev, ev0 on the eye side, lv, lv0 on the
light side), and each stopping at its selected slot ev or lv (the kernel
runs both walks in one loop, csrc/mmlt_trace.cuh:walk; the twin keeps a
loop over every slot, masked); the s = 0 emitter hit (or, with an environment, the s = 0 eye
walk that escaped, at MIS weight 1), or the selected connection with one
shadow ray (t = 1: the light-image projection onto the film); the
balance-heuristic MIS weight by the ratio recursion over the slots.  The
walks hit analytic spheres and read bitmap albedos as the path trace does
(ops/megatrace.py); a thin-lens camera is not in this kernel's scope, as
in the reference (megammlt.py:45-55).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from drmlt_mitsuba_tpu_torch.core.frame import to_local, to_world
from drmlt_mitsuba_tpu_torch.core.math import (
    RAY_EPS, cross, dot, normalize,
)
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.core.warp import square_to_cosine_hemisphere
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops.megatrace import (
    ENV_CONSTANT, ENV_NONE, INF, closest_hit, count_sweeps, mega_eligible,
    materials_at, occluded, pack_mega_tables_torch, scene_args,
    scope_fields, sphere_blocked, sphere_closest, sphere_uv,
)
from drmlt_mitsuba_tpu_torch.ops.intersect import scene_nodes
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    eval_bsdf, is_delta, sample_bsdf,
)
from drmlt_mitsuba_tpu_torch.render.emitter import (
    env_bilinear, env_dir_to_uv, pick_row,
)
from drmlt_mitsuba_tpu_torch.scene.bvh import NodeTable
from drmlt_mitsuba_tpu_torch.scene.types import Scene

_PI = math.pi
MAX_DEPTH = 16   # the kernels' per-thread slot arrays (mmlt_trace.cuh)


def mega_mmlt_eligible(scene: Scene, cfg: BDPTConfig) -> bool:
    """True when the MMLT kernel covers this scene (the path kernel's scene
    subset less the thin lens); otherwise raises NotImplementedError naming
    what is missing (a thin-lens scene's MMLT takes the bidirectional
    wavefront, integrators/bidir.py; BDPTConfig itself refuses media)."""
    if float(scene.camera.aperture_radius) > 0:
        raise NotImplementedError(
            "not yet ported to the CUDA MMLT kernel: a thin-lens camera "
            "(the reference's MMLT kernel excludes it too)")
    return mega_eligible(scene, cfg)


@dataclasses.dataclass(frozen=True)
class MmltTables:
    """Device-resident packed scene tables plus the static MMLT config;
    the scene-scope fields as in megatrace.TraceTables."""
    tri: torch.Tensor    # (T, 20)
    mat: torch.Tensor    # (M, 18)
    em: torch.Tensor     # (E, 20)
    cam: torch.Tensor    # (24,)
    max_depth: int
    light_image: bool
    eye_dims: int
    light_dims: int
    kinds: frozenset                 # the material table's BSDF kinds
    nodes: NodeTable | None = None   # the BVH above BVH_MIN_TRIS triangles
    sph: torch.Tensor | None = None
    tri_ext: torch.Tensor | None = None
    tex: torch.Tensor | None = None
    env_tab: torch.Tensor | None = None
    env_col: torch.Tensor | None = None
    env_row: torch.Tensor | None = None
    n_sphs: int = 0
    tex_shape: tuple | None = None
    env_shape: tuple | None = None
    env_mode: int = ENV_NONE
    env_row_pick: float = 0.0
    thinlens: bool = False
    full: bool = False

    technique = "mmlt"

    @property
    def n_core(self) -> int:
        """PSS dims the trace reads: depth, strategy, eye, light."""
        return 2 + self.eye_dims + self.light_dims

    @property
    def device(self):
        return self.tri.device


def make_mmlt_tables(scene: Scene, cfg: BDPTConfig, device) -> MmltTables:
    """Check eligibility, pack and move the tables to `device`."""
    mega_mmlt_eligible(scene, cfg)
    tabs = pack_mega_tables_torch(scene, device)
    tri, mat, emt, cam = (t.contiguous() for t in tabs[:4])
    return MmltTables(tri=tri, mat=mat, em=emt,
                      cam=cam.reshape(-1), max_depth=cfg.max_depth,
                      light_image=bool(cfg.light_image),
                      eye_dims=cfg.eye_dims, light_dims=cfg.light_dims,
                      nodes=scene_nodes(scene, tri),
                      **scope_fields(scene, tabs, False))


def check_depth(max_depth: int):
    """The CUDA kernels take max_depth <= MAX_DEPTH (the twin has no
    limit)."""
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"max_depth {max_depth}: the MMLT kernels take 1 to "
                         f"{MAX_DEPTH}")


def table_args(tables: MmltTables):
    """The tables and MMLT config as mmlt_trace_launch takes them."""
    return (*scene_args(tables), tables.max_depth, int(tables.light_image),
            tables.eye_dims)


# ---------------------------------------------------------------- twin
_VTX = ("p", "ns", "ng", "wi", "beta", "mat", "valid", "esc", "tu", "tv")


def _copy(dst, m, src):
    """Per-lane select of vertex records: src where m, else dst."""
    out = {}
    for k in _VTX:
        a, b = src[k], dst[k]
        mm = m[:, None] if a.dim() == 2 else m
        out[k] = torch.where(mm, a, b)
    return out


def _walk(tables, u, o, d, beta, pdf_sa, src_p, src_ns, n_slots, ubase,
          importance, sel, ep, work):
    """One subpath walk (megammlt.py:287-516).  sel: slot indices (R,)
    whose vertices to capture, sel[0] the last (the kernel's sel_a);
    ep: the endpoint (slot 0) record.  Returns (pdf_fwd, pdf_rev, delta,
    valid) per slot, the captured vertices and the emitter row of the
    first captured one.  A walk that leaves the scene marks the vertex of
    that slot escaped (its wi the escape direction reversed, its beta the
    throughput).  A lane stops after slot sel[0], as the kernel's does
    (nothing reads a slot past it), so `work` counts the sweeps the lane
    needs; the loop still runs every slot, masked."""
    tri = tables.tri
    R = o.shape[0]
    dev = o.device
    zero = torch.zeros(R, device=dev)
    fbool = torch.zeros(R, dtype=torch.bool, device=dev)
    pdf_fwd = [zero] * n_slots
    pdf_rev = [zero] * n_slots
    delta = [fbool] * n_slots
    valid = [fbool] * n_slots
    pdf_fwd[0], delta[0], valid[0] = ep["pdf_fwd"], ep["delta"], ep["valid"]
    init = dict(p=torch.zeros((R, 3), device=dev),
                ns=torch.zeros((R, 3), device=dev),
                ng=torch.zeros((R, 3), device=dev),
                wi=torch.zeros((R, 3), device=dev),
                beta=torch.zeros((R, 3), device=dev), mat=zero,
                valid=fbool, esc=fbool, tu=zero, tv=zero)
    caps = [_copy(init, idx == 0, ep["vertex"]) for idx in sel]
    erow0 = torch.full((R,), -1.0, device=dev)
    act = ep["valid"]
    pp, pn = src_p, src_ns
    for v in range(1, n_slots):
        act = act & (sel[0] >= v)
        best_t, best_id = closest_hit(tri, o, d, tables.nodes)
        count_sweeps(work, tri, act, o, d, nodes=tables.nodes)
        if tables.n_sphs:
            best_t, s_id = sphere_closest(tables.sph, tables.n_sphs, o, d,
                                          best_t)
            use_sph = s_id >= 0
        hit_valid = best_t < INF
        t_hit = torch.where(hit_valid, best_t, INF)
        active = act & hit_valid
        av = torch.where((best_id >= 0)[:, None],
                         tri[torch.clamp(best_id, min=0)], 0.0)
        erow = torch.where(hit_valid, av[:, 19], -1.0)
        e1, e2 = av[:, 3:6], av[:, 6:9]
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
        mat_id = av[:, 18]
        if tables.n_sphs:
            srow = tables.sph[torch.clamp(s_id, min=0)]
            sng = (hp - srow[:, 0:3]) * (
                1.0 / torch.clamp(srow[:, 3], min=1e-20))[:, None]
            ng = torch.where(use_sph[:, None], sng, ng)
            ns = torch.where(use_sph[:, None], sng, ns)
            mat_id = torch.where(use_sph, srow[:, 4], mat_id)
            erow = torch.where(use_sph, srow[:, 5], erow)
        tu = tv = zero
        if tables.tex_shape is not None:
            ext = tables.tri_ext[torch.clamp(best_id, min=0)]
            tu = w0 * ext[:, 20] + b1 * ext[:, 22] + b2 * ext[:, 24]
            tv = w0 * ext[:, 21] + b1 * ext[:, 23] + b2 * ext[:, 25]
            if tables.n_sphs:
                su, sv = sphere_uv(ng)
                tu = torch.where(use_sph, su, tu)
                tv = torch.where(use_sph, sv, tv)

        # pdf_fwd: the previous direction pdf -> area measure here
        seg = hp - pp
        d2 = torch.clamp(dot(seg, seg), min=1e-20)
        w = seg * (1.0 / torch.sqrt(d2))[:, None]
        cos_to = torch.abs(dot(w, ng))
        pdf_fwd[v] = torch.where(active, pdf_sa * cos_to / d2, 0.0)
        valid[v] = active
        mt = materials_at(tables, mat_id, tu, tv)
        delta[v] = is_delta(mt["kind"]) & active

        wiw = -d
        vtx = dict(p=hp, ns=ns, ng=ng, wi=wiw,
                   beta=torch.where(act[:, None], beta, 0.0), mat=mat_id,
                   valid=active, esc=act & ~hit_valid, tu=tu, tv=tv)
        for i, idx in enumerate(sel):
            caps[i] = _copy(caps[i], idx == v, vtx)
        erow0 = torch.where(sel[0] == v, erow, erow0)

        # BSDF sample and the reverse pdf of slot v - 1; the final slot
        # samples no direction and reads zeros, as the reference layout
        # zero-pads its last step
        wi = to_local(ns, wiw)
        if v == n_slots - 1:
            ub = [zero, zero, zero]
        else:
            ub = [u(ubase + (v - 1) * 3 + j) for j in range(3)]
        bs = sample_bsdf(mt, wi, ub[0], torch.stack([ub[1], ub[2]], -1))
        wow = to_world(ns, bs.wo)
        _, rev_sa = eval_bsdf(mt, bs.wo, wi)
        cos_prev = torch.abs(dot(w, pn))
        rev_sa = torch.where(bs.delta, 1.0, rev_sa)
        pdf_rev[v - 1] = torch.where(active, rev_sa * cos_prev / d2, 0.0)

        bn = beta * bs.weight
        if importance:
            num = torch.abs(dot(wiw, ns)) * torch.abs(dot(wow, ng))
            den = torch.abs(dot(wiw, ng)) * torch.abs(dot(wow, ns))
            corr = torch.where(den > 0,
                               num / torch.where(den > 0, den, 1.0), 1.0)
            bn = bn * corr[:, None]
        cont = active & (luminance(bn) > 0) & ((bs.pdf > 0) | bs.delta)
        eps_n = RAY_EPS * torch.clamp(t_hit, min=1.0)
        o = torch.where(active[:, None], hp + wow * eps_n[:, None], o)
        d = torch.where(active[:, None], wow, d)
        beta = torch.where(cont[:, None], bn, 0.0)
        pdf_sa = torch.where(bs.delta, 1.0, bs.pdf)
        act = cont
        pp = torch.where(active[:, None], hp, pp)
        pn = torch.where(active[:, None], ns, pn)
    return pdf_fwd, pdf_rev, delta, valid, caps, erow0


def _sa_to_area(pdf_sa, p_from, p_to, n_to):
    s = p_to - p_from
    d2 = torch.clamp(dot(s, s), min=1e-20)
    c = torch.abs(dot(s, n_to) * (1.0 / torch.sqrt(d2)))
    return pdf_sa * c / d2


def _delta_at(deltas, idx):
    out = torch.zeros_like(deltas[0])
    for i, dl in enumerate(deltas):
        out = out | ((idx == i) & dl)
    return out


def _ratio(p_num, p_den):
    return (torch.where(p_num > 0, p_num, 1.0)
            / torch.where(p_den > 0, p_den, 1.0))


def mmlt_trace_reference(tables: MmltTables, uT, work=None):
    """Plain-PyTorch twin of mmlt_trace_kernel: uT (n_core, R) -> (5, R).
    With a dict `work`, adds the kernel's ray-triangle tests to it."""
    tri, mat, em, cam = tables.tri, tables.mat, tables.em, tables.cam
    R = uT.shape[1]
    dev = uT.device
    K = tables.max_depth
    n_eye, n_light = K + 1, K
    zero = torch.zeros(R, device=dev)
    one = torch.ones(R, device=dev)
    tbool = torch.ones(R, dtype=torch.bool, device=dev)

    def u(j):
        return uT[j]

    # ---- technique dims -------------------------------------------------
    depth = torch.clamp(torch.floor(u(0) * K), max=K - 1.0) + 1.0
    n_strats = depth + 1.0
    s_pick = torch.minimum(torch.floor(u(1) * n_strats), depth)
    t_pick = depth + 1.0 - s_pick
    case_hit = s_pick == 0
    case_lt = t_pick == 1
    ev = torch.clamp(t_pick - 1.0, 0.0, n_eye - 1.0)
    ev0 = torch.clamp(t_pick - 2.0, 0.0, n_eye - 1.0)
    lv = torch.clamp(s_pick - 1.0, 0.0, n_light - 1.0)
    lv0 = torch.clamp(s_pick - 2.0, 0.0, n_light - 1.0)

    cam_f = torch.stack([cam[2], cam[5], cam[8]]).expand(R, 3)
    cam_o = cam[9:12].expand(R, 3)
    film_area = 4.0 * cam[12] * cam[13]

    # ---- eye walk -------------------------------------------------------
    ux, uy = u(2), u(3)
    x = (2.0 * ux - 1.0) * cam[12]
    y = (1.0 - 2.0 * uy) * cam[13]
    ed = normalize(torch.stack([cam[0] * x + cam[1] * y + cam[2],
                                cam[3] * x + cam[4] * y + cam[5],
                                cam[6] * x + cam[7] * y + cam[8]], -1))
    cos0 = dot(ed, cam_f)
    c0 = torch.clamp(cos0, min=1e-6)
    pdf0 = torch.where(cos0 > 1e-6, 1.0 / (film_area * (c0 * (c0 * c0))),
                       0.0)
    fbool = torch.zeros_like(tbool)
    cam_vtx = dict(p=cam_o, ns=cam_f, ng=cam_f, wi=-cam_f,
                   beta=torch.ones((R, 3), device=dev), mat=zero,
                   valid=tbool, esc=fbool, tu=zero, tv=zero)
    E_fwd, E_rev, E_delta, _, (Se, Se0), erow_ev = _walk(
        tables, u, cam_o, ed, torch.ones((R, 3), device=dev), pdf0, cam_o,
        cam_f, n_eye, 4, True, (ev, ev0),
        dict(pdf_fwd=one, delta=tbool, valid=tbool, vertex=cam_vtx), work)
    E_rev[0] = zero

    # ---- light walk (area emitters) --------------------------------------
    lbase = 2 + tables.eye_dims
    g = em[pick_row(em, u(lbase))]
    l_rad, l_area, l_pmf = g[:, 0:3], g[:, 3], g[:, 4]
    lng = g[:, 15:18]
    tw = torch.sqrt(torch.clamp(1.0 - u(lbase + 1), min=0.0))
    lb0 = 1.0 - tw
    lb1 = tw * u(lbase + 2)
    p0 = g[:, 6:9] + lb0[:, None] * g[:, 9:12] + lb1[:, None] * g[:, 12:15]
    pdf_pos = l_pmf / torch.clamp(l_area, min=1e-20)
    valid0 = (l_pmf > 0) & (g[:, 18] == 0.0)
    c = square_to_cosine_hemisphere(torch.stack([u(lbase + 3),
                                                 u(lbase + 4)], -1))
    ldir = to_world(lng, c)
    pdf_dir = torch.clamp(c[:, 2], min=1e-12) / _PI
    cos_l0 = torch.clamp(c[:, 2], min=0.0)
    bscale = cos_l0 / torch.clamp(pdf_pos * pdf_dir, min=1e-30)
    lb = torch.where(valid0[:, None], l_rad * bscale[:, None], 0.0)
    l_end_b = torch.where(
        valid0[:, None], l_rad / torch.clamp(pdf_pos, min=1e-20)[:, None],
        0.0)
    light_vtx = dict(p=p0, ns=lng, ng=lng, wi=lng, beta=l_end_b, mat=zero,
                     valid=valid0, esc=fbool, tu=zero, tv=zero)
    o0 = p0 + ldir * (RAY_EPS * 10.0)
    L_fwd, L_rev, L_delta, _, (Sl, Sl0), _ = _walk(
        tables, u, o0, ldir, lb, pdf_dir, p0, lng, n_light, lbase + 5,
        False, (lv, lv0),
        dict(pdf_fwd=pdf_pos, delta=torch.zeros_like(valid0), valid=valid0,
             vertex=light_vtx), work)

    # ---- s = 0: the selected eye vertex is on an emitter -----------------
    he = em[torch.clamp(erow_ev, min=0).to(torch.int64)]
    has_e = erow_ev >= 0
    he_rad = torch.where(has_e[:, None], he[:, 0:3], 0.0)
    he_area = torch.where(has_e, he[:, 3], 1.0)
    he_pmf = torch.where(has_e, he[:, 4], 0.0)
    cos_e_hit = dot(Se["wi"], Se["ng"])
    ok_hit = case_hit & Se["valid"] & has_e & (cos_e_hit > 0)
    ch = Se["beta"] * he_rad

    # ---- connection geometry (t = 1 light tracing uses ev = 0) -----------
    dv = Se["p"] - Sl["p"]
    dist2 = dot(dv, dv)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    wl = dv / dist[:, None]
    cos_l = torch.abs(dot(wl, Sl["ng"]))
    cos_e = torch.abs(dot(wl, Se["ng"]))
    gterm = cos_l * cos_e / torch.clamp(dist2, min=1e-20)

    is_s1 = s_pick == 1
    front = dot(wl, Sl["ng"]) > 0
    mtl = materials_at(tables, Sl["mat"], Sl["tu"], Sl["tv"])
    wl_loc = to_local(Sl["ns"], wl)
    wi_l_loc = to_local(Sl["ns"], Sl["wi"])
    fl_c, pdf_l_fwd = eval_bsdf(mtl, wi_l_loc, wl_loc)
    fl = fl_c * (1.0 / torch.clamp(torch.abs(wl_loc[:, 2]),
                                   min=1e-9))[:, None]
    fl = torch.where(is_s1[:, None],
                     torch.where(front, 1.0, 0.0)[:, None].expand(R, 3), fl)

    mte = materials_at(tables, Se["mat"], Se["tu"], Se["tv"])
    we_loc = to_local(Se["ns"], -wl)
    wi_e_loc = to_local(Se["ns"], Se["wi"])
    fe_c, pdf_e_fwd = eval_bsdf(mte, wi_e_loc, we_loc)
    fe = fe_c * (1.0 / torch.clamp(torch.abs(we_loc[:, 2]),
                                   min=1e-9))[:, None]
    # sensor importance toward -wl (pinhole)
    cosv = -dot(wl, cam_f)
    cv = torch.clamp(cosv, min=1e-6)
    inv_cosv = 1.0 / cv
    x_cam = -(wl[:, 0] * cam[0] + wl[:, 1] * cam[3]
              + wl[:, 2] * cam[6]) * inv_cosv
    y_cam = -(wl[:, 0] * cam[1] + wl[:, 1] * cam[4]
              + wl[:, 2] * cam[7]) * inv_cosv
    fu = (x_cam / cam[12] + 1.0) * 0.5
    fv = (1.0 - y_cam / cam[13]) * 0.5
    inside = (cosv > 1e-6) & (fu >= 0) & (fu < 1) & (fv >= 0) & (fv < 1)
    cv2 = cv * cv
    we_imp = torch.where(inside, 1.0 / (film_area * (cv2 * cv2)), 0.0)
    fe = torch.where(case_lt[:, None], we_imp[:, None].expand(R, 3), fe)
    cc = Sl["beta"] * fl * fe * Se["beta"] * gterm[:, None]

    l_delta_sel = _delta_at(L_delta, lv)
    l_deltab = ~is_s1 & l_delta_sel
    e_deltab = _delta_at(E_delta, ev)
    case_conn = ~case_hit & ~case_lt
    ok_conn = (case_conn & Sl["valid"] & Se["valid"] & ~l_deltab
               & ~e_deltab & (dist2 > 1e-12))
    ok_lt = case_lt & Sl["valid"] & ~l_delta_sel & inside & (dist2 > 1e-12)
    if not tables.light_image:
        ok_lt = torch.zeros_like(ok_lt)
    ok_c = (ok_conn | ok_lt) & (luminance(cc) > 0)
    sh_eps = RAY_EPS * torch.clamp(dist, min=1.0)
    sh_o = Sl["p"] + wl * sh_eps[:, None]
    sh_tmax = torch.where(ok_c, dist * (1.0 - 1e-3), 0.0)
    count_sweeps(work, tri, ok_c, sh_o, wl, sh_tmax, tables.nodes)
    blocked = occluded(tri, sh_o, wl, sh_tmax, tables.nodes)
    if tables.n_sphs:
        blocked = blocked | sphere_blocked(tables.sph, tables.n_sphs, sh_o,
                                           wl, sh_tmax)
    ok_c = ok_c & ~blocked

    # ---- junction pdfs ----------------------------------------------------
    cos_em = torch.clamp(dot(wl, Sl["ng"]), min=0.0)
    pLs_em = _sa_to_area(cos_em / _PI, Sl["p"], Se["p"], Se["ng"])
    pLs_bsdf = _sa_to_area(pdf_l_fwd, Sl["p"], Se["p"], Se["ng"])
    pLs_hit = torch.where(has_e, he_pmf / torch.clamp(he_area, min=1e-20),
                          0.0)
    pL_s = torch.where(case_hit, pLs_hit,
                       torch.where(is_s1, pLs_em, pLs_bsdf))
    _, pdf_e_rev = eval_bsdf(mte, we_loc, wi_e_loc)
    pLs1_bsdf = _sa_to_area(pdf_e_rev, Se["p"], Se0["p"], Se0["ng"])
    hw = Se0["p"] - Se["p"]
    hd2 = torch.clamp(dot(hw, hw), min=1e-20)
    cos_hit_l = torch.clamp(dot(hw, Se["ng"]) * (1.0 / torch.sqrt(hd2)),
                            min=0.0)
    pLs1_hit = _sa_to_area(cos_hit_l / _PI, Se["p"], Se0["p"], Se0["ng"])
    pL_s1 = torch.where(t_pick >= 3,
                        torch.where(case_hit, pLs1_hit, pLs1_bsdf), 0.0)
    pEt_sens = _sa_to_area(
        torch.where(cosv > 1e-6, 1.0 / (film_area * (cv * (cv * cv))), 0.0),
        Se["p"], Sl["p"], Sl["ng"])
    pEt_bsdf = _sa_to_area(pdf_e_fwd, Se["p"], Sl["p"], Sl["ng"])
    pE_t = torch.where(case_lt, pEt_sens, pEt_bsdf)
    _, pdf_l_rev = eval_bsdf(mtl, wl_loc, wi_l_loc)
    pE_t1 = torch.where(
        s_pick >= 2, _sa_to_area(pdf_l_rev, Sl["p"], Sl0["p"], Sl0["ng"]),
        0.0)

    # ---- balance-heuristic MIS: the ratio recursion over the slots --------
    sum_ri = zero
    ri = one
    for i in reversed(range(n_light)):
        pE_i = torch.where(i == s_pick - 1.0, pE_t,
                           torch.where(i == s_pick - 2.0, pE_t1, L_rev[i]))
        in_range = i <= s_pick - 1.0
        ri = torch.where(in_range, ri * _ratio(pE_i, L_fwd[i]), ri)
        d_lo = L_delta[i - 1] if i >= 2 else torch.zeros_like(in_range)
        sum_ri = sum_ri + torch.where(in_range & ~(d_lo | L_delta[i]), ri,
                                      0.0)
    rj = one
    for j in reversed(range(1, n_eye)):
        pL_j = torch.where(j == t_pick - 1.0, pL_s,
                           torch.where(j == t_pick - 2.0, pL_s1, E_rev[j]))
        in_range = j <= t_pick - 1.0
        rj = torch.where(in_range, rj * _ratio(pL_j, E_fwd[j]), rj)
        d_hi = E_delta[j - 1] if j >= 2 else torch.zeros_like(in_range)
        ok_j = in_range & ~(E_delta[j] | d_hi)
        if not tables.light_image and j == 1:
            ok_j = torch.zeros_like(ok_j)
        sum_ri = sum_ri + torch.where(ok_j, rj, 0.0)
    w_mis = 1.0 / (1.0 + sum_ri)

    # ---- combine ----------------------------------------------------------
    val = torch.where(ok_hit[:, None], ch * w_mis[:, None], 0.0)
    if tables.env_mode:
        # the environment seen by an s = 0 eye walk that escaped, at MIS
        # weight 1 (megammlt.py:883-930)
        if tables.env_mode == ENV_CONSTANT:
            env = cam[16:19].expand(R, 3)
        else:
            eu, ev_ = env_dir_to_uv(-Se["wi"])
            env = env_bilinear(tables.env_tab, tables.env_shape, eu, ev_)
        ok_env = case_hit & Se["esc"]
        val = val + torch.where(ok_env[:, None], Se["beta"] * env, 0.0)
    val = val + torch.where(ok_c[:, None], cc * w_mis[:, None], 0.0)
    val = val * (n_strats * float(K))[:, None]
    return torch.cat([val.T, torch.where(case_lt, fu, ux)[None],
                      torch.where(case_lt, fv, uy)[None]]).contiguous()


# ---------------------------------------------------------------- kernel
def _check_u(tables: MmltTables, uT):
    if uT.dtype != torch.float32 or uT.dim() != 2:
        raise ValueError("uT must be a 2-D float32 tensor (n_core, R)")
    if uT.shape[0] < tables.n_core:
        raise ValueError(f"uT has {uT.shape[0]} dims, the MMLT config "
                         f"reads {tables.n_core}")
    if uT.device != tables.device:
        raise ValueError(f"uT on {uT.device}, tables on {tables.device}")


def mmlt_trace(tables: MmltTables, uT):
    """(5, R) = value r, g, b and film position x, y of the PSS vectors
    uT (n_core, R).

    A CUDA tensor launches mmlt_trace_kernel; a CPU tensor runs
    mmlt_trace_reference."""
    _check_u(tables, uT)
    if uT.device.type == "cpu":
        return mmlt_trace_reference(tables, uT)
    if uT.device.type != "cuda":
        raise NotImplementedError(f"no MMLT kernel for {uT.device}")
    check_depth(tables.max_depth)
    uT = uT.contiguous()
    R = uT.shape[1]
    out = torch.empty((5, R), dtype=torch.float32, device=uT.device)
    lib = build.load()
    stream = torch.cuda.current_stream(uT.device).cuda_stream
    rc = lib.mmlt_trace_launch(*table_args(tables), uT.data_ptr(), R,
                               out.data_ptr(), stream)
    build.check(rc, "mmlt_trace_kernel")
    build.LAUNCHES[build.scope_key("mmlt_trace", tables)] += 1
    return out


def to_splats(out, scale: float = 1.0) -> Splats:
    """Splats of a (5, R) trace output, its value multiplied by scale."""
    value = out[0:3].T * scale
    return Splats(pos=out[3:5].T[:, None, :], value=value[:, None, :],
                  lum=luminance(value))


def make_mega_mmlt(scene: Scene, cfg: BDPTConfig, device):
    """trace(u) -> Splats for u (R, >= n_core) = [depth, strategy, eye...,
    light...(, pad)], the reference's make_mega_mmlt interface: the depth
    and strategy pmf scalings are applied inside the trace."""
    tables = make_mmlt_tables(scene, cfg, device)

    def trace(u):
        return to_splats(mmlt_trace(tables,
                                    u[:, :tables.n_core].T.contiguous()))

    return trace
