"""Unidirectional path tracer with NEE + MIS, as L(u) (counterpart of
drmlt_mitsuba_tpu/integrators/path.py).

The function is pure in the primary-sample matrix u (R, n_dims), so the
same trace serves plain Monte-Carlo rendering (u uniform) and MCMC (u =
chain state).  Two routes, picked per scene by `make_path_trace` as the
reference's make_path_trace does (path.py:585-606):

  * the CUDA path kernel (ops/megatrace.py:path_trace) on the scenes the
    trace kernels cover (ops/megatrace.py:mega_eligible); `trace_paths`
    is its plain-PyTorch twin, differentiable in the scene's float
    leaves, and `make_path_trace_diff` the differentiable trace of
    inverse rendering;
  * `trace_paths_wavefront`, the reference's XLA `trace_paths` (:137)
    without its medium, subsurface and motion branches, on every other
    surface scene: every BSDF kind but irawan with the mask, coating and
    mixture wrappers, normal maps, per-vertex colors, point, spot,
    directional and collimated emitters, emissive spheres, every sensor
    (render/sensor.py:sample_ray).  It is plain
    PyTorch over the intersection kernel: each bounce makes one fused
    closest-hit and shadow query (ops/intersect.py:intersect_and_occluded,
    csrc/intersect.cu on a CUDA tensor, its twin on the CPU) on all R
    lanes, dead lanes masked, and consumes u in the reference's layout
    (integrators/layout.py), so the same u gives the reference's Splats.
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.core.frame import to_local, to_world
from drmlt_mitsuba_tpu_torch.core.math import RAY_EPS, mis_power
from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.layout import (  # noqa: F401
    BOUNCE_DIMS, OFF_BSDF_CMP, OFF_LIGHT_PICK, OFF_RR, SENSOR_DIMS,
    PathConfig, Splats, path_splats,
)
from drmlt_mitsuba_tpu_torch.ops import megatrace
from drmlt_mitsuba_tpu_torch.ops.intersect import (
    RayTables, intersect_and_occluded, make_ray_tables,
)
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.render.bsdf import (
    MaterialRows, eval_bsdf_table, is_delta_table, material_table_rows,
    sample_bsdf_table,
)
from drmlt_mitsuba_tpu_torch.render.emitter import (
    EmitterRows, emitter_table_rows, env_pdf_dir, eval_emitter, eval_env,
    pdf_emitter_direct, sample_emitter_direct,
)
from drmlt_mitsuba_tpu_torch.render.sampler import make_sampler
from drmlt_mitsuba_tpu_torch.render.sensor import camera_rays, sample_ray
from drmlt_mitsuba_tpu_torch.render.texture import (
    apply_normal_map, surface_albedo,
)
from drmlt_mitsuba_tpu_torch.scene.types import (
    CAMERA_PERSPECTIVE, Scene, prepare_scene, to_device,
)


def trace_paths(scene: Scene, cfg: PathConfig, u) -> Splats:
    """Plain-PyTorch twin of the path kernel on a batch of camera paths u
    (R, cfg.n_dims), differentiable in the scene's float leaves."""
    tables = megatrace.make_tables(scene, cfg, u.device)
    return path_splats(u, megatrace.path_trace_reference(
        tables, u[:, :cfg.n_dims].T).T)


# ------------------------------------------------------------- wavefront
@dataclasses.dataclass(frozen=True)
class WavefrontTables:
    """What the wavefront reads, on one device: the scene there (hits are
    assembled from it), the intersection kernel's tables, the packed
    camera row, the material and emitter rows, the texture atlas (N, H,
    W, 3), per-vertex colors (T, 3, 3), the normal-map page of each
    material (M,)."""
    scene: Scene
    rays: RayTables
    cam: torch.Tensor
    mats: MaterialRows
    emit: EmitterRows
    tex_id: torch.Tensor
    atlas: torch.Tensor | None
    vcolors: torch.Tensor | None
    normal_tex: torch.Tensor | None


def wavefront_scope_missing(scene: Scene, cfg: PathConfig) -> list[str]:
    """What the wavefront does not render of this scene and config (empty
    when it renders it): motion, a perspective lens without the lens
    dims."""
    missing = []
    if cfg.motion or scene.motion is not None:
        missing.append("motion blur")
    if (scene.camera.kind == CAMERA_PERSPECTIVE
            and float(scene.camera.aperture_radius) > 0
            and not cfg.thinlens):
        missing.append("a lens aperture without PathConfig(thinlens=True)")
    return missing


def make_wavefront_tables(scene: Scene, cfg: PathConfig,
                          device) -> WavefrontTables:
    """Check the wavefront's scope (NotImplementedError naming what it
    lacks), attach the BVH above BVH_MIN_TRIS triangles and move every
    table to `device`."""
    missing = wavefront_scope_missing(scene, cfg)
    if missing:
        raise NotImplementedError(
            "not yet ported to the path wavefront: " + ", ".join(missing))
    scene = prepare_scene(scene)
    device = torch.device(device)
    tabs = megatrace.pack_mega_tables_torch(scene, device)
    mt = scene.materials
    atlas = (None if scene.textures is None
             else scene.textures.data.to(device=device, dtype=torch.float32))
    return WavefrontTables(
        scene=dataclasses.replace(
            to_device(dataclasses.replace(scene, bvh=None), device),
            bvh=scene.bvh),
        rays=make_ray_tables(scene, device), cam=tabs[3].reshape(-1),
        mats=material_table_rows(mt, tabs[1]),
        emit=emitter_table_rows(scene, tabs),
        tex_id=tabs[1][:, 17].to(torch.int64), atlas=atlas,
        vcolors=(None if scene.vcolors is None
                 else scene.vcolors.to(device=device, dtype=torch.float32)),
        normal_tex=(mt.normal_tex_id.to(device=device, dtype=torch.int64)
                    if mt.has_normalmap and atlas is not None else None))


def trace_paths_wavefront(scene: Scene, cfg: PathConfig, u,
                          tables: WavefrontTables | None = None) -> Splats:
    """Trace camera paths u (R, >= cfg.n_dims) through the wavefront (the
    reference's trace_paths): NEE with the power heuristic (or none,
    cfg.use_nee False), min_depth, Russian roulette from rr_depth, the thin
    lens, the image environment's MIS; the shadow ray of bounce b is
    resolved in the fused query of bounce b + 1.  `tables`
    (make_wavefront_tables on u's device) may be passed to reuse them."""
    tb = tables if tables is not None else make_wavefront_tables(
        scene, cfg, u.device)
    sc, mats, er = tb.scene, tb.mats, tb.emit
    R = u.shape[0]
    lens = u[:, 2:4] if cfg.thinlens else None
    if sc.camera.kind == CAMERA_PERSPECTIVE and not sc.camera.rdist:
        o, d = camera_rays(tb.cam, u[:, 0], u[:, 1], lens)
    else:
        o, d = sample_ray(sc.camera, u[:, 0:2], lens)
    tp = torch.ones_like(o)
    L = torch.zeros_like(o)
    active = torch.ones(R, dtype=torch.bool, device=u.device)
    prev_pdf = torch.zeros_like(o[:, 0])
    prev_delta = active.clone()
    eta_scale = torch.ones_like(prev_pdf)
    sh_o, sh_d = o, d
    sh_tmax = torch.zeros_like(prev_pdf)
    sh_contrib = torch.zeros_like(o)
    for depth in range(1, cfg.max_depth + 1):
        ub = u[:, SENSOR_DIMS + (depth - 1) * BOUNCE_DIMS:
               SENSOR_DIMS + depth * BOUNCE_DIMS]
        hit, sh_blocked = intersect_and_occluded(sc, o, d, sh_o, sh_d,
                                                 sh_tmax, tables=tb.rays)
        # the BSDF-sampling strategy: emission at the hit, weighed against
        # NEE at the previous vertex (none after a Dirac one)
        wi_world = -d
        le = eval_emitter(er, hit.emitter_id, wi_world, hit.ng)
        nee_pdf = pdf_emitter_direct(er, o, hit.emitter_id, hit.p, hit.ng)
        w_bsdf = torch.where(prev_delta | (not cfg.use_nee), 1.0,
                             mis_power(prev_pdf, nee_pdf))
        L = L + torch.where(sh_blocked[:, None], 0.0, sh_contrib)
        depth_ok = depth >= cfg.min_depth
        hit_em = active & hit.valid & (hit.emitter_id >= 0) & depth_ok
        L = L + torch.where(hit_em[:, None], tp * le * w_bsdf[:, None], 0.0)
        escaped = active & ~hit.valid & depth_ok
        env = eval_env(er, d)
        if er.env_shape is not None and cfg.use_nee:
            w_env = torch.where(prev_delta, 1.0,
                                mis_power(prev_pdf, env_pdf_dir(er, d)))
            env = env * w_env[:, None]
        L = L + torch.where(escaped[:, None], tp * env, 0.0)
        if depth == cfg.max_depth:
            break   # the last bounce only gathers emission
        active = active & hit.valid

        ns = hit.ns
        if tb.normal_tex is not None:
            ns = apply_normal_map(tb.normal_tex[hit.mat_id.to(torch.int64)],
                                  tb.atlas, sc.tris, hit, ns)
        wi = to_local(ns, wi_world)
        mid = hit.mat_id.to(torch.int64)
        albedo = surface_albedo(mats.mat[mid, 1:4], tb.tex_id[mid], tb.atlas,
                                tb.vcolors, hit)
        eps_t = torch.clamp(hit.t, min=1.0)[:, None]
        if cfg.use_nee:
            ds = sample_emitter_direct(er, hit.p, ub[:, OFF_LIGHT_PICK:
                                                   OFF_LIGHT_PICK + 3])
            f_val, f_pdf = eval_bsdf_table(mats, mid, albedo, wi,
                                           to_local(ns, ds.d))
            nee_ok = (active & ~is_delta_table(mats, mid) & (ds.pdf > 0)
                      & (luminance(f_val) > 0)
                      & (depth + 1 >= cfg.min_depth))
            w_nee = torch.where(ds.delta, 1.0, mis_power(ds.pdf, f_pdf))
            contrib = tp * f_val * ds.radiance * (
                w_nee / torch.clamp(ds.pdf, min=1e-20))[:, None]
            sh_contrib = torch.where(nee_ok[:, None], contrib, 0.0)
            # a lane without a shadow ray keeps a finite origin
            sh_o = torch.where(nee_ok[:, None],
                               hit.p + ds.d * RAY_EPS * eps_t, o)
            sh_d = ds.d
            sh_tmax = torch.where(nee_ok, ds.dist * (1.0 - 1e-3) - RAY_EPS,
                                  0.0)

        bs = sample_bsdf_table(mats, mid, albedo, wi,
                               ub[:, OFF_BSDF_CMP:OFF_BSDF_CMP + 3])
        wo_world = to_world(ns, bs.wo)
        tp = tp * bs.weight
        eta_scale = eta_scale * bs.eta
        alive = active & (luminance(tp) > 0)
        if depth >= cfg.rr_depth:
            q = torch.clamp(tp.amax(-1) * eta_scale * eta_scale, max=0.95)
            survive = ub[:, OFF_RR] < q
            tp = torch.where(survive[:, None],
                             tp / torch.clamp(q, min=1e-8)[:, None], tp)
            alive = alive & survive
        o = torch.where(active[:, None], hit.p + wo_world * RAY_EPS * eps_t, o)
        d = torch.where(active[:, None], wo_world, d)
        tp = torch.where(alive[:, None], tp, 0.0)
        active = alive
        prev_pdf, prev_delta = bs.pdf, bs.delta
    return path_splats(u, L)


def make_path_trace(scene: Scene, cfg: PathConfig, device):
    """trace(u) -> Splats on `device`: the path kernel (ops.megatrace.
    path_trace; its twin on the CPU) where the trace kernels cover the
    scene, else the wavefront (trace_paths_wavefront).  A scene neither
    covers raises NotImplementedError naming what is missing."""
    if megatrace.mega_eligible(scene, cfg):
        tables = megatrace.make_tables(scene, cfg, device)

        def trace(u):
            return path_splats(u, megatrace.path_trace(
                tables, u[:, :cfg.n_dims].T.contiguous()).T)
    else:
        wtables = make_wavefront_tables(scene, cfg, device)

        def trace(u):
            return trace_paths_wavefront(scene, cfg, u[:, :cfg.n_dims],
                                         wtables)
    return trace


def make_path_trace_diff(scene: Scene, cfg: PathConfig, device="cuda"):
    """trace(leaves, u) -> Splats, differentiable in the scene leaves named
    in `leaves` ({"materials.albedo": tensor, ...}; the others are
    `scene`'s): the path kernel (its twin on the CPU) runs forward and the
    backward replays the twin under autograd
    (ops.megatrace.make_mega_trace_diff; counterpart of the reference's
    path.py:make_path_trace_diff).  Scenes outside the kernels' scope
    raise: gradients over the wavefront are not ported."""
    return megatrace.make_mega_trace_diff(scene, cfg, device)


def render_pt(scene: Scene, cfg: PathConfig, generator, n_samples: int,
              film_cfg, mode: str = "accum", chunk: int = 65536,
              sampler: str = "independent"):
    """Plain Monte-Carlo render: n_samples paths splatted to an (H, W, 4)
    film (the MC oracle the MCMC renders are checked against), through
    make_path_trace's route.  Develop with render.film.develop.

    `sampler` names the generator of the primary samples
    (render/sampler.py: independent, stratified, halton, hammersley,
    ldsampler, sobol); the others than independent index the samples
    globally, sample start + i of chunk start, and n_total, which
    hammersley's first dimension and stratified's strata read, is
    n_samples, the count drawn.  The reference's n_total is its chunk
    count times 16,384, n_samples rounded up to whole chunks."""
    device = generator.device
    trace = make_path_trace(scene, cfg, device)
    sample = make_sampler(sampler, generator, cfg.n_dims)
    film = filmlib.new_film(film_cfg, device)
    scale = torch.tensor([film_cfg.width, film_cfg.height],
                         dtype=torch.float32, device=device)
    for start in range(0, n_samples, chunk):
        sp = trace(sample(start, min(chunk, n_samples - start), n_samples))
        film = filmlib.splat(film_cfg, film, sp.pos[:, 0, :] * scale,
                             sp.value[:, 0, :], mode=mode)
    return film
