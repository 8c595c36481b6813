"""Small forward renderers (counterpart of
drmlt_mitsuba_tpu/integrators/misc.py):

* render_ptracer: the adjoint particle tracer; light subpaths whose every
  vertex is connected to the sensor at weight 1 (the t = 1 strategies;
  the reference's ptracer.cpp), the light image is the render;
* render_field: first-hit field AOVs (position, relposition, distance,
  geonormal, shnormal, uv, albedo, primindex, shapeindex; field.cpp);
* render_multichannel: field channels and a radiance pass stacked
  (multichannel.cpp);
* render_motion_aov: the film-space velocity of the first hit over the
  shutter interval from Scene.motion (motion.cpp).

Each builds the bidirectional layer's tables (integrators/bidir.py:
BidirTables) once a call, or takes them built; every ray goes through
ops/intersect.py (the intersection kernel on a CUDA tensor), every trace
through trace_bdpt or the path kernel, and every film add through
render/film.py:splat (the splat kernel).  The uniforms come from the
generator, or from `u` when a caller passes them.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.math import cdiv, normalize
from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.integrators.bidir import (
    BDPTConfig, BidirTables, _albedo_uv, _tables, sensor_importance,
    trace_bdpt,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import render_pt
from drmlt_mitsuba_tpu_torch.ops.intersect import intersect
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.render.sensor import camera_rays

FIELD_KINDS = ("position", "relposition", "distance", "geonormal",
               "shnormal", "uv", "albedo", "primindex", "shapeindex")


def _config(scene, max_depth: int = 1) -> BDPTConfig:
    """The bidirectional config of `scene` (a Scene or its BidirTables):
    a thin lens when its camera has an aperture."""
    cam = (scene.scene if isinstance(scene, BidirTables) else scene).camera
    return BDPTConfig(max_depth=max_depth, light_image=True,
                      thinlens=float(cam.aperture_radius) > 0.0)


def _bidir(scene, device) -> BidirTables:
    """`scene`'s tables on `device`, or `scene` when it is a BidirTables."""
    return _tables(scene, _config(scene), device)


def _film_scale(film_cfg, device):
    return torch.tensor([film_cfg.width, film_cfg.height],
                        dtype=torch.float32, device=device)


def render_ptracer(scene, film_cfg, generator, n_paths: int,
                   max_depth: int = 5, chunk: int = 8192, u=None):
    """The adjoint particle tracer.  A path of length k has one t = 1
    strategy (s = k), so the unweighted light-image splats of
    trace_bdpt(mis=False) sum to ptracer.cpp's estimator over lengths
    1..max_depth: slot 0 (the eye splat, t >= 2) is zeroed and the rest
    splatted, in max(1, n_paths // chunk) chunks of `chunk` samples.
    `u` (n_chunks chunk, n_dims) replaces the generator's uniforms.
    Returns the developed (H, W, 3) image, scaled by W H / (n_chunks
    chunk)."""
    bcfg = _config(scene, max_depth)
    device = generator.device
    tb = _tables(scene, bcfg, device)
    W, H = film_cfg.width, film_cfg.height
    n_chunks = max(1, n_paths // chunk)
    scale = _film_scale(film_cfg, device)
    film = filmlib.new_film(film_cfg, device)
    for i in range(n_chunks):
        ui = (uniform((chunk, bcfg.n_dims), generator) if u is None
              else u[i * chunk:(i + 1) * chunk])
        sp = trace_bdpt(tb, bcfg, ui, mis=False)
        val = sp.value.clone()
        val[:, 0] = 0.0
        film = filmlib.splat(film_cfg, film, sp.pos.reshape(-1, 2) * scale,
                             val.reshape(-1, 3), mode="splat")
    return filmlib.develop(film_cfg, film, mode="splat",
                           scale=W * H / (n_chunks * chunk))


def first_hit_fields(tb: BidirTables, film_cfg, u):
    """Pixel-stratified camera rays, sample i in pixel i mod W H, and
    their first hits: (film uv (R, 2), o, d, Hit); u (R, 4) holds the
    pixel jitter and the lens uniforms."""
    W, H = film_cfg.width, film_cfg.height
    pix = torch.arange(u.shape[0], device=u.device) % (W * H)
    uv = torch.stack([cdiv((pix % W).to(torch.float32) + u[:, 0], float(W)),
                      cdiv((pix // W).to(torch.float32) + u[:, 1], float(H))],
                     -1)
    thin = float(tb.scene.camera.aperture_radius) > 0.0
    o, d = camera_rays(tb.cam, uv[:, 0], uv[:, 1],
                       u[:, 2:4] if thin else None)
    return uv, o, d, intersect(tb.scene, o, d, tables=tb.rays)


def _hit_uniforms(film_cfg, generator, spp: int, u):
    return (uniform((film_cfg.npixels * spp, 4), generator) if u is None
            else u)


def splat_aov(film_cfg, uv, val):
    """One splat a sample at its film position, developed to the mean."""
    film = filmlib.splat(film_cfg, filmlib.new_film(film_cfg, uv.device),
                         uv * _film_scale(film_cfg, uv.device), val,
                         mode="splat")
    return filmlib.develop(film_cfg, film, mode="splat",
                           scale=film_cfg.npixels / uv.shape[0])


def render_field(scene, film_cfg, generator, kind: str, spp: int = 4,
                 u=None):
    """First-hit field AOV image (H, W, 3) at spp samples a pixel
    (field.cpp); a miss adds zeros.  `u` (W H spp, 4) replaces the
    generator's uniforms.  albedo reads the bitmap page at the hit's
    texture coordinates (integrators/bidir.py:_albedo_uv)."""
    if kind not in FIELD_KINDS:
        raise ValueError(f"unknown field {kind!r} (have {FIELD_KINDS})")
    tb = _bidir(scene, generator.device)
    uv, o, d, hit = first_hit_fields(
        tb, film_cfg, _hit_uniforms(film_cfg, generator, spp, u))
    return splat_aov(film_cfg, uv, field_values(tb, o, d, hit, kind))


def field_values(tb: BidirTables, o, d, hit, kind: str):
    """(R, 3) per-sample values of a field AOV at the first hits `hit` of
    rays (o, d); zero where a ray misses."""
    if kind in ("position", "relposition"):
        val = o + hit.t[:, None] * d
        if kind == "relposition":
            val = val - tb.cam[9:12]
    elif kind == "distance":
        val = hit.t[:, None].expand(-1, 3)
    elif kind == "geonormal":
        val = hit.ng
    elif kind == "shnormal":
        val = hit.ns
    elif kind == "uv":
        val = torch.cat([hit.tex_uv, torch.zeros_like(hit.tex_uv[:, :1])],
                        -1)
    elif kind == "albedo":
        val = _albedo_uv(tb, hit.mat_id, hit.tex_uv)["albedo"]
    elif kind == "primindex":
        val = hit.prim.to(torch.float32)[:, None].expand(-1, 3)
    else:                                        # shapeindex: the material
        val = hit.mat_id.to(torch.float32)[:, None].expand(-1, 3)
    return torch.where(hit.valid[:, None], val, 0.0)


def render_multichannel(scene, film_cfg, generator, channels=None,
                        spp: int = 4, radiance_spp: int = 16,
                        max_depth: int = 5):
    """The requested channels, each a pass, stacked into (H, W, 3 n)
    (multichannel.cpp): "radiance" is render_pt at radiance_spp paths a
    pixel and max_depth (no Russian roulette), the others render_field at
    spp.  The passes draw from `generator` in channel order."""
    channels = channels or ("radiance", "shnormal", "distance", "albedo")
    tb = _bidir(scene, generator.device)
    pcfg = PathConfig(max_depth=max_depth, rr_depth=100,
                      thinlens=_config(tb).thinlens)
    planes = []
    for ch in channels:
        if ch == "radiance":
            film = render_pt(tb.scene, pcfg, generator,
                             film_cfg.npixels * radiance_spp, film_cfg,
                             mode="accum")
            planes.append(filmlib.develop(film_cfg, film, mode="accum"))
        else:
            planes.append(render_field(tb, film_cfg, generator, ch, spp))
    return torch.cat(planes, -1)


def render_motion_aov(scene, film_cfg, generator, spp: int = 4, u=None):
    """Film-space velocity AOV (motion.cpp): the first hit's displacement
    over the shutter interval (Scene.motion's deltas at the hit's
    barycentrics) projected through the camera, (vx, vy, 0) in pixels; a
    static scene gives zeros.  As in the reference, a sphere hit reads
    triangle 0's motion (its negative prim id clamped)."""
    tb = _bidir(scene, generator.device)
    uv, o, d, hit = first_hit_fields(
        tb, film_cfg, _hit_uniforms(film_cfg, generator, spp, u))
    p = o + hit.t[:, None] * d
    mo = tb.scene.motion
    if mo is None:
        vel = torch.zeros_like(p)
    else:
        ti = torch.clamp(hit.prim.to(torch.int64), 0, mo.dv0.shape[0] - 1)
        b1, b2 = hit.uv[:, 0:1], hit.uv[:, 1:2]
        vel = mo.dv0[ti] + mo.de1[ti] * b1 + mo.de2[ti] * b2
    cam_p = tb.cam[9:12]
    _, uv0, ok0 = sensor_importance(tb, normalize(p - cam_p))
    _, uv1, ok1 = sensor_importance(tb, normalize(p + vel - cam_p))
    ok = (ok0 & ok1 & hit.valid)[:, None]
    dpix = torch.where(ok, (uv1 - uv0) * _film_scale(film_cfg, p.device),
                       0.0)
    return splat_aov(film_cfg, uv,
                     torch.cat([dpix, torch.zeros_like(dpix[:, :1])], -1))
