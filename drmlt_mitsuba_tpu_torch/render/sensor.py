"""Camera rays (counterpart of drmlt_mitsuba_tpu/render/sensor.py).
`camera_rays` serves the perspective sensor, pinhole or thin lens, from
the packed camera row in the order of the trace kernels; `sample_ray`
serves every sensor the reference has (orthographic, telecentric,
spherical, the radiance, fluence and irradiance meters and the radial
distortion of perspective_rdist) from the Camera record, for the path
wavefront, as the reference's sample_ray does.

`camera_rays` reads the camera table `cam` (24,) of ops/megatrace.py
(camera-to-world rotation 0:9 row-major, origin 9:12, tan of the half
fields of view 12:13, aperture radius 14, focus distance 15) and evaluates
in the order of the kernels (csrc/path_trace.cuh: camera_ray, after the
reference kernel's megatrace.py:852-889).  The thin lens consumes PSS dims
2-3 (integrators/layout.py): the origin on the aperture disk, the
direction through the point of the focus plane.
"""
from __future__ import annotations

import torch

import math

from drmlt_mitsuba_tpu_torch.core.math import dot, normalize
from drmlt_mitsuba_tpu_torch.core.warp import (
    square_to_cosine_hemisphere, square_to_uniform_disk_concentric,
    square_to_uniform_sphere,
)
from drmlt_mitsuba_tpu_torch.scene.types import (
    CAMERA_FLUENCEMETER, CAMERA_IRRADIANCEMETER, CAMERA_ORTHOGRAPHIC,
    CAMERA_RADIANCEMETER, CAMERA_SPHERICAL, CAMERA_TELECENTRIC,
)


def camera_rays(cam, u0, u1, u_lens=None):
    """(origins (R, 3), unit directions (R, 3)) of film positions (u0, u1)
    in [0, 1)^2 (x right, y down); u_lens (R, 2) the aperture uniforms of
    a thin lens, None for the pinhole."""
    R = u0.shape[0]
    x = (2.0 * u0 - 1.0) * cam[12]
    y = (1.0 - 2.0 * u1) * cam[13]
    if u_lens is None:
        dc = torch.stack([x, y, torch.ones_like(x)], -1)
        o = cam[9:12].expand(R, 3)
    else:
        lens = square_to_uniform_disk_concentric(u_lens)
        lx, ly = lens[:, 0] * cam[14], lens[:, 1] * cam[14]
        f_d = cam[15]
        dc = torch.stack([x * f_d - lx, y * f_d - ly, f_d.expand(R)], -1)
        o = torch.stack([cam[0] * lx + cam[1] * ly + cam[9],
                         cam[3] * lx + cam[4] * ly + cam[10],
                         cam[6] * lx + cam[7] * ly + cam[11]], -1)
    d = normalize(torch.stack([dot(cam[0:3].expand(R, 3), dc),
                               dot(cam[3:6].expand(R, 3), dc),
                               dot(cam[6:9].expand(R, 3), dc)], -1))
    return o, d


def _point(m, p):
    return p @ m[:3, :3].T + m[:3, 3]


def _vector(m, v):
    return v @ m[:3, :3].T


def sample_ray(camera, uv, u_aperture=None):
    """(origins (R, 3), unit directions (R, 3)) of film positions uv (R,
    2) in [0, 1)^2 (x right, y down) for the Camera `camera` (its tensors
    on uv's device); u_aperture (R, 2) the lens uniforms of a thin lens or
    a telecentric lens (the reference's sample_ray)."""
    m = camera.to_world
    R = uv.shape[0]
    x = (2.0 * uv[:, 0] - 1.0) * camera.tan_half_fov_x
    y = (1.0 - 2.0 * uv[:, 1]) * camera.tan_half_fov_y
    org = m[:3, 3].expand(R, 3)
    kind = camera.kind
    if kind == CAMERA_RADIANCEMETER:
        return org, normalize(m[:3, 2]).expand(R, 3)
    if kind in (CAMERA_IRRADIANCEMETER, CAMERA_FLUENCEMETER,
                CAMERA_SPHERICAL):
        if kind == CAMERA_IRRADIANCEMETER:
            d_cam = square_to_cosine_hemisphere(uv)
        elif kind == CAMERA_FLUENCEMETER:
            d_cam = square_to_uniform_sphere(uv)
        else:
            theta = uv[:, 1] * math.pi
            phi = (uv[:, 0] * 2.0 - 1.0) * math.pi
            st = torch.sin(theta)
            d_cam = torch.stack([st * torch.sin(phi), torch.cos(theta),
                                 st * torch.cos(phi)], -1)
        return org, normalize(_vector(m, d_cam))
    if kind == CAMERA_TELECENTRIC:
        if u_aperture is None:
            u_aperture = torch.full((R, 2), 0.5, device=uv.device)
        lens = (square_to_uniform_disk_concentric(u_aperture)
                * camera.aperture_radius)
        o_cam = torch.stack([x + lens[:, 0], y + lens[:, 1],
                             torch.zeros_like(x)], -1)
        p_focus = torch.stack([x, y, torch.ones_like(x)
                               * camera.focus_distance], -1)
        return _point(m, o_cam), normalize(_vector(m, p_focus - o_cam))
    if kind == CAMERA_ORTHOGRAPHIC:
        o_cam = torch.stack([x, y, torch.zeros_like(x)], -1)
        z = torch.zeros_like(o_cam)
        z[:, 2] = 1.0
        return _point(m, o_cam), normalize(_vector(m, z))
    if camera.rdist:
        # Newton on the radius inverts p_d = p_u (1 + k0 r^2 + k1 r^4)
        k0, k1 = camera.kc[0], camera.kc[1]
        rd = torch.sqrt(x * x + y * y)
        ru = rd
        for _ in range(4):
            f = ru * (1.0 + k0 * ru * ru + k1 * ru ** 4) - rd
            fp = 1.0 + 3.0 * k0 * ru * ru + 5.0 * k1 * ru ** 4
            ru = ru - f / torch.clamp(fp, min=1e-6)
        scale = torch.where(rd > 1e-9, ru / torch.clamp(rd, min=1e-9), 1.0)
        x, y = x * scale, y * scale
    d_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    if u_aperture is not None:
        p_focus = d_cam * camera.focus_distance
        lens = (square_to_uniform_disk_concentric(u_aperture)
                * camera.aperture_radius)
        o_cam = torch.stack([lens[:, 0], lens[:, 1],
                             torch.zeros_like(lens[:, 0])], -1)
        d_cam = p_focus - o_cam
    else:
        o_cam = torch.zeros_like(d_cam)
    return _point(m, o_cam), normalize(_vector(m, d_cam))
