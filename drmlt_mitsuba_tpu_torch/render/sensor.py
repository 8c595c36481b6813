"""Camera rays from the packed camera row (counterpart of
drmlt_mitsuba_tpu/render/sensor.py: the perspective sensor, pinhole or
thin lens).

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

from drmlt_mitsuba_tpu_torch.core.math import dot, normalize
from drmlt_mitsuba_tpu_torch.core.warp import square_to_uniform_disk_concentric


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
