"""4x4 homogeneous transforms (counterpart of
drmlt_mitsuba_tpu/core/transform.py): host-side builders in numpy, returned
as float32 torch tensors.

`translate`, `scale`, `rotate` (axis-angle, degrees) and `matrix` build
the float64 numpy matrices of the Mitsuba XML `<transform>` elements:
scene/xml.py composes them and rounds the product to float32 once, as
the reference loader does (xml.py:_parse_transform).  `look_at` builds a
camera's float32 transform.
"""
from __future__ import annotations

import numpy as np
import torch


def translate(v):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(v, np.float64)
    return m


def scale(v):
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = np.broadcast_to(np.asarray(v, np.float64),
                                                (3,))
    return m


def rotate(axis, angle_deg):
    """Rotation by angle_deg about axis (a zero axis leaves it as given,
    as the reference's XML loader does)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    x, y, z = axis / (n if n > 0 else 1.0)
    a = np.deg2rad(float(angle_deg))
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ]
    return m


def matrix(values):
    """A 4x4 matrix from 16 row-major values."""
    return np.asarray(values, np.float64).reshape(4, 4)


def look_at(origin, target, up):
    """Camera-to-world transform, Mitsuba convention (+z = view direction)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return torch.from_numpy(m)
