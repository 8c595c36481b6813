"""4x4 homogeneous transforms (counterpart of
drmlt_mitsuba_tpu/core/transform.py): host-side builders in numpy, returned
as float32 torch tensors."""
from __future__ import annotations

import numpy as np
import torch


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
