"""Reconstruction filters (counterpart of drmlt_mitsuba_tpu/render/filters.py).

Slice 1 ports the box filter, the one the chain kernel splats with (and the
CLI's DRMLT film).  The other five reference filters come later.
"""
from __future__ import annotations

import dataclasses
import math

import torch

FILTER_BOX = "box"

_DEFAULTS = {FILTER_BOX: 0.5}


@dataclasses.dataclass(frozen=True)
class Filter:
    name: str
    radius: float       # support half-width in pixels
    footprint: int      # static pixels per axis touched by one splat

    def eval1d(self, x):
        """Filter value at signed pixel offset x."""
        return torch.where(torch.abs(x) <= self.radius, 1.0, 0.0)


def make_filter(name: str, radius: float | None = None) -> Filter:
    if name not in _DEFAULTS:
        raise NotImplementedError(f"reconstruction filter {name!r} not yet "
                                  f"ported (have {sorted(_DEFAULTS)})")
    r = _DEFAULTS[name] if radius is None else float(radius)
    return Filter(name=name, radius=r, footprint=max(1, math.ceil(2.0 * r)))
