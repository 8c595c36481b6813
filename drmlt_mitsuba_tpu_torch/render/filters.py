"""Reconstruction filters (counterpart of drmlt_mitsuba_tpu/render/filters.py).

Box, tent, gaussian, mitchell, catmullrom and lanczos, each a 1-D function
f(x) of the signed pixel offset with a radius; the film splats a separable
footprint of ceil(2 radius) pixels a side.  The chain kernel splats with
the box filter only (footprint 1); the other filters go through the
generic DRMLT step (integrators/drmlt.py:render_drmlt) and the splat
kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

FILTER_BOX = "box"
FILTER_TENT = "tent"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"
FILTER_CATMULLROM = "catmullrom"
FILTER_LANCZOS = "lanczos"

_DEFAULTS = {
    FILTER_BOX: 0.5,
    FILTER_TENT: 1.0,
    FILTER_GAUSSIAN: 2.0,
    FILTER_MITCHELL: 2.0,
    FILTER_CATMULLROM: 2.0,
    FILTER_LANCZOS: 3.0,
}
LANCZOS_TAPS = 3.0


def _cubic(ax, B: float, C: float):
    """Mitchell-Netravali's (B, C) cubic at |x| (mitchell B = C = 1/3,
    catmullrom B = 0, C = 1/2)."""
    x2 = ax * ax
    x3 = x2 * ax
    inner = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
             + (6 - 2 * B)) * (1.0 / 6.0)
    outer = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
             + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) * (1.0 / 6.0)
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))


@dataclasses.dataclass(frozen=True)
class Filter:
    name: str
    radius: float       # support half-width in pixels
    footprint: int      # static pixels per axis touched by one splat

    def eval1d(self, x):
        """Filter value at signed pixel offset x."""
        ax = torch.abs(x)
        if self.name == FILTER_BOX:
            return torch.where(ax <= self.radius, 1.0, 0.0)
        if self.name == FILTER_TENT:
            return torch.clamp(1.0 - ax / self.radius, min=0.0)
        if self.name == FILTER_GAUSSIAN:
            # sigma = radius / 4, less its value at the radius
            sigma = self.radius / 4.0
            alpha = -1.0 / (2.0 * sigma * sigma)
            tail = math.exp(alpha * self.radius * self.radius)
            return torch.clamp(torch.exp(alpha * ax * ax) - tail, min=0.0)
        if self.name == FILTER_MITCHELL:
            return _cubic(ax, 1.0 / 3.0, 1.0 / 3.0)
        if self.name == FILTER_CATMULLROM:
            return _cubic(ax, 0.0, 0.5)
        if self.name == FILTER_LANCZOS:
            t = LANCZOS_TAPS
            px = math.pi * ax
            far = ax > 1e-6
            sinc = torch.where(far, torch.sin(px) / torch.clamp(px, min=1e-9),
                               1.0)
            wind = torch.where(far, torch.sin(px / t)
                               / torch.clamp(px / t, min=1e-9), 1.0)
            return torch.where(ax < t, sinc * wind, 0.0)
        raise ValueError(self.name)


def make_filter(name: str, radius: float | None = None) -> Filter:
    if name not in _DEFAULTS:
        raise ValueError(f"unknown reconstruction filter '{name}'")
    r = _DEFAULTS[name] if radius is None else float(radius)
    return Filter(name=name, radius=r, footprint=max(1, math.ceil(2.0 * r)))
