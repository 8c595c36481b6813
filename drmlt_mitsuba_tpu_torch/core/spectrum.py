"""RGB spectrum helpers (counterpart of drmlt_mitsuba_tpu/core/spectrum.py).

The luminance weights are the reference's Rec.709 coefficients; the MCMC
target density is luminance.
"""
from __future__ import annotations

LUMINANCE_WEIGHTS = (0.212671, 0.715160, 0.072169)


def luminance(rgb):
    """Relative luminance; the last axis is the channel."""
    wr, wg, wb = LUMINANCE_WEIGHTS
    return wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]
