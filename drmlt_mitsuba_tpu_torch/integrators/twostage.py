"""Two-stage MLT's importance map (counterpart of
drmlt_mitsuba_tpu/integrators/twostage.py).

A first stage renders a 1/16-resolution luminance image and upsamples it
into an importance map (src/libbidir/util.cpp:96-200); the MCMC trace's
splats are divided by the map (SplatList::normalize(importanceMap),
pathsampler.cpp:1001-1028), so chains spread evenly over the image, and
the developed image is multiplied by it again (drmlt_proc.cpp:813-854).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from drmlt_mitsuba_tpu_torch.core.spectrum import luminance
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats


def luminance_pass(render_lowres_fn, film_cfg, downsample: int = 16,
                   floor_frac: float = 0.1):
    """The first stage's luminance image, as a full-resolution (H, W)
    importance map.

    render_lowres_fn(width, height) -> (h, w, 3) radiance image.  The map
    is clamped below at floor_frac x its mean, then upsampled bilinearly
    with half-pixel centres (jax.image.resize's "bilinear")."""
    lw = max(1, film_cfg.width // downsample)
    lh = max(1, film_cfg.height // downsample)
    lum = luminance(render_lowres_fn(lw, lh))
    lum = torch.clamp(lum, min=floor_frac * lum.mean())
    return F.interpolate(lum[None, None], size=(film_cfg.height,
                                                film_cfg.width),
                         mode="bilinear", align_corners=False)[0, 0]


def sample_importance(imap, pos):
    """Bilinear lookup of the importance map at film positions (..., 2) in
    [0, 1)^2, at least 1e-12."""
    h, w = imap.shape
    x = torch.clamp(pos[..., 0], 0.0, 1.0 - 1e-6) * w - 0.5
    y = torch.clamp(pos[..., 1], 0.0, 1.0 - 1e-6) * h - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    v = (imap[y0, x0] * (1 - fx) * (1 - fy) + imap[y0, x1] * fx * (1 - fy)
         + imap[y1, x0] * (1 - fx) * fy + imap[y1, x1] * fx * fy)
    return torch.clamp(v, min=1e-12)


def with_importance_map(trace_fn, imap):
    """The trace with its splats divided by the importance map (the
    two-stage target density); develop multiplies the map back
    (apply_importance_to_image)."""

    def trace(u) -> Splats:
        sp = trace_fn(u)
        val = sp.value / sample_importance(imap, sp.pos)[..., None]
        return Splats(pos=sp.pos, value=val, lum=luminance(val.sum(1)))

    return trace


def apply_importance_to_image(img, imap):
    """The two-stage develop's last step: multiply the map back."""
    return img * imap[..., None]
