"""Film and splatting (counterpart of drmlt_mitsuba_tpu/render/film.py).

The film is an (H, W, 4) tensor: rgb plus a filter-weight channel.  Two
accumulation modes, as in the reference:

  * accum — sampling integrators: filter-weighted radiance and weight are
    accumulated separately; develop() divides.
  * splat — MLT splats: each splat's footprint weights are normalised to 1;
    develop() scales by a caller-provided factor (b / mutations per pixel).

`splat` computes the taps of film.py:71-105 and adds them through
ops/splat.py: the splat kernel on a CUDA film, the exact f32 scatter
(index_put_ with accumulate) on a CPU film.  Taps outside the image get
zero weight, so a position of exactly W (or H) is dropped, not clamped.
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.ops.splat import splat_add, splat_add_
from drmlt_mitsuba_tpu_torch.render.filters import Filter, make_filter


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    width: int
    height: int
    filter: Filter

    @property
    def npixels(self):
        return self.width * self.height


def make_film_config(width: int, height: int, filter_name: str = "box",
                     radius: float | None = None) -> FilmConfig:
    return FilmConfig(width=width, height=height,
                      filter=make_filter(filter_name, radius))


def new_film(cfg: FilmConfig, device):
    """A zero (H, W, 4) film on `device` (no default: a film is never made
    on the CPU by accident)."""
    return torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                       device=device)


def _footprint(cfg: FilmConfig, pos):
    """Separable footprint of continuous pixel positions (N, 2): clamped
    int32 pixel indices and 1-D filter weights, each (N, F)."""
    f = cfg.filter
    base_x = torch.floor(pos[:, 0] - f.radius + 0.5).to(torch.int64)
    base_y = torch.floor(pos[:, 1] - f.radius + 0.5).to(torch.int64)
    offs = torch.arange(f.footprint, device=pos.device)
    px = base_x[:, None] + offs[None, :]
    py = base_y[:, None] + offs[None, :]
    wx = f.eval1d(px.to(torch.float32) + 0.5 - pos[:, 0:1])
    wy = f.eval1d(py.to(torch.float32) + 0.5 - pos[:, 1:2])
    wx = torch.where((px >= 0) & (px < cfg.width), wx, 0.0)
    wy = torch.where((py >= 0) & (py < cfg.height), wy, 0.0)
    return (torch.clamp(px, 0, cfg.width - 1).to(torch.int32),
            torch.clamp(py, 0, cfg.height - 1).to(torch.int32), wx, wy)


def taps(cfg: FilmConfig, pos, value, weight=None, mode="splat"):
    """The filter taps of a batch of splats: (py, px, vals), each tap a
    pixel and its rgb + weight (N * F * F of them, F the footprint).

    pos: (N, 2) continuous pixel coordinates; value: (N, 3); weight: (N,)
    optional per-splat scalar (MLT acceptance weights)."""
    px, py, wx, wy = _footprint(cfg, pos)
    w2 = wx[:, :, None] * wy[:, None, :]
    if mode == "splat":
        w2 = w2 / torch.clamp(w2.sum((1, 2), keepdim=True), min=1e-12)
    if weight is not None:
        value = value * weight[:, None]
        w_chan = weight
    else:
        w_chan = torch.ones(value.shape[:1], dtype=value.dtype,
                            device=value.device)
    contrib = torch.cat([value, w_chan[:, None]], -1)
    vals = (w2[:, :, :, None] * contrib[:, None, None, :]).reshape(-1, 4)
    F = cfg.filter.footprint
    n = py.shape[0]
    return (py[:, None, :].expand(n, F, F).reshape(-1),
            px[:, :, None].expand(n, F, F).reshape(-1), vals)


def splat(cfg: FilmConfig, film, pos, value, weight=None, mode="splat"):
    """Scatter-add a batch of splats (see `taps`) into `film` and return
    the film.  The add is in place unless autograd records it (film or
    value requires grad): then the film is not touched and a new film,
    differentiable in both, is returned (the reference's splat_add is
    functional)."""
    py, px, vals = taps(cfg, pos, value, weight, mode)
    if torch.is_grad_enabled() and (film.requires_grad or vals.requires_grad):
        return splat_add(film, py, px, vals)
    return splat_add_(film, py, px, vals)


def develop(cfg: FilmConfig, film, mode: str = "splat", scale: float = 1.0):
    """The final (H, W, 3) image: accum divides by the weight channel,
    splat multiplies by `scale`."""
    rgb = film[..., :3]
    if mode == "accum":
        w = film[..., 3:4]
        return torch.where(w > 0, rgb / torch.clamp(w, min=1e-12), 0.0)
    return rgb * scale
