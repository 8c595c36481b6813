"""Film and splatting (counterpart of drmlt_mitsuba_tpu/render/film.py).

The film is an (H, W, 4) tensor: rgb plus a filter-weight channel.  Two
accumulation modes, as in the reference:

  * accum — sampling integrators: filter-weighted radiance and weight are
    accumulated separately; develop() divides.
  * splat — MLT splats: each splat's footprint weights are normalised to 1;
    develop() scales by a caller-provided factor (b / mutations per pixel).

`splat` is the exact f32 scatter-add of film.py:71-105 (index_put_ with
accumulate); taps outside the image get zero weight, so a position of
exactly W (or H) is dropped, not clamped.
"""
from __future__ import annotations

import dataclasses

import torch

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


def new_film(cfg: FilmConfig, device=None):
    return torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                       device=device)


def _footprint(cfg: FilmConfig, pos):
    """Separable footprint of continuous pixel positions (N, 2): clamped
    pixel indices and 1-D filter weights, each (N, F)."""
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
    return (torch.clamp(px, 0, cfg.width - 1),
            torch.clamp(py, 0, cfg.height - 1), wx, wy)


def splat(cfg: FilmConfig, film, pos, value, weight=None, mode="splat"):
    """Scatter-add a batch of splats into `film` in place and return it.

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
    flat_idx = (py[:, None, :] * cfg.width + px[:, :, None]).reshape(-1)
    film.view(-1, 4).index_put_((flat_idx,), vals, accumulate=True)
    return film


def develop(cfg: FilmConfig, film, mode: str = "splat", scale: float = 1.0):
    """The final (H, W, 3) image: accum divides by the weight channel,
    splat multiplies by `scale`."""
    rgb = film[..., :3]
    if mode == "accum":
        w = film[..., 3:4]
        return torch.where(w > 0, rgb / torch.clamp(w, min=1e-12), 0.0)
    return rgb * scale
