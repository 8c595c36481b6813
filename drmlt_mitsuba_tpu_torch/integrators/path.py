"""Unidirectional path tracer with NEE + MIS, as L(u) (counterpart of
drmlt_mitsuba_tpu/integrators/path.py).

The function is pure in the primary-sample matrix u (R, n_dims), so the
same trace serves plain Monte-Carlo rendering (u uniform) and MCMC (u =
chain state).  `make_path_trace` runs the CUDA path kernel on a CUDA
device (ops/megatrace.py); `trace_paths` is its plain-PyTorch twin, and
is differentiable in the scene's float leaves.  `make_path_trace_diff`
is the differentiable trace of inverse rendering.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.integrators.layout import (  # noqa: F401
    PathConfig, Splats, path_splats,
)
from drmlt_mitsuba_tpu_torch.ops import megatrace
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.types import Scene


def trace_paths(scene: Scene, cfg: PathConfig, u) -> Splats:
    """Plain-PyTorch trace of a batch of camera paths u (R, cfg.n_dims),
    differentiable in the scene's float leaves."""
    tables = megatrace.make_tables(scene, cfg, u.device)
    return path_splats(u, megatrace.path_trace_reference(
        tables, u[:, :cfg.n_dims].T).T)


def make_path_trace(scene: Scene, cfg: PathConfig, device):
    """trace(u) -> Splats through ops.megatrace.path_trace: the CUDA path
    kernel for tensors on a CUDA device, its twin on the CPU."""
    tables = megatrace.make_tables(scene, cfg, device)

    def trace(u):
        return path_splats(u, megatrace.path_trace(
            tables, u[:, :cfg.n_dims].T.contiguous()).T)

    return trace


def make_path_trace_diff(scene: Scene, cfg: PathConfig, device="cuda"):
    """trace(leaves, u) -> Splats, differentiable in the scene leaves named
    in `leaves` ({"materials.albedo": tensor, ...}; the others are
    `scene`'s): the path kernel (its twin on the CPU) runs forward and the
    backward replays the twin under autograd
    (ops.megatrace.make_mega_trace_diff; counterpart of the reference's
    path.py:make_path_trace_diff)."""
    return megatrace.make_mega_trace_diff(scene, cfg, device)


def render_pt(scene: Scene, cfg: PathConfig, generator, n_samples: int,
              film_cfg, mode: str = "accum", chunk: int = 65536):
    """Plain Monte-Carlo render: n_samples independent paths splatted to
    an (H, W, 4) film (the MC oracle the MCMC renders are checked
    against).  Develop with render.film.develop."""
    device = generator.device
    trace = make_path_trace(scene, cfg, device)
    film = filmlib.new_film(film_cfg, device)
    scale = torch.tensor([film_cfg.width, film_cfg.height],
                         dtype=torch.float32, device=device)
    for start in range(0, n_samples, chunk):
        n = min(chunk, n_samples - start)
        u = uniform((n, cfg.n_dims), generator)
        sp = trace(u)
        film = filmlib.splat(film_cfg, film, sp.pos[:, 0, :] * scale,
                             sp.value[:, 0, :], mode=mode)
    return film
