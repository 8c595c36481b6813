"""Film splat: scatter-add of filter taps into an (H, W, 4) film.

`splat_add_(film, py, px, vals)` adds vals (N, 4) at integer pixels
(py, px) in place: on a CUDA film it launches
`csrc/splat.cu:splat_add_kernel`, the port of the reference's Pallas
kernel `splat_kernel.py:splat_add` (:79); on a CPU film it runs the plain
twin `splat_add_reference_`, the exact f32 scatter of the reference's
film.py:102-105.  `splat_add` is the out-of-place, differentiable form
(film + scatter, as the reference's `splat_add` returns); its backward is
the gather g[py, px], computed in plain PyTorch as the reference computes
it outside its kernel (splat_kernel.py:118-127).

A tap outside the film is dropped, forward and backward (its gradient is
0): the reference's kernel drops it too, since its one-hot rows match no
pixel.  Indices reach the kernel as int32 (film.taps makes them so).
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.ops import build


def _check(film, py, px, vals):
    if film.dtype != torch.float32 or film.dim() != 3 or film.shape[2] != 4:
        raise ValueError("film must be a float32 (H, W, 4) tensor")
    if not film.is_contiguous():
        raise ValueError("film must be contiguous (the kernel adds in place)")
    n = vals.shape[0]
    if vals.dtype != torch.float32 or vals.shape != (n, 4):
        raise ValueError("vals must be a float32 (N, 4) tensor")
    if py.shape != (n,) or px.shape != (n,):
        raise ValueError("py and px must be (N,) beside vals (N, 4)")
    if py.dtype.is_floating_point or px.dtype.is_floating_point:
        raise ValueError("py and px must be integer tensors")
    for t in (py, px, vals):
        if t.device != film.device:
            raise ValueError(f"splat inputs on {t.device}, film on "
                             f"{film.device}")


def _in_film(film, py, px):
    """(inside, flat): which taps lie on the film, and their flat pixel
    index (0 for a tap outside)."""
    H, W = film.shape[:2]
    py = py.to(torch.int64)
    px = px.to(torch.int64)
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    return inside, torch.where(inside, py * W + px, 0)


def splat_add_reference_(film, py, px, vals):
    """Plain twin: film[py, px] += vals, in place (exact f32 scatter); a
    tap outside the film adds 0."""
    inside, flat = _in_film(film, py, px)
    film.view(-1, 4).index_put_(
        (flat,), torch.where(inside[:, None], vals, 0.0), accumulate=True)
    return film


def splat_add_(film, py, px, vals):
    """film[py, px] += vals in place and return film.

    A CUDA film launches splat_add_kernel; a CPU film runs the twin."""
    _check(film, py, px, vals)
    if film.device.type == "cpu":
        return splat_add_reference_(film, py, px, vals)
    if film.device.type != "cuda":
        raise NotImplementedError(f"no splat kernel for {film.device}")
    # int32 indices as film.taps makes them: no conversion launches
    py = py.to(torch.int32).contiguous()
    px = px.to(torch.int32).contiguous()
    vals = vals.contiguous()
    if vals.data_ptr() % 16:          # the kernel reads a tap as one float4
        vals = vals.clone()
    lib = build.load()
    stream = torch.cuda.current_stream(film.device).cuda_stream
    rc = lib.splat_add_launch(film.data_ptr(), film.shape[0], film.shape[1],
                              py.data_ptr(), px.data_ptr(), vals.data_ptr(),
                              vals.shape[0], stream)
    build.check(rc, "splat_add_kernel")
    build.LAUNCHES["splat_add"] += 1
    return film


class _SplatAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, film, py, px, vals):
        ctx.save_for_backward(py, px)
        return splat_add_(film.clone(), py, px, vals)

    @staticmethod
    def backward(ctx, g):
        g_vals = None
        if ctx.needs_input_grad[3]:
            inside, flat = _in_film(g, *ctx.saved_tensors)
            g_vals = torch.where(inside[:, None], g.reshape(-1, 4)[flat], 0.0)
        return g, None, None, g_vals


def splat_add(film, py, px, vals):
    """film + scatter of vals at (py, px): out of place, differentiable in
    film and vals."""
    return _SplatAdd.apply(film, py, px, vals)
