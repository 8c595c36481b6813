"""MMLT technique wiring (counterpart of
drmlt_mitsuba_tpu/integrators/mmlt.py).

The pooled MMLT encoding gives the chain's PSS vector two leading
technique dims:
  u[0]  depth dim    - pinned; depth = 1 + floor(u0 * D);
  u[1]  strategy dim - frozen on small steps (moves only on large steps).
The traced value is multiplied by D (uniform depth pmf), so b and every
MH ratio are consistent with the plain Monte-Carlo estimator.  This is the
MMLT kernel's own interface (ops/megammlt.py; a thin-lens scene takes
the bidirectional wavefront, integrators/bidir.py), which the host PSSMLT
integrator and the generic DRMLT step (integrators/drmlt.py, the CLI's
`grouped=false`) run with `mmlt_masks`' pinned depth dim, and the generic
step's fixEmitterPath with `mmlt_emitter_mask` / `mmlt_lt_mask_fn`; the
depth-grouped driver (integrators/mmlt_grouped.py) pins the depth dim per
group instead.
"""
from __future__ import annotations

import torch

from drmlt_mitsuba_tpu_torch.integrators.bidir import (
    BDPTConfig, make_bidir_tables, trace_mmlt_wavefront,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import Splats
from drmlt_mitsuba_tpu_torch.scene.types import Scene

TECH_DIMS = 2  # depth + strategy


def mmlt_n_dims(cfg: BDPTConfig) -> int:
    return TECH_DIMS + cfg.eye_dims + cfg.light_dims


def mmlt_masks(cfg: BDPTConfig, even: bool = True, device=None):
    """(frozen_mask, pinned_mask, n_dims) over the chain's PSS vector: the
    strategy dim is frozen, the depth dim pinned; n_dims is padded to even
    unless even=False."""
    n = mmlt_n_dims(cfg)
    if even and n % 2:
        n += 1
    frozen = torch.zeros((n,), dtype=torch.bool, device=device)
    pinned = torch.zeros((n,), dtype=torch.bool, device=device)
    frozen[1] = True
    pinned[0] = True
    return frozen, pinned, n


def mmlt_emitter_mask(cfg: BDPTConfig, n_dims: int, device=None):
    """(n_dims,) mask of the light-subpath dims (fixEmitterPath)."""
    mask = torch.zeros((n_dims,), dtype=torch.bool, device=device)
    start = TECH_DIMS + cfg.eye_dims
    mask[start:start + cfg.light_dims] = True
    return mask


def mmlt_lt_mask_fn(cfg: BDPTConfig):
    """lt(u) -> (C,) bool: is the chain's current strategy light tracing
    (t == 1)?  depth = 1 + floor(u0 D), s = min(floor(u1 (depth + 1)),
    depth), t = depth + 1 - s."""
    D = cfg.max_depth

    def lt(u):
        depth = 1 + torch.clamp((u[:, 0] * D).to(torch.int32), max=D - 1)
        s_pick = torch.minimum(
            (u[:, 1] * (depth + 1).to(torch.float32)).to(torch.int32), depth)
        return depth + 1 - s_pick == 1

    return lt


def make_mmlt_trace(scene: Scene, cfg: BDPTConfig, device):
    """trace(u) -> Splats for u = [depth, strategy, eye..., light...(,
    pad)]: through ops.megammlt (the MMLT kernel on a CUDA device, its twin
    on the CPU) for a pinhole camera, and through the bidirectional
    wavefront (bidir.trace_mmlt_wavefront, the value times D for the
    uniform depth pmf) where cfg.thinlens: the kernel excludes the thin
    lens, as the reference's does (mmlt.py:79-93).  The route is fixed
    here, once, from the config."""
    if not cfg.thinlens:
        from drmlt_mitsuba_tpu_torch.ops.megammlt import make_mega_mmlt

        return make_mega_mmlt(scene, cfg, device)
    tables = make_bidir_tables(scene, cfg, device)
    D = cfg.max_depth
    n_core = mmlt_n_dims(cfg)

    def trace(u) -> Splats:
        depth = 1 + torch.clamp((u[:, 0] * D).to(torch.int64), max=D - 1)
        sp = trace_mmlt_wavefront(tables, cfg, u[:, 1:n_core], depth)
        return Splats(pos=sp.pos, value=sp.value * D, lum=sp.lum * D)

    return trace
