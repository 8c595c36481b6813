"""Bidirectional path layout and the selected-strategy MMLT trace
(counterpart of drmlt_mitsuba_tpu/integrators/bidir.py, the part the MMLT
chain kernel runs).

`BDPTConfig` fixes the primary-sample layout of an eye subpath and a light
subpath of at most max_depth segments.  `trace_mmlt` evaluates, per lane,
the single (s, t) strategy its strategy dimension selects for its path
depth: the MMLT kernel (ops/megammlt.py) on a CUDA device, its plain twin
on the CPU.  The XLA subpath walks of the reference (`eye_subpath`,
`light_subpath`, `trace_mmlt_dense`) are not ported: the reference's own
tests pin its kernel to them, and the port is held to the reference.
"""
from __future__ import annotations

import dataclasses

import torch

EYE_BOUNCE_DIMS = 3    # bsdf component + 2D
LIGHT_START_DIMS = 5   # emitter pick + surface 2D + direction 2D
LIGHT_BOUNCE_DIMS = 3


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """max_depth = max number of segments in a full path (the reference
    bdpt maxDepth).  A full path of n vertices has n-1 segments.  The
    thin-lens camera and the participating medium are not ported."""
    max_depth: int = 5
    light_image: bool = True   # include t=1 (light tracing) strategies
    thinlens: bool = False
    medium: bool = False

    def __post_init__(self):
        if self.thinlens or self.medium:
            raise NotImplementedError(
                "thin-lens cameras and media are not ported to the MMLT "
                "trace")

    @property
    def bounce_dims(self):
        return EYE_BOUNCE_DIMS

    @property
    def n_eye(self):    # camera vertex + surface vertices
        return self.max_depth + 1

    @property
    def n_light(self):  # light-surface vertex + bounce vertices
        return self.max_depth

    @property
    def eye_dims(self):
        # the final walk step samples no direction
        return 2 + self.bounce_dims * (self.n_eye - 2)

    @property
    def light_dims(self):
        # the start ray makes bounce vertex 1; BSDF sampling happens at
        # bounce vertices 1..n_light-2 (the last vertex samples nothing)
        return LIGHT_START_DIMS + self.bounce_dims * max(0,
                                                         self.n_light - 2)

    @property
    def n_dims(self):
        return self.eye_dims + self.light_dims


def trace_mmlt(scene, cfg: BDPTConfig, u, depth):
    """Selected-strategy MMLT trace (PathSampler::EMMLT): each lane
    evaluates the one (s, t) strategy its strategy dim selects for its
    depth, scaled by nStrats = depth + 1.

    u (R, 1 + eye_dims + light_dims) = [strategy, eye..., light...];
    depth (R,) integer path lengths in [1, cfg.max_depth].  Returns Splats.
    The kernel's depth dim is set so that it selects `depth`, and its
    uniform depth-pmf factor max_depth is divided out."""
    from drmlt_mitsuba_tpu_torch.ops import megammlt

    D = cfg.max_depth
    tables = megammlt.make_mmlt_tables(scene, cfg, u.device)
    u_depth = ((depth.to(torch.float32) - 0.5) / D)[:, None]
    out = megammlt.mmlt_trace(
        tables, torch.cat([u_depth, u[:, :tables.n_core - 1]], 1)
        .T.contiguous())
    return megammlt.to_splats(out, 1.0 / D)
