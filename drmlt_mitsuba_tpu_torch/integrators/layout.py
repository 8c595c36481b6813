"""Primary-sample-space dimension layout — the replay contract.

The reference's `findMaxDimensions` (src/integrators/pssmlt_utils.h:27-77)
budgets a fixed PSS dimension count per technique so that full-state DRMLT
proposals and seed replay stay aligned (drmlt_sampler.cpp fillSpace always
consumes exactly maxDim uniforms).  We keep that invariant but define our own
deterministic layout (SURVEY.md §7 hard-part (c)): every uniform has a fixed
index, so the tracer is a pure function L(u) of a fixed-shape vector — which
is also exactly what makes the chain state a dense tensor.

Unidirectional `path` technique layout:
  u[0:2]                pixel position (sensor)
  u[2:4]                aperture (thinlens; ignored by pinhole)
  per bounce b (0-based), base = SENSOR_DIMS + b*BOUNCE_DIMS:
    +0   emitter pick          (NEE)
    +1:3 emitter surface uv    (NEE)
    +3   bsdf component pick
    +4:6 bsdf uv
    +6   russian roulette
"""
from __future__ import annotations

import dataclasses

import torch

from drmlt_mitsuba_tpu_torch.core.spectrum import luminance

SENSOR_DIMS = 4
BOUNCE_DIMS = 9

# offsets within a bounce block
OFF_LIGHT_PICK = 0
OFF_LIGHT_U = 1
OFF_BSDF_CMP = 3
OFF_BSDF_U = 4
OFF_RR = 6
OFF_MED_CHANNEL = 7   # volpath: extinction channel pick
OFF_MED_DIST = 8      # volpath: distance sample
# (media dims exist in every layout so path and volpath stay replay-
# compatible — the findMaxDimensions media offset, pssmlt_utils.h:62-68)


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Static configuration of the unidirectional tracer (ref: path.cpp
    MIPathTracer parameters maxDepth/rrDepth/strictNormals)."""
    max_depth: int = 8       # max number of path segments (edges)
    min_depth: int = 1       # skip contributions below this many segments
    #                          (separateDirect: min_depth=3 leaves direct
    #                          illumination to the dedicated pass,
    #                          ref BidirectionalUtils::renderDirectComponent)
    rr_depth: int = 5        # start RR after this many segments
    use_nee: bool = True     # next-event estimation + MIS
    thinlens: bool = False
    # motion blur: one extra PSS dim (the LAST, so every existing offset
    # — and hence the replay contract for static scenes — is unchanged)
    # holding the path's normalized shutter time.  Ref: sensors sample a
    # time per ray, include/mitsuba/render/sensor.h:202.
    motion: bool = False

    @property
    def n_dims(self) -> int:
        return (SENSOR_DIMS + self.max_depth * BOUNCE_DIMS
                + (1 if self.motion else 0))

    @property
    def time_dim(self) -> int:
        """PSS index of the shutter-time dimension (motion=True only)."""
        return SENSOR_DIMS + self.max_depth * BOUNCE_DIMS


def bounce_base(b: int) -> int:
    return SENSOR_DIMS + b * BOUNCE_DIMS


@dataclasses.dataclass
class Splats:
    """Fixed-size splat list: one splat per unidirectional sample."""
    pos: torch.Tensor     # (R, 1, 2) continuous [0,1)^2 film position
    value: torch.Tensor   # (R, 1, 3)
    lum: torch.Tensor     # (R,) luminance (the MCMC target density)


def path_splats(u, value) -> Splats:
    """The splats of a unidirectional trace: film position u[:, 0:2] and
    value (R, 3), with its luminance."""
    return Splats(pos=u[:, None, 0:2], value=value[:, None, :],
                  lum=luminance(value))
