"""Phase functions (counterpart of the reference's render/medium.py and
render/phase.py).  Only the Henyey-Greenstein lobe is ported: the `hk`
slab BSDF (render/bsdf.py) scatters by it.  Participating media, and the
other phase functions with them, are not ported."""
from __future__ import annotations

import math

import torch


def hg_phase(g, cos_theta):
    """The Henyey-Greenstein phase value, normalised over the sphere
    (the reference's medium.py:hg_phase)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return (1.0 - g2) / (4.0 * math.pi * torch.clamp(denom, min=1e-8) ** 1.5)
