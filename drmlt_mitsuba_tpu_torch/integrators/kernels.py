"""Markov transition kernels (counterpart of
drmlt_mitsuba_tpu/integrators/kernels.py).

Gaussian, Kelemen ("hole") and wrapped-Cauchy kernels as pure functions of
uniforms, with log-pdfs.  `u2` is (..., 2); kernels that need one uniform
read u2[..., 0].  Default constants match drmlt_sampler.h:201-206.
"""
from __future__ import annotations

import dataclasses
import math

import torch

S1_DEFAULT = 1.0 / 1024.0
S2_DEFAULT = 1.0 / 64.0
SIGMA_DEFAULT = 1.0 / 64.0
RHO_DEFAULT = math.exp(-0.25)
KELEMEN_SCALE_ORBITAL = 1.9
SCALE_SECOND_DEFAULT = 0.1


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Zero-mean Gaussian step (Box-Muller, 2 uniforms)."""
    sigma: float

    def sample(self, u2):
        r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u2[..., 0],
                                                    min=1e-38)))
        return r * torch.cos(2.0 * math.pi * u2[..., 1]) * self.sigma

    def log_pdf(self, du):
        r = du / self.sigma
        return -0.5 * (r * r + math.log(2.0 * math.pi)
                       + 2.0 * math.log(self.sigma))


@dataclasses.dataclass(frozen=True)
class Kelemen:
    """Kelemen 'hole' kernel: |du| log-uniform on [s1, s2], random sign.

    log_pdf is -inf outside [s1, s2].  The reference writes
    log(max(pdf, 1e-38)), and 1e-38 is a float32 denormal: JAX 0.9 on the
    CPU gives -inf for it eagerly but -87.5 under jit, and CUDA keeps
    denormals (-87.5).  The port states -inf directly; the mira ratio
    (integrators/drmlt.py) is then 0 or NaN where a jitted reference's is
    tiny or finite, on dims whose offset lies outside the kernel's range."""
    s1: float = S1_DEFAULT
    s2: float = S2_DEFAULT

    @property
    def log_ratio(self):
        return -math.log(self.s2 / self.s1)

    def sample(self, u2):
        u = u2[..., 0]
        sign = torch.where(u < 0.5, 1.0, -1.0)
        x = torch.where(u < 0.5, 2.0 * u, 2.0 * (u - 0.5))
        return sign * (self.s2 * torch.exp((1.0 - x) * self.log_ratio))

    def pdf(self, du):
        d = torch.abs(du)
        ok = (d >= self.s1) & (d <= self.s2)
        p = 1.0 / (2.0 * torch.clamp(d, min=1e-20) * (-self.log_ratio))
        return torch.where(ok, p, 0.0)

    def log_pdf(self, du):
        return torch.log(self.pdf(du))


@dataclasses.dataclass(frozen=True)
class WrappedCauchy:
    """Circular wrapped-Cauchy angle kernel (DRMLT 2020 Sec 4.3, Eq. 10)."""
    rho: float = RHO_DEFAULT

    @property
    def dispersion(self):
        return 2.0 * self.rho / (1.0 + self.rho * self.rho)

    def cos_sin(self, u):
        """(cos th, sin th) of a sampled angle without evaluating arccos:
        the orbital rotation only consumes cos and sin, and
        sin(sign * arccos(a)) == sign * sqrt(1 - a^2)."""
        disp = self.dispersion
        sign = torch.where(u < 0.5, 1.0, -1.0)
        x = torch.where(u < 0.5, 2.0 * u, 2.0 * (u - 0.5))
        v = torch.cos(2.0 * math.pi * x)
        c = torch.clamp((v + disp) / (1.0 + disp * v), -1.0, 1.0)
        return c, sign * torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))

    def sample(self, u2):
        u = u2[..., 0]
        c, _ = self.cos_sin(u)
        return torch.where(u < 0.5, 1.0, -1.0) * torch.arccos(c)

    def pdf(self, du):
        r2 = self.rho * self.rho
        return (0.5 / math.pi * (1.0 - r2)
                / (1.0 + r2 - 2.0 * self.rho * torch.cos(du)))

    def log_pdf(self, du):
        return torch.log(torch.clamp(self.pdf(du), min=1e-38))
