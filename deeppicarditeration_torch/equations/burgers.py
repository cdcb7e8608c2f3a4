"""The 100-d Burgers-type benchmark equation "Cha".

Counterpart of ``deeppicarditeration_tpu/equations/burgers.py``. The PDE

    u_t + alpha/2 u_xx + [alpha k u - 1/(k d) - alpha k / 2] sum_i u_{x_i} = 0

in standard form ``fff(t, x, y, z) = sqrt(a) [k y - (2 + k^2 a d)/(2 k a d)]
sum_i z_i`` with exact solution ``u(t, x) = sigmoid(t + k sum_i x_i)``.
The user-facing ``k`` is scaled by 1/sqrt(nx) in ``create``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeppicarditeration_torch.equations.base import (
    SimpleDiffusionWithZ,
    register_equation,
)


@register_equation
@dataclasses.dataclass(frozen=True)
class Cha(SimpleDiffusionWithZ):
    nx: int = 100
    T: float = 1.0
    alpha: float = 1.0
    k: float = 1.0  # already / sqrt(nx)

    has_exact_solution = True

    @classmethod
    def create(cls, nx: int = 100, alpha: float = 1.0, k: float = 1.0,
               T: float = 1.0, seed: int = 0):
        del seed
        return cls(nx=nx, T=T, alpha=alpha, k=k / math.sqrt(nx))

    @property
    def ff_offset(self) -> float:
        """The constant c0 of ``fff``: coef = k y - c0."""
        k_alpha_d = self.k * self.alpha * self.nx
        return (2.0 + self.k * k_alpha_d) / (2.0 * k_alpha_d)

    def fff(self, t, x, y, z):
        alpha_d = self.alpha * self.nx
        k_alpha_d = self.k * alpha_d
        coef = self.k * y - (2.0 + self.k * k_alpha_d) / (2.0 * k_alpha_d)
        return self.alpha_sqrt * coef * torch.sum(z, dim=-1, keepdim=True)

    def g(self, x):
        return torch.sigmoid(self.T + self.k * torch.sum(x, dim=-1,
                                                         keepdim=True))

    def g_x(self, x):
        s = self.g(x)
        return (self.k * s * (1.0 - s)).expand(x.shape)

    def exact_solution(self, t, x):
        return torch.sigmoid(t + self.k * torch.sum(x, dim=-1, keepdim=True))

    def u_x(self, t, x):
        u = self.exact_solution(t, x)
        return (self.k * u * (1.0 - u)).expand(x.shape)

    def u_u_x(self, t, x):
        u = self.exact_solution(t, x)
        return u, (self.k * u * (1.0 - u)).expand(x.shape)

    def sample_x0(self, generator, n: int, dtype, device):
        del generator
        return torch.zeros((n, self.nx), dtype=dtype, device=device)
