"""Fully nonlinear (Hessian-dependent) 100-d benchmark equation.

Counterpart of ``deeppicarditeration_tpu/equations/fully_nonlinear.py``.
The PDE

    u_t + 1/2 u_xx + 1/4 sum_i |u_ii| - f(t, x) = 0

is manufactured so that its exact solution is a 2-neuron sine network

    u(t, x) = sum_k v^k sin(w_0^k t + sum_i w_i^k x_i)

with weights drawn from the seed by the host threefry reference
(``ops/threefry.py``) on the JAX package's key path, so that one seed gives
the same instance, bit for bit, in both packages. The weights live on the
CPU until ``to(device)`` moves them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from deeppicarditeration_torch.equations.base import (
    SimpleDiffusionWithHessian,
    param_tag,
    register_equation,
)
from deeppicarditeration_torch.ops import threefry


@register_equation
@dataclasses.dataclass(frozen=True, eq=False)
class GBMEquationComplexExact(SimpleDiffusionWithHessian):
    nx: int = 100
    T: float = 1.0
    alpha: float = 1.0
    # the 2-neuron exact-solution network: w (m, 1 + nx), v (m, 1)
    w: torch.Tensor = None
    v: torch.Tensor = None

    has_exact_solution = True
    supported_approximate_methods = ("SDGD",)

    @classmethod
    def create(cls, nx: int = 100, alpha: float = 1.0, T: float = 1.0,
               seed: int = 0, num_neurons: int = 2):
        key = threefry.fold_in(threefry.PRNGKey(seed), param_tag("gbm_wv"))
        kw, kv = threefry.split(key)
        w = threefry.normal(kw, (num_neurons, 1 + nx)) / np.float32(
            math.sqrt(nx))
        w[:, 0] = 1.0
        v = threefry.normal(kv, (num_neurons, 1))
        return cls(nx=nx, T=T, alpha=alpha, w=torch.from_numpy(w),
                   v=torch.from_numpy(v))

    def to(self, device) -> "GBMEquationComplexExact":
        """This instance with its weights on ``device``."""
        return dataclasses.replace(self, w=self.w.to(device),
                                   v=self.v.to(device))

    # --- exact solution and derivatives (closed form) ---------------------
    def _tx(self, t, x):
        if torch.is_tensor(t):
            t_b = t.to(dtype=x.dtype, device=x.device).expand(
                x[..., :1].shape)
        else:  # a number (g's T): filled on the device, no host copy, so
            # that DBDP's captured sub-iteration can call g
            t_b = torch.full_like(x[..., :1], t)
        return torch.cat([t_b, x], dim=-1)

    def _arg(self, t, x):
        return self._tx(t, x) @ self.w.T

    def exact_solution(self, t, x):
        return torch.sin(self._arg(t, x)) @ self.v

    def u_t(self, t, x):
        return torch.cos(self._arg(t, x)) @ (self.v * self.w[:, 0:1])

    def u_x(self, t, x):
        return torch.cos(self._arg(t, x)) @ (self.v * self.w[:, 1:])

    def u_u_x(self, t, x):
        arg = self._arg(t, x)
        return (torch.sin(arg) @ self.v,
                torch.cos(arg) @ (self.v * self.w[:, 1:]))

    def u_hessian(self, t, x):
        sin_term = -torch.sin(self._arg(t, x))  # (..., m)
        wx = self.w[:, 1:]  # (m, nx)
        outer = wx[:, :, None] * wx[:, None, :]  # (m, nx, nx)
        weights = self.v[:, :, None] * outer
        return torch.einsum("...j,jkl->...kl", sin_term, weights)

    def u_hessian_diag(self, t, x):
        """Diagonal of the exact Hessian without materializing (nx, nx)."""
        sin_term = -torch.sin(self._arg(t, x))
        return sin_term @ (self.v * self.w[:, 1:] ** 2)

    def laplacian(self, t, x):
        sin_term = torch.sin(self._arg(t, x))
        return -sin_term @ (self.v * torch.sum(self.w[:, 1:] ** 2, dim=-1,
                                               keepdim=True))

    # --- terminal condition ------------------------------------------------
    def g(self, x):
        return self.exact_solution(self.T, x)

    def g_x(self, x):
        return self.u_x(self.T, x)

    # --- nonlinearity ------------------------------------------------------
    def _source(self, t, x):
        exact_diag = self.u_hessian_diag(t, x)
        return (self.u_t(t, x) + 0.5 * self.laplacian(t, x)
                + 0.25 * torch.sum(torch.abs(exact_diag), dim=-1,
                                   keepdim=True))

    def ffi(self, t, x, y, u_ii):
        """The nonlinearity from (sampled) diagonal Hessian entries u_ii:
        d mean(u_ii) is the SDGD estimator of the trace."""
        return self.ffi_stats(t, x, y,
                              torch.mean(u_ii, dim=-1, keepdim=True),
                              torch.mean(torch.abs(u_ii), dim=-1,
                                         keepdim=True))

    def ffi_stats(self, t, x, y, mean_uii, mean_abs_uii):
        """ffi from the symmetric statistics of the sampled entries, which
        the estimators compute from multiplicity counts against the full
        diagonal (no per-index gather). ``t``/``x`` may carry singleton
        sample dims: the source terms are then evaluated once per point."""
        d = float(self.nx)
        return (0.5 * (1.0 - self.alpha) * d * mean_uii
                + 0.25 * d * mean_abs_uii - self._source(t, x))

    def ffh(self, t, x, y, w, hess):
        u_ii = torch.diagonal(hess, dim1=-2, dim2=-1)
        return self.ffi(t, x, y, u_ii)

    def pinn_function(self, t, x, u, u_t, u_x, u_ii):
        """PINN residual with the SDGD-sampled diagonal ``u_ii``."""
        d = float(self.nx)
        lap_est = d * torch.mean(u_ii, dim=-1, keepdim=True)
        nonlinear = d * torch.mean(torch.abs(u_ii), dim=-1, keepdim=True)
        return u_t + 0.5 * lap_est + 0.25 * nonlinear - self._source(t, x)

    def sample_x0(self, generator, n: int, dtype, device):
        del generator
        return torch.zeros((n, self.nx), dtype=dtype, device=device)
