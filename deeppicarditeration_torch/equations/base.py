"""Equation layer: terminal-value parabolic PDEs as plain functions on tensors.

Counterpart of ``deeppicarditeration_tpu/equations/base.py``. The general
form is

    u_t + 1/2 Tr(Sigma Sigma^T) u_xx + <mu, u_x> + ff(t, x, u, u_x) = 0
    u(T, x) = g(x)

with ``ff(t, x, y, w) = fff(t, x, y, z = Sigma w)`` and ``Sigma = sqrt(alpha)
I``, so the forward SDE is an exact one-shot Gaussian jump. Every function
broadcasts over leading batch dims (t: (..., 1), x: (..., nx)). Sampling
takes an explicit ``torch.Generator`` where the JAX code takes a key.
"""

from __future__ import annotations

import math
from typing import Dict, Type

import torch

_EQUATION_REGISTRY: Dict[str, Type] = {}


def register_equation(cls):
    """Register an equation class for config-driven lookup (EQUATION.cls)."""
    _EQUATION_REGISTRY[cls.__name__] = cls
    return cls


def get_equation_cls(name: str):
    if name not in _EQUATION_REGISTRY:
        raise NotImplementedError(
            f"Equation {name!r} is not ported yet (known: "
            f"{sorted(_EQUATION_REGISTRY)}); HJB and FN come in later "
            "slices of the port")
    return _EQUATION_REGISTRY[name]


def make_equation(name: str, run_seed: int = 0, **kwargs):
    """Instantiate an equation by name; an explicit ``seed`` in ``kwargs``
    pins the problem instance independently of the run seed."""
    cls = get_equation_cls(name)
    seed = kwargs.pop("seed", run_seed)
    return cls.create(seed=seed, **kwargs)


class EquationMethods:
    """Method mixin shared by all equations.

    Subclasses provide ``T`` (float), ``nx`` (int) and ``alpha`` (float)."""

    has_gradient_term: bool = False
    has_laplacian_term: bool = False
    has_hessian_term: bool = False
    has_exact_solution: bool = False
    nu: int = 1

    @property
    def alpha_sqrt(self) -> float:
        return math.sqrt(self.alpha)

    def fff(self, t, x, y, z):
        """Nonlinearity in terms of z = Sigma^T u_x."""
        raise NotImplementedError

    def ff(self, t, x, y, w):
        """Nonlinearity in terms of w = u_x (Sigma applied internally)."""
        return self.fff(t, x, y, self.alpha_sqrt * w)

    def f(self, t, x, y):
        raise NotImplementedError

    # --- forward SDE ------------------------------------------------------
    def transition(self, generator: torch.Generator, t, s, x):
        """X_s = x + sqrt(s-t) sqrt(a) dW with dW ~ N(0, I); returns
        (X_s, dW), dW being the standardized increment."""
        dW = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                         device=x.device)
        x_next = x + torch.sqrt(s - t) * self.alpha_sqrt * dW
        return x_next, dW

    def sample_x0(self, generator: torch.Generator, n: int, dtype, device):
        return torch.randn((n, self.nx), generator=generator, dtype=dtype,
                           device=device)

    def sample_x(self, generator: torch.Generator, t):
        """x ~ law of X_t started from x0 at time 0."""
        x0 = self.sample_x0(generator, t.shape[0], t.dtype, t.device)
        x, _ = self.transition(generator, torch.zeros_like(t), t, x0)
        return x

    # --- terminal condition ----------------------------------------------
    def g(self, x):
        raise NotImplementedError

    def g_x(self, x):
        """Gradient of g via one batched reverse pass."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            y = self.g(xx)
            (gx,) = torch.autograd.grad(y, xx, torch.ones_like(y))
        return gx

    # --- exact-solution oracles ------------------------------------------
    def exact_solution(self, t, x):
        raise NotImplementedError

    def u_x(self, t, x):
        raise NotImplementedError

    def u_u_x(self, t, x):
        return self.exact_solution(t, x), self.u_x(t, x)

    @classmethod
    def create(cls, seed: int = 0, **kwargs):
        del seed
        return cls(**kwargs)


class SimpleDiffusionMethods(EquationMethods):
    """Sigma = sqrt(alpha) I, mu = 0."""


class SimpleDiffusionWithZ(SimpleDiffusionMethods):
    """ff depends on z = sqrt(alpha) u_x."""

    has_gradient_term = True
