"""Diagonal-covariance Gaussian and Gaussian-mixture distributions.

Counterpart of ``deeppicarditeration_tpu/distributions.py``: parameters are
tensors, sampling takes an explicit ``torch.Generator``, and ``log_prob`` /
``grad_log_prob`` are vectorized (logsumexp and softmax over components).
``make_random_gmm`` draws the mixture with the host threefry reference
(``ops/threefry.py``), so one key gives the JAX package's mixture bit for
bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from deeppicarditeration_torch.ops import threefry

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """N(mean, diag(var)); mean, var: (n,)."""

    mean: torch.Tensor
    var: torch.Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., 1)."""
        diff = x - self.mean
        quad = torch.sum(diff * diff / self.var, dim=-1, keepdim=True)
        norm = torch.sum(torch.log(self.var)) + self.dim * _LOG_2PI
        return -0.5 * (quad + norm)

    def grad_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -(x - self.mean) / self.var

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        z = torch.randn((n, self.dim), generator=generator,
                        dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + torch.sqrt(self.var) * z


@dataclasses.dataclass(frozen=True)
class DiagGaussianMixture:
    """Mixture of K diagonal Gaussians: means, vars (..., K, n), log_weights
    (..., K); leading batch dims, where present, match x's (the OU exact
    solution's per-sample mixtures)."""

    means: torch.Tensor
    vars: torch.Tensor
    log_weights: torch.Tensor

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    @property
    def num_components(self) -> int:
        return self.means.shape[-2]

    def _component_log_probs(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> log p_k(x) + log w_k, (..., K)."""
        diff = x[..., None, :] - self.means
        quad = torch.sum(diff * diff / self.vars, dim=-1)
        norm = torch.sum(torch.log(self.vars), dim=-1) + self.dim * _LOG_2PI
        return self.log_weights - 0.5 * (quad + norm)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., 1)."""
        return torch.logsumexp(self._component_log_probs(x), dim=-1,
                               keepdim=True)

    def grad_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """d/dx log p(x): the responsibility-weighted component scores."""
        resp = torch.softmax(self._component_log_probs(x), dim=-1)
        comp_grad = -(x[..., None, :] - self.means) / self.vars
        return torch.sum(resp[..., None] * comp_grad, dim=-2)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        if self.means.ndim != 2:
            raise ValueError(
                "DiagGaussianMixture.sample supports only unbatched (K, n) "
                "parameters")
        idx = torch.multinomial(torch.softmax(self.log_weights, dim=-1), n,
                                replacement=True, generator=generator)
        z = torch.randn((n, self.dim), generator=generator,
                        dtype=self.means.dtype, device=self.means.device)
        return self.means[idx] + torch.sqrt(self.vars[idx]) * z


def make_random_gmm(key, nx: int, num_components: int, mean_scale: float,
                    var_scale: float) -> DiagGaussianMixture:
    """The JAX package's seeded mixture from a threefry ``key``
    (``ops/threefry.py``): means ~ U[-mean_scale, mean_scale]^nx, isotropic
    variance var_scale, random normalized weights; f32 on the CPU."""
    k_mean, k_pi = threefry.split(key)
    f32 = np.float32
    means = f32(mean_scale) * (
        threefry.uniform(k_mean, (num_components, nx)) * f32(2.0) - f32(1.0))
    vars_ = np.full((num_components, nx), var_scale, f32)
    pi = threefry.uniform(k_pi, (num_components,))
    total = f32(0.0)
    for p in pi:  # in order, as XLA reduces a short vector
        total = f32(total + p)
    log_weights = threefry.xla_log_f32((pi / total).astype(f32))
    return DiagGaussianMixture(torch.from_numpy(means.astype(f32)),
                               torch.from_numpy(vars_),
                               torch.from_numpy(log_weights))
