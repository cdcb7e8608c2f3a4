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


def _fma(a, b, c):
    """f32 fused multiply-add (the product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _xla_log_f32(v: np.ndarray) -> np.ndarray:
    """log of positive f32 values as XLA computes it on the CPU (Cephes'
    polynomial, its products fused as the compiled code fuses them), so
    that the mixture's log-weights equal the JAX package's bit for bit;
    numpy's log is 1 ulp off on about a fifth of the inputs."""
    f = np.float32
    x = np.maximum(np.asarray(v, f), f(1.17549435e-38))
    bits = x.view(np.uint32)
    e = f(1.0) + ((bits >> 23).astype(np.int32) - 127).astype(f)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f)
    below = m < f(0.70710677)
    x = (m - f(1.0)) + np.where(below, m, f(0.0))
    e = e - np.where(below, f(1.0), f(0.0))
    x2 = x * x
    x3 = x2 * x
    y1 = _fma(_fma(x, f(7.0376836e-2), f(-1.1514610e-1)), x, f(1.1676998e-1))
    y2 = _fma(_fma(x, f(-1.2420141e-1), f(1.4249323e-1)), x,
              f(-1.6668057e-1))
    y3 = _fma(_fma(x, f(2.0000714e-1), f(-2.4999994e-1)), x,
              f(3.3333331e-1))
    y = _fma(_fma(_fma(y1, x3, y2), x3, y3), x3, f(-2.12194440e-4) * e)
    out = ((x - f(0.5) * x2) + y) + f(0.693359375) * e
    return np.where(np.asarray(v, f) == 0, f(-np.inf), out).astype(f)


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
    log_weights = _xla_log_f32((pi / total).astype(f32))
    return DiagGaussianMixture(torch.from_numpy(means.astype(f32)),
                               torch.from_numpy(vars_),
                               torch.from_numpy(log_weights))
