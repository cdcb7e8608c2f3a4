"""Collocation-time samplers (counterpart of deeppicarditeration_tpu/ops/samplers.py).

The uniform law, and the Picard power law t = T (1 - prod of k uniforms),
drawn as T (1 - exp(-Gamma(k, 1))) (``sample_t_picard``; the evaluator's L2
sweeps). Generation with ``t_always_uniform`` false, which draws the power
law at the iteration's factor count, is not ported yet.
"""

from __future__ import annotations

import math

import torch


def sample_t_uniform(generator: torch.Generator, n: int, T: float,
                     eps: float = 0.0, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """t ~ U[eps, T - eps]; shape (n, 1)."""
    u = torch.rand((n, 1), generator=generator, dtype=dtype, device=device)
    return (T - 2.0 * eps) * (1.0 - u) + eps


def sample_gamma(generator: torch.Generator, k: float, shape,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Gamma(k, 1) draws for k >= 1 from ``generator``: Marsaglia and
    Tsang's squeeze, rejected draws redrawn until all are accepted."""
    d = k - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        z = torch.randn(m, generator=generator, dtype=torch.float64,
                        device=device)
        u = torch.rand(m, generator=generator, dtype=torch.float64,
                       device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    return out.reshape(shape).to(dtype)


def sample_t_picard(generator: torch.Generator, n: int, T: float,
                    n_factors, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """t ~ T (1 - prod of n_factors iid U[0, 1]); shape (n, 1): sampled as
    T (1 - exp(-Gamma(k, 1))) with k = max(n_factors, 1), the same law
    (-log of a product of k uniforms is a sum of k Exp(1) draws)."""
    k = max(float(n_factors), 1.0)
    g = sample_gamma(generator, k, (n, 1), dtype, device)
    return T * (1.0 - torch.exp(-g))
