"""Collocation-time samplers (counterpart of deeppicarditeration_tpu/ops/samplers.py).

Only the uniform law is ported; the Picard power law
(``sample_t_picard``) comes with a later slice.
"""

from __future__ import annotations

import torch


def sample_t_uniform(generator: torch.Generator, n: int, T: float,
                     eps: float = 0.0, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """t ~ U[eps, T - eps]; shape (n, 1)."""
    u = torch.rand((n, 1), generator=generator, dtype=dtype, device=device)
    return (T - 2.0 * eps) * (1.0 - u) + eps


def sample_t_picard(*args, **kwargs):
    raise NotImplementedError(
        "sample_t_picard (the Picard power-law t draw, used when "
        "DATA.kwargs.t_always_uniform is false) is not ported yet; it comes "
        "with a later slice of the port")
