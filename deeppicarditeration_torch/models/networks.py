"""Solution-ansatz networks (counterpart of deeppicarditeration_tpu/models/networks.py).

Only the plain ``MLP`` is ported; ``PISGradNet`` and ``EnforceTerminal``
come with the HJB slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def _elu(x):
    """ELU via exp, as the JAX package writes it (``where(x>0, x,
    exp(min(x,0)) - 1)``), not torch's expm1-based ``nn.ELU``: the two
    differ by ~1 ulp near 0, and the JAX form is the reference. The
    ``where`` on the exp argument keeps the gradient free of inf * 0."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, torch.exp(safe) - 1.0)


_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ELU": _elu,
    "ReLU": torch.relu,
    "GELU": nn.functional.gelu,
    "SiLU": nn.functional.silu,
    "Swish": nn.functional.silu,
    "Sigmoid": torch.sigmoid,
    "Softplus": nn.functional.softplus,
    "Sin": torch.sin,
}


def get_activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default Dense kernel init: truncated normal (at +-2 sd) with
    variance 1/fan_in."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)


class MLP(nn.Module):
    """Hidden widths ``neurons`` with ``activations`` after each hidden
    layer, a final linear head, and an optional clamp to [-bound, bound].

    ``layers`` holds the Linear layers in order (the last is the head); the
    CUDA estimator kernel reads their weights from there."""

    def __init__(self, in_dim: int, neurons: Sequence[int],
                 activations: Sequence[str], out_dim: int,
                 bound: Optional[float] = None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(neurons) != len(activations):
            raise ValueError(
                f"{len(activations)} activations for {len(neurons)} layers")
        self.neurons = tuple(int(n) for n in neurons)
        self.activations = tuple(activations)
        self.out_dim = int(out_dim)
        self.bound = bound
        widths = (int(in_dim),) + self.neurons + (self.out_dim,)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype) for a, b in zip(widths, widths[1:]))
        for lin in self.layers:
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        self._acts = [get_activation(a) for a in self.activations]

    def forward(self, tx):
        h = tx
        for lin, act in zip(self.layers[:-1], self._acts):
            h = act(lin(h))
        h = self.layers[-1](h)
        if self.bound is not None:
            if not self.bound > 0:
                raise ValueError("NETWORK.BOUND must be positive")
            h = torch.clamp(h, -self.bound, self.bound)
        return h
