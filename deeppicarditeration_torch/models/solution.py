"""The frozen-solution abstraction consumed by estimators and evaluators.

Counterpart of ``deeppicarditeration_tpu/models/solution.py``. A
``Solution`` is the zero function (Picard iteration 1) or a network. Value
gradients never use a per-sample Jacobian: the network is pointwise across
the batch, so one batched backward pass with a ones cotangent gives exact
per-sample gradients. The ``ValueGradient``/``OnlyGradient`` net types and
the ``gx``/oracle kinds come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

VALUE = "Value"
VALUE_GRADIENT = "ValueGradient"
ONLY_GRADIENT = "OnlyGradient"


def output_dim_for(net_type: str, nx: int, nu: int = 1) -> int:
    """NETWORK.TYPE -> output dim."""
    if net_type == VALUE:
        return nu
    if net_type == VALUE_GRADIENT:
        return nu + nx
    if net_type == ONLY_GRADIENT:
        return nx
    raise ValueError(f"Unknown network type {net_type!r}")


def _require_value(net_type: str) -> None:
    if net_type != VALUE:
        raise NotImplementedError(
            f"NETWORK.TYPE {net_type!r} is not ported yet (only 'Value'); "
            "the ValueGradient/OnlyGradient heads come with a later slice")


class Solution:
    """u(t, x) ansatz: the zero function or a network (``kind`` 'zero' or
    'net')."""

    def __init__(self, module: Optional[nn.Module], kind: str,
                 net_type: str, nx: int):
        _require_value(net_type)
        self.module = module
        self.kind = kind
        self.net_type = net_type
        self.nx = int(nx)

    @classmethod
    def zero(cls, nx: int, net_type: str = VALUE) -> "Solution":
        return cls(None, "zero", net_type, nx)

    @classmethod
    def from_net(cls, module: nn.Module, net_type: str,
                 nx: int) -> "Solution":
        return cls(module, "net", net_type, nx)

    @property
    def output_dim(self) -> int:
        return output_dim_for(self.net_type, self.nx)

    def __call__(self, tx: torch.Tensor) -> torch.Tensor:
        """Raw network output, shape (..., output_dim)."""
        if self.kind == "zero":
            return tx.new_zeros(tx.shape[:-1] + (self.output_dim,))
        return self.module(tx)

    def value(self, tx: torch.Tensor) -> torch.Tensor:
        """The scalar value head u(t, x), shape (..., 1)."""
        return self(tx)[..., 0:1]

    def value_and_grad_x(self, t: torch.Tensor, x: torch.Tensor):
        """(u, du/dx) per sample, detached; u: (..., 1), du/dx: (..., nx).

        One batched backward pass with a ones cotangent."""
        if self.kind == "zero":
            return x.new_zeros(x.shape[:-1] + (1,)), torch.zeros_like(x)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            tx = torch.cat([t.expand(xx.shape[:-1] + (1,)), xx], dim=-1)
            u = self.module(tx)
            (gx,) = torch.autograd.grad(u, xx, torch.ones_like(u))
        return u.detach(), gx

    def value_and_grad_tx(self, tx: torch.Tensor, create_graph: bool = False):
        """(u, du/d(tx)) per sample; du/d(tx): (..., 1 + nx).

        The training step passes ``create_graph=True`` so that a loss on
        the gradient back-propagates to the parameters."""
        if self.kind == "zero":
            return (tx.new_zeros(tx.shape[:-1] + (1,)),
                    torch.zeros_like(tx))
        with torch.enable_grad():
            z = tx.detach().requires_grad_(True)
            u = self.value(z)
            (g,) = torch.autograd.grad(u, z, torch.ones_like(u),
                                       create_graph=create_graph)
        if create_graph:
            return u, g
        return u.detach(), g.detach()
