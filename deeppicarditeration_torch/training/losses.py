"""Loss functions and value/gradient/Hessian loss scalers.

Counterpart of ``deeppicarditeration_tpu/training/losses.py``. Scalers
combine the value loss (scalar) with the per-dimension gradient loss vector
(batch-averaged); the gradient losses are summed over dimensions, so a
FixedLossScaler weight w corresponds to lambda = w * nx in the DPI paper.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

_SCALER_REGISTRY = {}


def register_scaler(cls):
    _SCALER_REGISTRY[cls.__name__] = cls
    return cls


def get_scaler(name, **kwargs):
    """Scaler factory; None -> FixedLossScaler(1.0)."""
    if name is None:
        return FixedLossScaler(fixed_weight=1.0)
    if name not in _SCALER_REGISTRY:
        raise ValueError(
            f"Unknown scaler {name!r}; known: {sorted(_SCALER_REGISTRY)}")
    return _SCALER_REGISTRY[name](**kwargs)


def make_loss_fn(cls=None, **kwargs):
    """Pointwise residual penalty: square by default, linear-clip optionally."""
    if cls is None:
        return torch.square
    if cls == "LossFnLinearClip":
        clip = float(kwargs["clip"])

        def linear_clip(x):
            return torch.where(torch.abs(x) < clip, torch.square(x),
                               2.0 * clip * torch.abs(x) - clip * clip)

        return linear_clip
    raise ValueError(f"Unknown loss fn {cls!r}")


@dataclasses.dataclass(frozen=True)
class LossScaler:
    def scale(self, v_loss, g_loss_vec) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def scale_g_h(self, v_loss, g_loss_vec, h_loss_vec
                  ) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError


@register_scaler
@dataclasses.dataclass(frozen=True)
class SimpleLossScaler(LossScaler):
    """a = clamp(v/g, 0, 1e3) (no grad through a); loss = v + a g."""

    def scale(self, v_loss, g_loss_vec):
        g_loss = torch.sum(g_loss_vec)
        a = torch.clamp(v_loss / g_loss, 0.0, 1e3).detach()
        return v_loss + a * g_loss, {
            "train_gradient_loss(unscaled)": g_loss,
            "train_gradient_loss_scaling_factor": a,
        }


@register_scaler
@dataclasses.dataclass(frozen=True)
class DimensionLossScaler(LossScaler):
    """Per-dimension ratio scaling."""

    def scale(self, v_loss, g_loss_vec):
        a = torch.clamp(v_loss / g_loss_vec, 0.0, 1e3).detach()
        g_loss = torch.sum(a * g_loss_vec)
        return v_loss + g_loss, {
            "train_gradient_loss(unscaled)": g_loss,
            "train_gradient_loss_scaling_factor": torch.mean(a),
        }


@register_scaler
@dataclasses.dataclass(frozen=True)
class FixedLossScaler(LossScaler):
    fixed_weight: float = 1.0

    def scale(self, v_loss, g_loss_vec):
        g_loss = torch.sum(g_loss_vec)
        return v_loss + self.fixed_weight * g_loss, {
            "train_gradient_loss(unscaled)": g_loss,
        }


@register_scaler
@dataclasses.dataclass(frozen=True)
class FixedHessianLossScaler(LossScaler):
    fixed_gradient_weight: float = 1.0
    fixed_hessian_weight: float = 1.0

    def scale_g_h(self, v_loss, g_loss_vec, h_loss_vec):
        g_loss = torch.sum(g_loss_vec)
        h_loss = torch.sum(h_loss_vec)
        total = (v_loss + self.fixed_gradient_weight * g_loss
                 + self.fixed_hessian_weight * h_loss)
        return total, {
            "train_gradient_loss(unscaled)": g_loss,
            "train_hessian_loss(unscaled)": h_loss,
        }
