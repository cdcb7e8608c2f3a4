"""Accuracy metrics (counterpart of deeppicarditeration_tpu/evaluation/metrics.py).

rRMSE = ||err||_2 / ||u||_2, rMAE = ||err||_1 / ||u||_1, MArE = mean|err/u|,
MSE = sqrt(mean(err^2)) (an RMSE, named for compatibility). Gradient
variants reduce per dimension first, then average the per-dimension ratios.
"""

from __future__ import annotations

from typing import Dict

import torch


def _mare(err, exact, eps: float = 1e-8):
    """mean|err/u| over entries with |u| > eps."""
    denom = torch.abs(exact)
    valid = denom > eps
    ratio = torch.where(valid, err / torch.clamp(denom, min=eps),
                        torch.zeros_like(err))
    return torch.sum(ratio) / torch.clamp(torch.sum(valid), min=1)


def value_metrics(u_pred, u_exact, prefix: str = "") -> Dict[str, torch.Tensor]:
    err = torch.abs(u_pred - u_exact)
    rrmse = torch.sqrt(torch.sum(err ** 2)) / torch.sqrt(torch.sum(u_exact ** 2))
    rmae = torch.sum(err) / torch.sum(torch.abs(u_exact))
    mse = torch.sqrt(torch.mean(err ** 2))
    mare = _mare(err, u_exact)
    return {f"MSE{prefix}": mse, f"rRMSE{prefix}": rrmse,
            f"rMAE{prefix}": rmae, f"MArE{prefix}": mare}


def grad_metrics(pred, exact, prefix: str = "g") -> Dict[str, torch.Tensor]:
    """Per-dimension relative errors, averaged over dimensions; (N, nx)."""
    err = torch.abs(pred - exact)
    l2 = (torch.sqrt(torch.sum(err ** 2, dim=0))
          / torch.sqrt(torch.sum(exact ** 2, dim=0)))
    l1 = torch.sum(err, dim=0) / torch.sum(torch.abs(exact), dim=0)
    mse = torch.mean(torch.sqrt(torch.mean(err ** 2, dim=0)))
    mare = _mare(err, exact)
    return {f"MSE{prefix}": mse, f"rRMSE{prefix}": torch.mean(l2),
            f"rMAE{prefix}": torch.mean(l1), f"MArE{prefix}": mare}
