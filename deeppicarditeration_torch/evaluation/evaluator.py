"""Solution evaluation against the closed-form oracle.

Counterpart of ``deeppicarditeration_tpu/evaluation/evaluator.py``
(``make_traced_eval`` and ``eval_solution``): x ~ law(X_t) on a t-linspace
grid, u, grad u and (EVAL.TEST_HESSIAN, with TEST_GRAD) the full Hessian of
the solution against the exact solution. The Monte-Carlo self-consistency
evaluators come later.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.derivatives import full_hessian


def _eval_batch(sol: Solution, eq, t, x, test_grad: bool,
                test_hessian: bool = False) -> Dict:
    tx = torch.cat([t, x], dim=-1)
    u_pred, g_tx = sol.value_and_grad_tx(tx)
    out = {"u": u_pred, "u_exact": eq.exact_solution(t, x)}
    if test_grad:
        out["g"] = g_tx[:, 1:]
        out["g_exact"] = eq.u_x(t, x)
        if test_hessian:
            n = t.shape[0]
            out["h"] = full_hessian(sol, t, x).reshape(n, -1)
            out["h_exact"] = eq.u_hessian(t, x).reshape(n, -1)
    return out


def _metrics_dict(cat: Dict, test_grad: bool,
                  test_hessian: bool = False) -> Dict[str, torch.Tensor]:
    metrics = value_metrics(cat["u"], cat["u_exact"])
    if test_grad:
        metrics.update(grad_metrics(cat["g"], cat["g_exact"], prefix="g"))
        if test_hessian:
            metrics.update(grad_metrics(cat["h"], cat["h_exact"],
                                        prefix="h"))
    return metrics


def eval_points(generator, eq, n_points: int):
    """The eval's points: t on a linspace over [0, T], x ~ law(X_t) drawn
    from ``generator``, on its device."""
    t = torch.linspace(0.0, eq.T, n_points, device=generator.device)[:, None]
    return t, eq.sample_x(generator, t)


def make_traced_eval(test_grad: bool, test_hessian: bool):
    """(names, fn) with fn(sol, eq, t, x) -> the metric values on the
    points (t, x) stacked in one tensor, in the sorted order of ``names``:
    the in-training eval, read back once per iteration by the runner. The
    points come from ``eval_points`` (eagerly, where the fit is captured
    as a CUDA graph: fn has no host sync and goes into the graph). The
    Hessian metrics (``test_hessian`` with ``test_grad``, prefix "h") are
    the flattened (nx, nx) Hessians' per-entry errors."""
    names = sorted(_metrics_dict(
        {k: torch.ones(1, 1) for k in ("u", "u_exact", "g", "g_exact", "h",
                                       "h_exact")},
        test_grad, test_hessian))

    def fn(sol: Solution, eq, t, x):
        md = _metrics_dict(_eval_batch(sol, eq, t, x, test_grad,
                                       test_hessian),
                           test_grad, test_hessian)
        return torch.stack([md[n] for n in names])

    return names, fn


def eval_solution(generator, sol: Solution, eq, n_points: int,
                  test_grad: bool = False, test_hessian: bool = False,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
    """Metrics of sol vs the exact solution on the generator's device, as
    floats (one readback); ``batch_size`` bounds the points per pass."""
    t, x = eval_points(generator, eq, n_points)
    bs = batch_size or n_points
    batches = [_eval_batch(sol, eq, t[i:i + bs], x[i:i + bs], test_grad,
                           test_hessian)
               for i in range(0, n_points, bs)]
    cat = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
    md = _metrics_dict(cat, test_grad, test_hessian)
    names = sorted(md)
    vals = torch.stack([md[n] for n in names]).cpu().tolist()
    return dict(zip(names, vals))
