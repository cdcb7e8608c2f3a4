"""Solution evaluation against the closed-form oracle.

Counterpart of ``deeppicarditeration_tpu/evaluation/evaluator.py``
(``make_traced_eval`` and ``eval_solution``): x ~ law(X_t) on a t-linspace
grid, u and grad u of the solution against the exact solution. The Monte-
Carlo self-consistency evaluators and Hessian metrics come later.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models.solution import Solution


def _eval_batch(sol: Solution, eq, t, x, test_grad: bool) -> Dict:
    tx = torch.cat([t, x], dim=-1)
    u_pred, g_tx = sol.value_and_grad_tx(tx)
    out = {"u": u_pred, "u_exact": eq.exact_solution(t, x)}
    if test_grad:
        out["g"] = g_tx[:, 1:]
        out["g_exact"] = eq.u_x(t, x)
    return out


def _metrics_dict(cat: Dict, test_grad: bool) -> Dict[str, torch.Tensor]:
    metrics = value_metrics(cat["u"], cat["u_exact"])
    if test_grad:
        metrics.update(grad_metrics(cat["g"], cat["g_exact"], prefix="g"))
    return metrics


def _eval_points(generator, eq, n_points: int):
    t = torch.linspace(0.0, eq.T, n_points, device=generator.device)[:, None]
    return t, eq.sample_x(generator, t)


def make_traced_eval(n_points: int, test_grad: bool, test_hessian: bool):
    """(names, fn) with fn(sol, eq, generator) -> stacked metric values (a
    tensor on the generator's device, in the sorted order of ``names``);
    the in-training eval, read back once per iteration by the runner."""
    if test_hessian:
        raise NotImplementedError(
            "EVAL.TEST_HESSIAN is not ported yet (FN slice)")
    names = sorted(_metrics_dict(
        {k: torch.ones(1, 1) for k in ("u", "u_exact", "g", "g_exact")},
        test_grad))

    def fn(sol: Solution, eq, generator):
        t, x = _eval_points(generator, eq, n_points)
        md = _metrics_dict(_eval_batch(sol, eq, t, x, test_grad), test_grad)
        return torch.stack([md[n] for n in names])

    return names, fn


def eval_solution(generator, sol: Solution, eq, n_points: int,
                  test_grad: bool = False, test_hessian: bool = False,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
    """Metrics of sol vs the exact solution on the generator's device, as
    floats (one readback); ``batch_size`` bounds the points per pass."""
    if test_hessian:
        raise NotImplementedError(
            "EVAL.TEST_HESSIAN is not ported yet (FN slice)")
    t, x = _eval_points(generator, eq, n_points)
    bs = batch_size or n_points
    batches = [_eval_batch(sol, eq, t[i:i + bs], x[i:i + bs], test_grad)
               for i in range(0, n_points, bs)]
    cat = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
    md = _metrics_dict(cat, test_grad)
    names = sorted(md)
    vals = torch.stack([md[n] for n in names]).cpu().tolist()
    return dict(zip(names, vals))
