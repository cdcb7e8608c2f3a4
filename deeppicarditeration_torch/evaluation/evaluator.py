"""Solution evaluation against the closed-form oracle.

Counterpart of ``deeppicarditeration_tpu/evaluation/evaluator.py``
(``make_traced_eval`` and ``eval_solution``): x ~ law(X_t) on a t-linspace
grid, u, grad u and (EVAL.TEST_HESSIAN, with TEST_GRAD) the full Hessian of
the solution against the exact solution; and the Monte-Carlo
self-consistency check (``monte_carlo_at_zero``): u_net(0, 0) against a
fresh Picard estimate built from u_net itself (the value-only estimators,
10^6 samples by default), with the L2 sweeps' helpers (``l2_at_t``,
``value_batched``) of ``evaluation/experiment.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
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


def _eval_batches(sol: Solution, eq, t, x, test_grad: bool,
                  test_hessian: bool, batch_size: Optional[int]) -> Dict:
    """``_eval_batch`` over at most ``batch_size`` points a pass (None: one
    pass), concatenated."""
    n = t.shape[0]
    bs = int(batch_size) if batch_size else n
    if bs >= n:
        return _eval_batch(sol, eq, t, x, test_grad, test_hessian)
    batches = [_eval_batch(sol, eq, t[i:i + bs], x[i:i + bs], test_grad,
                           test_hessian) for i in range(0, n, bs)]
    return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}


def make_traced_eval(test_grad: bool, test_hessian: bool,
                     batch_size: Optional[int] = None):
    """(names, fn) with fn(sol, eq, t, x) -> the metric values on the
    points (t, x) stacked in one tensor, in the sorted order of ``names``:
    the in-training eval, read back once per iteration by the runner. The
    points come from ``eval_points`` (eagerly, where the fit is captured
    as a CUDA graph: fn has no host sync and goes into the graph). The
    Hessian metrics (``test_hessian`` with ``test_grad``, prefix "h") are
    the flattened (nx, nx) Hessians' per-entry errors. ``batch_size``
    (EVAL.BATCH_SIZE) bounds the points per pass."""
    names = sorted(_metrics_dict(
        {k: torch.ones(1, 1) for k in ("u", "u_exact", "g", "g_exact", "h",
                                       "h_exact")},
        test_grad, test_hessian))

    def fn(sol: Solution, eq, t, x):
        md = _metrics_dict(_eval_batches(sol, eq, t, x, test_grad,
                                         test_hessian, batch_size),
                           test_grad, test_hessian)
        return torch.stack([md[n] for n in names])

    return names, fn


def eval_solution(generator, sol: Solution, eq, n_points: int,
                  test_grad: bool = False, test_hessian: bool = False,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
    """Metrics of sol vs the exact solution on the generator's device, as
    floats (one readback); ``batch_size`` bounds the points per pass."""
    t, x = eval_points(generator, eq, n_points)
    cat = _eval_batches(sol, eq, t, x, test_grad, test_hessian, batch_size)
    md = _metrics_dict(cat, test_grad, test_hessian)
    names = sorted(md)
    vals = torch.stack([md[n] for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def monte_carlo_at(seed: int, eq, sol: Solution, gen: "est.GenConfig",
                   x: torch.Tensor, t: Optional[torch.Tensor] = None):
    """A fresh Picard MC estimate of u(t, x) from ``sol``, (B, 1): the
    value-only estimators (``estimators.generate_values``) at the points
    (t = 0 by default), drawn from ``seed``."""
    if t is None:
        t = x.new_zeros(x.shape[:-1] + (1,))
    with torch.no_grad():
        return est.generate_values(seed, eq, sol, torch.cat([t, x], -1), gen)


def monte_carlo_at_zero(seed: int, eq, sol: Solution,
                        n_estimate: int = 1_000_000,
                        chunk_elems: int = 2 ** 22,
                        n_estimate_integral: Optional[int] = None,
                        device=None) -> Dict[str, float]:
    """u_net(0, 0) against an ``n_estimate``-sample MC estimate built from
    u_net itself (``n_estimate_integral`` defaults to ``n_estimate``): the
    reference's self-consistency check. Its GenConfig is the JAX package's
    (the chunk estimators, torch.Generator draws: no kernel runs); the
    points live on ``device`` (default: the card)."""
    from deeppicarditeration_torch.device import resolve_device

    gen = est.GenConfig(n_estimate_terminal=n_estimate,
                        n_estimate_integral=(n_estimate_integral
                                             or n_estimate),
                        chunk_elems=chunk_elems)
    x0 = torch.zeros((1, eq.nx), device=resolve_device(device))
    u_mc = monte_carlo_at(seed, eq, sol, gen, x0)
    with torch.no_grad():
        u_net = sol.value(torch.cat([torch.zeros_like(x0[:, :1]), x0], -1))
    u_net, u_mc = float(u_net[0, 0]), float(u_mc[0, 0])
    return {"u_net_at_zero": u_net, "u_mc_at_zero": u_mc,
            "self_consistency_error": abs(u_net - u_mc)}


def value_batched(sol: Solution, tx: torch.Tensor,
                  batch_size: Optional[int] = None) -> torch.Tensor:
    """sol.value over ``tx`` in chunks of at most ``batch_size`` rows
    (EVAL.BATCH_SIZE; None: one chunk)."""
    n = tx.shape[0]
    bs = int(batch_size) if batch_size else n
    with torch.no_grad():
        if bs >= n:
            return sol.value(tx)
        return torch.cat([sol.value(tx[i:i + bs]) for i in range(0, n, bs)])


def l2_at_t(generator, sol: Solution, eq, t: torch.Tensor,
            batch_size: Optional[int] = None) -> Dict[str, float]:
    """RMSE of the value head against the exact solution at x ~ law(X_t)
    drawn from ``generator`` at the times ``t`` (n, 1); ``batch_size``
    bounds the net's chunk, the draw stays whole."""
    x = eq.sample_x(generator, t)
    err = value_batched(sol, torch.cat([t, x], -1), batch_size) - \
        eq.exact_solution(t, x)
    return {"l2_error": float(torch.sqrt(torch.mean(err ** 2)))}
