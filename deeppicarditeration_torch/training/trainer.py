"""Supervised-fit engine: optimizer factory, loss and one train step.

Counterpart of ``deeppicarditeration_tpu/training/trainer.py``. Adam is
``torch.optim.Adam``: optax's and torch's Adam agree (bias-corrected first
and second moments, eps added to the square root of the corrected second
moment, no eps inside the root), so the same lr/betas/eps give the same
update up to rounding. The captured fit (``training/fused.py``) takes
``capturable=True`` on the card: its step count lives on the device and
the bias correction is computed there in f32 (on the host in f64 without
it). Schedulers, the other optimizers and Hessian supervision come with
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from deeppicarditeration_torch.models.solution import VALUE, Solution
from deeppicarditeration_torch.training.losses import (
    FixedHessianLossScaler,
    get_scaler,
    make_loss_fn,
)


def make_optimizer(opt_cfg, params,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """torch optimizer for TRAIN.OPTIMIZER (Adam without a scheduler).

    optax's keyword names are accepted: ``b1``/``b2`` map to ``betas``.
    ``capturable``: a step that a CUDA graph can capture (parameters on
    the card)."""
    cls = opt_cfg.get("cls", "Adam")
    kwargs = dict(opt_cfg.get("kwargs", {}) or {})
    sched = (opt_cfg.get("SCHEDULER", {}) or {}).get("cls")
    if cls != "Adam" or sched is not None:
        raise NotImplementedError(
            f"TRAIN.OPTIMIZER {cls!r} with scheduler {sched!r} is not ported "
            "yet (only Adam without a scheduler)")
    lr = float(kwargs.pop("lr", 1e-3))
    kwargs.pop("weight_decay", None)  # optax.adam has none; JAX drops it
    b1 = float(kwargs.pop("b1", 0.9))
    b2 = float(kwargs.pop("b2", 0.999))
    eps = float(kwargs.pop("eps", 1e-8))
    if kwargs:
        raise NotImplementedError(f"Adam kwargs {sorted(kwargs)} not ported")
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            capturable=capturable)


def reset_optimizer(optimizer: torch.optim.Adam) -> None:
    """Adam's state as a fresh optimizer starts it (step 0, zero moments),
    set in place: the tensors keep their addresses, so a captured step
    stays valid. Creates the state where it does not exist yet, with the
    step count on the parameter's device when capturable (else on the
    host), as ``torch.optim.Adam`` would at its first step."""
    for group in optimizer.param_groups:
        capturable = bool(group.get("capturable", False))
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                for v in state.values():
                    v.zero_()
                continue
            state["step"] = torch.zeros(
                (), dtype=torch.float32,
                device=p.device if capturable else "cpu")
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Static training-step description."""

    net_type: str = VALUE
    nx: int = 1
    supervise_gradient: bool = False
    supervise_hessian: bool = False
    beta: float = 0.0
    scaler_cls: Optional[str] = None
    scaler_kwargs: tuple = ()
    loss_fn_cls: Optional[str] = None
    loss_fn_kwargs: tuple = ()

    @classmethod
    def from_cfg(cls, cfg, nx: int) -> "TrainSpec":
        t = cfg.TRAIN
        return cls(
            net_type=cfg.NETWORK.TYPE,
            nx=nx,
            supervise_gradient=bool(t.SUPERVISE_GRADIENT),
            supervise_hessian=bool(t.SUPERVISE_HESSIAN),
            beta=float(t.LOSS.beta),
            scaler_cls=t.LOSS.SCALER.cls,
            scaler_kwargs=tuple(sorted((t.LOSS.SCALER.kwargs or {}).items())),
            loss_fn_cls=t.LOSS.FN.cls,
            loss_fn_kwargs=tuple(sorted((t.LOSS.FN.kwargs or {}).items())),
        )

    @property
    def effective_scaler(self):
        if self.supervise_hessian and self.scaler_cls is None:
            return FixedHessianLossScaler(1.0, 1.0)
        return get_scaler(self.scaler_cls, **dict(self.scaler_kwargs))

    @property
    def gradient_short_circuit(self) -> bool:
        """FixedLossScaler with weight ~ 0 trains the plain value loss."""
        if self.supervise_hessian or not self.supervise_gradient:
            return False
        if self.scaler_cls == "FixedLossScaler":
            w = dict(self.scaler_kwargs).get("fixed_weight", 1.0)
            return (w is not None and float(w) <= 1e-9
                    and self.net_type == VALUE)
        return False


def compute_loss(module, tx, y, spec: TrainSpec):
    """(loss, metrics) for one batch; metrics are detached scalars."""
    sol = Solution.from_net(module, spec.net_type, spec.nx)
    lfn = make_loss_fn(spec.loss_fn_cls, **dict(spec.loss_fn_kwargs))
    weight = torch.exp(tx[:, 0:1] * spec.beta)
    nx = spec.nx
    metrics: Dict[str, torch.Tensor] = {}
    if spec.supervise_hessian:
        raise NotImplementedError(
            "Hessian supervision is not ported yet (FN slice)")
    if spec.supervise_gradient and not spec.gradient_short_circuit:
        y_u, y_ux = y[:, 0:1], y[:, 1:1 + nx]
        # per-sample gradient via one batched backward pass, kept in the
        # graph so the gradient loss reaches the parameters
        u, g_tx = sol.value_and_grad_tx(tx, create_graph=True)
        u_x = g_tx[:, 1:]
        v_loss = torch.mean(weight * lfn(u - y_u))
        g_vec = torch.mean(weight * lfn(u_x - y_ux), dim=0)
        loss, info = spec.effective_scaler.scale(v_loss, g_vec)
        metrics.update(info)
        metrics["train_value_loss"] = v_loss
    else:
        y_u = y[:, 0:1]
        u = sol.value(tx)
        loss = torch.mean(weight * lfn(u - y_u))
        metrics["train_value_loss"] = loss
    metrics["train_loss"] = loss
    return loss, {k: v.detach() for k, v in metrics.items()}


def train_step(module, optimizer: torch.optim.Optimizer, tx, y,
               spec: TrainSpec) -> Dict[str, torch.Tensor]:
    """One optimizer step on one batch; returns the batch's metrics."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_loss(module, tx, y, spec)
    loss.backward()
    optimizer.step()
    return metrics


def train_steps(module, optimizer: torch.optim.Optimizer, txs, ys,
                spec: TrainSpec) -> Tuple[List[str], torch.Tensor]:
    """``train_step`` on the batches ``txs[s], ys[s]`` in order; the last
    step's metric names and their values stacked in one tensor. In the
    captured fit that tensor is the graph's static output."""
    for tx, y in zip(txs, ys):
        metrics = train_step(module, optimizer, tx, y, spec)
    return list(metrics), torch.stack(list(metrics.values()))
