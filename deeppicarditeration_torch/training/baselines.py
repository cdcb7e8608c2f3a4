"""Baseline solvers: D-DBSDE (Diffusion) so far.

Counterpart of ``deeppicarditeration_tpu/training/baselines.py``,
dispatched by METHOD.cls from ``PicardRunner.run_one``. The PINN-HTE and
DBDP (FullyNonlinearSolver) baselines come with later slices.

The JAX package fuses each log interval of epochs into one ``lax.scan``
dispatch, always. Here each D-DBSDE epoch's draws run eagerly (the
per-epoch generators and the rollout kernel with its host seed) into
static buffers, and its loss, double backward and Adam step are one
CUDA-graph replay (``training/fused.py``), whenever the baseline runs on
the card; on the CPU the same epoch runs eagerly. The log interval keeps
the JAX semantics: a "diffusion" row (the interval's last loss) and an
"eval" row per interval, read back once per interval, the periodic
``{model, optimizer}`` state and its meta sidecar, and the final
params-only ``model_{i}``.

Random streams: the JAX package folds the epoch into the iteration's key and
splits it four ways (t0, x0, paths, x_T); here each is a ``torch.Generator``
seeded from ``derive_seed(SEED, iteration, epoch, purpose)``, and the
rollout kernel takes a seed of the same form. RESUME stays rejected by the
runner.
"""

from __future__ import annotations

import json
import time

import torch

from deeppicarditeration_torch.device import (
    Timer,
    derive_seed,
    make_generator,
)
from deeppicarditeration_torch.evaluation.evaluator import (
    eval_points,
    make_traced_eval,
)
from deeppicarditeration_torch.models.factory import (
    freeze,
    init_solution,
    is_enforce_terminal,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.rollout import brownian_paths
from deeppicarditeration_torch.training import checkpoint as ckpt
from deeppicarditeration_torch.training.fused import FusedStep
from deeppicarditeration_torch.training.trainer import reset_optimizer

# derive_seed(SEED, iteration, epoch, purpose): the epoch's draws
T0, X0, PATHS, XT, EVAL = range(5)
# the baselines' fixed optimizer, optax.adam(1e-3) in the JAX package
BASELINE_LR = 1e-3


def run_baseline(runner):
    method = runner.cfg.METHOD.cls
    if method == "Diffusion":
        return train_diffusion(runner)
    if method == "PINN":
        raise NotImplementedError(
            "the PINN baseline is not ported yet; it comes with the "
            "baselines slice")
    if method == "FullyNonlinearSolver":
        raise NotImplementedError(
            "the DBDP baseline (FullyNonlinearSolver) is not ported yet; it "
            "comes with the FN slice")
    raise ValueError(f"Unknown baseline {method!r}")


# ---------------------------------------------------------------------------
# D-DBSDE / Diffusion
# ---------------------------------------------------------------------------

def rollout_dts(eq, t0: torch.Tensor, dt: float, K: int) -> torch.Tensor:
    """(B, 1) step sizes: dt, shrunk to (T - t0) / K where t0 + K dt > T."""
    return torch.where(t0 + K * dt <= eq.T, torch.full_like(t0, dt),
                       (eq.T - t0) / K)


def diffusion_loss(sol: Solution, eq, ts: torch.Tensor, xs: torch.Tensor,
                   dts: torch.Tensor, xT, terminal_weight: float):
    """The D-DBSDE loss on drawn paths: the BSDE martingale residual
    v_K - (v_0 - sum f dt + sum <grad v, dX>) over the (K+1, B) path points,
    plus ``terminal_weight`` * mean((u(T, x_T) - g(x_T))^2) (``xT`` (B, nx),
    unused at weight 0). Back-propagates to the parameters through v and
    grad v (a double backward)."""
    v, v_grad = sol.value_and_grad_x(ts, xs, create_graph=True)
    if eq.has_gradient_term:
        fs = eq.ff(ts, xs, v, v_grad)
    else:
        fs = eq.f(ts, xs, v)
    dxs = xs[1:] - xs[:-1]
    v_pred = (v[0] - torch.sum(fs[:-1] * dts[None], dim=0)
              + torch.sum(torch.sum(v_grad[:-1] * dxs, dim=-1, keepdim=True),
                          dim=0))
    loss = torch.mean((v[-1] - v_pred) ** 2)
    if terminal_weight > 0.0:
        T = torch.full_like(xT[:, :1], eq.T)
        uT = sol.value(torch.cat([T, xT], dim=-1))
        loss = loss + terminal_weight * torch.mean((uT - eq.g(xT)) ** 2)
    return loss


def diffusion_buffers(runner, terminal_weight: float) -> dict:
    """Static buffers for ``diffusion_draws(..., out=)``: dts (B, 1), ts
    (K+1, B, 1), xs (K+1, B, nx), the rollout's xi (K, B, nx) and, at a
    positive terminal weight, xT (B, nx)."""
    cfg, nx, dev = runner.cfg, runner.equation.nx, runner.device
    K, bs = int(cfg.METHOD.K), int(cfg.TRAIN.BATCH_SIZE)
    shapes = {"dts": (bs, 1), "ts": (K + 1, bs, 1), "xs": (K + 1, bs, nx),
              "xi": (K, bs, nx)}
    if terminal_weight > 0.0:
        shapes["xT"] = (bs, nx)
    return {k: torch.empty(v, dtype=torch.float32, device=dev)
            for k, v in shapes.items()}


def diffusion_draws(runner, epoch: int, terminal_weight: float,
                    out: dict = None):
    """The epoch's inputs (dts, ts, xs, xT). The paths always come from the
    rollout kernel (its plain version on the CPU, which draws what the
    closed form would from the same seed), whatever DATA.TPU.PALLAS_ROLLOUT
    says: on the card the kernel is faster at every measured shape.
    ``out`` (``diffusion_buffers``): written into and returned, the same
    draws (the rollout kernel writes its paths there directly)."""
    cfg, eq, dev = runner.cfg, runner.equation, runner.device
    K, dt, bs = int(cfg.METHOD.K), float(cfg.METHOD.dt), int(
        cfg.TRAIN.BATCH_SIZE)

    def gen(purpose):
        g = torch.Generator(device=dev)
        g.manual_seed(derive_seed(runner.seed, runner.i, epoch, purpose))
        return g

    t0 = eq.T * torch.rand((bs, 1), generator=gen(T0), device=dev)
    x0 = eq.sample_x(gen(X0), t0)
    dts = rollout_dts(eq, t0, dt, K)
    ts, xs, _ = brownian_paths(
        gen(PATHS), eq, t0, x0, dts, K, use_pallas=True,
        seed=derive_seed(runner.seed, runner.i, epoch, PATHS),
        out=None if out is None else (out["xs"], out["xi"]))
    runner.rollout_calls += 1
    xT = None
    if terminal_weight > 0.0:
        xT = eq.sample_x(gen(XT), torch.full((bs, 1), eq.T, device=dev))
    if out is None:
        return dts, ts, xs, xT
    out["dts"].copy_(dts)
    out["ts"].copy_(ts)
    if xT is not None:
        out["xT"].copy_(xT)
    return out["dts"], out["ts"], out["xs"], out.get("xT")


def train_diffusion(runner):
    """K-step rollout + BSDE martingale-residual loss with Adam(1e-3),
    whatever TRAIN.OPTIMIZER says, for TRAIN.N_EPOCHS epochs."""
    cfg, eq = runner.cfg, runner.equation
    module = init_solution(
        cfg, eq, runner.device,
        make_generator(torch.device("cpu"), runner.seed, runner.i, 0)).module
    # a terminal-enforcing ansatz needs no terminal penalty
    terminal_weight = (0.0 if is_enforce_terminal(cfg)
                       else float(cfg.TRAIN.LOSS.beta))
    optimizer = torch.optim.Adam(
        module.parameters(), lr=BASELINE_LR,
        capturable=runner.device.type == "cuda")
    reset_optimizer(optimizer)
    sol = Solution.from_net(module, runner.net_type, eq.nx)
    bufs = diffusion_buffers(runner, terminal_weight)

    def loss_step():
        """The epoch on its drawn inputs: the graph's body."""
        optimizer.zero_grad(set_to_none=True)
        loss = diffusion_loss(sol, eq, bufs["ts"], bufs["xs"], bufs["dts"],
                              bufs.get("xT"), terminal_weight)
        loss.backward()
        optimizer.step()
        return loss.detach()

    fused = FusedStep(loss_step, bufs, module, optimizer)
    runner.fused_steps.append(fused)

    def step(epoch):
        diffusion_draws(runner, epoch, terminal_weight, out=bufs)
        return fused()

    return _baseline_loop(runner, step, module, optimizer,
                          int(cfg.TRAIN.N_EPOCHS), "diffusion")


# ---------------------------------------------------------------------------
# shared epoch loop
# ---------------------------------------------------------------------------

def _baseline_state_paths(runner):
    """(periodic {model, optimizer} state, its epoch/wall-time sidecar)."""
    state_path = (runner.exp_dir / f"baseline_{runner.i}_state").absolute()
    meta_path = runner.exp_dir / f"baseline_{runner.i}_meta.json"
    return state_path, meta_path


def _baseline_loop(runner, step, module, optimizer, n_epochs: int, tag: str):
    """Run ``step(epoch)`` for n_epochs; per log interval (EVAL.FREQ or 100
    epochs) one readback of the last loss and the eval, a ``tag`` row and
    an "eval" row, and the periodic state. Then the final ``model_{i}`` and
    ``runner.u_current``. The interval's epochs are timed on the device
    (``runner.timings``: ``interval_ms`` over ``epochs``)."""
    cfg, eq = runner.cfg, runner.equation
    log_interval = int(cfg.EVAL.FREQ or 100)
    state_path, meta_path = _baseline_state_paths(runner)
    names = eval_fn = None
    if eq.has_exact_solution:
        names, eval_fn = make_traced_eval(bool(cfg.EVAL.TEST_GRAD), False)
    sol = Solution.from_net(module, runner.net_type, eq.nx)
    t_start = time.perf_counter()
    for e0 in range(0, n_epochs, log_interval):
        n = min(log_interval, n_epochs - e0)
        with Timer(runner.device) as tm:
            for e in range(e0, e0 + n):
                loss = step(e)
        epoch = e0 + n - 1
        vals = [loss.reshape(1)]
        if eval_fn is not None:
            g = torch.Generator(device=runner.device)
            g.manual_seed(derive_seed(runner.seed, runner.i, epoch, EVAL))
            t, x = eval_points(g, eq, int(cfg.EVAL.L2_N_POINTS))
            vals.append(eval_fn(sol, eq, t, x))
        host = torch.cat(vals).cpu().tolist()  # one readback per interval
        wall = time.perf_counter() - t_start
        runner.logger.log({"loss": host[0], "epoch": epoch,
                           "wall_time": wall}, epoch, context=tag)
        ckpt.save_state(state_path, module, optimizer)
        meta_path.write_text(json.dumps({"epoch": e0 + n,
                                         "wall_time": wall}))
        if eval_fn is not None:
            em = dict(zip(names, host[1:]))
            em["wall_time"] = wall
            runner.logger.log(em, epoch, context="eval")
        runner.timings.append({"iter": runner.i, "epoch": epoch,
                               "epochs": n, "interval_ms": tm.ms})
    ckpt.save_params(ckpt.ckpt_path(runner.exp_dir, runner.i), module)
    runner.u_current = Solution.from_net(freeze(module), runner.net_type,
                                         eq.nx)
    return module
