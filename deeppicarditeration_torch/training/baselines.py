"""Baseline solvers: D-DBSDE (Diffusion) and DBDP (FullyNonlinearSolver).

Counterpart of ``deeppicarditeration_tpu/training/baselines.py``,
dispatched by METHOD.cls from ``PicardRunner.run_one``. The PINN-HTE
baseline comes with a later slice.

The JAX package fuses each log interval of epochs into one ``lax.scan``
dispatch, always. Here each D-DBSDE epoch (its draws from per-epoch
generators registered with the graph, the rollout kernel with its seed
from a device table, the loss, double backward and Adam step) is one
CUDA-graph replay (``training/fused.py``) whenever the baseline runs on
the card; on the CPU the same epoch runs eagerly. The log interval keeps
the JAX semantics: a "diffusion" row (the interval's last loss) and an
"eval" row per interval, read back once per interval, the periodic
``{model, optimizer}`` state and its meta sidecar, and the final
params-only ``model_{i}``.

Random streams: the JAX package folds the epoch into the iteration's key and
splits it four ways (t0, x0, paths, x_T); here each is a ``torch.Generator``
seeded from ``derive_seed(SEED, iteration, epoch, purpose)``, and the
rollout kernel takes a seed of the same form (a ``kernels.SeedTable``
filled with a log interval's seeds in one copy). RESUME stays rejected by
the runner.

DBDP (``train_dbdp``) sweeps the time grid backward with a value net and a
gradient net per grid time, each pair with its own Adam kept across epochs;
every sub-iteration draws fresh paths from the rollout kernel and takes
one Adam step, as one CUDA-graph replay over a static working pair
(``CapturedPairFit``; the JAX package scans a timestep's sub-iterations in
one dispatch). ``EagerPairFit``, the same steps launched one by one over
the pairs themselves, is the reference the tests hold it to.
"""

from __future__ import annotations

import copy
import json
import math
import time
from typing import Optional

import torch
from torch import nn

from deeppicarditeration_torch.device import (
    Timer,
    derive_seed,
    make_generator,
)
from deeppicarditeration_torch.equations.base import EquationMethods
from deeppicarditeration_torch.evaluation.evaluator import (
    eval_points,
    make_traced_eval,
)
from deeppicarditeration_torch.evaluation.metrics import value_metrics
from deeppicarditeration_torch.models.factory import (
    build_dbdp_pair,
    freeze,
    init_solution,
    is_enforce_terminal,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels
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
        return train_dbdp(runner)
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


def epoch_generators(runner) -> dict:
    """The D-DBSDE epoch's generators on the runner's device, by purpose
    (T0, X0, XT); ``seed_epoch`` seeds them for an epoch."""
    return {p: torch.Generator(device=runner.device) for p in (T0, X0, XT)}


def seed_epoch(runner, gens: dict, epoch: int) -> None:
    for purpose, g in gens.items():
        g.manual_seed(derive_seed(runner.seed, runner.i, epoch, purpose))


def diffusion_inputs(runner, gens: dict, paths_seed, terminal_weight: float):
    """The epoch's inputs (dts, ts, xs, xT): t0 ~ U(0, T) and x0 ~ law(X_t0)
    from ``gens``, the paths from the rollout kernel seeded with
    ``paths_seed`` (an int or a ``kernels.SeedTable``; on the CPU its plain
    version, which draws what the closed form would from the same seed)
    whatever DATA.TPU.PALLAS_ROLLOUT says (on the card the kernel is faster
    at every measured shape), and at a positive terminal weight xT ~
    law(X_T). Free of host syncs: the fused epoch runs it in its graph."""
    cfg, eq, dev = runner.cfg, runner.equation, runner.device
    K, dt, bs = int(cfg.METHOD.K), float(cfg.METHOD.dt), int(
        cfg.TRAIN.BATCH_SIZE)
    t0 = eq.T * torch.rand((bs, 1), generator=gens[T0], device=dev)
    x0 = eq.sample_x(gens[X0], t0)
    dts = rollout_dts(eq, t0, dt, K)
    ts, xs, _ = brownian_paths(None, eq, t0, x0, dts, K, use_pallas=True,
                               seed=paths_seed)
    xT = None
    if terminal_weight > 0.0:
        xT = eq.sample_x(gens[XT], torch.full((bs, 1), eq.T, device=dev))
    return dts, ts, xs, xT


def diffusion_draws(runner, epoch: int, terminal_weight: float):
    """The epoch's inputs (dts, ts, xs, xT), drawn eagerly: what the fused
    epoch draws in its graph for the same epoch."""
    gens = epoch_generators(runner)
    seed_epoch(runner, gens, epoch)
    runner.rollout_calls += 1
    return diffusion_inputs(
        runner, gens, derive_seed(runner.seed, runner.i, epoch, PATHS),
        terminal_weight)


def train_diffusion(runner):
    """K-step rollout + BSDE martingale-residual loss with Adam(1e-3),
    whatever TRAIN.OPTIMIZER says, for TRAIN.N_EPOCHS epochs. An epoch is
    one ``FusedStep``: its draws (the generators seeded for the epoch, the
    rollout from a seed table filled once per log interval), loss, double
    backward and Adam step, one graph replay on the card."""
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
    n_epochs = int(cfg.TRAIN.N_EPOCHS)
    interval = _log_interval(cfg)
    gens = epoch_generators(runner)
    seeds = kernels.SeedTable(interval, runner.device)

    def body():
        """The epoch: the graph's body."""
        optimizer.zero_grad(set_to_none=True)
        dts, ts, xs, xT = diffusion_inputs(runner, gens, seeds,
                                           terminal_weight)
        loss = diffusion_loss(sol, eq, ts, xs, dts, xT, terminal_weight)
        loss.backward()
        optimizer.step()
        return loss.detach()

    fused = FusedStep(body, {}, module, optimizer,
                      generators=list(gens.values()), state=[seeds.index])
    runner.fused_steps.append(fused)

    def step(epoch):
        if epoch % interval == 0:  # the interval's rollout seeds
            seeds.fill([derive_seed(runner.seed, runner.i, e, PATHS)
                        for e in range(epoch, min(epoch + interval,
                                                  n_epochs))])
        seed_epoch(runner, gens, epoch)
        runner.rollout_calls += 1
        return fused()

    return _baseline_loop(runner, step, module, optimizer, n_epochs,
                          "diffusion")


# ---------------------------------------------------------------------------
# DBDP / FullyNonlinearSolver (arXiv:1908.00412)
# ---------------------------------------------------------------------------

# derive_seed(SEED, iteration, INIT, k, net): grid time k's pair
INIT, INIT_U, INIT_G = 1000, 0, 1
# derive_seed(SEED, iteration, epoch, k, sub-iteration, purpose): a
# sub-iteration's draws (k = K + 1: the terminal pre-fit's)
DBDP_X0, DBDP_PATHS = 0, 1
# derive_seed(SEED, iteration, epoch, k, DBDP_EVAL): the grid eval's points
DBDP_EVAL = 777
# points per grid time in the grid eval
DBDP_EVAL_POINTS = 100


def check_dbdp(eq) -> None:
    """DBDP's loss reads the equation's ``ffh``: fail before the run where
    the equation defines none (the JAX package fails at its first step)."""
    if type(eq).ffh is EquationMethods.ffh:
        raise NotImplementedError(
            f"DBDP (METHOD.cls FullyNonlinearSolver) needs the equation's "
            f"ffh; {type(eq).__name__} defines none")


class DBDPNets(nn.Module):
    """DBDP's K + 1 per-grid-time net pairs: ``u[k]`` and ``g[k]`` map x to
    the value and the gradient corrections at t_k = k dt (``dbdp_u_at``,
    ``dbdp_ux_at`` anchor them to the terminal condition). Its state_dict
    is the checkpoint of the stacked nets."""

    def __init__(self, pairs):
        super().__init__()
        pairs = list(pairs)
        self.u = nn.ModuleList(p[0] for p in pairs)
        self.g = nn.ModuleList(p[1] for p in pairs)

    def pair(self, k: int):
        return self.u[k], self.g[k]

    def pair_parameters(self, k: int):
        return list(self.u[k].parameters()) + list(self.g[k].parameters())

    def copy_pair(self, src: int, dst: int) -> None:
        """Pair ``dst`` takes pair ``src``'s parameters (the warm start;
        the optimizer state stays ``dst``'s)."""
        with torch.no_grad():
            for a, b in zip(self.pair_parameters(dst),
                            self.pair_parameters(src)):
                a.copy_(b)

    def load_pairs(self, pairs) -> None:
        """Load a list of (u state_dict, g state_dict), one per grid time
        (``models/convert.py:dbdp_pair_state_dicts_from_flax``)."""
        for k, (us, gs) in enumerate(pairs):
            self.u[k].load_state_dict(us)
            self.g[k].load_state_dict(gs)


def dbdp_u_at(eq, u_mod, t_k, x):
    """The value at grid time t_k: g(x) + (T - t_k) u_k(x)."""
    return eq.g(x) + (eq.T - t_k) * u_mod(x)


def dbdp_ux_at(eq, g_mod, t_k, x):
    """The gradient at grid time t_k: g_x(x) + (T - t_k) g_k(x)."""
    return eq.g_x(x) + (eq.T - t_k) * g_mod(x)


def dbdp_hessian(eq, g_mod, t_next, x_next, terminal: bool):
    """(B, nx, nx): the per-sample Jacobian of the next gradient net (g_x
    alone at the terminal step of a terminal-enforcing ansatz) at x_next,
    by ``vmap(jacrev)``; no graph to the parameters."""

    def gnet(xx, tt):
        xx = xx[None]
        if terminal:
            return eq.g_x(xx)[0]
        return dbdp_ux_at(eq, g_mod, tt, xx)[0]

    with torch.no_grad():
        return torch.func.vmap(torch.func.jacrev(gnet))(x_next, t_next)


def dbdp_loss(eq, pair_prev, pair_next, t_prev, t_next, x, x_next, dW,
              is_last: bool, enforce: bool, dt: float):
    """One DBDP step's loss: mean((u_next - F)^2) with
    F = u - ffh(t, x, u, u_x, Hess u_next(x_next)) dt + <u_x, sqrt(a) dW>;
    u_next and the Hessian are held fixed. The Hessian is computed only
    for an equation with a Hessian term: ``ffh`` of any other equation
    does not read it (OU's is ``ff``), and the JAX package's compiled step
    drops it there too."""
    u_mod, g_mod = pair_prev
    un_mod, gn_mod = pair_next
    u = dbdp_u_at(eq, u_mod, t_prev, x)
    u_x = dbdp_ux_at(eq, g_mod, t_prev, x)
    with torch.no_grad():
        if enforce and is_last:
            u_next = eq.g(x_next)
        else:
            u_next = dbdp_u_at(eq, un_mod, t_next, x_next)
    hess = (dbdp_hessian(eq, gn_mod, t_next, x_next, enforce and is_last)
            if eq.has_hessian_term else None)
    f_hat = eq.ffh(t_prev, x, u, u_x, hess)
    F = (u - f_hat * dt
         + torch.sum(u_x * eq.alpha_sqrt * dW, dim=-1, keepdim=True))
    return torch.mean((u_next - F) ** 2)


def dbdp_terminal_loss(eq, pair, t_K, x, dt: float):
    """The terminal pre-fit's loss at grid time t_K on x = X_T:
    mean((u - g)^2) + dt mean((u_x - g_x)^2)."""
    u = dbdp_u_at(eq, pair[0], t_K, x)
    u_x = dbdp_ux_at(eq, pair[1], t_K, x)
    return (torch.mean((u - eq.g(x)) ** 2)
            + dt * torch.mean((u_x - eq.g_x(x)) ** 2))


class DBDPGridModule(nn.Module):
    """u(t, x) over DBDP's grid nets: the value net of the nearest grid
    time (round half to even, clipped to [0, K]) in its anchored form
    g(x) + (T - t_k) u_k(x). Every grid net runs on every point and the
    sample's row is gathered: an evaluation view, as the JAX package's."""

    def __init__(self, u_nets: nn.ModuleList, ts_grid: torch.Tensor,
                 K: int, dt: float, eq):
        super().__init__()
        self.u = u_nets
        self.register_buffer("ts_grid", ts_grid, persistent=False)
        self.K, self.dt, self.eq = int(K), float(dt), eq

    def forward(self, tx):
        t, x = tx[..., 0:1], tx[..., 1:]
        kk = torch.clamp(torch.round(t / self.dt).long(), 0, self.K)
        us = torch.stack([dbdp_u_at(self.eq, u, self.ts_grid[k], x)
                          for k, u in enumerate(self.u)])
        return torch.gather(us, 0, kk[None]).squeeze(0)


def dbdp_grid_eval(eq, nets: DBDPNets, ts_grid, generator=None,
                   n: int = DBDP_EVAL_POINTS, x_eval=None):
    """Value metrics of the grid nets against the exact solution, over n
    points x ~ law(X_{t_k}) at every grid time t_k (one draw for all from
    ``generator``, or ``x_eval`` ((K + 1) n, nx), grid time by grid time)."""
    t_eval = ts_grid.repeat_interleave(n)[:, None]
    if x_eval is None:
        x_eval = eq.sample_x(generator, t_eval)
    with torch.no_grad():
        us = torch.cat([dbdp_u_at(eq, nets.u[k], ts_grid[k],
                                  x_eval[k * n:(k + 1) * n])
                        for k in range(len(nets.u))])
        return value_metrics(us, eq.exact_solution(t_eval, x_eval))


class DBDPSweep:
    """What DBDP's sub-iterations share: the runner (its seed, iteration,
    counters), the equation, the grid (K steps of dt, ``ts_grid``), the
    batch, the ansatz and the sub-iterations per grid time; the paths'
    static buffers xs (K+1, B, nx), xi (K, B, nx), the start times t0 = 0
    and steps dts = dt."""

    def __init__(self, runner):
        cfg, eq, dev = runner.cfg, runner.equation, runner.device
        self.runner, self.eq, self.device = runner, eq, dev
        self.K = round(eq.T / float(cfg.METHOD.dt))
        self.dt = eq.T / self.K
        self.num_sub_iter = int(cfg.METHOD.num_sub_iter)
        self.bs, self.nx = int(cfg.TRAIN.BATCH_SIZE), eq.nx
        self.enforce = is_enforce_terminal(cfg)
        self.ts_grid = torch.arange(self.K + 1, dtype=torch.float32,
                                    device=dev) * self.dt
        self.xs = torch.empty((self.K + 1, self.bs, self.nx),
                              dtype=torch.float32, device=dev)
        self.xi = torch.empty((self.K, self.bs, self.nx), dtype=torch.float32,
                              device=dev)
        self.t0 = torch.zeros((self.bs, 1), dtype=torch.float32, device=dev)
        self.dts = torch.full((self.bs, 1), self.dt, dtype=torch.float32,
                              device=dev)

    def seeds(self, epoch: int, kk: int):
        """(x0 generator seed, rollout seed) of each sub-iteration of grid
        time kk (K + 1: the terminal pre-fit) in ``epoch``."""
        r = self.runner
        out = []
        for it in range(self.num_sub_iter):
            seed = derive_seed(r.seed, r.i, epoch, kk, it)
            out.append((derive_seed(seed, DBDP_X0),
                        derive_seed(seed, DBDP_PATHS)))
        return out

    def draw(self, x0_gen, paths_seed):
        """Fresh paths in the static buffers from x0 ~ the equation's start
        law (``x0_gen``) and the rollout kernel (``paths_seed``: an int or
        a ``kernels.SeedTable``); returns (xs, dW = xi sqrt(dt))."""
        x0 = self.eq.sample_x0(x0_gen, self.bs, torch.float32, self.device)
        brownian_paths(None, self.eq, self.t0, x0, self.dts, self.K,
                       use_pallas=True, seed=paths_seed,
                       out=(self.xs, self.xi))
        return self.xs, self.xi * math.sqrt(self.dt)


def _adam_step(opt, loss_fn):
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


class EagerPairFit:
    """A grid time's sub-iterations as an eager loop over the pair itself,
    one Adam per pair kept across epochs: the reference that
    ``CapturedPairFit`` is held to. Its Adams are capturable on the card
    too (the step count on the device, the bias correction in f32, as
    optax's), so that the two differ by the capture alone; ``capturable``
    False keeps the step count and the bias correction (f64) on the
    host."""

    def __init__(self, sweep: DBDPSweep, nets: DBDPNets,
                 capturable: Optional[bool] = None):
        self.sweep, self.nets = sweep, nets
        if capturable is None:
            capturable = sweep.device.type == "cuda"
        self.opts = [torch.optim.Adam(nets.pair_parameters(k),
                                      lr=BASELINE_LR, capturable=capturable)
                     for k in range(sweep.K + 1)]

    def __call__(self, epoch: int, kk: int):
        """Grid time kk's sub-iterations (kk = K + 1: the terminal
        pre-fit of pair K, else pair kk - 1 against pair kk); returns the
        last loss."""
        sw, nets, eq = self.sweep, self.nets, self.sweep.eq
        K, dev = sw.K, sw.device
        loss = None
        for s_x0, s_paths in sw.seeds(epoch, kk):
            g = torch.Generator(device=dev)
            g.manual_seed(s_x0)
            xs, dW = sw.draw(g, s_paths)
            sw.runner.rollout_calls += 1
            if kk == K + 1:
                loss = _adam_step(self.opts[K], lambda: dbdp_terminal_loss(
                    eq, nets.pair(K), sw.ts_grid[K], xs[K], sw.dt))
                continue
            t_prev = sw.ts_grid[kk - 1].expand(sw.bs, 1)
            t_next = sw.ts_grid[kk].expand(sw.bs, 1)
            loss = _adam_step(self.opts[kk - 1], lambda: dbdp_loss(
                eq, nets.pair(kk - 1), nets.pair(kk), t_prev, t_next,
                xs[kk - 1], xs[kk], dW[kk - 1], kk == K, sw.enforce, sw.dt))
        return loss

    def adam_state(self, k: int):
        """Pair k's Adam state: (step, exp_avg, exp_avg_sq) per parameter,
        in the order of ``DBDPNets.pair_parameters``."""
        opt = self.opts[k]
        return [opt.state[p][name] for p in self.nets.pair_parameters(k)
                for name in ("step", "exp_avg", "exp_avg_sq")]


class CapturedPairFit:
    """A grid time's sub-iterations as CUDA-graph replays (``FusedStep``;
    eagerly on the CPU) over static working modules: a trainable pair, a
    frozen next pair, t_prev / t_next and the grid index as tensors, and
    one Adam (capturable on the card) whose state is copied in from the
    pair's own and back after the grid time. So each pair keeps its own
    Adam across epochs, as the JAX package's stacked optimizer does, and
    at most three graphs serve the whole sweep: the terminal pre-fit, the
    last step of a terminal-enforcing ansatz, every other step. A
    sub-iteration is one replay: x0, the rollout (its seed from a table
    filled once per grid time), the loss with its Hessian, backward and
    the Adam step."""

    def __init__(self, sweep: DBDPSweep, nets: DBDPNets):
        sw, dev = sweep, sweep.device
        self.sweep, self.nets = sw, nets
        self.work = DBDPNets(copy.deepcopy([nets.pair(0), nets.pair(1)]))
        self.opt = torch.optim.Adam(self.work.pair_parameters(0),
                                    lr=BASELINE_LR,
                                    capturable=dev.type == "cuda")
        reset_optimizer(self.opt)
        self.opt_state = [self.opt.state[p][name]
                          for p in self.work.pair_parameters(0)
                          for name in ("step", "exp_avg", "exp_avg_sq")]
        # each pair's Adam state as a fresh Adam starts it
        self.stored = [[torch.zeros_like(t) for t in self.opt_state]
                       for _ in range(sw.K + 1)]
        self.t_prev = torch.zeros((sw.bs, 1), dtype=torch.float32,
                                  device=dev)
        self.t_next = torch.zeros_like(self.t_prev)
        self.k_prev = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.k_next = torch.zeros_like(self.k_prev)
        self.x0_gen = torch.Generator(device=dev)
        self.seeds = kernels.SeedTable(sw.num_sub_iter, dev)
        self.steps = {}

    def _body(self, kind):
        sw, eq, work = self.sweep, self.sweep.eq, self.work

        def loss_fn():
            xs, dW = sw.draw(self.x0_gen, self.seeds)
            if kind == "prefit":
                return dbdp_terminal_loss(eq, work.pair(0), self.t_prev,
                                          xs[sw.K], sw.dt)
            return dbdp_loss(
                eq, work.pair(0), work.pair(1), self.t_prev, self.t_next,
                xs.index_select(0, self.k_prev)[0],
                xs.index_select(0, self.k_next)[0],
                dW.index_select(0, self.k_prev)[0], kind == "last",
                sw.enforce, sw.dt)

        return lambda: _adam_step(self.opt, loss_fn)

    def _step(self, kind) -> FusedStep:
        if kind not in self.steps:
            self.steps[kind] = FusedStep(
                self._body(kind), {}, self.work, self.opt,
                generators=[self.x0_gen],
                state=[self.seeds.index])
            self.sweep.runner.fused_steps.append(self.steps[kind])
        return self.steps[kind]

    def __call__(self, epoch: int, kk: int):
        """As ``EagerPairFit.__call__``."""
        sw, nets = self.sweep, self.nets
        K = sw.K
        k = K if kk == K + 1 else kk - 1
        kind = ("prefit" if kk == K + 1
                else "last" if sw.enforce and kk == K else "step")
        seeds = sw.seeds(epoch, kk)
        with torch.no_grad():
            torch._foreach_copy_(self.work.pair_parameters(0),
                                 nets.pair_parameters(k))
            torch._foreach_copy_(self.opt_state, self.stored[k])
            self.t_prev.fill_(sw.ts_grid[k])
            if kind != "prefit":
                torch._foreach_copy_(self.work.pair_parameters(1),
                                     nets.pair_parameters(kk))
                self.t_next.fill_(sw.ts_grid[kk])
                self.k_prev.fill_(kk - 1)
                self.k_next.fill_(kk)
        self.seeds.fill([s for _, s in seeds])
        step = self._step(kind)
        loss = None
        for s_x0, _ in seeds:
            self.x0_gen.manual_seed(s_x0)
            sw.runner.rollout_calls += 1
            loss = step()
        loss = loss.clone()  # the graph's output: the next replay rewrites it
        with torch.no_grad():
            torch._foreach_copy_(nets.pair_parameters(k),
                                 self.work.pair_parameters(0))
            torch._foreach_copy_(self.stored[k], self.opt_state)
        return loss

    def adam_state(self, k: int):
        """As ``EagerPairFit.adam_state``."""
        return self.stored[k]


def init_dbdp_nets(runner, K: int) -> DBDPNets:
    """The K + 1 pairs, each initialized from its own seeded generators."""
    cpu = torch.device("cpu")
    return DBDPNets(
        build_dbdp_pair(runner.cfg, runner.equation, runner.device,
                        make_generator(cpu, runner.seed, runner.i, INIT, kk,
                                       INIT_U),
                        make_generator(cpu, runner.seed, runner.i, INIT, kk,
                                       INIT_G))
        for kk in range(K + 1))


def train_dbdp(runner):
    """The backward DBDP sweep: per epoch, the terminal pre-fit (unless the
    ansatz enforces the terminal condition), then for k = K .. 1 the warm
    start pair_{k-1} <- pair_k (parameters only) and METHOD.num_sub_iter
    Adam(1e-3) steps of pair k-1 on fresh paths (``CapturedPairFit``);
    after each k, the grid eval. One readback per epoch; a "dbdp" and an "eval" row per
    k; the stacked nets saved every epoch and at the end;
    ``runner.u_current`` the grid view. ``runner.timings`` gets each k's
    sub-iterations' ms."""
    cfg, eq, dev = runner.cfg, runner.equation, runner.device
    sw = DBDPSweep(runner)
    K, num_sub_iter = sw.K, sw.num_sub_iter
    nets = init_dbdp_nets(runner, K)
    fit = CapturedPairFit(sw, nets)
    ts_grid = sw.ts_grid

    def timed(epoch, kk):
        with Timer(dev) as tm:
            loss = fit(epoch, kk)
        runner.timings.append({"iter": runner.i, "epoch": epoch, "k": kk,
                               "sub_iters": num_sub_iter, "ms": tm.ms})
        return loss

    state_path, _ = _baseline_state_paths(runner)
    step_counter = 0
    t_start = time.perf_counter()
    wall0 = 0.0
    for epoch in range(int(cfg.TRAIN.N_EPOCHS)):
        if not sw.enforce:
            timed(epoch, K + 1)
        pending = []
        for kk in range(K, 0, -1):
            if kk < K:  # warm start from step k
                nets.copy_pair(kk, kk - 1)
            loss = timed(epoch, kk)
            step_counter += num_sub_iter
            em = None
            if eq.has_exact_solution:
                em = dbdp_grid_eval(eq, nets, ts_grid, make_generator(
                    dev, runner.seed, runner.i, epoch, kk, DBDP_EVAL))
            pending.append((kk, step_counter, loss, em))
        names = sorted(pending[0][3]) if pending[0][3] is not None else []
        host = torch.stack([v for _, _, loss, em in pending
                            for v in [loss] + [em[n] for n in names]]
                           ).cpu().tolist()  # one readback per epoch
        # per-k walls interpolated between the epoch's readbacks
        wall1 = time.perf_counter() - t_start
        width = 1 + len(names)
        for j, (kk, sc, _, _) in enumerate(pending):
            vals = host[j * width:(j + 1) * width]
            wall = wall0 + (wall1 - wall0) * (j + 1) / len(pending)
            runner.logger.log({"loss": vals[0], "k": kk, "epoch": epoch,
                               "wall_time": wall}, sc, context="dbdp")
            if names:
                runner.logger.log(dict(zip(names, vals[1:])), sc,
                                  context="eval")
        wall0 = wall1
        # the periodic save (never model_{i}: that marks a finished run)
        ckpt.save_params(state_path, nets)
    ckpt.save_params(ckpt.ckpt_path(runner.exp_dir, runner.i), nets)
    runner.u_current = Solution.from_net(
        freeze(DBDPGridModule(nets.u, ts_grid, K, sw.dt, eq)), "Value",
        sw.nx)
    return nets


# ---------------------------------------------------------------------------
# shared epoch loop
# ---------------------------------------------------------------------------

def _baseline_state_paths(runner):
    """(periodic {model, optimizer} state, its epoch/wall-time sidecar)."""
    state_path = (runner.exp_dir / f"baseline_{runner.i}_state").absolute()
    meta_path = runner.exp_dir / f"baseline_{runner.i}_meta.json"
    return state_path, meta_path


def _log_interval(cfg) -> int:
    """Epochs per log interval: EVAL.FREQ, or 100."""
    return int(cfg.EVAL.FREQ or 100)


def _baseline_loop(runner, step, module, optimizer, n_epochs: int, tag: str):
    """Run ``step(epoch)`` for n_epochs; per log interval (EVAL.FREQ or 100
    epochs) one readback of the last loss and the eval, a ``tag`` row and
    an "eval" row, and the periodic state. Then the final ``model_{i}`` and
    ``runner.u_current``. The interval's epochs are timed on the device
    (``runner.timings``: ``interval_ms`` over ``epochs``)."""
    cfg, eq = runner.cfg, runner.equation
    log_interval = _log_interval(cfg)
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
