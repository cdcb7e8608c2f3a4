"""Post-hoc experiment evaluation (the ``evaluate`` subcommand).

Counterpart of ``deeppicarditeration_tpu/evaluation/experiment.py``: read
an experiment directory's ``config.yaml`` (the port's JSON dump, through
the port's YAML reader) and its ``model_{i}`` checkpoints, and run the MC
self-consistency check at (0, 0) (``monte_carlo_at_zero``) for iterations
0..PICARD.N, or the L2 sweeps (under the Picard time law and at t = 0, or
against a solution file). Iteration 0 is the zero ansatz, or g itself for a
terminal-enforcing one. Streams: iteration i's MC estimate draws from
derive_seed(seed, i), its L2 sweep's times and points from
derive_seed(seed, i, 0 | 1 | 2 | 3). Every net forward runs in chunks of
at most EVAL.BATCH_SIZE rows.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional

import torch

from deeppicarditeration_torch.config import load_cfg
from deeppicarditeration_torch.device import (
    derive_seed,
    make_generator,
    resolve_device,
)
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import (
    l2_at_t,
    monte_carlo_at_zero,
    value_batched,
)
from deeppicarditeration_torch.models.factory import (
    freeze,
    init_solution,
    is_enforce_terminal,
)
from deeppicarditeration_torch.models.networks import TerminalValue
from deeppicarditeration_torch.models.solution import VALUE, Solution
from deeppicarditeration_torch.ops.samplers import sample_t_picard
from deeppicarditeration_torch.training import checkpoint as ckpt

# the JAX package's evaluator key, PRNGKey(1234)
EVAL_SEED = 1234


class ExperimentEvaluator:
    """An experiment directory's iterates, evaluated on ``device`` (default:
    the config's DEVICE, itself "cuda" unless the run asked for the CPU)."""

    def __init__(self, exp_dir, n_estimate_terminal: int = 1_000_000,
                 n_estimate_integral: int = 1_000_000, device=None):
        self.exp_dir = pathlib.Path(exp_dir)
        self.cfg = load_cfg(self.exp_dir / "config.yaml")
        self.device = resolve_device(
            device if device is not None else self.cfg.get("DEVICE", "cuda"))
        self.equation = make_equation(
            self.cfg.EQUATION.cls, run_seed=int(self.cfg.SEED),
            **(self.cfg.EQUATION.kwargs or {})).to(self.device)
        self.n_terminal = n_estimate_terminal
        self.n_integral = n_estimate_integral
        self.eval_bs = self.cfg.EVAL.BATCH_SIZE
        self._cache: Dict[int, Solution] = {}

    def get_solution(self, i: int) -> Solution:
        """Iteration i's solution; i == 0 is the zero ansatz, or g(x) for a
        terminal-enforcing one."""
        if i in self._cache:
            return self._cache[i]
        eq, cfg = self.equation, self.cfg
        if i == 0:
            sol = (Solution.from_net(TerminalValue(eq.g), VALUE, eq.nx)
                   if is_enforce_terminal(cfg)
                   else Solution.zero(eq.nx, cfg.NETWORK.TYPE))
        else:
            module = init_solution(cfg, eq, self.device).module
            ckpt.load_params(ckpt.ckpt_path(self.exp_dir, i), module)
            sol = Solution.from_net(freeze(module), cfg.NETWORK.TYPE, eq.nx)
        self._cache[i] = sol
        return sol

    def monte_carlo_at_zero(self, iters: Optional[List[int]] = None,
                            seed: int = EVAL_SEED) -> List[Dict[str, float]]:
        out = []
        iters = iters if iters is not None else range(
            int(self.cfg.PICARD.N) + 1)
        for i in iters:
            rec = monte_carlo_at_zero(
                derive_seed(seed, i), self.equation, self.get_solution(i),
                n_estimate=self.n_terminal,
                n_estimate_integral=self.n_integral, device=self.device)
            rec["iter"] = i
            print(f"{i}: u(0,0)={rec['u_net_at_zero']:.6f}\t"
                  f"Picard Estimate: {rec['u_mc_at_zero']:.6f}")
            out.append(rec)
        return out

    def l2(self, n_points: int, seed: int = EVAL_SEED,
           plots: bool = True) -> List[Dict[str, float]]:
        """L2 under the Picard t-law and at t = 0 per iteration, with
        error-scatter plots where ``plots``."""
        eq, N, dev = self.equation, int(self.cfg.PICARD.N), self.device
        out = []
        for i in range(1, N + 1):
            sol = self.get_solution(i)
            t_rand = sample_t_picard(make_generator(dev, seed, i, 0),
                                     n_points, eq.T, max(N - i + 1, 1),
                                     device=dev)
            rec = {"iter": i}
            rec["l2_td"] = l2_at_t(make_generator(dev, seed, i, 1), sol, eq,
                                   t_rand, self.eval_bs)["l2_error"]
            t0 = torch.zeros((n_points, 1), device=dev)
            rec["l2_t0"] = l2_at_t(make_generator(dev, seed, i, 2), sol, eq,
                                   t0, self.eval_bs)["l2_error"]
            if plots:
                from deeppicarditeration_torch.evaluation.plots import (
                    plot_error,
                )

                x = eq.sample_x(make_generator(dev, seed, i, 3), t_rand)
                tx = torch.cat([t_rand, x], dim=-1)
                err = torch.abs(value_batched(sol, tx, self.eval_bs)
                                - eq.exact_solution(t_rand, x))
                plot_error(self.exp_dir, t_rand, x, err, f"iter_{i:03d}")
            print(f"Iter {i}: L2(td) = {rec['l2_td']:.4e}  "
                  f"L2(t0) = {rec['l2_t0']:.4e}")
            out.append(rec)
        return out

    def l2_file(self, sol_file, plots: bool = True
                ) -> List[Dict[str, float]]:
        """Per-iteration L2 against a (tx, u) solution file: .h5/.hdf5 with
        tx/u datasets (h5py, imported here), .npz with tx/u, or .npy
        columns [t, x(nx), u]."""
        import numpy as np

        sol_file = pathlib.Path(sol_file)
        if sol_file.suffix in (".h5", ".hdf5"):
            import h5py

            with h5py.File(sol_file, "r") as h5f:
                tx, u = h5f["tx"][()], h5f["u"][()]
        elif sol_file.suffix == ".npz":
            z = np.load(sol_file)
            tx, u = z["tx"], z["u"]
        else:
            data = np.load(sol_file)
            nx = self.equation.nx
            tx, u = data[:, :1 + nx], data[:, 1 + nx:2 + nx]
        tx = torch.as_tensor(np.asarray(tx), dtype=torch.float32,
                             device=self.device)
        u = torch.as_tensor(np.asarray(u), dtype=torch.float32,
                            device=self.device).reshape(tx.shape[0], 1)
        out = []
        for i in range(1, int(self.cfg.PICARD.N) + 1):
            err = torch.abs(value_batched(self.get_solution(i), tx,
                                          self.eval_bs) - u)
            l2 = float(torch.sqrt(torch.mean(err ** 2)))
            rec = {"iter": i, "l2": l2}
            if plots:
                from deeppicarditeration_torch.evaluation.plots import (
                    plot_error,
                )

                plot_error(self.exp_dir, tx[:, 0], tx[:, 1:], err,
                           f"iter_{i:03d}_of_given_file")
            print(f"Iter {i}: L2 error = {l2:.4e}")
            out.append(rec)
        return out
