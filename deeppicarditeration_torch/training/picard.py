"""The outer Picard loop: generate -> fit -> checkpoint -> swap.

Counterpart of ``deeppicarditeration_tpu/training/picard.py``. Per
iteration: a fresh (or RELOADed) network, a dataset generated from the
FROZEN previous iterate, a supervised fit for TRAIN.N_EPOCHS with an
in-training eval at every EVAL.FREQ boundary, a checkpoint, a swap. The
JAX package fuses the fit and its evals into one ``lax.scan`` dispatch; the
port keeps that dispatch's semantics (eval at each EVAL.FREQ boundary, one
metrics readback per iteration) in a plain loop.

Random streams: the JAX package splits keys; here each stream is a
``torch.Generator`` seeded from ``derive_seed(SEED, iteration, purpose,
...)``. METHOD.cls Diffusion runs the D-DBSDE baseline
(``training/baselines.py``) in place of the Picard steps. Not ported yet:
RESUME, offline datasets and DATA.SAVE, the TwoLayer formula, the PINN and
DBDP baselines, multi-device runs, plots.
"""

from __future__ import annotations

import pathlib
import shutil
from typing import List, Optional

import torch

from deeppicarditeration_torch.data.dataset import (
    DeviceDataset,
    default_gen_batch,
    epoch_batches,
    generate_dataset,
)
from deeppicarditeration_torch.device import (
    Timer,
    derive_seed,
    make_generator,
    resolve_device,
)
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import make_traced_eval
from deeppicarditeration_torch.models.factory import freeze, init_solution
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.estimators import GenConfig
from deeppicarditeration_torch.training import checkpoint as ckpt
from deeppicarditeration_torch.training.logging import MetricLogger
from deeppicarditeration_torch.training.trainer import (
    TrainSpec,
    make_optimizer,
    train_step,
)

# PRECISION.MATMUL -> torch.set_float32_matmul_precision
_MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                     "high": "high", "tensorfloat32": "high",
                     "bfloat16": "medium"}


def _tri_state(v):
    """Parse a false/true/"auto" config value (YAML bool or string)."""
    if isinstance(v, str):
        s = v.strip().lower()
        if s == "auto":
            return "auto"
        return s in ("1", "true", "yes", "on")
    return bool(v)


def gen_config_from_cfg(cfg) -> GenConfig:
    d = cfg.DATA
    kwargs = d.kwargs or {}
    if d.HESSIAN_APPROXIMATION.method is not None:
        raise NotImplementedError(
            "DATA.HESSIAN_APPROXIMATION is not ported yet (FN slice)")
    eps = 0.0
    if ("ByGx" in (d.ESTIMATE_TERMINAL or "")
            or "Joint" in (d.ESTIMATE_INTEGRAL or "")):
        eps = 0.01  # the reference's uniform-t epsilon
    return GenConfig(
        n_estimate_terminal=int(kwargs.get("n_estimate_terminal", 1)),
        n_estimate_integral=int(kwargs.get("n_estimate_integral", 1)),
        chunk_elems=int(d.CHUNK_ELEMS),
        t_always_uniform=bool(kwargs.get("t_always_uniform", False)),
        t_uniform_eps=eps,
        sample_bound=(float(d.SAMPLE_BOUND)
                      if d.SAMPLE_BOUND is not None else None),
        estimate_delta_t=float(d.ESTIMATE_DELTA_T),
        tpu_prng=bool(d.TPU.PRNG),
        antithetic=bool(d.TPU.ANTITHETIC),
        pallas_terminal=bool(d.TPU.PALLAS_TERMINAL),
        pallas_integral=bool(d.TPU.PALLAS_INTEGRAL),
        pallas_generate=_tri_state(d.TPU.PALLAS_GENERATE),
        pallas_precision=str(d.TPU.get("PALLAS_PRECISION", "bf16x3")),
    )


def _reject_unported(cfg) -> None:
    """Fail loudly on recipe features this slice of the port lacks."""
    checks = [
        (cfg.METHOD.cls not in ("Picard", "Diffusion"),
         f"METHOD.cls {cfg.METHOD.cls!r}"),
        (cfg.PICARD.FORMULA is not None,
         f"PICARD.FORMULA {cfg.PICARD.FORMULA!r}"),
        (bool(cfg.RESUME), "RESUME"),
        (not cfg.DATA.ONLINE, "DATA.ONLINE: false (offline datasets)"),
        (bool(cfg.DATA.SAVE), "DATA.SAVE"),
        (bool(cfg.DATA.EXACT), "DATA.EXACT"),
        (bool(cfg.TRAIN.SUPERVISE_HESSIAN), "TRAIN.SUPERVISE_HESSIAN"),
        (cfg.NETWORK.PRETRAIN_PATH is not None, "NETWORK.PRETRAIN_PATH"),
        (cfg.EVAL.REFERENCE_FILE is not None, "EVAL.REFERENCE_FILE"),
        (bool(cfg.EVAL.PLOT), "EVAL.PLOT"),
        (cfg.MESH.SHAPE is not None, "MESH.SHAPE (multi-device runs)"),
        (cfg.DATA.TPU.PALLAS_ACT is not None,
         "bf16 activation storage in the kernel (DATA.TPU.PALLAS_ACT)"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with a later slice")


class PicardRunner:
    """Drives PICARD.N iterations of generate -> fit -> checkpoint."""

    def __init__(self, cfg, exp_root: Optional[pathlib.Path] = None,
                 device=None):
        _reject_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(
            device if device is not None else cfg.get("DEVICE", "cuda"))
        self.exp_dir = pathlib.Path(exp_root or ".") / cfg.NAME
        self._prepare_exp_dir()
        self.seed = int(cfg.SEED)
        prec = (cfg.get("PRECISION") or {}).get("MATMUL", "default")
        if prec in _MATMUL_PRECISION:
            torch.set_float32_matmul_precision(_MATMUL_PRECISION[prec])
        self.dtype = torch.float32
        self.equation = make_equation(cfg.EQUATION.cls, run_seed=self.seed,
                                      **(cfg.EQUATION.kwargs or {}))
        eq = self.equation
        self.supervise_gradient = bool(cfg.TRAIN.SUPERVISE_GRADIENT
                                       or eq.has_gradient_term)
        self.net_type = cfg.NETWORK.TYPE
        self.N = int(cfg.PICARD.N)
        self.i = 0
        self.spec = TrainSpec.from_cfg(cfg, eq.nx)
        self.u_current = Solution.zero(eq.nx, self.net_type)
        self.u_history: List[Solution] = [self.u_current]
        self.logger = MetricLogger(self.exp_dir, cfg.LOGGING.LOGGER)
        self.global_step = 0
        self.generate_calls = 0
        self.rollout_calls = 0
        self.timings: List[dict] = []

    # ------------------------------------------------------------------
    def _prepare_exp_dir(self):
        """Create/wipe the experiment dir and dump the config (FORCE)."""
        cfg_file = self.exp_dir / "config.yaml"
        if self.exp_dir.exists() and any(self.exp_dir.iterdir()):
            contents = list(self.exp_dir.iterdir())
            if not (len(contents) == 1 and contents[0].name == cfg_file.name):
                if not self.cfg.FORCE:
                    raise FileExistsError(
                        f"Experiment directory {self.exp_dir} already "
                        "exists; set FORCE: true to overwrite")
                shutil.rmtree(self.exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        cfg_file.write_text(self.cfg.dump())

    @property
    def generation_mode(self) -> str:
        return "gradient" if self.supervise_gradient else "value"

    def _make_dataset(self, seed: int, gen: GenConfig,
                      mode: str) -> DeviceDataset:
        n_total = int(self.cfg.DATA.DATA_SIZE)
        gen_batch = self.cfg.DATA.get("GEN_BATCH")
        gen_batch = (int(gen_batch) if gen_batch else
                     default_gen_batch(n_total, gen.chunk_elems,
                                       self.equation.nx))
        self.generate_calls += -(-n_total // gen_batch)
        return generate_dataset(seed, self.equation, self.u_current,
                                n_total, gen, mode, gen_batch=gen_batch,
                                dtype=self.dtype, device=self.device)

    def _train_iteration(self, module, optimizer, ds: DeviceDataset):
        cfg = self.cfg
        bs = int(cfg.TRAIN.BATCH_SIZE)
        n_epochs = int(cfg.TRAIN.N_EPOCHS)
        if n_epochs <= 0:
            return  # generation-only config: nothing to fit
        steps = ds.size // bs
        freq = cfg.EVAL.FREQ
        seg = min(int(freq), steps) if freq else steps
        if seg <= 0:
            raise ValueError(
                f"TRAIN.BATCH_SIZE ({bs}) exceeds the dataset size "
                f"({ds.size}); no full batch can be formed")
        do_eval = bool(freq) and self.equation.has_exact_solution
        names = eval_fn = None
        if do_eval:
            names, eval_fn = make_traced_eval(
                int(cfg.EVAL.L2_N_POINTS), bool(cfg.EVAL.TEST_GRAD),
                bool(cfg.EVAL.TEST_HESSIAN))
        shuffle_gen = make_generator(self.device, self.seed, self.i, 2, 0)
        eval_gen = make_generator(self.device, self.seed, self.i, 2, 1)
        shuffle = cfg.DATA.SHUFFLE is not False
        rows = []  # (epoch, global step, train metrics, eval values)
        for epoch in range(n_epochs):
            txs, ys = epoch_batches(shuffle_gen, ds, bs, shuffle=shuffle)
            for s0 in range(0, steps, seg):
                s1 = min(s0 + seg, steps)
                for s in range(s0, s1):
                    metrics = train_step(module, optimizer, txs[s], ys[s],
                                         self.spec)
                self.global_step += s1 - s0
                ev = None
                if do_eval:
                    sol = Solution.from_net(module, self.net_type,
                                            self.equation.nx)
                    ev = eval_fn(sol, self.equation, eval_gen)
                rows.append((epoch, self.global_step, metrics, ev))
        if not freq:
            rows = rows[-1:]  # no in-training eval: one train row
        # ONE readback for the iteration's train + eval metrics
        keys = list(rows[0][2])
        flat = [torch.stack([r[2][k] for k in keys]) for r in rows]
        flat += [r[3] for r in rows if r[3] is not None]
        host = torch.cat(flat).cpu().tolist()
        n_tr = len(keys)
        lr = float((cfg.TRAIN.OPTIMIZER.kwargs or {}).get("lr", 1e-3))
        ev_base = len(rows) * n_tr
        for j, (epoch, gs, _, ev) in enumerate(rows):
            row = dict(zip(keys, host[j * n_tr:(j + 1) * n_tr]))
            self.logger.log({**row, "iter": self.i, "epoch": epoch}, gs,
                            context="train")
            if ev is not None:
                off = ev_base + j * len(names)
                em = dict(zip(names, host[off:off + len(names)]))
                em["iter"] = self.i
                em["lr"] = lr
                self.logger.log(em, gs, context="eval")

    def run_one(self) -> bool:
        cfg = self.cfg
        self.i += 1
        if cfg.METHOD.cls in ("PINN", "Diffusion", "FullyNonlinearSolver"):
            from deeppicarditeration_torch.training import baselines

            baselines.run_baseline(self)
            return True
        module = init_solution(
            cfg, self.equation, self.device,
            make_generator(torch.device("cpu"), self.seed, self.i, 0)).module
        if cfg.NETWORK.RELOAD and self.i > 1:
            ckpt.load_params(ckpt.ckpt_path(self.exp_dir, self.i - 1),
                             module)
        gen = gen_config_from_cfg(cfg)
        with Timer(self.device) as t_gen:
            ds = self._make_dataset(derive_seed(self.seed, self.i, 1), gen,
                                    self.generation_mode)
        optimizer = make_optimizer(cfg.TRAIN.OPTIMIZER, module.parameters())
        with Timer(self.device) as t_fit:
            self._train_iteration(module, optimizer, ds)
        ckpt.save_params(ckpt.ckpt_path(self.exp_dir, self.i), module)
        self.u_current = Solution.from_net(freeze(module), self.net_type,
                                           self.equation.nx)
        timing = {"iter": self.i, "generate_ms": t_gen.ms,
                  "fit_ms": t_fit.ms}
        self.timings.append(timing)
        self.logger.log(timing, self.global_step, context="timing")
        return True

    def run(self):
        while self.i < self.N:
            try:
                if not self.run_one():
                    break
            except KeyboardInterrupt:
                print("Interrupted... stopping the Picard loop")
                break
            self.u_history.append(self.u_current)
        self.logger.close()
