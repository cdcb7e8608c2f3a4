"""The outer Picard loop: generate -> fit -> checkpoint -> swap.

Counterpart of ``deeppicarditeration_tpu/training/picard.py``. Per
iteration: a fresh (or RELOADed) network, a dataset generated from the
FROZEN previous iterate, a supervised fit for TRAIN.N_EPOCHS with an
in-training eval at every EVAL.FREQ boundary, a checkpoint, a swap. The
JAX package fuses the fit and its evals into one ``lax.scan`` dispatch
(``TRAIN.FUSED``); the port's counterpart replays an epoch of train steps
and its evals as a CUDA graph (``training/fused.py``), with the shuffle
and the eval points drawn eagerly into its static buffers, so that the
draws, the batch order and the logged rows are the loop's. ``fit_route``
reads TRAIN.FUSED as the JAX runner does; where its gate fails, or under
``false``, the fit is a plain loop. Either way one metrics readback per
iteration.

Random streams: the JAX package splits keys; here each stream is a
``torch.Generator`` seeded from ``derive_seed(SEED, iteration, purpose,
...)``. METHOD.cls PINN, Diffusion and FullyNonlinearSolver run the
PINN-HTE, D-DBSDE and DBDP baselines (``training/baselines.py``) in place
of the Picard steps; OptimalControl and DeepNesting run the Picard steps,
as in the JAX runner. RESUME continues a run from its latest ``model_{i}``
(``_maybe_resume``) and a baseline from its periodic state. Not ported
yet: offline datasets and DATA.SAVE (with it RESUME from a saved dataset),
the TwoLayer formula, Hessian supervision, multi-device runs, plots.
"""

from __future__ import annotations

import copy
import pathlib
import shutil
from typing import List, Optional, Tuple

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
from deeppicarditeration_torch.evaluation.evaluator import (
    eval_points,
    make_traced_eval,
)
from deeppicarditeration_torch.models.factory import freeze, init_solution
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.estimators import GenConfig
from deeppicarditeration_torch.training import checkpoint as ckpt
from deeppicarditeration_torch.training.fused import FusedStep
from deeppicarditeration_torch.training.logging import MetricLogger
from deeppicarditeration_torch.training.trainer import (
    TrainSpec,
    make_optimizer,
    reset_optimizer,
    train_steps,
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


def _opt_str(v):
    """Optional-string config value: None for every null-ish spelling
    (None, False, "", "none"/"null"/"off"/"false"/"0"), else the lowercased
    string."""
    if v is None or v is False or v == "" or v == 0:
        return None
    s = str(v).strip().lower()
    return None if s in ("none", "null", "off", "false", "0") else s


def sdgd_v_from_cfg(cfg) -> Optional[int]:
    """SDGD's sampled diagonal entries per point (DATA.HESSIAN_APPROXIMATION
    method SDGD, kwargs.v), or None."""
    hess = cfg.DATA.HESSIAN_APPROXIMATION
    if hess.method != "SDGD":
        return None
    v = (hess.kwargs or {}).get("v")
    if v is None:
        raise ValueError(
            "DATA.HESSIAN_APPROXIMATION.method is SDGD but "
            "DATA.HESSIAN_APPROXIMATION.kwargs.v is not set")
    return int(v)


def gen_config_from_cfg(cfg) -> GenConfig:
    d = cfg.DATA
    kwargs = d.kwargs or {}
    sdgd_v = sdgd_v_from_cfg(cfg)
    hess_store = _opt_str(d.TPU.get("HESSIAN_STORE"))
    if hess_store not in (None, "bf16"):
        # a typo would otherwise silently run the f32 chain
        raise ValueError(
            f"DATA.TPU.HESSIAN_STORE must be null or 'bf16', got "
            f"{d.TPU.HESSIAN_STORE!r}")
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
        sdgd_v=sdgd_v,
        hess_store=hess_store,
    )


# METHOD.cls values that run the Picard loop: the HJB recipes' "optimal
# control" and "deep nesting" names have no solver of their own in the
# JAX package either and fall through to it
PICARD_METHODS = ("Picard", "OptimalControl", "DeepNesting")
# the ported baselines (training/baselines.py)
BASELINE_METHODS = ("PINN", "Diffusion", "FullyNonlinearSolver")


def _reject_unported(cfg) -> None:
    """Fail loudly on recipe features this slice of the port lacks."""
    checks = [
        (cfg.METHOD.cls not in PICARD_METHODS + BASELINE_METHODS,
         f"METHOD.cls {cfg.METHOD.cls!r}"),
        (cfg.PICARD.FORMULA is not None,
         f"PICARD.FORMULA {cfg.PICARD.FORMULA!r}"),
        (not cfg.DATA.ONLINE, "DATA.ONLINE: false (offline datasets)"),
        (bool(cfg.DATA.SAVE),
         "DATA.SAVE (and RESUME from a saved dataset)"
         if cfg.RESUME else "DATA.SAVE"),
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


FUSED, LOOP = "fused", "loop"


def fit_route(cfg, steps: int,
              has_exact_solution: bool) -> Tuple[str, Optional[str]]:
    """(FUSED or LOOP, why the fused fit is unavailable or None):
    TRAIN.FUSED read as the JAX runner reads it
    (``training/picard.py:_train_iteration``). EVAL.FREQ null takes the
    fused epochs without evals whatever TRAIN.FUSED says (the JAX
    ``_make_epoch_scan``). Otherwise "auto" and true take the fused fit
    unless its gate fails: steps not a multiple of the EVAL.FREQ segment,
    EVAL.REFERENCE_FILE set, or EVAL.BATCH_SIZE below EVAL.L2_N_POINTS
    (the fused eval takes every point in one pass); false takes the loop."""
    freq = cfg.EVAL.FREQ
    if freq is None:
        return FUSED, None
    seg = min(int(freq), steps)
    n_points = int(cfg.EVAL.L2_N_POINTS)
    eval_bs = cfg.EVAL.BATCH_SIZE
    fail = None
    if seg <= 0:
        fail = "EVAL.FREQ/steps <= 0" if freq else None
    elif steps % seg != 0:
        fail = (f"steps ({steps}) is not a multiple of EVAL.FREQ "
                f"({seg})")
    elif cfg.EVAL.REFERENCE_FILE:
        fail = "EVAL.REFERENCE_FILE is set"
    elif (has_exact_solution and eval_bs is not None
          and int(eval_bs) < n_points):
        fail = (f"EVAL.BATCH_SIZE ({eval_bs}) < EVAL.L2_N_POINTS "
                f"({n_points})")
    if _tri_state(cfg.TRAIN.FUSED) is not False and fail is None and seg > 0:
        return FUSED, None
    return LOOP, fail


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
        self.equation = make_equation(
            cfg.EQUATION.cls, run_seed=self.seed,
            **(cfg.EQUATION.kwargs or {})).to(self.device)
        eq = self.equation
        if cfg.METHOD.cls == "FullyNonlinearSolver":
            from deeppicarditeration_torch.training.baselines import (
                check_dbdp,
            )

            check_dbdp(eq)
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
        # the fused fit's (shape key, FusedStep, train metric names, eval
        # names): one train module and optimizer per runner, captured once
        # per shape
        self._fused = None
        # every FusedStep of the run (the fit's, the baseline's)
        self.fused_steps: List[FusedStep] = []
        if cfg.RESUME:
            self._maybe_resume()

    # ------------------------------------------------------------------
    def _prepare_exp_dir(self):
        """Create/wipe the experiment dir and dump the config (FORCE);
        under RESUME its checkpoints stay."""
        cfg_file = self.exp_dir / "config.yaml"
        if self.exp_dir.exists() and any(self.exp_dir.iterdir()):
            contents = list(self.exp_dir.iterdir())
            if self.cfg.RESUME:
                pass  # _maybe_resume picks up from the checkpoints
            elif not (len(contents) == 1
                      and contents[0].name == cfg_file.name):
                if not self.cfg.FORCE:
                    raise FileExistsError(
                        f"Experiment directory {self.exp_dir} already "
                        "exists; set FORCE: true to overwrite")
                shutil.rmtree(self.exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        cfg_file.write_text(self.cfg.dump())

    def _maybe_resume(self):
        """Continue from the latest ``model_{i}`` in the experiment dir: it
        becomes ``u_current``, so that iteration i + 1 generates its
        targets from the network an uninterrupted run would use. DBDP's
        ``model_{i}`` holds the stacked grid nets: its completed iterations
        are skipped, nothing is loaded. A baseline's unfinished iteration
        continues from its periodic state (``baselines._baseline_loop``)."""
        latest = 0
        while ckpt.ckpt_path(self.exp_dir, latest + 1).exists():
            latest += 1
        if latest == 0:
            return
        if self.cfg.METHOD.cls == "FullyNonlinearSolver":
            self.i = latest
            print(f"RESUME: DBDP iterations 1..{latest} already complete "
                  f"({self.exp_dir}); skipping them")
            return
        module = init_solution(self.cfg, self.equation, self.device).module
        ckpt.load_params(ckpt.ckpt_path(self.exp_dir, latest), module)
        self.u_current = Solution.from_net(freeze(module), self.net_type,
                                           self.equation.nx)
        self.u_history.append(self.u_current)
        self.i = latest
        print(f"RESUME: continuing from iteration {latest} "
              f"({self.exp_dir})")

    @property
    def graph_replays(self) -> int:
        """CUDA-graph replays of the run's fused steps (0 on the CPU)."""
        return sum(step.replays for step in self.fused_steps)

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

    def _train_iteration(self, module, ds: DeviceDataset):
        """Fit the fresh (or RELOADed) ``module`` to ``ds`` for
        TRAIN.N_EPOCHS epochs, by ``fit_route``; returns the trained
        module (the fused fit's own, into which ``module``'s weights were
        copied, or ``module`` itself)."""
        cfg = self.cfg
        bs = int(cfg.TRAIN.BATCH_SIZE)
        n_epochs = int(cfg.TRAIN.N_EPOCHS)
        if n_epochs <= 0:
            return module  # generation-only config: nothing to fit
        steps = ds.size // bs
        freq = cfg.EVAL.FREQ
        seg = min(int(freq), steps) if freq else steps
        if seg <= 0:
            raise ValueError(
                f"TRAIN.BATCH_SIZE ({bs}) exceeds the dataset size "
                f"({ds.size}); no full batch can be formed")
        do_eval = bool(freq) and self.equation.has_exact_solution
        route, fail = fit_route(cfg, steps, self.equation.has_exact_solution)
        if route == FUSED:
            return self._fit_fused(module, ds, steps, bs, seg, do_eval)
        if _tri_state(cfg.TRAIN.FUSED) is True and fail:
            # an explicit TRAIN.FUSED: true (not "auto") must not silently
            # take the slow segmented loop (the JAX runner's notice)
            print(f"TRAIN.FUSED: true requested but unavailable "
                  f"({fail}); using the segmented loop")
        return self._fit_loop(module, ds, steps, bs, seg, do_eval)

    def _fit_streams(self):
        """The iteration's shuffle and eval-point generators."""
        return (make_generator(self.device, self.seed, self.i, 2, 0),
                make_generator(self.device, self.seed, self.i, 2, 1))

    def _fit_loop(self, module, ds, steps, bs, seg, do_eval):
        cfg = self.cfg
        optimizer = make_optimizer(cfg.TRAIN.OPTIMIZER, module.parameters())
        n_points = int(cfg.EVAL.L2_N_POINTS)
        eval_names = eval_fn = None
        if do_eval:
            eval_names, eval_fn = make_traced_eval(
                bool(cfg.EVAL.TEST_GRAD), bool(cfg.EVAL.TEST_HESSIAN),
                batch_size=cfg.EVAL.BATCH_SIZE)
        sol = Solution.from_net(module, self.net_type, self.equation.nx)
        shuffle_gen, eval_gen = self._fit_streams()
        shuffle = cfg.DATA.SHUFFLE is not False
        rows, vals = [], []  # (epoch, global step); their metric values
        for epoch in range(int(cfg.TRAIN.N_EPOCHS)):
            txs, ys = epoch_batches(shuffle_gen, ds, bs, shuffle=shuffle)
            for s0 in range(0, steps, seg):
                s1 = min(s0 + seg, steps)
                names, m = train_steps(module, optimizer, txs[s0:s1],
                                       ys[s0:s1], self.spec)
                self.global_step += s1 - s0
                vals.append(m)
                if do_eval:
                    t, x = eval_points(eval_gen, self.equation, n_points)
                    vals.append(eval_fn(sol, self.equation, t, x))
                rows.append((epoch, self.global_step))
        # ONE readback for the iteration's train + eval metrics
        self._log_fit(rows, torch.cat(vals).cpu().tolist(), names,
                      eval_names)
        return module

    def _fused_step(self, fresh, ds, steps, bs, seg, do_eval):
        """(shape key, FusedStep, train metric names, eval names): the
        runner's fused fit for this shape, its module holding ``fresh``'s
        weights and its optimizer reset; built (and captured at its first
        call) once per shape."""
        cfg, eq = self.cfg, self.equation
        n_points = int(cfg.EVAL.L2_N_POINTS)
        key = (steps, bs, seg, do_eval, n_points, bool(cfg.EVAL.TEST_GRAD),
               ds.tx.shape[1], ds.y.shape[1])
        if self._fused is not None and self._fused[0] == key:
            step = self._fused[1]
            with torch.no_grad():
                step.module.load_state_dict(fresh.state_dict())
            reset_optimizer(step.optimizer)
            return self._fused
        module = copy.deepcopy(fresh)
        optimizer = make_optimizer(cfg.TRAIN.OPTIMIZER, module.parameters(),
                                   capturable=self.device.type == "cuda")
        reset_optimizer(optimizer)
        inputs = {"txs": ds.tx.new_empty((steps, bs, ds.tx.shape[1])),
                  "ys": ds.y.new_empty((steps, bs, ds.y.shape[1]))}
        eval_names = eval_fn = None
        if do_eval:
            eval_names, eval_fn = make_traced_eval(
                bool(cfg.EVAL.TEST_GRAD), bool(cfg.EVAL.TEST_HESSIAN))
            inputs["eval_t"] = ds.tx.new_empty((n_points, 1))
            inputs["eval_x"] = ds.tx.new_empty((steps // seg, n_points,
                                                eq.nx))
        sol = Solution.from_net(module, self.net_type, eq.nx)
        names: List[str] = []

        def body():
            """An epoch: each segment's steps, its last metrics and its
            eval, in one tensor."""
            out = []
            for j in range(steps // seg):
                sl = slice(j * seg, (j + 1) * seg)
                names[:], m = train_steps(module, optimizer,
                                          inputs["txs"][sl],
                                          inputs["ys"][sl], self.spec)
                out.append(m)
                if eval_fn is not None:
                    out.append(eval_fn(sol, eq, inputs["eval_t"],
                                       inputs["eval_x"][j]))
            return torch.cat(out)

        self._fused = (key, FusedStep(body, inputs, module, optimizer),
                       names, eval_names)
        self.fused_steps.append(self._fused[1])
        return self._fused

    def _fit_fused(self, fresh, ds, steps, bs, seg, do_eval):
        cfg = self.cfg
        _, step, names, eval_names = self._fused_step(fresh, ds, steps, bs,
                                                      seg, do_eval)
        n_points = int(cfg.EVAL.L2_N_POINTS)
        shuffle_gen, eval_gen = self._fit_streams()
        shuffle = cfg.DATA.SHUFFLE is not False
        n_epochs, nseg = int(cfg.TRAIN.N_EPOCHS), steps // seg
        ins = step.inputs
        outs = []
        for _ in range(n_epochs):
            epoch_batches(shuffle_gen, ds, bs, shuffle=shuffle,
                          out=(ins["txs"], ins["ys"]))
            for j in range(nseg if do_eval else 0):
                t, x = eval_points(eval_gen, self.equation, n_points)
                ins["eval_t"].copy_(t)
                ins["eval_x"][j].copy_(x)
            outs.append(step().clone())
        rows = [(e, self.global_step + e * steps + (j + 1) * seg)
                for e in range(n_epochs) for j in range(nseg)]
        self.global_step += n_epochs * steps
        # ONE readback for the iteration's train + eval metrics
        host = torch.stack(outs).cpu().reshape(-1).tolist()
        if cfg.EVAL.FREQ is None:  # no in-training eval: one train row
            rows, host = rows[-1:], host[-len(names):]
        self._log_fit(rows, host, names, eval_names)
        return step.module

    def _log_fit(self, rows, host, names, eval_names):
        """Log each (epoch, global step) row's train metrics ``names`` and,
        where ``eval_names``, its eval, from ``host``: the rows' values in
        order, each row's train values followed by its eval values."""
        lr = float((self.cfg.TRAIN.OPTIMIZER.kwargs or {}).get("lr", 1e-3))
        width = len(names) + len(eval_names or ())
        for j, (epoch, gs) in enumerate(rows):
            vals = host[j * width:(j + 1) * width]
            row = dict(zip(names, vals))
            self.logger.log({**row, "iter": self.i, "epoch": epoch}, gs,
                            context="train")
            if eval_names:
                em = dict(zip(eval_names, vals[len(names):]))
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
        with Timer(self.device) as t_fit:
            trained = self._train_iteration(module, ds)
        ckpt.save_params(ckpt.ckpt_path(self.exp_dir, self.i), trained)
        # the fused fit trains its own module on: the iterate is a copy
        frozen = trained if trained is module else copy.deepcopy(trained)
        self.u_current = Solution.from_net(freeze(frozen), self.net_type,
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
