"""The fused fit (TRAIN.FUSED) and the fused D-DBSDE epoch on the CPU.

On the card both are CUDA-graph replays (``training/fused.py``); on the CPU
the same bodies run eagerly over the same static buffers, and that is what
these tests hold against the loop:

* the Picard fit with TRAIN.FUSED auto against false, over 2 iterations of
  a tiny recipe: the same train and eval rows in metrics.jsonl and the same
  weights, to 1e-6 relative (the same arithmetic in the same order);
* the in-place Adam reset against a fresh ``torch.optim.Adam``: the same
  trajectory, exactly, with the state tensors at the same addresses;
* the D-DBSDE epoch (draws into static buffers, then the body) against a
  loop of the eager epoch over 20 epochs: the same rows and weights;
* ``fit_route`` against the JAX runner's gate
  (``deeppicarditeration_tpu/training/picard.py:_train_iteration``): the
  same path, and the same notice, in each case;
* the port's CLI against the JAX CLI on a tiny recipe with TRAIN.FUSED
  auto: the same sequence of (context, step, epoch) rows.
"""

import contextlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.cli import main as jax_cli
from deeppicarditeration_tpu.config import default_cfg as jax_default_cfg
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.training.picard import (
    PicardRunner as JaxPicardRunner,
)
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.config import default_cfg
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.training import baselines, checkpoint, trainer
from deeppicarditeration_torch.training.picard import (
    FUSED,
    LOOP,
    PicardRunner,
    fit_route,
)

torch.set_num_threads(1)

RTOL = 1e-6
NX, NEURONS = 4, (16, 16)
TINY = {
    "NAME": "fused_tiny", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": NX, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "PICARD": {"N": 2},
    "DATA": {"DATA_SIZE": 64, "CHUNK_ELEMS": 65536,
             "kwargs": {"t_always_uniform": True, "n_estimate_terminal": 16,
                        "n_estimate_integral": 16}},
    "TRAIN": {"BATCH_SIZE": 16, "N_EPOCHS": 3, "SUPERVISE_GRADIENT": True,
              "OPTIMIZER": {"kwargs": {"lr": 0.003}},
              "LOSS": {"SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 1.0}}}},
    "NETWORK": {"NEURONS": list(NEURONS), "ACTIVATIONS": ["ELU", "ELU"],
                "RELOAD": True},
    "EVAL": {"L2_N_POINTS": 50, "FREQ": 2, "TEST_GRAD": True},
}


def _cfg(*overrides, base=TINY):
    cfg = default_cfg()
    cfg.merge(base, allow_new=False)
    cfg.merge_from_list(["DEVICE", "cpu", *overrides])
    return cfg.freeze()


def _rows(exp_dir, contexts=("train", "eval", "diffusion")):
    rows = [json.loads(ln) for ln in
            (exp_dir / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "time"} for r in rows
            if r["context"] in contexts]


def _same_rows(a, b):
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    for ra, rb in zip(a, b):
        for k, v in ra.items():
            if isinstance(v, float):
                np.testing.assert_allclose(v, rb[k], rtol=RTOL, err_msg=k)
            else:
                assert v == rb[k], (k, ra, rb)


def _weights(exp_dir, i):
    mod = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1)
    checkpoint.load_params(checkpoint.ckpt_path(exp_dir, i), mod)
    return mod.state_dict()


@pytest.mark.parametrize("overrides", [
    (),  # the gradient loss, two segments of 2 steps per epoch, RELOAD
    # the value loss alone (weight 0), one segment per epoch, no shuffle
    ("TRAIN.LOSS.SCALER.kwargs.fixed_weight", "0.0", "EVAL.FREQ", "4",
     "NETWORK.RELOAD", "false", "DATA.SHUFFLE", "false"),
])
def test_fused_fit_equals_the_loop_over_two_iterations(tmp_path, overrides):
    runs = {}
    for fused in ("auto", "false"):
        runner = PicardRunner(_cfg("TRAIN.FUSED", fused, *overrides),
                              exp_root=tmp_path / fused)
        runner.run()
        runs[fused] = runner
    fused, loop = runs["auto"], runs["false"]
    assert fused._fused is not None and loop._fused is None
    rows = _rows(fused.exp_dir)
    assert len(rows) == len(_rows(loop.exp_dir)) > 0
    _same_rows(rows, _rows(loop.exp_dir))
    steps = int(fused.cfg.DATA.DATA_SIZE) // int(fused.cfg.TRAIN.BATCH_SIZE)
    nseg = steps // min(int(fused.cfg.EVAL.FREQ), steps)
    assert len(rows) == 2 * 2 * 3 * nseg  # (train, eval) x iters x epochs
    for i in (1, 2):
        wa, wb = _weights(fused.exp_dir, i), _weights(loop.exp_dir, i)
        for k in wa:
            np.testing.assert_allclose(wa[k].numpy(), wb[k].numpy(),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
    # the iterate is a frozen copy; the fused fit's own module trains on
    train_mod = fused._fused[1].module
    assert fused.u_current.module is not train_mod
    assert all(p.requires_grad for p in train_mod.parameters())
    assert not any(p.requires_grad
                   for p in fused.u_current.module.parameters())


def test_adam_reset_in_place_equals_a_fresh_adam():
    g = torch.Generator().manual_seed(0)
    mod = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1, generator=g)
    init = {k: v.clone() for k, v in mod.state_dict().items()}
    tx = torch.randn((5, 16, 1 + NX), generator=g)
    y = torch.randn((5, 16, 1 + NX), generator=g)
    spec = trainer.TrainSpec(nx=NX, supervise_gradient=True)
    opt_cfg = {"cls": "Adam", "kwargs": {"lr": 0.01}}

    def run(module, optimizer):
        _, m = trainer.train_steps(module, optimizer, tx, y, spec)
        return m, {k: v.clone() for k, v in module.state_dict().items()}

    opt = trainer.make_optimizer(opt_cfg, mod.parameters())
    run(mod, opt)  # state from a first trajectory
    ptrs = {k: v.data_ptr() for p in opt.state.values()
            for k, v in p.items()}
    mod.load_state_dict(init)
    trainer.reset_optimizer(opt)
    assert all(float(v.abs().sum()) == 0 for p in opt.state.values()
               for v in p.values())
    m_reset, w_reset = run(mod, opt)
    assert {k: v.data_ptr() for p in opt.state.values()
            for k, v in p.items()} == ptrs
    fresh = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1)
    fresh.load_state_dict(init)
    m_fresh, w_fresh = run(fresh, trainer.make_optimizer(
        opt_cfg, fresh.parameters()))
    torch.testing.assert_close(m_reset, m_fresh, rtol=0, atol=0)
    for k in w_fresh:
        torch.testing.assert_close(w_reset[k], w_fresh[k], rtol=0, atol=0)
    # a reset that creates the state equals a fresh optimizer's first step
    fresh2 = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1)
    fresh2.load_state_dict(init)
    opt2 = trainer.make_optimizer(opt_cfg, fresh2.parameters())
    trainer.reset_optimizer(opt2)
    _, w_created = run(fresh2, opt2)
    for k in w_fresh:
        torch.testing.assert_close(w_created[k], w_fresh[k], rtol=0, atol=0)


DIFFUSION = {
    "NAME": "fused_diffusion", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": NX, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "METHOD": {"cls": "Diffusion", "K": 5, "dt": 0.05},
    "PICARD": {"N": 1},
    "TRAIN": {"BATCH_SIZE": 32, "N_EPOCHS": 20, "LOSS": {"beta": 10.0}},
    "NETWORK": {"NEURONS": list(NEURONS), "ACTIVATIONS": ["ELU", "ELU"]},
    "EVAL": {"FREQ": 10, "L2_N_POINTS": 64, "TEST_GRAD": True},
}


def test_diffusion_fused_epoch_equals_the_loop_over_20_epochs(
        tmp_path, monkeypatch):
    cfg = _cfg(base=DIFFUSION)
    fused = PicardRunner(cfg, exp_root=tmp_path / "fused")
    fused.run()
    assert fused.rollout_calls == 20

    def loop_diffusion(runner):
        """The epoch as a plain loop: draws into fresh tensors, then the
        loss, backward and a step of a fresh Adam."""
        from deeppicarditeration_torch.models.factory import init_solution
        from deeppicarditeration_torch.device import make_generator
        from deeppicarditeration_torch.models.solution import Solution

        eq = runner.equation
        module = init_solution(
            runner.cfg, eq, runner.device,
            make_generator(torch.device("cpu"), runner.seed, runner.i,
                           0)).module
        tw = float(runner.cfg.TRAIN.LOSS.beta)
        optimizer = torch.optim.Adam(module.parameters(),
                                     lr=baselines.BASELINE_LR)
        sol = Solution.from_net(module, runner.net_type, eq.nx)

        def step(epoch):
            dts, ts, xs, xT = baselines.diffusion_draws(runner, epoch, tw)
            optimizer.zero_grad(set_to_none=True)
            loss = baselines.diffusion_loss(sol, eq, ts, xs, dts, xT, tw)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return baselines._baseline_loop(runner, step, module, optimizer,
                                        int(runner.cfg.TRAIN.N_EPOCHS),
                                        "diffusion")

    monkeypatch.setattr(baselines, "train_diffusion", loop_diffusion)
    loop = PicardRunner(cfg, exp_root=tmp_path / "loop")
    loop.run()
    rows = _rows(fused.exp_dir)
    assert [r["context"] for r in rows] == ["diffusion", "eval"] * 2
    ref = _rows(loop.exp_dir)
    for r in rows + ref:
        r.pop("wall_time")
    _same_rows(rows, ref)
    wa, wb = _weights(fused.exp_dir, 1), _weights(loop.exp_dir, 1)
    for k in wa:
        np.testing.assert_allclose(wa[k].numpy(), wb[k].numpy(), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


class _Picked(Exception):
    pass


GATE_CASES = {
    # name: (overrides, data size) with BATCH_SIZE 16
    "auto": ((), 64),
    "true": (("TRAIN.FUSED", "true"), 64),
    "false": (("TRAIN.FUSED", "false"), 64),
    "ragged segments auto": (("EVAL.FREQ", "3"), 64),
    "ragged segments true": (("EVAL.FREQ", "3", "TRAIN.FUSED", "true"), 64),
    "eval batch auto": (("EVAL.BATCH_SIZE", "10"), 64),
    "eval batch true": (("EVAL.BATCH_SIZE", "10", "TRAIN.FUSED", "true"),
                        64),
    "eval batch covers the points": (("EVAL.BATCH_SIZE", "50",
                                      "TRAIN.FUSED", "true"), 64),
    "freq null": (("EVAL.FREQ", "None"), 64),
    "freq null false": (("EVAL.FREQ", "None", "TRAIN.FUSED", "false"), 64),
    "freq 0 true": (("EVAL.FREQ", "0", "TRAIN.FUSED", "true"), 64),
    "freq above steps": (("EVAL.FREQ", "8"), 48),
}


def _jax_route(overrides, n, tmp_path):
    """The path the JAX runner's _train_iteration takes, and its output."""
    cfg = jax_default_cfg()
    cfg.merge(TINY)
    cfg.merge_from_list(list(overrides))
    runner = JaxPicardRunner(cfg, exp_root=tmp_path / "jax")

    def jitted(key, make):
        raise _Picked(key if isinstance(key, str) else key[0])

    runner._jitted = jitted
    runner._run_fused_freq = lambda *a, **k: "fused_freq"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            got = runner._train_iteration(jax.random.PRNGKey(0), None,
                                          types.SimpleNamespace(size=n))
        except _Picked as e:
            got = e.args[0]
    route = {"fused_freq": FUSED, "epoch_scan": FUSED,
             "multi_step": LOOP}[got]
    return route, out.getvalue()


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_fit_route_picks_the_jax_runners_path(tmp_path, case):
    overrides, n = GATE_CASES[case]
    want, want_notice = _jax_route(overrides, n, tmp_path)
    cfg = _cfg(*overrides)
    runner = PicardRunner(cfg, exp_root=tmp_path / "torch")
    runner._fit_fused = lambda *a: FUSED
    runner._fit_loop = lambda *a: LOOP
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = runner._train_iteration(None, types.SimpleNamespace(size=n))
    assert (got, out.getvalue()) == (want, want_notice)
    assert fit_route(cfg, n // 16, True)[0] == want
    # true with a failed gate takes the loop with a notice; EVAL.FREQ 0
    # has no eval, so no gate to fail
    assert ("requested but unavailable" in want_notice) == (
        case in ("ragged segments true", "eval batch true"))


CLI_YAML = """\
NAME: fused_cli
FORCE: true
EQUATION:
  cls: Cha
  kwargs: {nx: 4, alpha: 1.0, k: 1.0, T: 1.0}
PICARD:
  N: 2
DATA:
  DATA_SIZE: 64
  CHUNK_ELEMS: 65536
  kwargs: {t_always_uniform: true, n_estimate_terminal: 16,
           n_estimate_integral: 16}
TRAIN:
  BATCH_SIZE: 16
  N_EPOCHS: 2
  SUPERVISE_GRADIENT: true
  FUSED: auto
NETWORK:
  NEURONS: [16, 16]
  ACTIVATIONS: [ELU, ELU]
EVAL:
  L2_N_POINTS: 50
  FREQ: 2
  TEST_GRAD: true
"""


def test_metrics_rows_follow_the_jax_clis_sequence(tmp_path, monkeypatch):
    (tmp_path / "tiny.yaml").write_text(CLI_YAML)
    monkeypatch.setenv("DPI_NO_COMPILE_CACHE", "1")  # no cache under HOME
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_cli(["train", "../tiny.yaml"]) in (0, None)
    jax_ckpt.wait_all()
    monkeypatch.chdir(tmp_path / "torch")
    assert torch_cli(["train", "../tiny.yaml", "DEVICE", "cpu"]) == 0

    def seq(root):
        return [(r["context"], r["step"], r.get("epoch"))
                for r in _rows(root / "fused_cli", ("train", "eval"))]

    want = seq(tmp_path / "jax")
    assert len(want) == 2 * 2 * 2 * 2  # (train, eval) x iters x epochs x
    assert seq(tmp_path / "torch") == want  # segments
