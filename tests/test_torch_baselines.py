"""The D-DBSDE (Diffusion) baseline: the port against the JAX package.

* One epoch at a tiny Diffusion config through the JAX runner (N_EPOCHS 1,
  EVAL.FREQ 1). The port gets the same initial weights (flax params copied
  with ``models/convert.py``) and the epoch's draws rebuilt from the JAX key
  tree (``PRNGKey(SEED)`` -> ``fold_in(., 1)`` for the iteration; its
  ``fold_in(., 0)`` both initializes the net and, split four ways, draws
  epoch 0's t0, x0, paths and x_T). Its loss must equal the JAX run's logged
  "diffusion" loss, its parameter gradients a JAX gradient of the same loss
  (written from ``baselines.py:train_diffusion``), and its weights after one
  Adam step the JAX ``model_1``: all to rtol 1e-5 (f32 sums over the
  (K+1) B path points in another order; the loss goes through a double
  backward of the ELU net), atol 1e-6 for gradients and 1e-5 for weights
  (Adam's first step moves each weight by ~lr sign(grad)).
* The port's CLI end to end on the CPU, with DATA.TPU.PALLAS_ROLLOUT true
  and false: files, metric rows, rRMSE falling. The port takes the rollout
  kernel whatever the flag says (its plain version on CPU tensors).
* PINN is ported (tests/test_torch_pinn.py): the runner dispatches it.
  FullyNonlinearSolver (DBDP) is ported (tests/test_torch_fn.py) and
  raises on the Burgers equation, which has no ``ffh``.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.config import default_cfg as jax_default_cfg
from deeppicarditeration_tpu.models.factory import (
    init_solution as jax_init_solution,
)
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.rollout import (
    brownian_paths as jax_brownian_paths,
)
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.training.picard import (
    PicardRunner as JaxPicardRunner,
)
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.config import default_cfg, load_cfg
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.ops.rollout import brownian_paths
from deeppicarditeration_torch.training import baselines, checkpoint
from deeppicarditeration_torch.training.picard import PicardRunner

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

NX, K, DT, BS, BETA, NEURONS = 4, 5, 0.05, 32, 10.0, (16, 16)
TINY = {
    "NAME": "diff_tiny", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": NX, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "METHOD": {"cls": "Diffusion", "K": K, "dt": DT},
    "PICARD": {"N": 1},
    "TRAIN": {"BATCH_SIZE": BS, "N_EPOCHS": 1, "LOSS": {"beta": BETA}},
    "NETWORK": {"NEURONS": list(NEURONS), "ACTIVATIONS": ["ELU", "ELU"]},
    "EVAL": {"FREQ": 1, "L2_N_POINTS": 64, "TEST_GRAD": False},
}


def _jax_cfg():
    cfg = jax_default_cfg()
    cfg.merge(TINY)
    return cfg


def _jax_epoch0_draws(cfg, jeq):
    """Epoch 0's inputs and the initial params, from the JAX key tree."""
    key_iter = jax.random.fold_in(jax.random.PRNGKey(int(cfg.SEED)), 1)
    params = jax_init_solution(jax.random.fold_in(key_iter, 0), cfg,
                               jeq).params
    kt, kx, kw, kT = jax.random.split(jax.random.fold_in(key_iter, 0), 4)
    t0 = jeq.T * jax.random.uniform(kt, (BS, 1))
    x0 = jeq.sample_x(kx, t0)
    dts = jnp.where(t0 + K * DT <= jeq.T, DT, (jeq.T - t0) / K)
    xi = jax.random.normal(kw, (K, BS, NX), jnp.float32)
    xT = jeq.sample_x(kT, jnp.full((BS, 1), jeq.T))
    return params, kw, t0, x0, dts, xi, xT


def _jax_loss(module, params, jeq, ts, xs, dts, xT):
    """train_diffusion's loss_fn (deeppicarditeration_tpu/training/
    baselines.py:170-192) on given paths."""
    sol = JaxSolution.from_net(module, params, "Value", NX)
    v, v_grad = sol.value_and_grad_x(ts, xs)
    fs = jeq.ff(ts, xs, v, v_grad)
    dxs = jnp.diff(xs, axis=0)
    v_pred = (v[0] - jnp.sum(fs[:-1] * dts[None], axis=0)
              + jnp.sum(jnp.sum(v_grad[:-1] * dxs, axis=-1, keepdims=True),
                        axis=0))
    loss = jnp.mean((v[-1] - v_pred) ** 2)
    T = jnp.full((BS, 1), jeq.T)
    uT = sol.value(jnp.concatenate([T, xT], axis=-1))
    return loss + BETA * jnp.mean((uT - jeq.g(xT)) ** 2)


def test_diffusion_loss_gradients_and_one_adam_step_match_jax(tmp_path):
    cfg = _jax_cfg()
    runner = JaxPicardRunner(cfg, exp_root=tmp_path / "jax")
    runner.run_one()
    jax_ckpt.wait_all()
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    (logged,) = [r["loss"] for r in rows if r["context"] == "diffusion"]
    jeq = runner.equation
    params, kw, t0, x0, dts, xi, xT = _jax_epoch0_draws(cfg, jeq)
    # the paths the JAX run drew: its closed form on the same key
    jts, jxs, jxi = jax_brownian_paths(kw, jeq, t0, x0, dts, K)
    np.testing.assert_array_equal(np.asarray(jxi), np.asarray(xi))
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(runner.module, p, jeq, jts, jxs, dts, xT))(params)
    np.testing.assert_allclose(float(jloss), logged, rtol=1e-5)
    after = jax_ckpt.load_params(jax_ckpt.ckpt_path(runner.exp_dir, 1),
                                 params)

    def state(tree):
        return mlp_state_dict_from_flax(jax.tree_util.tree_map(np.array,
                                                               tree))

    teq = make_equation("Cha", nx=NX, alpha=1.0, k=1.0, T=1.0)
    mod = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1)
    mod.load_state_dict(state(params))
    sol = Solution.from_net(mod, "Value", NX)

    def t(a):
        return torch.from_numpy(np.array(a))

    ts, xs, _ = brownian_paths(None, teq, t(t0), t(x0), t(dts), K, xi=t(xi))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6,
                               atol=1e-6)
    loss = baselines.diffusion_loss(sol, teq, ts, xs, t(dts), t(xT), BETA)
    np.testing.assert_allclose(float(loss.detach()), logged, rtol=1e-5)
    opt = torch.optim.Adam(mod.parameters(), lr=baselines.BASELINE_LR)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in mod.named_parameters()}
    for name, g in state(jgrads).items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6)
    opt.step()
    for name, p in state(after).items():
        np.testing.assert_allclose(mod.state_dict()[name].numpy(),
                                   p.numpy(), rtol=1e-5, atol=1e-5)
        assert not np.allclose(p.numpy(), state(params)[name].numpy())


def test_rollout_dts_match_the_tail_shrunk_steps():
    t0 = torch.tensor([[0.0], [0.5], [0.9], [0.95]])
    eq = make_equation("Cha", nx=2, alpha=1.0, k=1.0, T=1.0)
    dts = baselines.rollout_dts(eq, t0, 0.05, 4)  # K dt = 0.2
    jd = jnp.where(jnp.asarray(t0.numpy()) + 4 * 0.05 <= 1.0, 0.05,
                   (1.0 - jnp.asarray(t0.numpy())) / 4)
    np.testing.assert_array_equal(dts.numpy(), np.asarray(jd))
    assert float(dts[0]) == np.float32(0.05) and float(dts[3]) < 0.05


def test_value_and_grad_x_keeps_the_graph_on_request():
    """Detached by default (the estimators); with create_graph=True a loss
    on u and du/dx reaches the parameters, as JAX's traced vjp does."""
    rng = np.random.default_rng(0)
    mod = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1,
              generator=torch.Generator().manual_seed(0))
    sol = Solution.from_net(mod, "Value", NX)
    t = torch.from_numpy(rng.uniform(size=(3, 6, 1)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 6, NX)).astype(np.float32))
    u, g = sol.value_and_grad_x(t, x)
    assert not u.requires_grad and not g.requires_grad
    u2, g2 = sol.value_and_grad_x(t, x, create_graph=True)
    assert u2.requires_grad and g2.requires_grad
    assert torch.equal(u, u2.detach()) and torch.equal(g, g2.detach())
    (g2.sum() + u2.sum()).backward()
    assert all(p.grad is not None for p in mod.parameters())
    # the same values as the JAX vjp with the copied weights
    from deeppicarditeration_tpu.models.networks import MLP as JaxMLP

    jmod = JaxMLP(neurons=NEURONS, activations=("ELU", "ELU"), out_dim=1)
    jp = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1 + NX)))
    mod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jp)))
    ju, jg = JaxSolution.from_net(jmod, jp, "Value", NX).value_and_grad_x(
        jnp.asarray(t.numpy()), jnp.asarray(x.numpy()))
    u3, g3 = sol.value_and_grad_x(t, x, create_graph=True)
    np.testing.assert_allclose(u3.detach().numpy(), np.asarray(ju),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g3.detach().numpy(), np.asarray(jg),
                               rtol=1e-5, atol=1e-6)


def test_periodic_state_round_trips(tmp_path):
    mod = MLP(3, (8,), ("ELU",), 1,
              generator=torch.Generator().manual_seed(1))
    opt = torch.optim.Adam(mod.parameters(), lr=1e-3)
    mod(torch.ones(4, 3)).sum().backward()
    opt.step()
    checkpoint.save_state(tmp_path / "s", mod, opt)
    assert not (tmp_path / "s.tmp").exists()
    mod2 = MLP(3, (8,), ("ELU",), 1)
    opt2 = torch.optim.Adam(mod2.parameters(), lr=1e-3)
    checkpoint.load_state(tmp_path / "s", mod2, opt2)
    for a, b in zip(mod.parameters(), mod2.parameters()):
        assert torch.equal(a, b)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert all(torch.equal(s1[k]["exp_avg_sq"], s2[k]["exp_avg_sq"])
               for k in s1)


TINY_YAML = """\
NAME: diff_e2e
FORCE: true
EQUATION:
  cls: Cha
  kwargs: {nx: 4, alpha: 1.0, k: 1.0, T: 1.0}
METHOD: {cls: Diffusion, K: 5, dt: 0.05}
PICARD: {N: 1}
TRAIN:
  BATCH_SIZE: 64
  N_EPOCHS: 150
  LOSS: {beta: 10.0}
NETWORK:
  NEURONS: [16, 16]
  ACTIVATIONS: [ELU, ELU]
EVAL: {FREQ: 50, L2_N_POINTS: 200, TEST_GRAD: true}
"""


@pytest.mark.parametrize("pallas_rollout", ["false", "true"])
def test_cli_diffusion_end_to_end_on_cpu(tmp_path, monkeypatch,
                                         pallas_rollout):
    (tmp_path / "d.yaml").write_text(TINY_YAML)
    monkeypatch.chdir(tmp_path)
    n0 = kernels.ROLLOUT.launches
    assert torch_cli(["train", "d.yaml", "DEVICE", "cpu",
                      "DATA.TPU.PALLAS_ROLLOUT", pallas_rollout]) == 0
    assert kernels.ROLLOUT.launches == n0  # CPU tensors: the plain version
    exp = tmp_path / "diff_e2e"
    for name in ("config.yaml", "metrics.jsonl", "model_1",
                 "baseline_1_state", "baseline_1_meta.json"):
        assert (exp / name).exists(), name
    assert json.loads((exp / "baseline_1_meta.json").read_text())[
        "epoch"] == 150
    rows = [json.loads(ln) for ln in
            (exp / "metrics.jsonl").read_text().splitlines()]
    diff = [r for r in rows if r["context"] == "diffusion"]
    evals = [r for r in rows if r["context"] == "eval"]
    assert [r["epoch"] for r in diff] == [49, 99, 149]
    assert [r["step"] for r in evals] == [49, 99, 149]
    assert all(np.isfinite(r["loss"]) and r["wall_time"] > 0 for r in diff)
    assert {"rRMSE", "rRMSEg", "wall_time"} <= evals[0].keys()
    assert evals[-1]["rRMSE"] < evals[0]["rRMSE"] < 1.0
    # model_1 holds the trained weights alone; the state adds Adam's
    mod = MLP(5, (16, 16), ("ELU", "ELU"), 1)
    checkpoint.load_params(exp / "model_1", mod)
    opt = torch.optim.Adam(mod.parameters())
    checkpoint.load_state(exp / "baseline_1_state", mod, opt)
    assert opt.state_dict()["state"][0]["step"] == 150


def test_cli_diffusion_runs_the_same_with_and_without_the_rollout_flag_on_cpu(
        tmp_path):
    """The baseline takes the rollout kernel whatever the flag says; on the
    CPU its plain version draws from a generator seeded like the closed
    form's, so the two settings train the same weights."""
    weights = []
    for flag in (False, True):
        cfg = default_cfg()
        cfg.merge({**TINY, "NAME": f"flag_{flag}", "DEVICE": "cpu",
                   "TRAIN": {"BATCH_SIZE": BS, "N_EPOCHS": 3,
                             "LOSS": {"beta": BETA}},
                   "DATA": {"TPU": {"PALLAS_ROLLOUT": flag}}},
                  allow_new=False)
        runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
        runner.run()
        assert runner.rollout_calls == 3
        weights.append([p.clone() for p in
                        runner.u_current.module.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*weights))


@pytest.mark.parametrize("method", ["PINN", "FullyNonlinearSolver"])
def test_unported_baselines_raise(tmp_path, method, monkeypatch):
    """Both baselines are ported now. The runner rejects DBDP before any
    work where the equation has no ffh, which its loss reads (Cha defines
    none); PINN on the Burgers recipe constructs and ``run_baseline``
    dispatches it to ``train_pinn``."""
    cfg = load_cfg(ROOT / "configs/burgers/diffusion_100d_T1.0_beta10.0.yaml",
                   ["DEVICE", "cpu", "METHOD.cls", method])
    if method == "FullyNonlinearSolver":
        with pytest.raises(NotImplementedError, match="ffh"):
            PicardRunner(cfg, exp_root=tmp_path)
        return
    runner = PicardRunner(cfg, exp_root=tmp_path)
    monkeypatch.setattr(baselines, "train_pinn", lambda r: ("pinn", r))
    assert baselines.run_baseline(runner) == ("pinn", runner)
