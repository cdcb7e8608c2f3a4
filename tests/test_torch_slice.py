"""The slice as a whole: targets -> clip -> Adam steps -> eval, JAX vs port.

Deterministic: fixed (t, x), noise and initial weights (made with numpy /
flax and handed to both sides). Targets come from the JAX Pallas merged
kernel (interpret mode, external noise) and the port's plain version; the
fit is a few Adam steps on a fixed batch order (JAX ``compute_loss`` +
``optax.adam`` vs the port's ``train_step`` + ``torch.optim.Adam``); the
final weights and the eval metrics on fixed points are compared at
rtol 1e-4 / atol 1e-5 (f32 sums reassociated through a net and 4 Adam
steps, whose first updates are ~lr * sign(grad)).

Then an end-to-end CPU run of the port's CLI on the tiny recipe of
tests/test_picard_e2e.py must reach the same accuracy the JAX test asks for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.evaluation.metrics import (
    grad_metrics as jax_grad_metrics,
    value_metrics as jax_value_metrics,
)
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
)
from deeppicarditeration_tpu.training import trainer as jax_trainer
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import eval_solution
from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.kernels import generate_with_gradients_plain
from deeppicarditeration_torch.training import checkpoint, trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def test_slice_targets_fit_and_eval_match_jax():
    nx, b, m, bs, n_steps, bound, lr = 4, 32, 32, 8, 4, 0.6, 1e-3
    neurons = (16, 16)
    rng = np.random.default_rng(0)
    t = rng.uniform(0.0, 0.95, size=(b, 1)).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    tx = np.concatenate([t, x], 1)
    u01 = rng.uniform(size=(b, m, 1)).astype(np.float32)
    nt = rng.normal(size=(b, m, nx)).astype(np.float32)
    ni = rng.normal(size=(b, m, nx)).astype(np.float32)
    jeq = jax_make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    teq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)

    # frozen iterate (a random net) and the fresh net to fit, both sides
    jmod = JaxMLP(neurons=neurons, activations=("ELU", "ELU"), out_dim=1)
    p_frozen = jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 1 + nx)))
    p_fit = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 1 + nx)))

    def torch_net(params):
        mod = MLP(1 + nx, neurons, ("ELU", "ELU"), 1)
        mod.load_state_dict(mlp_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        return mod

    # 1. targets, clipped at the sample bound
    y_j = jnp.clip(generate_with_gradients_pallas(
        0, jeq, JaxSolution.from_net(jmod, p_frozen, "Value", nx),
        jnp.asarray(tx), m, tile_b=8, mblk=8, u01=jnp.asarray(u01),
        noise_t=jnp.asarray(nt), noise_i=jnp.asarray(ni)), -bound, bound)
    y_t = torch.clamp(generate_with_gradients_plain(
        0, teq, Solution.from_net(torch_net(p_frozen), "Value", nx),
        torch.from_numpy(tx), m, torch.from_numpy(u01), torch.from_numpy(nt),
        torch.from_numpy(ni)), -bound, bound)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=5e-5,
                               atol=5e-5)
    assert float((y_t.abs() >= bound).float().mean()) > 0  # the clip bit
    y = np.asarray(y_j)

    # 2. Adam steps on a fixed batch order
    spec_kw = dict(nx=nx, supervise_gradient=True,
                   scaler_cls="FixedLossScaler",
                   scaler_kwargs=(("fixed_weight", 1.0),))
    jspec, tspec = jax_trainer.TrainSpec(**spec_kw), trainer.TrainSpec(**spec_kw)
    opt = optax.adam(lr)
    state, params = opt.init(p_fit), p_fit
    tmod = torch_net(p_fit)
    topt = trainer.make_optimizer({"cls": "Adam", "kwargs": {"lr": lr}},
                                  tmod.parameters())
    order = np.random.default_rng(3).permutation(b)
    loss_grad = jax.jit(jax.grad(lambda p, a, c: jax_trainer.compute_loss(
        jmod, p, a, c, jspec)[0]))
    for s in range(n_steps):
        idx = order[s * bs:(s + 1) * bs]
        grads = loss_grad(params, tx[idx], y[idx])
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        trainer.train_step(tmod, topt, torch.from_numpy(tx[idx]),
                           torch.from_numpy(y[idx]), tspec)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    for name, p in tmod.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), **TOL)
        # the steps moved every weight tensor
        assert not np.allclose(ref[name].numpy(), mlp_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, p_fit))[name].numpy())

    # 3. eval metrics on fixed points
    te = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    xe = (rng.normal(size=(64, nx)) * np.sqrt(te)).astype(np.float32)
    ju, jg = JaxSolution.from_net(jmod, params, "Value", nx).value_and_grad_tx(
        np.concatenate([te, xe], 1))
    jm = {**jax_value_metrics(ju, jeq.exact_solution(te, xe)),
          **jax_grad_metrics(jg[:, 1:], jeq.u_x(te, xe))}
    tu, tg = Solution.from_net(tmod, "Value", nx).value_and_grad_tx(
        torch.from_numpy(np.concatenate([te, xe], 1)))
    tte, txe = torch.from_numpy(te), torch.from_numpy(xe)
    tm = {**value_metrics(tu, teq.exact_solution(tte, txe)),
          **grad_metrics(tg[:, 1:], teq.u_x(tte, txe))}
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)


TINY_YAML = """\
NAME: tiny_e2e
FORCE: true
EQUATION:
  cls: Cha
  kwargs: {nx: 4, alpha: 1.0, k: 1.0, T: 1.0}
PICARD:
  N: 3
DATA:
  DATA_SIZE: 512
  CHUNK_ELEMS: 65536
  kwargs: {t_always_uniform: true, n_estimate_terminal: 512,
           n_estimate_integral: 512}
TRAIN:
  BATCH_SIZE: 128
  N_EPOCHS: 30
  SUPERVISE_GRADIENT: true
  OPTIMIZER: {kwargs: {lr: 0.003}}
  LOSS: {SCALER: {cls: FixedLossScaler, kwargs: {fixed_weight: 1.0}}}
NETWORK:
  NEURONS: [32, 32]
  ACTIVATIONS: [ELU, ELU]
  RELOAD: true
EVAL:
  L2_N_POINTS: 500
  FREQ: null
  TEST_GRAD: true
"""


def test_cli_e2e_tiny_recipe_on_cpu(tmp_path, monkeypatch):
    """The tiny recipe of tests/test_picard_e2e.py through the port's CLI
    (DEVICE cpu): rRMSE < 0.08 and improving iterate over iterate."""
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    monkeypatch.chdir(tmp_path)
    assert torch_cli(["train", "tiny.yaml", "DEVICE", "cpu"]) == 0
    exp = tmp_path / "tiny_e2e"
    assert (exp / "config.yaml").exists() and (exp / "metrics.jsonl").exists()
    eq = make_equation("Cha", nx=4, alpha=1.0, k=1.0, T=1.0)

    def metrics_of(i):
        mod = MLP(5, (32, 32), ("ELU", "ELU"), 1)
        checkpoint.load_params(checkpoint.ckpt_path(exp, i), mod)
        return eval_solution(torch.Generator().manual_seed(99),
                             Solution.from_net(mod, "Value", 4), eq, 1000,
                             test_grad=True)

    first, final = metrics_of(1), metrics_of(3)
    assert final["rRMSE"] < 0.08, final
    assert final["rRMSEg"] < 0.6, final
    assert final["rRMSE"] < first["rRMSE"]


def test_cli_rejects_missing_cuda_without_cpu_request(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: DEVICE cuda is valid here")
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli(["train", "tiny.yaml"])
