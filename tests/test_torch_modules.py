"""Each ported module against its JAX counterpart, on the CPU.

Inputs are made from a seed with numpy and handed to both sides; network
weights are flax's, carried across with ``mlp_state_dict_from_flax``.
Tolerances are f32's: rtol 1e-5 / atol 1e-6 for elementwise and
single-layer functions, rtol 1e-4 / atol 1e-6 where a network's sums
(or the gradients of a loss through them) are reassociated by the other
framework.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.evaluation import metrics as jax_metrics
from deeppicarditeration_tpu.models import networks as jax_networks
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.derivatives import get_f as jax_get_f
from deeppicarditeration_tpu.training import losses as jax_losses
from deeppicarditeration_tpu.training import trainer as jax_trainer
from deeppicarditeration_tpu.data.dataset import (
    default_gen_batch as jax_default_gen_batch,
)
from deeppicarditeration_torch.data.dataset import (
    DeviceDataset,
    default_gen_batch,
    epoch_batches,
)
from deeppicarditeration_torch.device import derive_seed, resolve_device
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation import metrics
from deeppicarditeration_torch.models import networks
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.derivatives import get_f
from deeppicarditeration_torch.ops.samplers import sample_t_uniform
from deeppicarditeration_torch.training import checkpoint, losses, trainer
from deeppicarditeration_torch.training.logging import MetricLogger

torch.set_num_threads(1)

EW = dict(rtol=1e-5, atol=1e-6)  # elementwise / one layer
NET = dict(rtol=1e-4, atol=1e-6)  # through a network's reassociated sums


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a), np.asarray(b), **tol)


def _points(seed, n, nx, lead=()):
    rng = np.random.default_rng(seed)
    t = rng.uniform(size=lead + (n, 1)).astype(np.float32)
    x = (rng.normal(size=lead + (n, nx)) * 0.7).astype(np.float32)
    return t, x


def _pair_net(nx, neurons, acts, seed=0, out_dim=1):
    jmod = jax_networks.MLP(neurons=neurons, activations=acts,
                            out_dim=out_dim)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    tmod = networks.MLP(1 + nx, neurons, acts, out_dim)
    tmod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, tmod


def _cha(nx, **kw):
    args = dict(nx=nx, alpha=1.3, k=2.0, T=1.0)
    args.update(kw)
    return jax_make_equation("Cha", **args), make_equation("Cha", **args)


# ---------------------------------------------------------------------------
# equations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["g", "g_x", "exact_solution", "u_x", "u_u_x",
                                "ff"])
def test_cha_matches_jax(fn):
    nx = 7
    jeq, teq = _cha(nx)
    assert teq.k == pytest.approx(jeq.k) and teq.alpha_sqrt == jeq.alpha_sqrt
    t, x = _points(1, 33, nx, lead=(2,))
    rng = np.random.default_rng(2)
    y = rng.normal(size=t.shape).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    tt, xt = torch.from_numpy(t), torch.from_numpy(x)
    if fn in ("g", "g_x"):
        _close(getattr(teq, fn)(xt), getattr(jeq, fn)(x), EW)
    elif fn == "ff":
        _close(teq.ff(tt, xt, torch.from_numpy(y), torch.from_numpy(w)),
               jeq.ff(t, x, y, w), EW)
    elif fn == "u_u_x":
        (u1, g1), (u2, g2) = teq.u_u_x(tt, xt), jeq.u_u_x(t, x)
        _close(u1, u2, EW)
        _close(g1, g2, EW)
    else:
        _close(getattr(teq, fn)(tt, xt), getattr(jeq, fn)(t, x), EW)


def test_cha_base_g_x_autodiff_and_ff_offset():
    """The base class's autodiff g_x equals Cha's closed form, and the
    kernel's ff constant reproduces fff."""
    _, teq = _cha(5)
    x = torch.from_numpy(_points(3, 10, 5)[1])
    base = super(type(teq), teq).g_x(x)
    torch.testing.assert_close(base, teq.g_x(x), **EW)
    y = torch.linspace(-1, 1, 10)[:, None]
    z = torch.ones(10, 5)
    ref = teq.fff(None, x, y, z)
    alt = teq.alpha_sqrt * (teq.k * y - teq.ff_offset) * 5.0
    torch.testing.assert_close(ref, alt, **EW)


def test_sample_x_law_and_uniform_t():
    _, teq = _cha(3)
    g = torch.Generator().manual_seed(0)
    t = sample_t_uniform(g, 20000, 1.0, 0.01)
    assert float(t.min()) >= 0.01 and float(t.max()) <= 0.99
    assert abs(float(t.mean()) - 0.5) < 0.01
    x = teq.sample_x(g, t)
    # X_t = sqrt(a t) N(0, I) from x0 = 0
    assert abs(float((x / torch.sqrt(1.3 * t)).std()) - 1.0) < 0.02


# ---------------------------------------------------------------------------
# networks, solution, get_f
# ---------------------------------------------------------------------------

def test_elu_and_gradient_match_jax():
    z = np.linspace(-30, 5, 301).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_(True)
    y = networks._elu(zt)
    (g,) = torch.autograd.grad(y.sum(), zt)
    _close(y, jax_networks._elu(z), EW)
    _close(g, jax.grad(lambda a: jnp.sum(jax_networks._elu(a)))(z), EW)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("acts,bound", [(("ELU", "ELU"), None),
                                        (("Tanh", "ELU"), 0.3)])
def test_mlp_and_solution_grads_match_jax(acts, bound):
    nx = 5
    jmod = jax_networks.MLP(neurons=(16, 16), activations=acts, out_dim=1,
                            bound=bound)
    params = jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 1 + nx)))
    tmod = networks.MLP(1 + nx, (16, 16), acts, 1, bound=bound)
    tmod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    t, x = _points(4, 40, nx)
    tx = np.concatenate([t, x], 1)
    _close(tmod(torch.from_numpy(tx)), jmod.apply(params, tx), NET)
    js = JaxSolution.from_net(jmod, params, "Value", nx)
    ts = Solution.from_net(tmod, "Value", nx)
    (u1, g1), (u2, g2) = (ts.value_and_grad_x(torch.from_numpy(t),
                                              torch.from_numpy(x)),
                          js.value_and_grad_x(t, x))
    _close(u1, u2, NET)
    _close(g1, g2, NET)
    (u1, g1), (u2, g2) = (ts.value_and_grad_tx(torch.from_numpy(tx)),
                          js.value_and_grad_tx(tx))
    _close(u1, u2, NET)
    _close(g1, g2, NET)


def test_zero_solution_and_get_f_match_jax():
    nx = 6
    jeq, teq = _cha(nx)
    jmod, params, tmod = _pair_net(nx, (32, 32), ("ELU", "ELU"), seed=2)
    t, x = _points(5, 24, nx, lead=(3,))
    for js, ts in ((JaxSolution.zero(nx), Solution.zero(nx)),
                   (JaxSolution.from_net(jmod, params, "Value", nx),
                    Solution.from_net(tmod, "Value", nx))):
        _close(get_f(teq, ts, torch.from_numpy(t), torch.from_numpy(x)),
               jax_get_f(jeq, js, t, x), NET)
    z = Solution.zero(nx)
    u, g = z.value_and_grad_tx(torch.ones(3, 1 + nx))
    assert not u.any() and not g.any() and g.shape == (3, 1 + nx)


def test_unported_net_types_raise():
    with pytest.raises(NotImplementedError):
        Solution.zero(3, "ValueGradient")


def test_flax_conversion_layout():
    _, params, tmod = _pair_net(3, (4,), ("ELU",), seed=3)
    k = np.asarray(params["params"]["Dense_0"]["kernel"])
    assert k.shape == (4, 4)
    _close(tmod.layers[0].weight, k.T, dict(rtol=0, atol=0))
    _close(tmod.layers[1].bias, params["params"]["Dense_1"]["bias"],
           dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# losses, trainer, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("SimpleLossScaler", {}), ("DimensionLossScaler", {}),
    ("FixedLossScaler", {"fixed_weight": 0.7}), (None, {})])
def test_loss_scalers_match_jax(name, kwargs):
    rng = np.random.default_rng(6)
    v = np.float32(rng.uniform(0.1, 1.0))
    g = rng.uniform(0.01, 0.5, size=(9,)).astype(np.float32)
    tl, ti = losses.get_scaler(name, **kwargs).scale(torch.tensor(v),
                                                     torch.from_numpy(g))
    jl, ji = jax_losses.get_scaler(name, **kwargs).scale(v, g)
    _close(tl, jl, EW)
    assert sorted(ti) == sorted(ji)
    for key in ti:
        _close(ti[key], ji[key], EW)


def test_hessian_scaler_and_loss_fns_match_jax():
    rng = np.random.default_rng(7)
    v = np.float32(0.3)
    g, h = (rng.uniform(size=(5,)).astype(np.float32) for _ in range(2))
    tl, _ = losses.FixedHessianLossScaler(0.5, 2.0).scale_g_h(
        torch.tensor(v), torch.from_numpy(g), torch.from_numpy(h))
    jl, _ = jax_losses.FixedHessianLossScaler(0.5, 2.0).scale_g_h(v, g, h)
    _close(tl, jl, EW)
    r = np.linspace(-3, 3, 61).astype(np.float32)
    for cls, kw in ((None, {}), ("LossFnLinearClip", {"clip": 1.0})):
        _close(losses.make_loss_fn(cls, **kw)(torch.from_numpy(r)),
               jax_losses.make_loss_fn(cls, **kw)(r), EW)


@pytest.mark.parametrize("supervise_gradient,weight,beta", [
    (True, 1.0, 0.0), (True, 0.0, 0.0), (False, 1.0, 0.5)])
def test_compute_loss_and_param_grads_match_jax(supervise_gradient, weight,
                                                beta):
    nx = 4
    jmod, params, tmod = _pair_net(nx, (16, 16), ("ELU", "ELU"), seed=4)
    spec_kw = dict(nx=nx, supervise_gradient=supervise_gradient, beta=beta,
                   scaler_cls="FixedLossScaler",
                   scaler_kwargs=(("fixed_weight", weight),))
    jspec = jax_trainer.TrainSpec(**spec_kw)
    tspec = trainer.TrainSpec(**spec_kw)
    assert tspec.gradient_short_circuit == jspec.gradient_short_circuit
    t, x = _points(8, 32, nx)
    tx = np.concatenate([t, x], 1)
    y = np.random.default_rng(9).uniform(
        size=(32, 1 + nx)).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_trainer.compute_loss(jmod, p, tx, y, jspec),
        has_aux=True)(params)
    tl, tm = trainer.compute_loss(tmod, torch.from_numpy(tx),
                                  torch.from_numpy(y), tspec)
    tl.backward()
    _close(tl, jl, NET)
    assert sorted(tm) == sorted(jm)
    for key in tm:
        _close(tm[key], jm[key], NET)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in tmod.named_parameters():
        _close(p.grad, ref[name], dict(rtol=1e-4, atol=1e-5))


def test_make_optimizer_adam_only():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt = trainer.make_optimizer({"cls": "Adam", "kwargs": {"lr": 0.01}}, p)
    assert opt.defaults["lr"] == 0.01 and opt.defaults["eps"] == 1e-8
    with pytest.raises(NotImplementedError):
        trainer.make_optimizer({"cls": "SGD", "kwargs": {}}, p)
    with pytest.raises(NotImplementedError):
        trainer.make_optimizer({"cls": "Adam", "kwargs": {},
                                "SCHEDULER": {"cls": "StepLR"}}, p)


@pytest.mark.parametrize("which", ["value", "grad"])
def test_metrics_match_jax(which):
    rng = np.random.default_rng(10)
    exact = rng.uniform(0.1, 1.0, size=(200, 6)).astype(np.float32)
    exact[3, 2] = 0.0  # MArE skips |u| <= eps
    pred = (exact + rng.normal(size=exact.shape) * 0.01).astype(np.float32)
    if which == "value":
        pred, exact = pred[:, :1], exact[:, :1]
        tm = metrics.value_metrics(torch.from_numpy(pred),
                                   torch.from_numpy(exact))
        jm = jax_metrics.value_metrics(pred, exact)
    else:
        tm = metrics.grad_metrics(torch.from_numpy(pred),
                                  torch.from_numpy(exact))
        jm = jax_metrics.grad_metrics(pred, exact)
    assert sorted(tm) == sorted(jm)
    for key in tm:
        _close(tm[key], jm[key], dict(rtol=1e-5, atol=1e-7))


# ---------------------------------------------------------------------------
# dataset, checkpoint, logging, device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(4096, 2 ** 25, 100), (10_240_000, 2 ** 22,
                                                         100), (64, 16, 3)])
def test_default_gen_batch_matches_jax(args):
    assert default_gen_batch(*args) == jax_default_gen_batch(*args)


def test_epoch_batches_permute_and_drop_last():
    ds = DeviceDataset(tx=torch.arange(10.0)[:, None].repeat(1, 3),
                       y=torch.arange(10.0)[:, None])
    g = torch.Generator().manual_seed(0)
    tx, y = epoch_batches(g, ds, 3)
    assert tx.shape == (3, 3, 3) and y.shape == (3, 3, 1)
    idx = y.reshape(-1).long()
    assert len(set(idx.tolist())) == 9
    torch.testing.assert_close(tx[..., 0], y[..., 0])
    tx2, _ = epoch_batches(g, ds, 3, shuffle=False)
    torch.testing.assert_close(tx2.reshape(-1, 3)[:, 0], torch.arange(9.0))
    with pytest.raises(ValueError):
        epoch_batches(g, ds, 11)


def test_checkpoint_roundtrip_and_logger(tmp_path):
    _, _, tmod = _pair_net(3, (8,), ("ELU",), seed=5)
    path = checkpoint.ckpt_path(tmp_path, 2)
    assert path.name == "model_2"
    checkpoint.save_params(path, tmod)
    other = networks.MLP(4, (8,), ("ELU",), 1)
    checkpoint.load_params(path, other)
    for a, b in zip(tmod.parameters(), other.parameters()):
        assert torch.equal(a, b)
    log = MetricLogger(tmp_path, "jsonl")
    log.log({"rRMSE": torch.tensor(0.5), "bad": float("nan")}, 3, "eval")
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["rRMSE"] == 0.5 and rec["bad"] is None and rec["step"] == 3
    with pytest.raises(NotImplementedError):
        MetricLogger(tmp_path, "wandb")


def test_device_and_seed_helpers():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert derive_seed(1, 2) == derive_seed(1, 2) != derive_seed(1, 3)
    assert 0 <= derive_seed(5) < 2 ** 63
