"""The PINN-HTE baseline and the second-order operators under it: the port
against the JAX package, on the CPU.

The JAX package's own residual (``training/baselines.py:_pinn_residual``)
runs on a key; the port gets the draws that key makes (t, x and x_T from
its four-way split, the Rademacher probes from ``split(kr, num_v)``, the
SDGD indices from a permutation per point) and the same weights. Residual,
loss, every parameter's gradient and the weights after one Adam(1e-3) step
agree to 1e-5 of each tensor's largest magnitude (f32 sums in another
order through a third-order backward of the net); Burgers with Hutchinson
and the exact Laplacian (the per-index fallback: 4 v < the narrowest
layer), HJB with the terminal-enforcing PISGradNet, FN with SDGD (the
chain's fast path and the fallback) and with the full Hessian. A two-epoch
run of the port's runner on the JAX run's draws logs the JAX run's losses
(1e-5 relative). The operators with ``create_graph`` back-propagate to the
parameters what JAX's gradient of the same operator gives (1e-5 of the
largest magnitude).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppicarditeration_tpu.config import default_cfg as jax_default_cfg
from deeppicarditeration_tpu.equations import (
    make_equation as jax_make_equation,
)
from deeppicarditeration_tpu.models.factory import (
    init_solution as jax_init_solution,
)
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.networks import (
    PISGradNet as JaxPISGradNet,
)
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops import derivatives as jd
from deeppicarditeration_tpu.training import baselines as jax_baselines
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.training.picard import (
    PicardRunner as JaxPicardRunner,
)
from deeppicarditeration_tpu.utils.static_fn import StaticFn
from deeppicarditeration_torch.config import default_cfg
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.convert import (
    mlp_state_dict_from_flax,
    pisgradnet_state_dict_from_flax,
)
from deeppicarditeration_torch.models.networks import MLP, PISGradNet
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import derivatives as td
from deeppicarditeration_torch.training import baselines
from deeppicarditeration_torch.training.picard import PicardRunner

torch.set_num_threads(1)

REL = 1e-5  # of each tensor's largest magnitude
BS = 32


def T_(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(out - ref).max()) <= rel * scale, (
        float(np.abs(out - ref).max()), scale)


def _jitter(params, seed, jitter):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.normal(size=a.shape).astype(
            np.float32), params)


def _mlp(nx, neurons, seed=0, jitter=0.2):
    jm = JaxMLP(neurons=tuple(neurons), activations=("ELU",) * len(neurons),
                out_dim=1)
    p = _jitter(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx))),
                seed, jitter)
    tm = MLP(1 + nx, tuple(neurons), ("ELU",) * len(neurons), 1)
    tm.load_state_dict(mlp_state_dict_from_flax(p))
    return jm, p, tm, mlp_state_dict_from_flax


def _pis(jeq, teq, nx, hidden, seed=1, jitter=0.1):
    jm = JaxPISGradNet(hidden_shapes=hidden, dim=nx,
                       g0=StaticFn(jeq.g, ("g", id(jeq))), T=jeq.T)
    p = _jitter(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx))),
                seed, jitter)
    tm = PISGradNet(nx, hidden, (teq.gmm_means, teq.gmm_vars,
                                 teq.gmm_log_weights), T=teq.T)
    tm.load_state_dict(pisgradnet_state_dict_from_flax(p))
    return jm, p, tm, pisgradnet_state_dict_from_flax


# name -> (equation, kwargs, net, num_v, sdgd_v, terminal weight)
CASES = {
    "burgers hutchinson": ("Cha", {"nx": 4, "alpha": 1.0, "k": 1.0},
                           ("mlp", (16, 16)), 3, None, 10.0),
    "burgers exact": ("Cha", {"nx": 3, "alpha": 1.0, "k": 1.0},
                      ("mlp", (16, 16)), 0, None, 10.0),
    "hjb pisgradnet": ("OUProcessEquation",
                       {"nx": 4, "num_components": 3, "seed": 5},
                       ("pis", (8, 8)), 3, None, 0.0),
    "fn sdgd": ("GBMEquationComplexExact", {"nx": 4, "seed": 3},
                ("mlp", (16, 16)), 0, 2, 10.0),
    "fn sdgd wide": ("GBMEquationComplexExact", {"nx": 4, "seed": 3},
                     ("mlp", (12, 16)), 0, 3, 10.0),
    "fn full hessian": ("GBMEquationComplexExact", {"nx": 4, "seed": 3},
                        ("mlp", (16, 16)), 0, None, 10.0),
}


def _case(name):
    cls, kw, (kind, neurons), num_v, sdgd_v, w = CASES[name]
    jeq = jax_make_equation(cls, **kw)
    teq = make_equation(cls, **kw)
    nx = kw["nx"]
    if kind == "mlp":
        jm, p, tm, conv = _mlp(nx, neurons)
    else:
        jm, p, tm, conv = _pis(jeq, teq, nx, neurons)
    return jeq, teq, jm, p, tm, conv, num_v, sdgd_v, w


def _jax_draws(jeq, key, bs, num_v, sdgd_v, w):
    """train_pinn's loss_fn draws for ``key`` (its four-way split), and the
    probes or indices ``_pinn_residual`` draws from kr."""
    kt, kx, kr, kT = jax.random.split(key, 4)
    t = jeq.T * jax.random.uniform(kt, (bs, 1))
    x = jeq.sample_x(kx, t)
    probes = idx = None
    if jeq.has_hessian_term:
        if sdgd_v:
            idx = jax.vmap(lambda kk: jax.random.permutation(kk, jeq.nx)[
                :sdgd_v])(jax.random.split(kr, bs)).astype(jnp.int32)
    elif num_v > 0:
        probes = jax.vmap(lambda k: jax.random.rademacher(
            k, x.shape, dtype=jnp.int32).astype(x.dtype))(
            jax.random.split(kr, num_v))
    xT = jeq.sample_x(kT, jnp.full((bs, 1), jeq.T)) if w > 0 else None
    return t, x, kr, xT, idx, probes


def _jax_loss(jeq, jm, params, t, x, kr, xT, w, num_v, sdgd_v):
    sol = JaxSolution.from_net(jm, params, "Value", jeq.nx)
    res = jax_baselines._pinn_residual(jeq, sol, t, x, kr, sdgd_v, num_v)
    loss = jnp.mean(res ** 2)
    if w > 0:
        T = jnp.full((t.shape[0], 1), jeq.T)
        uT = sol.value(jnp.concatenate([T, xT], axis=-1))
        loss = loss + w * jnp.mean((uT - jeq.g(xT)) ** 2)
    return loss, res


def _port(teq, tm, t, x, xT, idx, probes, w):
    sol = Solution.from_net(tm, "Value", teq.nx)
    args = (None if idx is None else T_(idx).long(),
            None if probes is None else T_(probes))
    res = baselines.pinn_residual(teq, sol, T_(t), T_(x), *args)
    loss = baselines.pinn_loss(sol, teq, T_(t), T_(x),
                               None if xT is None else T_(xT), w, *args)
    return loss, res


@pytest.mark.parametrize("name", list(CASES))
def test_pinn_residual_loss_gradients_and_adam_step_match_jax(name):
    jeq, teq, jm, p, tm, conv, num_v, sdgd_v, w = _case(name)
    t, x, kr, xT, idx, probes = _jax_draws(jeq, jax.random.PRNGKey(7), BS,
                                           num_v, sdgd_v, w)
    (jloss, jres), jgrads = jax.value_and_grad(
        lambda q: _jax_loss(jeq, jm, q, t, x, kr, xT, w, num_v, sdgd_v),
        has_aux=True)(p)
    loss, res = _port(teq, tm, t, x, xT, idx, probes, w)
    _close(res.detach().numpy(), jres)
    _close(float(loss.detach()), float(jloss))
    opt = torch.optim.Adam(tm.parameters(), lr=baselines.BASELINE_LR)
    opt.zero_grad()
    loss.backward()
    want = conv(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, q in tm.named_parameters():
        _close(q.grad.numpy(), want[n].numpy())
    jopt = optax.adam(1e-3)
    upd, _ = jopt.update(jgrads, jopt.init(p), p)
    after = conv(jax.tree_util.tree_map(np.asarray,
                                        optax.apply_updates(p, upd)))
    opt.step()
    for n, q in tm.state_dict().items():
        _close(q.numpy(), after[n].numpy())


@pytest.mark.parametrize("op", ["hutchinson", "exact", "exact narrow",
                                "diag entries", "full hessian"])
def test_second_order_operators_keep_the_graph_to_the_parameters(op):
    """Each operator with ``create_graph``: its value is the default's (the
    estimators' numbers do not move), and the gradient of its sum to the
    parameters is JAX's."""
    nx = 3 if op == "exact narrow" else 4
    jm, p, tm, conv = _mlp(nx, (16, 16), seed=4)
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 1, (BS, 1)).astype(np.float32)
    x = rng.normal(size=(BS, nx)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    probes = np.asarray(jax.vmap(lambda k: jax.random.rademacher(
        k, x.shape, dtype=jnp.int32).astype(jnp.float32))(
        jax.random.split(key, 3)))
    idx = rng.integers(0, nx, (BS, 2)).astype(np.int32)

    def jax_op(q):
        s = JaxSolution.from_net(jm, q, "Value", nx)
        if op == "hutchinson":
            return jd.hutchinson_laplacian(key, s, t, x, 3)
        if op.startswith("exact"):
            return jd.exact_laplacian(s, t, x)
        if op == "diag entries":
            return jd.diag_hessian_entries(s, t, x, jnp.asarray(idx))
        return jd.full_hessian(s, t, x)

    def port_op(create_graph):
        s = Solution.from_net(tm, "Value", nx)
        if op == "hutchinson":
            return td.hutchinson_laplacian(None, s, T_(t), T_(x), 3,
                                           probes=T_(probes),
                                           create_graph=create_graph)
        if op.startswith("exact"):
            return td.exact_laplacian(s, T_(t), T_(x),
                                      create_graph=create_graph)
        if op == "diag entries":
            return td.diag_hessian_entries(s, T_(t), T_(x), T_(idx),
                                           create_graph=create_graph)
        return td.full_hessian(s, T_(t), T_(x), create_graph=create_graph)

    value, jgrads = jax.value_and_grad(lambda q: jnp.sum(jax_op(q)))(p)
    frozen = port_op(False)
    assert not frozen.requires_grad
    out = port_op(True)
    _close(out.detach().numpy(), frozen.numpy())
    _close(out.detach().numpy(), jax_op(p))
    out.sum().backward()
    want = conv(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, q in tm.named_parameters():
        # the head's bias has no second derivative: no graph reaches it
        g = q.grad if q.grad is not None else torch.zeros_like(q)
        _close(g.numpy(), want[n].numpy())


def test_elu_equals_the_where_form_to_the_third_derivative():
    """The port's ELU (relu and exp, no ``where``) against the where form
    it replaced, which the CUDA kernels follow: values, three reverse
    derivatives and the nested forward-mode pair the second-order chain
    takes, bit for bit, exact zeros included (a pre-activation is exactly 0
    now and then at the card's sizes; the derivative there is 1)."""
    from deeppicarditeration_torch.models.networks import _elu

    def where_form(z):
        safe = torch.where(z > 0, torch.zeros_like(z), z)
        return torch.where(z > 0, z, torch.exp(safe) - 1.0)

    x = torch.randn((64, 32), generator=torch.Generator().manual_seed(0)) * 3
    x[0, :6] = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 88.0, -104.0])
    x[1] = 0.0
    assert torch.equal(_elu(x), where_form(x))
    outs = []
    for f in (_elu, where_form):
        xx = x.clone().requires_grad_(True)
        y, ds = f(xx), []
        for k in range(3):
            (y,) = torch.autograd.grad(y.sum(), xx, create_graph=k < 2)
            ds.append(y)
        outs.append(ds + list(td._elementwise_d12(f, x)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert bool((outs[0][0][1] == 1.0).all())


def test_sdgd_without_replacement_draws_distinct_uniform_indices():
    g = torch.Generator().manual_seed(0)
    idx = baselines.sdgd_without_replacement(g, 20000, 7, 3, "cpu")
    assert idx.shape == (20000, 3)
    s, _ = torch.sort(idx, dim=-1)
    assert bool((s[:, 1:] != s[:, :-1]).all())
    counts = torch.bincount(idx.reshape(-1), minlength=7).double()
    # each index with probability 3/7 per row: binomial, 5 sigma
    p = 3 / 7
    sd = (20000 * p * (1 - p)) ** 0.5
    assert float((counts - 20000 * p).abs().max()) < 5 * sd
    first = torch.bincount(idx[:, 0], minlength=7).double()
    sd1 = (20000 / 7 * (1 - 1 / 7)) ** 0.5
    assert float((first - 20000 / 7).abs().max()) < 5 * sd1


# ---------------------------------------------------------------------------
# two epochs of the runner on the JAX run's draws
# ---------------------------------------------------------------------------

TINY = {
    "burgers": {
        "EQUATION": {"cls": "Cha",
                     "kwargs": {"nx": 4, "alpha": 1.0, "k": 1.0, "T": 1.0}},
        "METHOD": {"cls": "PINN", "num_v_samples": 3},
        "TRAIN": {"BATCH_SIZE": BS, "N_EPOCHS": 2, "LOSS": {"beta": 10.0}},
        "NETWORK": {"NEURONS": [16, 16], "ACTIVATIONS": ["ELU", "ELU"]},
    },
    "fn": {
        "EQUATION": {"cls": "GBMEquationComplexExact",
                     "kwargs": {"nx": 4, "seed": 3}},
        "METHOD": {"cls": "PINN"},
        "DATA": {"HESSIAN_APPROXIMATION": {"method": "SDGD",
                                           "kwargs": {"v": 2}}},
        "TRAIN": {"BATCH_SIZE": BS, "N_EPOCHS": 2, "LOSS": {"beta": 10.0}},
        "NETWORK": {"NEURONS": [16, 16], "ACTIVATIONS": ["ELU", "ELU"]},
    },
}
COMMON = {"FORCE": True, "PICARD": {"N": 1},
          "EVAL": {"FREQ": 1, "L2_N_POINTS": 64}}


def _rows(exp_dir, context):
    return [json.loads(ln) for ln in
            (exp_dir / "metrics.jsonl").read_text().splitlines()
            if json.loads(ln)["context"] == context]


@pytest.mark.parametrize("family", list(TINY))
def test_two_epochs_on_the_jax_draws_log_the_jax_losses(tmp_path, family,
                                                        monkeypatch):
    recipe = {**COMMON, **TINY[family], "NAME": f"pinn_{family}"}
    jcfg = jax_default_cfg()
    jcfg.merge(recipe)
    jrun = JaxPicardRunner(jcfg, exp_root=tmp_path / "jax")
    jrun.run_one()
    jax_ckpt.wait_all()
    jlosses = [r["loss"] for r in _rows(jrun.exp_dir, "pinn")]
    assert len(jlosses) == 2
    jeq = jrun.equation
    key_iter = jax.random.fold_in(jax.random.PRNGKey(int(jcfg.SEED)), 1)
    params = jax_init_solution(jax.random.fold_in(key_iter, 0), jcfg,
                               jeq).params
    num_v = int(jcfg.METHOD.num_v_samples)
    sdgd_v = 2 if family == "fn" else None
    draws = [_jax_draws(jeq, jax.random.fold_in(key_iter, e), BS, num_v,
                        sdgd_v, 10.0) for e in range(2)]

    def init(cfg, eq, device, generator=None):
        tm = MLP(1 + eq.nx, (16, 16), ("ELU", "ELU"), 1)
        tm.load_state_dict(mlp_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        return Solution.from_net(tm, "Value", eq.nx)

    calls = []

    def inputs(runner, gens, sdgd_v_, num_v_, w):
        t, x, _, xT, idx, probes = draws[len(calls)]
        calls.append(1)
        return (T_(t), T_(x), T_(xT),
                None if idx is None else T_(idx).long(),
                None if probes is None else T_(probes))

    monkeypatch.setattr(baselines, "init_solution", init)
    monkeypatch.setattr(baselines, "pinn_inputs", inputs)
    cfg = default_cfg()
    cfg.merge({**recipe, "DEVICE": "cpu"}, allow_new=False)
    run = PicardRunner(cfg.freeze(), exp_root=tmp_path / "torch")
    run.run()
    losses = [r["loss"] for r in _rows(run.exp_dir, "pinn")]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert (run.exp_dir / "model_1").exists()
    assert len(_rows(run.exp_dir, "eval")) == 2


@pytest.mark.parametrize("recipe", [
    "configs/hjb/pinn_100d_T1.0_v16.yaml",
    "configs/fully_nonlinear/pinn_100d_T1.0_v16_beta10.0.yaml"])
def test_shipped_pinn_recipes_run_cut_on_the_cpu(tmp_path, recipe):
    """The HJB and FN recipes through the runner at nx = 4, narrow nets, B =
    16 and 2 epochs: the rows, the files, a finite loss; HJB's PISGradNet
    enforces the terminal value (no x_T draw), FN draws SDGD indices
    without replacement (v = nx = 4 of the recipe's 100 here)."""
    from deeppicarditeration_torch.config import load_cfg

    ov = ["DEVICE", "cpu", "TRAIN.N_EPOCHS", "2", "EVAL.FREQ", "1",
          "TRAIN.BATCH_SIZE", "16", "EQUATION.kwargs.nx", "4",
          "EVAL.L2_N_POINTS", "32", "NETWORK.NEURONS", "[8, 8]",
          "NETWORK.ACTIVATIONS", "['ELU', 'ELU']"]
    if "fully" in recipe:
        ov += ["DATA.HESSIAN_APPROXIMATION.kwargs.v", "4"]
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = load_cfg(root / recipe, ov)
    run = PicardRunner(cfg, exp_root=tmp_path)
    run.run()
    rows = _rows(run.exp_dir, "pinn")
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    for f in ("model_1", "baseline_1_state", "baseline_1_meta.json"):
        assert (run.exp_dir / f).exists()
    assert run.graph_replays == 0  # the CPU runs the epoch eagerly
