"""The HJB family (OU equation, PISGradNet, EnforceTerminal) against the
JAX package, on the CPU.

Tolerances, each with its reason:
* the threefry reference, the mixture's parameters: bit for bit (the same
  integer arithmetic; the log-weights through the replica of XLA's f32
  log);
* the equation's functions: rtol 1e-5, atol 1e-5 (f32 sums over nx and the
  components in another order; values up to ~100);
* the nets' value and gradient: rtol 1e-5, atol 2e-5 (f32 products and
  sums reassociated through a few layers and a logsumexp);
* the merged estimator's plain version against the Pallas kernel in
  interpret mode with external noise: rtol 5e-5 (the JAX kernel's own,
  tests/test_pallas.py; the sums over M in another order) and atol 1e-5
  of the outputs' largest magnitude: OU's targets reach ~20 where the
  Burgers targets are O(1), and under bf16x3 an f32 value an ulp apart on
  the two sides (XLA's and torch's sin, exp and log on the CPU) splits
  into other bf16 hi and lo parts, whose dropped lo*lo term moves a
  sample's summand by ~1e-6 of its size, amplified by the integral's
  1 / sqrt(s - t) weights;
* the slice (targets -> Adam steps -> eval): rtol 1e-4, atol 1e-5, as
  tests/test_torch_slice.py;
* the D-DBSDE loss on OU: rtol 1e-5 (loss, gradients; atol 1e-6) and
  rtol 1e-5, atol 1e-5 (weights after one Adam step), as
  tests/test_torch_baselines.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppicarditeration_tpu.config import default_cfg as jax_default_cfg
from deeppicarditeration_tpu.distributions import (
    make_random_gmm as jax_make_random_gmm,
)
from deeppicarditeration_tpu.equations import (
    make_equation as jax_make_equation,
)
from deeppicarditeration_tpu.equations.base import param_tag as jax_param_tag
from deeppicarditeration_tpu.evaluation.metrics import (
    grad_metrics as jax_grad_metrics,
    value_metrics as jax_value_metrics,
)
from deeppicarditeration_tpu.models.networks import (
    MLP as JaxMLP,
    EnforceTerminal as JaxEnforceTerminal,
    PISGradNet as JaxPISGradNet,
)
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
)
from deeppicarditeration_tpu.ops.rollout import (
    brownian_paths as jax_brownian_paths,
)
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.training import trainer as jax_trainer
from deeppicarditeration_tpu.training.picard import (
    PicardRunner as JaxPicardRunner,
)
from deeppicarditeration_tpu.utils.static_fn import StaticFn
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.config import default_cfg
from deeppicarditeration_torch.distributions import make_random_gmm
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import eval_solution
from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models import factory
from deeppicarditeration_torch.models.convert import (
    enforce_terminal_state_dict_from_flax,
    mlp_state_dict_from_flax,
    pisgradnet_state_dict_from_flax,
)
from deeppicarditeration_torch.models.networks import (
    MLP,
    EnforceTerminal,
    PISGradNet,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels, threefry
from deeppicarditeration_torch.ops.rollout import brownian_paths
from deeppicarditeration_torch.training import baselines, checkpoint, trainer
from deeppicarditeration_torch.training.picard import PicardRunner
from tests.test_torch_baselines import (
    BETA,
    K,
    NEURONS,
    NX,
    TINY,
    _jax_epoch0_draws,
    _jax_loss,
)

torch.set_num_threads(1)

EQ_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-5, atol=2e-5)
KERNEL_RTOL, KERNEL_ATOL_OF_MAX = 5e-5, 1e-5
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(a):
    return np.asarray(a)


def _close_to_kernel(out, ref):
    ref = _np(ref)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=KERNEL_RTOL,
        atol=KERNEL_ATOL_OF_MAX * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# threefry and the mixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 + 5, 2 ** 32 + 7,
                                  -3])
def test_threefry_keys_fold_in_split_and_uniform_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jax.random.key_data(jkey)), key)
    for data in (0, 5, jax_param_tag("ou_gmm")):
        np.testing.assert_array_equal(
            _np(jax.random.key_data(jax.random.fold_in(jkey, data))),
            threefry.fold_in(key, data))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(
            _np(jax.random.key_data(jax.random.split(jkey, num))),
            threefry.split(key, num))
    k1 = jax.random.split(jkey)[1]
    key1 = threefry.split(key)[1]
    np.testing.assert_array_equal(_np(jax.random.bits(k1, (5, 9))),
                                  threefry.random_bits(key1, (5, 9)))
    u, ref = threefry.uniform(key1, (4, 33)), _np(
        jax.random.uniform(k1, (4, 33)))
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, ref)


@pytest.mark.parametrize("seed,nx,n_comp", [(0, 100, 5), (3, 4, 2),
                                             (17, 10, 5), (99, 7, 8)])
def test_ou_gmm_parameters_are_bit_equal(seed, nx, n_comp):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed),
                              jax_param_tag("ou_gmm"))
    key = threefry.fold_in(threefry.PRNGKey(seed), jax_param_tag("ou_gmm"))
    ref = jax_make_random_gmm(jkey, nx, n_comp, 1.0, 2.0)
    got = make_random_gmm(key, nx, n_comp, 1.0, 2.0)
    for name in ("means", "vars", "log_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)))
    jeq = jax_make_equation("OUProcessEquation", nx=nx,
                            num_components=n_comp, seed=seed)
    teq = make_equation("OUProcessEquation", nx=nx, num_components=n_comp,
                        seed=seed)
    np.testing.assert_array_equal(teq.gmm_log_weights.numpy(),
                                  _np(jeq.gmm_log_weights))


def test_equation_seed_kwarg_pins_the_instance():
    """EQUATION.kwargs.seed overrides the run seed, as in the JAX
    package's make_equation."""
    a = make_equation("OUProcessEquation", run_seed=4, nx=6, seed=9)
    b = make_equation("OUProcessEquation", run_seed=5, nx=6, seed=9)
    c = make_equation("OUProcessEquation", run_seed=4, nx=6)
    assert torch.equal(a.gmm_means, b.gmm_means)
    assert not torch.equal(a.gmm_means, c.gmm_means)
    ref = jax_make_equation("OUProcessEquation", run_seed=4, nx=6)
    np.testing.assert_array_equal(c.gmm_means.numpy(), _np(ref.gmm_means))


# ---------------------------------------------------------------------------
# the equation
# ---------------------------------------------------------------------------

def _ou_pair(nx=8, n_comp=3, seed=5, **kw):
    return (jax_make_equation("OUProcessEquation", nx=nx,
                              num_components=n_comp, seed=seed, **kw),
            make_equation("OUProcessEquation", nx=nx, num_components=n_comp,
                          seed=seed, **kw))


def _points(seed, b, nx, scale=2.0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 0.99, size=(b, 1)).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * scale).astype(np.float32)
    return t, x


@pytest.mark.parametrize("fn", ["g", "g_x", "ff", "fff", "exact_solution",
                                "u_x", "F"])
def test_ou_functions_match_jax(fn):
    jeq, teq = _ou_pair(theta=0.7, mu=0.3, alpha=1.5)
    t, x = _points(0, 32, 8)
    w = np.random.default_rng(1).normal(size=(32, 8)).astype(np.float32)
    y = np.zeros((32, 1), np.float32)
    tt, txx, tw, ty = (torch.from_numpy(a) for a in (t, x, w, y))
    if fn in ("g", "g_x"):
        ref, got = getattr(jeq, fn)(x), getattr(teq, fn)(txx)
    elif fn in ("ff", "fff"):
        ref, got = getattr(jeq, fn)(t, x, y, w), getattr(teq, fn)(
            tt, txx, ty, tw)
    else:
        ref, got = getattr(jeq, fn)(t, x), getattr(teq, fn)(tt, txx)
    np.testing.assert_allclose(got.numpy(), _np(ref), **EQ_TOL)


def test_ou_sample_x0_law_and_device_move():
    """x0 ~ N(0, alpha_scale alpha I), not the base class's N(0, I)."""
    teq = make_equation("OUProcessEquation", nx=50, alpha=0.5,
                        alpha_scale=4.0)
    x0 = teq.sample_x0(torch.Generator().manual_seed(0), 4000,
                       torch.float32, torch.device("cpu"))
    assert x0.shape == (4000, 50)
    np.testing.assert_allclose(float(x0.var()), 2.0, rtol=0.02)
    assert abs(float(x0.mean())) < 0.01
    moved = teq.to("cpu")
    assert moved.gmm_means.device.type == "cpu" and moved.nx == 50


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------

def _pis_pair(jeq, teq, nx, hidden, seed=1, jitter=0.1):
    """A flax PISGradNet and the port's with the same (jittered) params."""
    jmod = JaxPISGradNet(hidden_shapes=hidden, dim=nx,
                         g0=StaticFn(jeq.g, ("g", id(jeq))), T=jeq.T)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.normal(size=a.shape).astype(
            np.float32), params)
    tmod = PISGradNet(nx, hidden, (teq.gmm_means, teq.gmm_vars,
                                   teq.gmm_log_weights), T=teq.T)
    tmod.load_state_dict(pisgradnet_state_dict_from_flax(params))
    return jmod, params, tmod


def test_pisgradnet_value_and_grad_x_match_jax():
    nx, hidden = 8, (16, 16)
    jeq, teq = _ou_pair(nx)
    jmod, params, tmod = _pis_pair(jeq, teq, nx, hidden)
    t, x = _points(2, 64, nx)
    tx = np.concatenate([t, x], 1)
    np.testing.assert_array_equal(
        tmod.timestep_coeff.numpy(),
        _np(jmod.bind(params).timestep_coeff))
    np.testing.assert_allclose(tmod(torch.from_numpy(tx)).detach().numpy(),
                               _np(jmod.apply(params, tx)), **NET_TOL)
    ju, jg = JaxSolution.from_net(jmod, params, "Value", nx) \
        .value_and_grad_x(t, x)
    tu, tg = Solution.from_net(tmod, "Value", nx).value_and_grad_x(
        torch.from_numpy(t), torch.from_numpy(x))
    np.testing.assert_allclose(tu.numpy(), _np(ju), **NET_TOL)
    np.testing.assert_allclose(tg.numpy(), _np(jg), **NET_TOL)
    # the mixture is held as buffers (they move with the module) and is
    # not saved with the parameters
    assert "gmm_means" not in tmod.state_dict()
    assert {n for n, _ in tmod.named_buffers()} >= {
        "gmm_means", "gmm_vars", "gmm_log_weights", "timestep_coeff"}


def test_pisgradnet_precision_wrapper_swaps_every_dense():
    """with_precision runs every Dense of the t_encoder, the smooth_net
    and the nn_module through precision_dot, as the JAX module's
    dot_general knob swaps all three."""
    nx = 8
    _, teq = _ou_pair(nx)
    tmod = PISGradNet(nx, (16, 16), (teq.gmm_means, teq.gmm_vars,
                                     teq.gmm_log_weights),
                      generator=torch.Generator().manual_seed(0))
    sol = Solution.from_net(tmod, "Value", nx)
    calls = []
    real = kernels.precision_dot

    def spy(a, b, precision):
        calls.append(tuple(b.shape))
        return real(a, b, precision)

    t, x = _points(3, 4, nx)
    tx = torch.from_numpy(np.concatenate([t, x], 1))
    try:
        kernels.precision_dot = spy
        kernels.with_precision(sol, "default")(tx)
    finally:
        kernels.precision_dot = real
    n_dense = len(tmod.t_encoder) + 2 * len(tmod.smooth_net) + len(
        tmod.nn_module)  # the gate runs on e(lambda) and on e(0)
    assert len(calls) == n_dense
    assert kernels.with_precision(sol, "highest") is sol


def test_enforce_terminal_matches_jax():
    nx, hidden = 5, (16, 16)
    jeq, teq = _ou_pair(nx)
    jmod = JaxEnforceTerminal(
        inner=JaxMLP(neurons=hidden, activations=("ELU", "ELU"), out_dim=1),
        anchor=StaticFn(jeq.g, ("g", id(jeq))), T=jeq.T)
    params = jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 1 + nx)))
    tmod = EnforceTerminal(MLP(1 + nx, hidden, ("ELU", "ELU"), 1), teq.g,
                           T=teq.T)
    tmod.load_state_dict(enforce_terminal_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    t, x = _points(4, 32, nx)
    ju, jg = JaxSolution.from_net(jmod, params, "Value", nx) \
        .value_and_grad_x(t, x)
    tu, tg = Solution.from_net(tmod, "Value", nx).value_and_grad_x(
        torch.from_numpy(t), torch.from_numpy(x))
    np.testing.assert_allclose(tu.numpy(), _np(ju), **NET_TOL)
    np.testing.assert_allclose(tg.numpy(), _np(jg), **NET_TOL)


@pytest.mark.parametrize("overrides,kind", [
    ({"NETWORK.PISGRADNET": True}, PISGradNet),
    ({"NETWORK.cls": "PicardSolutionEnforceTerminal"}, EnforceTerminal),
    ({}, MLP)])
def test_factory_builds_the_hjb_nets(overrides, kind):
    cfg = default_cfg()
    cfg.EQUATION.cls = "OUProcessEquation"
    cfg.NETWORK.NEURONS = [16, 16]
    cfg.NETWORK.ACTIVATIONS = ["ELU", "ELU"]
    for k, v in overrides.items():
        sec, key = k.split(".")
        cfg[sec][key] = v
    teq = make_equation("OUProcessEquation", nx=6)
    mod = factory.build_network(cfg, teq, torch.device("cpu"),
                                torch.Generator().manual_seed(0))
    assert type(mod) is kind
    assert factory.is_enforce_terminal(cfg) == (kind is not MLP)
    if kind is PISGradNet:
        assert float(mod.timestep_phase.detach().abs().sum()) == 0.0
        cha = make_equation("Cha", nx=6)
        with pytest.raises(NotImplementedError, match="OU"):
            factory.build_network(cfg, cha, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the merged estimator on OU (+ PISGradNet) against the JAX kernel
# ---------------------------------------------------------------------------

def _noise(seed, b, m, nx):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, m, 1)).astype(np.float32),
            rng.normal(size=(b, m, nx)).astype(np.float32),
            rng.normal(size=(b, m, nx)).astype(np.float32))


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
@pytest.mark.parametrize("net", [False, True])
def test_merged_plain_matches_jax_kernel_on_ou(precision, net):
    nx, b, m, hidden = 8, 8, 16, (16, 16)
    jeq, teq = _ou_pair(nx)
    t, x = _points(5, b, nx)
    tx = np.concatenate([t, x], 1)
    u01, nt, ni = _noise(6, b, m, nx)
    jsol, tsol = JaxSolution.zero(nx), Solution.zero(nx)
    if net:
        jmod, params, tmod = _pis_pair(jeq, teq, nx, hidden)
        jsol = JaxSolution.from_net(jmod, params, "Value", nx)
        tsol = Solution.from_net(tmod, "Value", nx)
    ref = generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        u01=jnp.asarray(u01), noise_t=jnp.asarray(nt),
        noise_i=jnp.asarray(ni), mxu_precision=precision)
    args = [torch.from_numpy(a) for a in (tx, u01, nt, ni)]
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, args[0], m, *args[1:], precision=precision)
    _close_to_kernel(out, ref)
    # the CPU wrapper of the PIS kernel is this plain version
    np.testing.assert_array_equal(
        kernels.generate_pis_cuda(0, teq, tsol, args[0], m, *args[1:],
                                  precision=precision).numpy(),
        out.numpy())


def test_pack_pis_tc_layout():
    """The PIS kernel's slab images decode to the matrices in
    ``pis_layer_shapes`` order (hi + lo = the f32 weight to bf16x3's
    precision), and the vector holds the embedding, the gate's biases and
    head row, the encoder's and the net's biases."""
    nx, L = 20, 2
    teq = make_equation("OUProcessEquation", nx=nx)
    mod = PISGradNet(nx, (512,) * L, (teq.gmm_means, teq.gmm_vars,
                                      teq.gmm_log_weights),
                     generator=torch.Generator().manual_seed(0))
    img, vec = kernels.pack_pis_tc(mod, nx)
    shapes = kernels.pis_layer_shapes(L, nx)
    assert len(shapes) == 3 * L + 5
    assert img.dtype == torch.bfloat16
    assert img.numel() == sum(2 * n * k for n, k in shapes)
    sn, nn_ = mod.smooth_net, mod.nn_module
    want = ([sn[0].weight, sn[1].weight, sn[2].weight,
             mod.t_encoder[0].weight, mod.t_encoder[1].weight,
             nn_[0].weight, nn_[1].weight, nn_[2].weight,
             nn_[2].weight.t(), nn_[1].weight.t(),
             nn_[0].weight[:, 64:64 + nx].t()])
    off = 0
    for w, (n, k) in zip(want, shapes):
        part = img[off:off + 2 * n * k].float().reshape(k // 16, 2, n // 8,
                                                         2, 8, 8)
        off += 2 * n * k
        # (slab, hi/lo, row block, col block, row, col) -> (n, k)
        dec = part.permute(1, 2, 4, 0, 3, 5).reshape(2, n, k)
        full = torch.zeros((n, k))
        full[:w.shape[0], :w.shape[1]] = w.detach()
        assert torch.equal(dec[0], full.to(torch.bfloat16).float())
        torch.testing.assert_close(dec[0] + dec[1], full, rtol=2e-5,
                                   atol=1e-7)
    c = 64
    parts = [mod.timestep_coeff[0], mod.timestep_phase[0]] + [
        sn[i].bias for i in range(L + 1)] + [
        sn[L + 1].weight[0], sn[L + 1].bias[:1], mod.t_encoder[0].bias,
        mod.t_encoder[1].bias] + [lin.bias for lin in nn_]
    torch.testing.assert_close(vec, torch.cat([p.detach() for p in parts]))
    assert vec.numel() == 2 * c + (L + 1) * c + c + 1 + 2 * c + L * 512 + nx
    assert kernels.generate_pis_macs_per_sample(100, (512,) * 4) == (
        (164 * 512 + 3 * 512 ** 2 + 512 * 100)
        + (100 * 512 + 3 * 512 ** 2 + 512 * 100)
        + (128 * 64 + 4 * 64 * 64 + 64) + (128 * 64 + 64 * 64))


def test_pis_kernel_coverage_is_decided_by_structure():
    nx = 16
    teq = make_equation("OUProcessEquation", nx=nx)
    gmm = (teq.gmm_means, teq.gmm_vars, teq.gmm_log_weights)

    def pis(hidden):
        return Solution.from_net(PISGradNet(nx, hidden, gmm), "Value", nx)

    zero, wide, narrow = Solution.zero(nx), pis((512,) * 2), pis((64,) * 4)
    assert kernels.pis_covers(teq, zero, "highest", False) is None
    assert kernels.pis_covers(teq, wide, "default", False) is None
    assert kernels.pis_covers(teq, wide, "bf16x3", False) is None
    assert "highest" in kernels.pis_covers(teq, wide, "highest", False)
    assert "width" in kernels.pis_covers(teq, narrow, "default", False)
    assert "antithetic" in kernels.pis_covers(teq, wide, "default", True)
    cha = make_equation("Cha", nx=nx)
    assert "OU" in kernels.pis_covers(cha, zero, "default", False)
    et = Solution.from_net(EnforceTerminal(
        MLP(1 + nx, (16,), ("ELU",), 1), teq.g), "Value", nx)
    assert "PISGradNet" in kernels.pis_covers(teq, et, "default", False)


# ---------------------------------------------------------------------------
# the slice as a whole: targets -> fit -> eval on OU + PISGradNet
# ---------------------------------------------------------------------------

def test_hjb_slice_targets_fit_and_eval_match_jax():
    nx, b, m, bs, n_steps, lr, hidden = 4, 32, 32, 8, 4, 1e-3, (16, 16)
    jeq, teq = _ou_pair(nx, 2)
    t, x = _points(7, b, nx)
    tx = np.concatenate([t, x], 1)
    u01, nt, ni = _noise(8, b, m, nx)
    jfrozen, p_frozen, tfrozen = _pis_pair(jeq, teq, nx, hidden, seed=1)
    jmod, p_fit, tmod = _pis_pair(jeq, teq, nx, hidden, seed=2, jitter=0.0)

    # 1. targets (bf16x3 on both sides, as the merged kernels run)
    y_j = generate_with_gradients_pallas(
        0, jeq, JaxSolution.from_net(jfrozen, p_frozen, "Value", nx),
        jnp.asarray(tx), m, tile_b=8, mblk=8, u01=jnp.asarray(u01),
        noise_t=jnp.asarray(nt), noise_i=jnp.asarray(ni),
        mxu_precision="bf16x3")
    y_t = kernels.generate_with_gradients_plain(
        0, teq, Solution.from_net(tfrozen, "Value", nx),
        torch.from_numpy(tx), m, *(torch.from_numpy(a)
                                   for a in (u01, nt, ni)),
        precision="bf16x3")
    _close_to_kernel(y_t, y_j)
    y = _np(y_j)

    # 2. Adam steps on a fixed batch order
    spec_kw = dict(nx=nx, supervise_gradient=True,
                   scaler_cls="FixedLossScaler",
                   scaler_kwargs=(("fixed_weight", 0.1),))
    jspec, tspec = jax_trainer.TrainSpec(**spec_kw), trainer.TrainSpec(
        **spec_kw)
    opt = optax.adam(lr)
    state, params = opt.init(p_fit), p_fit
    topt = trainer.make_optimizer({"cls": "Adam", "kwargs": {"lr": lr}},
                                  tmod.parameters())
    order = np.random.default_rng(9).permutation(b)
    loss_grad = jax.jit(jax.grad(lambda p, a, c: jax_trainer.compute_loss(
        jmod, p, a, c, jspec)[0]))
    for s in range(n_steps):
        idx = order[s * bs:(s + 1) * bs]
        grads = loss_grad(params, tx[idx], y[idx])
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        trainer.train_step(tmod, topt, torch.from_numpy(tx[idx]),
                           torch.from_numpy(y[idx]), tspec)
    ref = pisgradnet_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, params))
    start = pisgradnet_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, p_fit))
    for name, p in tmod.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), **SLICE_TOL)
    assert not np.allclose(ref["nn_module.0.weight"].numpy(),
                           start["nn_module.0.weight"].numpy())

    # 3. eval metrics on fixed points
    te = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    xe = (np.random.default_rng(10).normal(size=(64, nx)) * 2.0).astype(
        np.float32)
    ju, jg = JaxSolution.from_net(jmod, params, "Value", nx) \
        .value_and_grad_tx(np.concatenate([te, xe], 1))
    jm = {**jax_value_metrics(ju, jeq.exact_solution(te, xe)),
          **jax_grad_metrics(jg[:, 1:], jeq.u_x(te, xe))}
    tu, tg = Solution.from_net(tmod, "Value", nx).value_and_grad_tx(
        torch.from_numpy(np.concatenate([te, xe], 1)))
    tte, txe = torch.from_numpy(te), torch.from_numpy(xe)
    tm = {**value_metrics(tu, teq.exact_solution(tte, txe)),
          **grad_metrics(tg[:, 1:], teq.u_x(tte, txe))}
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **SLICE_TOL)


# ---------------------------------------------------------------------------
# the CLI end to end on the tiny recipes of tests/test_hjb_fn_e2e.py
# ---------------------------------------------------------------------------

def _tiny_yaml(name, eq_kwargs, picard_n, epochs, pis):
    return json.dumps({
        "NAME": name, "FORCE": True,
        "EQUATION": {"cls": "OUProcessEquation", "kwargs": eq_kwargs},
        "PICARD": {"N": picard_n},
        "DATA": {"DATA_SIZE": 512, "CHUNK_ELEMS": 2 ** 16,
                 "kwargs": {"t_always_uniform": True,
                            "n_estimate_terminal": 512,
                            "n_estimate_integral": 512}},
        "TRAIN": {"BATCH_SIZE": 128, "N_EPOCHS": epochs,
                  "SUPERVISE_GRADIENT": True,
                  "OPTIMIZER": {"kwargs": {"lr": 3e-3}},
                  "LOSS": {"SCALER": {"cls": "FixedLossScaler",
                                      "kwargs": {"fixed_weight": 0.1}}}},
        "NETWORK": {"NEURONS": [48, 48], "ACTIVATIONS": ["ELU", "ELU"],
                    "RELOAD": True, "PISGRADNET": pis},
        "EVAL": {"FREQ": None},
    })


@pytest.mark.parametrize("case", ["ou_dpi", "pisgradnet"])
def test_cli_train_tiny_hjb_recipes_on_cpu(tmp_path, monkeypatch, case):
    """The tiny recipes of tests/test_hjb_fn_e2e.py through the port's CLI
    (DEVICE cpu), at the bars the JAX tests set: the OU DPI recipe (nx 4,
    2x48 MLP, 6 iterations) to rRMSE < 0.12 with gradients and below
    iteration 1's; the PISGradNet smoke (2 iterations) to rRMSE < 0.5."""
    kw = {"nx": 4, "alpha": 1.0, "T": 1.0, "num_components": 2}
    if case == "ou_dpi":
        kw.update(mean_scale=1.0, var_scale=2.0, alpha_scale=4.0)
        text, n, pis = _tiny_yaml("hjb_e2e", kw, 6, 40, False), 6, False
    else:
        text, n, pis = _tiny_yaml("hjb_pis", kw, 2, 15, True), 2, True
    (tmp_path / "tiny.yaml").write_text(text)
    monkeypatch.chdir(tmp_path)
    assert torch_cli(["train", "tiny.yaml", "DEVICE", "cpu"]) == 0
    exp = tmp_path / ("hjb_e2e" if case == "ou_dpi" else "hjb_pis")
    eq = make_equation("OUProcessEquation", **kw)

    def metrics_of(i, test_grad=False):
        if pis:
            mod = PISGradNet(4, (48, 48), (eq.gmm_means, eq.gmm_vars,
                                           eq.gmm_log_weights))
        else:
            mod = MLP(5, (48, 48), ("ELU", "ELU"), 1)
        checkpoint.load_params(checkpoint.ckpt_path(exp, i), mod)
        return eval_solution(torch.Generator().manual_seed(7),
                             Solution.from_net(mod, "Value", 4), eq, 800,
                             test_grad=test_grad)

    final = metrics_of(n, test_grad=not pis)
    assert np.isfinite(final["rRMSE"])
    if case == "ou_dpi":
        assert final["rRMSE"] < 0.12, final
        assert final["rRMSE"] < metrics_of(1)["rRMSE"]
    else:
        assert final["rRMSE"] < 0.5, final


# ---------------------------------------------------------------------------
# D-DBSDE on OU
# ---------------------------------------------------------------------------

OU_TINY = {**TINY, "NAME": "diff_ou_tiny",
           "EQUATION": {"cls": "OUProcessEquation",
                        "kwargs": {"nx": NX, "num_components": 2}}}


def test_ou_diffusion_loss_gradients_and_one_adam_step_match_jax(tmp_path):
    """tests/test_torch_baselines.py's check on the OU equation: the JAX
    runner's first epoch (x0 from OU's N(0, alpha_scale alpha I)) and the
    port's loss, gradients and Adam step on the same draws and weights."""
    cfg = jax_default_cfg()
    cfg.merge(OU_TINY)
    runner = JaxPicardRunner(cfg, exp_root=tmp_path / "jax")
    runner.run_one()
    jax_ckpt.wait_all()
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    (logged,) = [r["loss"] for r in rows if r["context"] == "diffusion"]
    jeq = runner.equation
    params, kw, t0, x0, dts, xi, xT = _jax_epoch0_draws(cfg, jeq)
    assert float(np.var(np.asarray(x0))) > 2.0  # OU's wide initial law
    jts, jxs, _ = jax_brownian_paths(kw, jeq, t0, x0, dts, K)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(runner.module, p, jeq, jts, jxs, dts, xT))(params)
    np.testing.assert_allclose(float(jloss), logged, rtol=1e-5)
    after = jax_ckpt.load_params(jax_ckpt.ckpt_path(runner.exp_dir, 1),
                                 params)

    def state(tree):
        return mlp_state_dict_from_flax(jax.tree_util.tree_map(np.array,
                                                               tree))

    teq = make_equation("OUProcessEquation", nx=NX, num_components=2)
    mod = MLP(1 + NX, NEURONS, ("ELU", "ELU"), 1)
    mod.load_state_dict(state(params))
    sol = Solution.from_net(mod, "Value", NX)

    def t(a):
        return torch.from_numpy(np.array(a))

    ts, xs, _ = brownian_paths(None, teq, t(t0), t(x0), t(dts), K, xi=t(xi))
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


def test_diffusion_baseline_on_ou_runs_on_cpu(tmp_path):
    """The port's runner takes the D-DBSDE recipe on OU (x0 from the
    equation's sample_x0), with no terminal penalty under a
    terminal-enforcing ansatz; OptimalControl and DeepNesting run the
    Picard loop."""
    cfg = default_cfg()
    cfg.merge(OU_TINY)
    cfg.merge({"DEVICE": "cpu", "TRAIN": {"N_EPOCHS": 3},
               "EVAL": {"FREQ": 3}})
    runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
    runner.run()
    assert runner.rollout_calls == 3
    rows = [json.loads(ln) for ln in (runner.exp_dir / "metrics.jsonl")
            .read_text().splitlines()]
    assert [r["context"] for r in rows] == ["diffusion", "eval"]
    assert np.isfinite(rows[1]["rRMSE"])
    for method in ("OptimalControl", "DeepNesting"):
        cfg = default_cfg()
        cfg.merge({"NAME": method, "FORCE": True, "DEVICE": "cpu",
                   "METHOD": {"cls": method},
                   "EQUATION": {"cls": "OUProcessEquation",
                                "kwargs": {"nx": 3}},
                   "DATA": {"DATA_SIZE": 32,
                            "kwargs": {"t_always_uniform": True,
                                       "n_estimate_terminal": 8,
                                       "n_estimate_integral": 8}},
                   "TRAIN": {"BATCH_SIZE": 16, "N_EPOCHS": 1},
                   "NETWORK": {"NEURONS": [8], "ACTIVATIONS": ["ELU"]}})
        runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
        runner.run()
        assert runner.generate_calls == 1 and runner.rollout_calls == 0
