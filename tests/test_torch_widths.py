"""The merged estimator at every net of the JAX package's dispatcher matrix
(``scripts/bench_dispatcher_matrix.py``: ELU MLPs 3x64, 4x512, 6x512 and
2x1024), against the JAX package, on the CPU.

* The port's plain merged estimator (what the CUDA wrapper runs on CPU
  tensors, and what the card holds ``csrc/generate.cu``'s width-64 and
  wide passes to) against ``generate_with_gradients_pallas`` in interpret
  mode on the same external noise, the nets' weights carried across by
  ``models/convert.py``: b = 8, m = 16, nx = 8 (and one case at nx = 33),
  with and without antithetic pairing, in "highest" (the JAX kernel's
  default) and, at 3x64 and 2x1024, "bf16x3" (the card's default):
  rtol = atol = 1e-5 (f32 sums of up to 1024 products reassociated).
* One Picard iteration at a 3x64 and a 2x1024 net on the same data and
  weights: the frozen iterate's targets (the JAX kernel against the port's
  plain version, rtol = atol = 1e-4: ``TARGET_TOL``), clipped, then Adam
  steps of the fresh net on a fixed batch order (JAX ``compute_loss`` +
  ``optax.adam`` against the port's ``train_step`` +
  ``torch.optim.Adam``), then the eval metrics on fixed points: rtol 1e-4
  / atol 1e-5, as tests/test_torch_slice.py.
* ``merged_covers`` and ``generation_route`` at every matrix net and nx,
  and at the nets that stay uncovered (unequal widths, width 192,
  "highest" past width 128), decided from the structure alone.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py paths U, V, W, X).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_eq
from deeppicarditeration_tpu.evaluation.metrics import (
    grad_metrics as jax_grad_metrics,
)
from deeppicarditeration_tpu.evaluation.metrics import (
    value_metrics as jax_value_metrics,
)
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
)
from deeppicarditeration_tpu.training import trainer as jax_trainer
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.metrics import (
    grad_metrics,
    value_metrics,
)
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.training import trainer

torch.set_num_threads(1)

T_ = torch.from_numpy
RTOL = ATOL = 1e-5
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
# the iteration's targets: a draw with s - t = 1.4e-6 Tt (u01's smallest
# here) weighs its f by 1 / sqrt(s - t), which carries the f32 rounding of
# u_x's sums over 1024 units into the gradient columns (at 2x1024 both
# sides lie within 4.1e-5 of the plain version in f64, and 6.7e-5 apart)
TARGET_TOL = dict(rtol=1e-4, atol=1e-4)
# a first-step gradient below this share of its tensor's largest stands
# within the f32 rounding of its sum over the batch
CLEAR_OF_ZERO = 1e-4
# the nets of bench_results/dispatcher_matrix_r5.jsonl
MATRIX_NETS = ((64,) * 3, (512,) * 4, (512,) * 6, (1024,) * 2)


def _inputs(seed, b, rows, nx):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=(b, 1)) * 0.8).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    return (np.concatenate([t, x], axis=1),
            rng.uniform(size=(b, rows, 1)).astype(np.float32),
            rng.normal(size=(b, rows, nx)).astype(np.float32),
            rng.normal(size=(b, rows, nx)).astype(np.float32))


def _flax_mlp(nx, neurons, seed):
    jmod = JaxMLP(neurons=neurons, activations=("ELU",) * len(neurons),
                  out_dim=1)
    return jmod, jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))


def _torch_mlp(nx, neurons, params):
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    mod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return mod


def _cha_pair(nx, k=5.0):
    kw = dict(nx=nx, alpha=1.0, k=k, T=1.0)
    return jax_make_eq("Cha", **kw), make_equation("Cha", **kw)


# ---------------------------------------------------------------------------
# the plain merged estimator against the JAX kernel at the matrix's nets
# ---------------------------------------------------------------------------

CASES = ([(neurons, 8, anti, "highest") for neurons in MATRIX_NETS
          for anti in (False, True)]
         + [((64,) * 3, 33, False, "highest"), ((1024,) * 2, 33, True,
                                                 "highest"),
            ((64,) * 3, 8, False, "bf16x3"), ((1024,) * 2, 8, True,
                                              "bf16x3")])


@pytest.mark.parametrize("neurons,nx,antithetic,precision", CASES)
def test_plain_merged_matches_jax_kernel_at_the_matrix_nets(
        neurons, nx, antithetic, precision):
    b, m = 8, 16
    rows = m // 2 if antithetic else m
    jeq, teq = _cha_pair(nx)
    jmod, params = _flax_mlp(nx, neurons, len(neurons) + nx)
    jsol = JaxSolution.from_net(jmod, params, "Value", nx)
    tsol = Solution.from_net(_torch_mlp(nx, neurons, params), "Value", nx)
    assert kernels.merged_covers(teq, tsol, precision if precision !=
                                 "highest" else "bf16x3") is None
    tx, u01, nt, ni = _inputs(nx + len(neurons), b, rows, nx)
    ref = generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        antithetic=antithetic, u01=jnp.asarray(u01),
        noise_t=jnp.asarray(nt), noise_i=jnp.asarray(ni),
        mxu_precision=precision)
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, T_(tx), m, T_(u01), T_(nt), T_(ni),
        antithetic=antithetic, precision=precision)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # the CPU wrapper is that plain version
    torch.testing.assert_close(kernels.generate_with_gradients_cuda(
        0, teq, tsol, T_(tx), m, T_(u01), T_(nt), T_(ni),
        antithetic=antithetic, precision=precision), out, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# one Picard iteration: targets -> clip -> Adam steps -> eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("neurons,n_steps", [((64,) * 3, 4),
                                             ((1024,) * 2, 1)])
def test_one_picard_iteration_matches_jax(neurons, n_steps):
    """At 2x1024 one Adam step: its update's sign is the first gradient's
    alone, which the weights' check masks where it is rounding (below);
    past it a second gradient near 0 moves a weight by ~1e-5 (seen on one
    of the 1043634 unmasked ones)."""
    nx, b, m, bs, bound, lr = 8, 32, 16, 8, 0.6, 1e-3
    jeq, teq = _cha_pair(nx, k=1.0)
    tx, u01, nt, ni = _inputs(5, b, m, nx)
    jmod, p_frozen = _flax_mlp(nx, neurons, 1)
    _, p_fit = _flax_mlp(nx, neurons, 2)

    # the frozen iterate's targets, clipped at the sample bound
    y_j = jnp.clip(generate_with_gradients_pallas(
        0, jeq, JaxSolution.from_net(jmod, p_frozen, "Value", nx),
        jnp.asarray(tx), m, tile_b=8, mblk=8, u01=jnp.asarray(u01),
        noise_t=jnp.asarray(nt), noise_i=jnp.asarray(ni)), -bound, bound)
    y_t = torch.clamp(kernels.generate_with_gradients_plain(
        0, teq, Solution.from_net(_torch_mlp(nx, neurons, p_frozen),
                                  "Value", nx),
        T_(tx), m, T_(u01), T_(nt), T_(ni)), -bound, bound)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               **TARGET_TOL)
    y = np.asarray(y_j)

    # the fit: Adam steps on a fixed batch order
    spec_kw = dict(nx=nx, supervise_gradient=True,
                   scaler_cls="FixedLossScaler",
                   scaler_kwargs=(("fixed_weight", 1.0),))
    jspec, tspec = (jax_trainer.TrainSpec(**spec_kw),
                    trainer.TrainSpec(**spec_kw))
    opt = optax.adam(lr)
    state, params = opt.init(p_fit), p_fit
    tmod = _torch_mlp(nx, neurons, p_fit)
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
        trainer.train_step(tmod, topt, T_(tx[idx]), T_(y[idx]), tspec)
        if s == 0:  # the first step's gradients, at the same weights
            g0 = mlp_state_dict_from_flax(jax.tree_util.tree_map(
                np.asarray, grads))
            for name, p in tmod.named_parameters():
                scale = float(np.abs(g0[name].numpy()).max())
                np.testing.assert_allclose(p.grad.numpy(),
                                           g0[name].numpy(), rtol=1e-4,
                                           atol=1e-5 * scale)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    # Adam's first update is lr g / (|g| + eps): +-lr wherever g is not 0,
    # so a gradient within f32 rounding of 0 takes either sign on the two
    # sides (at 2x1024, 9 of the hidden layer's 1048576 weights); the
    # weights are held where the first gradient stands clear of 0
    for name, p in tmod.state_dict().items():
        g = np.abs(g0[name].numpy())
        clear = g > CLEAR_OF_ZERO * g.max()
        assert clear.mean() > 0.99
        np.testing.assert_allclose(p.numpy()[clear], ref[name].numpy()[clear],
                                   **FIT_TOL)

    # the eval on fixed points
    rng = np.random.default_rng(10)
    te = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    xe = (rng.normal(size=(64, nx)) * np.sqrt(te)).astype(np.float32)
    ju, jg = JaxSolution.from_net(jmod, params, "Value",
                                  nx).value_and_grad_tx(
        np.concatenate([te, xe], 1))
    jm = {**jax_value_metrics(ju, jeq.exact_solution(te, xe)),
          **jax_grad_metrics(jg[:, 1:], jeq.u_x(te, xe))}
    tu, tg = Solution.from_net(tmod, "Value", nx).value_and_grad_tx(
        T_(np.concatenate([te, xe], 1)))
    tm = {**value_metrics(tu, teq.exact_solution(T_(te), T_(xe))),
          **grad_metrics(tg[:, 1:], teq.u_x(T_(te), T_(xe)))}
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **FIT_TOL)


# ---------------------------------------------------------------------------
# the cover and the route, from the structure alone
# ---------------------------------------------------------------------------

def _cha(nx, neurons):
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    return eq, Solution.from_net(mod, "Value", nx)


def _gen(precision="bf16x3"):
    return est.GenConfig(n_estimate_terminal=64, n_estimate_integral=64,
                         pallas_precision=precision)


@pytest.mark.parametrize("neurons", MATRIX_NETS)
@pytest.mark.parametrize("nx", [100, 256, 512])
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
def test_auto_takes_the_merged_kernel_at_the_matrix_nets(
        neurons, nx, precision, capsys, monkeypatch):
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    eq, sol = _cha(nx, neurons)
    assert neurons[0] in kernels.GENERATE_TC_WIDTHS
    assert kernels.merged_covers(eq, sol, precision) is None
    assert est.generation_route(eq, sol, _gen(precision)) == est.MERGED
    assert "split estimators" not in capsys.readouterr().out


@pytest.mark.parametrize("nx,neurons,precision,why", [
    (100, (512, 256), "bf16x3", "all of width 64, 128, 256"),
    (256, (64, 128, 64), "default", "all of width 64, 128, 256"),
    (100, (192,) * 4, "bf16x3", "got neurons (192, 192, 192, 192)"),
    (100, (1152,) * 2, "bf16x3", "896 or 1024"),
    (100, (512,) * 4, "highest", "all of width 128,"),
    (256, (64,) * 3, "highest", "all of width 128,"),
    (512, (1024,) * 2, "highest", "nx=512 exceeds its 511"),
    (1025, (64,) * 3, "bf16x3", "nx=1025 exceeds its 1024"),
])
def test_uncovered_nets_split_with_one_notice(nx, neurons, precision, why,
                                              capsys, monkeypatch):
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    eq, sol = _cha(nx, neurons)
    reason = kernels.merged_covers(eq, sol, precision)
    assert reason is not None and why in reason
    for _ in range(2):
        assert est.generation_route(eq, sol, _gen(precision)) == est.SPLIT
    out = capsys.readouterr().out
    assert out.count("using the split estimators") == 1 and why in out
    # forced, the wrapper raises before it loads the library or checks
    # the device (a tensor on the meta device: no memory, no card)
    launches = kernels.GENERATE.launches
    with pytest.raises(NotImplementedError, match="merged estimator"):
        kernels.generate_with_gradients_cuda(
            0, eq, sol, torch.empty((4, 1 + nx), device="meta"), 64,
            precision=precision)
    assert kernels.GENERATE.launches == launches


def test_other_activations_and_a_bound_stay_uncovered():
    nx = 100
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    for mod in (MLP(1 + nx, (512,) * 4, ("Tanh",) * 4, 1),
                MLP(1 + nx, (64,) * 3, ("ELU",) * 3, 1, bound=1.0)):
        sol = Solution.from_net(mod, "Value", nx)
        assert kernels.merged_covers(eq, sol, "bf16x3") is not None


def test_the_widths_are_the_wide_pass_steps():
    """64, 128, then every multiple of 128 from 256 to 1024 (the wide
    pass's column blocks of m64n128); each width has a launch plan's saved
    derivatives of TILE x width floats, and the L2 count stages 128-row
    slabs past 128 (64-row ones at 64)."""
    assert kernels.GENERATE_TC_WIDTHS == (64, 128, 256, 384, 512, 640, 768,
                                          896, 1024)
    assert len(kernels.GENERATE_TC_WIDTHS) <= kernels.TC_WIDTHS_CAP
    plan = {"stages": 4, "save_smem": False, "dw_smem": True,
            "smem_bytes": 0, "scratch_floats": 0}
    for width in kernels.GENERATE_TC_WIDTHS:
        assert kernels.TC_SAVE_LAYER_FLOATS[width] == 64 * width
    # 3x64 at nx = 100: layer 1's 2 K-slabs and one slab each way for each
    # of 2 hidden layers, 64-row slabs (16 KB under bf16x3)
    v = kernels.generate_tc_l2_bytes(1, 128, 100, 3, "bf16x3", plan, 64)
    assert v["weights"] == (2 + 2 * 2) * 16384
    # 2x1024: 8 column blocks of layer 1's 2 K-slabs, 8 x 16 K-slabs each
    # way for the hidden layer; the saved derivatives of one layer, the
    # layer outputs (2 written, the input of 2 products read 8 times)
    v = kernels.generate_tc_l2_bytes(1, 128, 100, 2, "bf16x3", plan, 1024)
    assert v["weights"] == (8 * 2 + 2 * 8 * 16) * 32768
    layer = 64 * 1024 * 4
    assert v["scratch"] == 2 * (layer * 2 + layer * (2 + 8 * 2))


@pytest.mark.parametrize("path", ["U", "V", "W", "X"])
def test_width_paths_load_as_in_jax(path):
    """Paths U, V, W, X: the w1.0 recipe with the matrix cell's net and nx
    as chip_smoke reads it (the port's YAML reader) is the JAX package's
    load_cfg tree, DEVICE apart; the generation flags map alike, one
    generation call an iteration (nx <= 512 at B = 4096), and "auto" takes
    the merged kernel for the path's net."""
    import chip_smoke
    from deeppicarditeration_torch.config import load_cfg
    from deeppicarditeration_torch.data.dataset import default_gen_batch
    from deeppicarditeration_torch.training.picard import (
        gen_config_from_cfg,
    )
    from deeppicarditeration_tpu.config import load_cfg as jax_load_cfg
    from deeppicarditeration_tpu.training.picard import (
        gen_config_from_cfg as jax_gen_config_from_cfg,
    )

    recipe, overrides = chip_smoke._recipe_of(path)
    neurons, nx, limits = chip_smoke.WIDTH_PATHS[path]
    root = chip_smoke.ROOT
    cfg = chip_smoke.path_cfg(path, 3, "cpu")
    port = cfg.to_dict()
    assert port == load_cfg(root / recipe, list(overrides) + [
        "PICARD.N", "3", "DEVICE", "cpu"]).to_dict()
    assert port.pop("DEVICE") == "cpu"
    jcfg = jax_load_cfg(root / recipe, list(overrides) + ["PICARD.N", "3"])
    assert port == jcfg.to_dict()
    assert tuple(cfg.NETWORK.NEURONS) == neurons
    assert cfg.EQUATION.kwargs.nx == nx and len(limits) == 3
    gen = gen_config_from_cfg(cfg)
    jgen = jax_gen_config_from_cfg(jcfg, 1)
    for field in ("n_estimate_terminal", "n_estimate_integral",
                  "pallas_generate", "pallas_precision", "antithetic"):
        assert getattr(gen, field) == getattr(jgen, field), field
    assert default_gen_batch(int(cfg.DATA.DATA_SIZE), gen.chunk_elems,
                             nx) == int(cfg.DATA.DATA_SIZE) == 4096
    eq, sol = _cha(nx, neurons)
    assert est.generation_route(eq, sol, gen) == est.MERGED
