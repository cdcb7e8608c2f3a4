"""The port's merged estimator against the JAX Pallas kernel.

The same numpy-made inputs and external noise go through
``deeppicarditeration_tpu.ops.pallas_kernels.generate_with_gradients_pallas``
(interpret mode off the TPU, as tests/test_pallas.py runs it) and the
port's ``generate_with_gradients_plain``. Tolerance rtol = atol = 5e-5,
the JAX kernel's own (tests/test_pallas.py). The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
)
from deeppicarditeration_torch.data.dataset import generate_dataset
from deeppicarditeration_torch.device import derive_seed
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels

torch.set_num_threads(1)

RTOL = ATOL = 5e-5


def _inputs(seed, b, m, nx):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=(b, 1)) * 0.8).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    tx = np.concatenate([t, x], axis=1)
    u01 = rng.uniform(size=(b, m, 1)).astype(np.float32)
    noise_t = rng.normal(size=(b, m, nx)).astype(np.float32)
    noise_i = rng.normal(size=(b, m, nx)).astype(np.float32)
    return tx, u01, noise_t, noise_i


def _nets(nx, neurons, seed=0):
    """A flax MLP and the port's MLP carrying the same weights."""
    jmod = JaxMLP(neurons=neurons, activations=("ELU",) * len(neurons),
                  out_dim=1)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    tmod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    tmod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (JaxSolution.from_net(jmod, params, "Value", nx),
            Solution.from_net(tmod, "Value", nx))


@pytest.mark.parametrize("case", ["zero", "mlp_4x128"])
def test_plain_matches_jax_pallas_kernel(case):
    """Zero iterate (Picard iteration 1) and the slice's full-width net
    (nx=100, 4x128 ELU) at b=8, m=16."""
    nx, b, m = 100, 8, 16
    jeq = jax_make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    teq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    if case == "zero":
        jsol, tsol = JaxSolution.zero(nx), Solution.zero(nx)
    else:
        jsol, tsol = _nets(nx, (128, 128, 128, 128))
    tx, u01, noise_t, noise_i = _inputs(1, b, m, nx)
    ref = generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        u01=jnp.asarray(u01), noise_t=jnp.asarray(noise_t),
        noise_i=jnp.asarray(noise_i))
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
        torch.from_numpy(noise_t), torch.from_numpy(noise_i), chunk_rows=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    if case == "mlp_4x128":
        # the integral chain reaches the frozen net: targets differ from the
        # zero iterate's
        zero = kernels.generate_with_gradients_plain(
            0, teq, Solution.zero(nx), torch.from_numpy(tx), m,
            torch.from_numpy(u01), torch.from_numpy(noise_t),
            torch.from_numpy(noise_i))
        assert float((out - zero).abs().max()) > 1e-3


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the kernel wrapper returns the plain version's result
    (external noise and in-generator draws alike)."""
    nx, b, m = 6, 4, 40
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    sol = Solution.from_net(MLP(1 + nx, (16,), ("ELU",), 1), "Value", nx)
    tx, u01, nt, ni = (torch.from_numpy(a) for a in _inputs(2, b, m, nx))
    a = kernels.generate_with_gradients_cuda(7, eq, sol, tx, m, u01, nt, ni)
    p = kernels.generate_with_gradients_plain(7, eq, sol, tx, m, u01, nt, ni)
    torch.testing.assert_close(a, p, rtol=0, atol=0)
    a = kernels.generate_with_gradients_cuda(7, eq, sol, tx, m)
    p = kernels.generate_with_gradients_plain(7, eq, sol, tx, m)
    torch.testing.assert_close(a, p, rtol=0, atol=0)


def test_plain_chunking_and_variance():
    """The M-chunking does not change the estimate, and return_var gives
    the per-sample variance of the 1 + nx summands."""
    nx, b, m = 5, 3, 48
    eq = make_equation("Cha", nx=nx, alpha=1.3, k=1.0, T=1.0)
    sol = Solution.from_net(MLP(1 + nx, (8, 8), ("ELU", "ELU"), 1),
                            "Value", nx)
    tx, u01, nt, ni = (torch.from_numpy(a) for a in _inputs(3, b, m, nx))
    whole, var = kernels.generate_with_gradients_plain(
        0, eq, sol, tx, m, u01, nt, ni, return_var=True)
    chunked = kernels.generate_with_gradients_plain(
        0, eq, sol, tx, m, u01, nt, ni, chunk_rows=b * 4)
    torch.testing.assert_close(whole, chunked, rtol=1e-5, atol=1e-6)
    # variance of the per-sample summand, recomputed per sample
    zs = []
    for k in range(m):
        zk = kernels.generate_with_gradients_plain(
            0, eq, sol, tx, 1, u01[:, k:k + 1], nt[:, k:k + 1],
            ni[:, k:k + 1])
        zs.append(zk)
    z = torch.stack(zs, dim=1)
    base = z.mean(dim=1) - whole  # the (g0 + f0 Tt, 0) offset cancels
    assert float(base.abs().max()) < 1e-5
    torch.testing.assert_close(var, z.var(dim=1, unbiased=False), rtol=1e-3,
                               atol=1e-6)


def test_dispatcher_routes_to_the_estimator_and_rejects_unported():
    nx, b, m = 4, 8, 16
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    sol = Solution.zero(nx)
    tx = torch.from_numpy(_inputs(4, b, m, nx)[0])
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        pallas_generate=True)
    out = est.generate_with_gradients(11, eq, sol, tx, gen)
    ref = kernels.generate_with_gradients_plain(11, eq, sol, tx, m)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # "auto" leaves the zero iterate at nx < 32 to the chunk estimators
    auto = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m)
    out = est.generate_with_gradients(11, eq, sol, tx, auto)
    ref = (est.estimate_terminal_with_gradients(derive_seed(11, 1), eq, tx,
                                                auto)
           + est.estimate_integral_with_gradients(derive_seed(11, 2), eq,
                                                  sol, tx, auto))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # antithetic pairing stays on the merged estimator
    anti = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                         antithetic=True, pallas_generate=True)
    out = est.generate_with_gradients(11, eq, sol, tx, anti)
    ref = kernels.generate_with_gradients_plain(11, eq, sol, tx, m,
                                                antithetic=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # different sample counts take the split estimators
    split = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=2 * m)
    out = est.generate_with_gradients(11, eq, sol, tx, split)
    ref = (est.estimate_terminal_with_gradients(derive_seed(11, 1), eq, tx,
                                                split)
           + est.estimate_integral_with_gradients(derive_seed(11, 2), eq,
                                                  sol, tx, split))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # still unported: TD estimators and the value-only mode
    with pytest.raises(NotImplementedError, match="TD"):
        est.generate_with_gradients(
            11, eq, sol, tx, est.GenConfig(n_estimate_terminal=m,
                                           n_estimate_integral=m,
                                           estimate_delta_t=0.1))
    with pytest.raises(NotImplementedError, match="value"):
        est.sample_batch(11, eq, sol, b, gen, mode="value", device="cpu")


@pytest.mark.parametrize("entry", ["sample_tx", "sample_batch",
                                   "generate_dataset"])
def test_generation_entry_points_default_to_the_card(entry):
    """Without ``device`` the generation entry points run on the card, and
    raise where there is none; the CPU runs only when asked for."""
    nx, b, m = 3, 4, 8
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    sol = Solution.zero(nx)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        t_always_uniform=True)

    def run(**kw):
        if entry == "sample_tx":
            on_card = "device" not in kw and torch.cuda.is_available()
            g = torch.Generator(device="cuda" if on_card else "cpu")
            g.manual_seed(0)
            return [est.sample_tx(g, eq, b, gen, **kw)]
        if entry == "sample_batch":
            return list(est.sample_batch(0, eq, sol, b, gen, **kw))
        ds = generate_dataset(0, eq, sol, b, gen, "gradient", **kw)
        return [ds.tx, ds.y]

    for v in run(device="cpu"):
        assert v.device.type == "cpu" and v.shape == (b, 1 + nx)
    if torch.cuda.is_available():
        assert all(v.is_cuda for v in run())
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


@pytest.mark.parametrize("neurons,acts,bound", [
    ((64, 64), ("ELU", "ELU"), None),
    ((128, 128), ("Tanh", "ELU"), None),
    ((128,), ("ELU",), 1.0),
])
def test_kernel_net_rejects_uncovered_nets(neurons, acts, bound):
    nx = 10
    sol = Solution.from_net(MLP(1 + nx, neurons, acts, 1, bound=bound),
                            "Value", nx)
    with pytest.raises(NotImplementedError):
        kernels.kernel_net(sol, nx)


def test_pack_mlp_layout():
    """The packed buffer holds W1^T, b1, per hidden layer (W^T, W, b), then
    the head, in the order the CUDA kernel reads it."""
    nx, h = 3, 128
    mod = MLP(1 + nx, (h, h), ("ELU", "ELU"), 1)
    assert kernels.kernel_net(Solution.from_net(mod, "Value", nx), nx) is mod
    w = kernels.pack_mlp(mod)
    l0, l1, l2 = mod.layers
    o = 0
    for part in (l0.weight.t(), l0.bias, l1.weight.t(), l1.weight, l1.bias,
                 l2.weight.reshape(-1), l2.bias):
        n = part.numel()
        torch.testing.assert_close(w[o:o + n], part.reshape(-1))
        o += n
    assert o == w.numel()
    flops = kernels.generate_flops_per_sample(100, (128,) * 4)
    assert flops == 2 * (101 * 128 + 3 * 128 * 128 + 128
                         + 128 + 3 * 128 * 128 + 128)
