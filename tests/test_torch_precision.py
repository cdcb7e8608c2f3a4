"""The precision of the estimator kernels' frozen-net dots
(``DATA.TPU.PALLAS_PRECISION``) against the JAX package.

* ``precision_dot`` and its backward against the JAX
  ``bf16x3_dot_general`` (``_split3`` / ``_bf16x3_bwd``) on numpy inputs:
  every product is exact in both, only the order of the f32 sums differs,
  so rtol = 1e-5 (atol 1e-6 for sums near 0).
* The merged and the integral plain versions in "bf16x3" and "highest"
  against ``generate_with_gradients_pallas`` and
  ``integral_with_gradients_pallas`` with ``mxu_precision`` the same mode
  (interpret mode, external noise; nx=100, 4x128 ELU, b=8, m=16, as
  tests/test_torch_generate.py): rtol = atol = 1e-5.
* ``GenConfig`` reads the key, defaults to bf16x3 and raises on anything
  else; the dispatch hands it to the merged and the integral estimator and
  nowhere else; the tensor-core kernels' packed net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import (
    make_equation as jax_make_equation,
)
from deeppicarditeration_tpu.ops.pallas_kernels import (
    bf16x3_dot_general,
    generate_with_gradients_pallas,
    integral_with_gradients_pallas,
)
from deeppicarditeration_tpu.training.picard import (
    gen_config_from_cfg as jax_gen_config_from_cfg,
)
from deeppicarditeration_torch import config as tconfig
from deeppicarditeration_torch.device import derive_seed
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.training.picard import gen_config_from_cfg
from tests.test_torch_config import W1
from tests.test_torch_generate import _inputs, _nets

torch.set_num_threads(1)

DOT_RTOL, DOT_ATOL = 1e-5, 1e-6
RTOL = ATOL = 1e-5


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("lead,k,n", [((7,), 37, 19), ((3, 5), 101, 128)])
def test_split3_dot_and_backward_match_jax(lead, k, n):
    rng = np.random.default_rng(0)
    a = rng.normal(size=lead + (k,)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    g = rng.normal(size=lead + (n,)).astype(np.float32)
    dims = (((len(lead),), (0,)), ((), ()))
    ref, vjp = jax.vjp(lambda u, v: bf16x3_dot_general(u, v, dims),
                       jnp.asarray(a), jnp.asarray(b))
    ref_da, ref_db = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = kernels.precision_dot(ta, tb, "bf16x3")
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    for got, want in ((out, ref), (da, ref_da), (db, ref_db)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=DOT_RTOL, atol=DOT_ATOL)
    # bf16x3 is not the f32 product, and differs from it by ~2^-16
    full = a @ b
    assert 0 < np.abs(out.detach().numpy() - full).max() < 1e-4


def test_default_dot_is_one_bf16_pass():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(9, 33)).astype(np.float32)
    b = rng.normal(size=(33, 5)).astype(np.float32)
    g = rng.normal(size=(9, 5)).astype(np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    out = kernels.precision_dot(ta, torch.from_numpy(b), "default")
    (da,) = torch.autograd.grad(out, (ta,), torch.from_numpy(g))
    want = _bf16_np(a).astype(np.float64) @ _bf16_np(b)
    want_da = _bf16_np(g).astype(np.float64) @ _bf16_np(b).T
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(da.numpy(), want_da, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        kernels.precision_dot(torch.from_numpy(a), torch.from_numpy(b),
                              "highest"),
        torch.from_numpy(a) @ torch.from_numpy(b), rtol=0, atol=0)
    with pytest.raises(ValueError, match="pallas_precision"):
        kernels.precision_dot(ta, torch.from_numpy(b), "high")


def _full_width_case():
    nx, b, m = 100, 8, 16
    jeq = jax_make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    teq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    jsol, tsol = _nets(nx, (128, 128, 128, 128))
    return nx, b, m, jeq, teq, jsol, tsol, _inputs(1, b, m, nx)


@pytest.mark.parametrize("kernel", ["generate", "integral"])
@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_plain_matches_jax_kernel_in_the_same_mode(kernel, precision):
    nx, b, m, jeq, teq, jsol, tsol, (tx, u01, nt, ni) = _full_width_case()
    if kernel == "generate":
        ref = generate_with_gradients_pallas(
            0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
            u01=jnp.asarray(u01), noise_t=jnp.asarray(nt),
            noise_i=jnp.asarray(ni), mxu_precision=precision)
        out = kernels.generate_with_gradients_plain(
            0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
            torch.from_numpy(nt), torch.from_numpy(ni), precision=precision)
    else:
        ref = integral_with_gradients_pallas(
            0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
            u01=jnp.asarray(u01), noise=jnp.asarray(ni),
            mxu_precision=precision)
        out = kernels.integral_with_gradients_plain(
            0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
            torch.from_numpy(ni), precision=precision)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_the_mode_reaches_the_plain_versions():
    """bf16x3 and highest differ (by less than the ~2e-5 the JAX package
    measured on the TPU), and "default" differs more."""
    nx, b, m, _, teq, _, tsol, (tx, u01, nt, ni) = _full_width_case()
    args = (0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
            torch.from_numpy(nt), torch.from_numpy(ni))
    out = {p: kernels.generate_with_gradients_plain(*args, precision=p)
           for p in kernels.PRECISIONS}
    d3 = float((out["bf16x3"] - out["highest"]).abs().max())
    d1 = float((out["default"] - out["highest"]).abs().max())
    assert 0 < d3 < 5e-5 and d1 > 10 * d3, (d3, d1)
    integ = kernels.integral_with_gradients_plain(
        0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
        torch.from_numpy(ni), precision="bf16x3")
    assert float((integ - kernels.integral_with_gradients_plain(
        0, teq, tsol, torch.from_numpy(tx), m, torch.from_numpy(u01),
        torch.from_numpy(ni))).abs().max()) > 0


@pytest.mark.parametrize("value", [None, "bf16x3", "highest", "default"])
def test_gen_config_reads_the_precision_key(value):
    ov = [] if value is None else ["DATA.TPU.PALLAS_PRECISION", value]
    cfg = tconfig.load_cfg(W1, ov)
    gen = gen_config_from_cfg(cfg)
    assert gen.pallas_precision == (value or "bf16x3")
    from deeppicarditeration_tpu.config import load_cfg as jax_load_cfg

    assert gen.pallas_precision == jax_gen_config_from_cfg(
        jax_load_cfg(W1, ov), 1).pallas_precision
    assert est.GenConfig().pallas_precision == "bf16x3"


def test_unknown_precision_raises():
    cfg = tconfig.load_cfg(W1, ["DATA.TPU.PALLAS_PRECISION", "high"])
    with pytest.raises(ValueError, match="pallas_precision"):
        gen_config_from_cfg(cfg)
    with pytest.raises(ValueError, match="pallas_precision"):
        est.GenConfig(pallas_precision="fp32")
    nx, b, m = 4, 2, 4
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    tx = torch.from_numpy(_inputs(0, b, m, nx)[0])
    for fn in (kernels.generate_with_gradients_cuda,
               kernels.integral_with_gradients_cuda):
        with pytest.raises(ValueError, match="pallas_precision"):
            fn(0, eq, Solution.zero(nx), tx, m, precision="tf32")


def test_dispatch_passes_the_precision_to_the_kernels_only():
    """The merged and the standalone integral estimator get the mode; the
    terminal kernel and the chunk estimators stay f32."""
    nx, b, m = 6, 4, 8
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    g = torch.Generator().manual_seed(0)
    sol = Solution.from_net(MLP(1 + nx, (128, 128), ("ELU", "ELU"), 1,
                                generator=g), "Value", nx)
    tx = torch.from_numpy(_inputs(5, b, m, nx)[0])

    def gen(p, **kw):
        return est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                             pallas_precision=p, **kw)

    for p in kernels.PRECISIONS:
        out = est.generate_with_gradients(3, eq, sol, tx, gen(p))
        ref = kernels.generate_with_gradients_plain(3, eq, sol, tx, m,
                                                    precision=p)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        out = est.estimate_integral_with_gradients(
            3, eq, sol, tx, gen(p, pallas_integral=True))
        ref = kernels.integral_with_gradients_plain(3, eq, sol, tx, m,
                                                    precision=p)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    split = {p: est.generate_with_gradients(3, eq, sol, tx,
                                            gen(p, pallas_generate=False))
             for p in ("bf16x3", "highest")}
    torch.testing.assert_close(split["bf16x3"], split["highest"], rtol=0,
                               atol=0)
    both = (est.estimate_terminal_with_gradients(derive_seed(3, 1), eq, tx,
                                                 gen("highest"))
            + est.estimate_integral_with_gradients(derive_seed(3, 2), eq,
                                                   sol, tx, gen("highest")))
    torch.testing.assert_close(split["highest"], both, rtol=0, atol=0)


@pytest.mark.parametrize("nx,neurons", [(100, (128,) * 4), (7, (128,)),
                                        (30, (128, 128)),
                                        (1024, (256, 256))])
def test_pack_mlp_tc_layout(nx, neurons):
    """The tensor-core kernels' images hold hi = bf16(W) and lo =
    bf16(W - hi) of W1 (columns x_1..x_nx, s, zero padding to whole slabs
    of 64) and of each hidden W, in 8 x 8 core matrices; then the biases,
    the head, the column sums over x of hi(W1) and lo(W1), the head's
    bias. At hidden width 128 and 256 (the merged kernel's widths; path
    S's K1 = 1025 padded to 1088)."""
    h = neurons[0]
    g = torch.Generator().manual_seed(nx)
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1, generator=g)
    with torch.no_grad():
        for lin in mod.layers:
            lin.bias.normal_(generator=g)
    img, vec = kernels.pack_mlp_tc(mod, nx)
    k1 = kernels.tc_k1(nx)
    assert k1 % 64 == 0 and 1 + nx <= k1 < 65 + nx
    assert img.dtype == torch.bfloat16 and vec.dtype == torch.float32

    def untile(flat, n, k):  # core (i, j) at (i * k/8 + j) * 64, rows of 8
        return flat.reshape(n // 8, k // 8, 8, 8).permute(0, 2, 1, 3) \
            .reshape(n, k)

    w1 = mod.layers[0].weight.detach()
    w1p = torch.zeros((h, k1))
    w1p[:, :nx], w1p[:, nx] = w1[:, 1:], w1[:, 0]
    o = 0
    his = []
    for w, k in [(w1p, k1)] + [(lin.weight.detach(), h)
                               for lin in mod.layers[1:-1]]:
        hi = untile(img[o:o + h * k], h, k).float()
        lo = untile(img[o + h * k:o + 2 * h * k], h, k).float()
        torch.testing.assert_close(hi, w.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(lo, (w - hi).to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
        assert float((w - hi - lo).abs().max()) <= 2 ** -16 * float(
            w.abs().max())
        his.append((hi, lo))
        o += 2 * h * k
    assert o == img.numel()
    L = len(neurons)
    want = [lin.bias.detach() for lin in mod.layers[:-1]] + [
        mod.layers[-1].weight.detach().reshape(-1),
        his[0][0][:, :nx].sum(1), his[0][1][:, :nx].sum(1),
        mod.layers[-1].bias.detach()]
    torch.testing.assert_close(vec, torch.cat(want), rtol=0, atol=0)
    assert vec.numel() == (L + 3) * h + 1
