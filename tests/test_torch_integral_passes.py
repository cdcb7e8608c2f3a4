"""The integral kernel's "highest" mode: six bf16 passes over three pieces
of each operand, on the CPU.

* ``pack_mlp_tc`` with three pieces: the pieces of each W sum back to W
  exactly, in the core-tile layout of the two-piece images
  (tests/test_torch_precision.py: test_pack_mlp_tc_layout), and the
  column sums over x of each piece of W1 sum to W1's within f32 rounding.
* ``six_pass_dot``, the torch emulation of the kernel's products (nothing
  on the card's path calls it): within f32 rounding of the f64 product,
  and within DOT_RTOL / DOT_ATOL (tests/test_torch_precision.py: f32 sums
  in another order) of JAX's ``jnp.dot(..., precision=HIGHEST)`` on the
  same numpy inputs.
* A model of those products on the tensor cores, each wgmma's sum cut
  toward zero to its f32 accumulator: six passes in one accumulator keep
  several times f32's error, the five smaller products in an accumulator
  of their own (as ``csrc/value_mlp_tc.cuh`` keeps them) f32's.
* The integral wrapper's ``lib`` argument (the bench's other builds) takes
  the plain version on CPU tensors in every mode.
* chip_smoke's bound model counts "highest" as six bf16 passes on the
  tensor pipe, the least time for f32-accurate products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels

torch.set_num_threads(1)

DOT_RTOL, DOT_ATOL = 1e-5, 1e-6


def _untile(flat, n, k):  # core (i, j) at (i * k/8 + j) * 64, rows of 8
    return flat.reshape(n // 8, k // 8, 8, 8).permute(0, 2, 1, 3) \
        .reshape(n, k)


def _mlp(nx, neurons, seed):
    g = torch.Generator().manual_seed(seed)
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1, generator=g)
    with torch.no_grad():
        for lin in mod.layers:
            lin.bias.normal_(generator=g)
    return mod


@pytest.mark.parametrize("nx,neurons", [(100, (128,) * 4), (7, (128,)),
                                        (30, (128, 128))])
def test_three_piece_images_sum_back_to_w(nx, neurons):
    mod = _mlp(nx, neurons, nx)
    img, vec = kernels.pack_mlp_tc(mod, nx, pieces=3)
    k1 = kernels.tc_k1(nx)
    assert img.dtype == torch.bfloat16 and vec.dtype == torch.float32
    w1 = mod.layers[0].weight.detach()
    w1p = torch.zeros((128, k1))
    w1p[:, :nx], w1p[:, nx] = w1[:, 1:], w1[:, 0]
    two, _ = kernels.pack_mlp_tc(mod, nx)
    o = o2 = 0
    for w, k in [(w1p, k1)] + [(lin.weight.detach(), 128)
                               for lin in mod.layers[1:-1]]:
        p = [_untile(img[o + i * 128 * k:o + (i + 1) * 128 * k], 128,
                     k).float() for i in range(3)]
        # each piece is the bf16 rounding of what the earlier ones leave
        torch.testing.assert_close(p[0], w.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(p[1], (w - p[0]).to(torch.bfloat16)
                                   .float(), rtol=0, atol=0)
        assert torch.equal(p[0] + (p[1] + p[2]), w)
        # the first two pieces are the two-piece images, in the same layout
        for i in range(2):
            assert torch.equal(img[o + i * 128 * k:o + (i + 1) * 128 * k],
                               two[o2 + i * 128 * k:o2 + (i + 1) * 128 * k])
        o += 3 * 128 * k
        o2 += 2 * 128 * k
    assert o == img.numel() and o2 == two.numel()


@pytest.mark.parametrize("nx", [100, 7])
def test_three_piece_column_sums(nx):
    """Biases, head, the column sums over x of each piece of W1, the head's
    bias; the piece sums add up to W1's column sums within f32 rounding."""
    neurons = (128,) * 3
    mod = _mlp(nx, neurons, 3 + nx)
    _, vec = kernels.pack_mlp_tc(mod, nx, pieces=3)
    L = len(neurons)
    assert vec.numel() == (L + 4) * 128 + 1
    w1x = mod.layers[0].weight.detach()[:, 1:]
    pieces = kernels.bf16_pieces(w1x, 3)
    want = [lin.bias.detach() for lin in mod.layers[:-1]] + [
        mod.layers[-1].weight.detach().reshape(-1)] + [
        p.sum(1) for p in pieces] + [mod.layers[-1].bias.detach()]
    torch.testing.assert_close(vec, torch.cat(want), rtol=0, atol=0)
    c = vec[(L + 1) * 128:(L + 4) * 128].reshape(3, 128).double().sum(0)
    exact = w1x.double().sum(1)
    bound = nx * 2.0 ** -23 * w1x.double().abs().sum(1)
    assert bool(((c - exact).abs() <= bound).all())


@pytest.mark.parametrize("lead,k,n", [((7,), 37, 19), ((64,), 128, 128),
                                      ((3, 5), 101, 128)])
def test_six_pass_dot_is_f32_accurate(lead, k, n):
    rng = np.random.default_rng(k)
    a = rng.normal(size=lead + (k,)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    out = kernels.six_pass_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32
    exact = a.astype(np.float64) @ b.astype(np.float64)
    # f32 sums of k products (and the three dropped piece products, each
    # below 2^-24 |a||b|): within a few ulps of the f64 product's scale
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(out.numpy().astype(np.float64) - exact)
    assert np.all(err <= (k + 6) * 2.0 ** -24 * scale)
    ref = jnp.dot(jnp.asarray(a), jnp.asarray(b),
                  precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=DOT_RTOL,
                               atol=DOT_ATOL)
    # the pieces: each the bf16 rounding of the rest, exact in sum
    p = kernels.bf16_pieces(torch.from_numpy(a), 3)
    assert torch.equal(p[0] + (p[1] + p[2]), torch.from_numpy(a))
    # one bf16 pass is far from it: the emulation is not the f32 matmul's
    # own code path by accident
    one = kernels.precision_dot(torch.from_numpy(a), torch.from_numpy(b),
                                "default")
    assert float((one - out).abs().max()) > 100 * float(err.max())


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, cut toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _wgmma_sums(a, b, pairs, apart):
    """a @ b as the kernel's wgmma take it: per k16 chunk and piece pair
    (i, j) one product a_i b_j, its sum (exact here) added to an f32
    accumulator and cut toward zero; ``apart``: every pair but (0, 0) into
    a second accumulator, the two joined in f32 at the end."""
    n = 1 + max(max(p) for p in pairs)
    ap = [p.double() for p in kernels.bf16_pieces(a, n)]
    bp = [p.double() for p in kernels.bf16_pieces(b, n)]
    acc = torch.zeros((a.shape[0], b.shape[1]))
    cor = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 16):
        for i, j in pairs:
            s = ap[i][:, k0:k0 + 16] @ bp[j][k0:k0 + 16]
            if apart and (i, j) != (0, 0):
                cor = _toward_zero(cor.double() + s)
            else:
                acc = _toward_zero(acc.double() + s)
    return (acc.double() + cor.double()).float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_six_passes_keep_f32_only_with_the_small_products_apart(seed):
    rng = np.random.default_rng(seed)
    k = 128
    a = torch.from_numpy(rng.normal(size=(64, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, 128)) / np.sqrt(k))
                         .astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()

    def err(out):
        return float(((out.double() - exact).abs() / scale).max())

    six = [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
    apart = err(_wgmma_sums(a, b, six, True))
    one = err(_wgmma_sums(a, b, six, False))
    x3 = err(_wgmma_sums(a, b, [(0, 0), (1, 0), (0, 1)], False))
    # apart: an ulp of the scale per chunk at most, f32's own level
    assert apart <= (k // 16) * 2.0 ** -24
    assert one > 3 * apart and x3 > 2 * one


@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_integral_wrapper_takes_another_build_only_on_the_card(precision):
    other = kernels.CudaLibrary("integral.cu", lambda lib: None)
    nx, b, m = 5, 3, 24
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    sol = Solution.from_net(MLP(1 + nx, (8,), ("ELU",), 1), "Value", nx)
    rng = np.random.default_rng(0)
    tx = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 0.9, (b, 1)), rng.normal(size=(b, nx))],
        1).astype(np.float32))
    out = kernels.integral_with_gradients_cuda(3, eq, sol, tx, m,
                                               precision=precision,
                                               lib=other)
    ref = kernels.integral_with_gradients_plain(3, eq, sol, tx, m,
                                                precision=precision)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert other.launches == 0 and other._lib is None


def test_bound_model_counts_highest_as_six_tensor_passes():
    import chip_smoke

    nx, neurons = 100, (128,) * 4
    fp32 = {m: chip_smoke._net_work(nx, neurons, m)
            for m in kernels.PRECISIONS}
    assert fp32["highest"][1] == 6 * fp32["default"][1] \
        == 2 * fp32["bf16x3"][1] > 0
    # the head and the column-sum contraction once in f32, two subtracts
    # per A element (three pieces) where bf16x3 has one
    split = (1 + nx) + 2 * sum(neurons[1:])
    assert fp32["highest"][0] - fp32["default"][0] == split
    # at path B's shapes the bound is the tensor pipe's, twice bf16x3's
    b = m = 4096
    n_w = (1 + nx) * 128 + 128 + 3 * (128 * 128 + 128) + 129
    hi = chip_smoke._bound(chip_smoke._integral_work(b, m, nx, False,
                                                     neurons, n_w,
                                                     "highest"))
    x3 = chip_smoke._bound(chip_smoke._integral_work(b, m, nx, False,
                                                     neurons, n_w,
                                                     "bf16x3"))
    assert hi[2] == x3[2] == "TENSOR"
    assert hi[0] == pytest.approx(2 * x3[0])
