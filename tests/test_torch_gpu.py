"""The CUDA estimator kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA card with nvcc (sm_90a); elsewhere they skip.
They import neither JAX nor the JAX package, so they run where only torch
is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import pytest
import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

# FP32 sums over M samples in another order than the plain version's
# (sequential FMA in the kernel, pairwise in torch): a few 1e-6 here.
RTOL = ATOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(cuda, b, m, nx=100, net=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    if net:
        mod = MLP(1 + nx, (128,) * 4, ("ELU",) * 4, 1, generator=g).to(cuda)
        sol = Solution.from_net(mod, "Value", nx)
    else:
        sol = Solution.zero(nx)
    t = torch.rand((b, 1), generator=g) * 0.99
    x = torch.randn((b, nx), generator=g) * t.sqrt()
    tx = torch.cat([t, x], 1).to(cuda)
    u01 = torch.rand((b, m, 1), generator=g).to(cuda)
    nt = torch.randn((b, m, nx), generator=g).to(cuda)
    ni = torch.randn((b, m, nx), generator=g).to(cuda)
    return eq, sol, tx, u01, nt, ni


@pytest.mark.parametrize("net,m,nx", [(False, 64, 100), (True, 64, 100),
                                      (True, 50, 100), (True, 70, 7)])
def test_kernel_matches_plain_on_external_noise(cuda, net, m, nx):
    eq, sol, tx, u01, nt, ni = _problem(cuda, 16, m, nx, net)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_inkernel_philox_within_clt_bounds(cuda):
    """In-kernel normals vs torch.Generator normals: each of the 1 + nx
    means within 5 standard errors of the difference."""
    b, m = 32, 4096
    eq, sol, tx, *_ = _problem(cuda, b, m)
    out = kernels.generate_with_gradients_cuda(1234, eq, sol, tx, m)
    again = kernels.generate_with_gradients_cuda(1234, eq, sol, tx, m)
    other = kernels.generate_with_gradients_cuda(1235, eq, sol, tx, m)
    ref, var = kernels.generate_with_gradients_plain(99, eq, sol, tx, m,
                                                     return_var=True)
    assert torch.equal(out, again)  # deterministic for a fixed seed
    assert not torch.equal(out, other)
    z = (out - ref) / torch.sqrt(2.0 * var / m).clamp(min=1e-12)
    assert torch.isfinite(out).all()
    assert float(z.abs().max()) < 5.0, float(z.abs().max())


def test_launch_counter_and_dispatcher(cuda):
    eq, sol, tx, *_ = _problem(cuda, 8, 32)
    n0 = kernels.GENERATE.launches
    gen = est.GenConfig(n_estimate_terminal=32, n_estimate_integral=32)
    out = est.generate_with_gradients(5, eq, sol, tx, gen)
    assert kernels.GENERATE.launches == n0 + 1
    assert out.shape == (8, 101) and out.is_cuda
    tanh = Solution.from_net(
        MLP(101, (128,), ("Tanh",), 1).to(cuda), "Value", 100)
    with pytest.raises(NotImplementedError):
        est.generate_with_gradients(5, eq, tanh, tx, gen)
    assert kernels.GENERATE.launches == n0 + 1
