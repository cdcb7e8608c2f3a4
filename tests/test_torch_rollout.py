"""The port's Brownian path rollout (``ops/rollout.py``) and the rollout
kernel's plain version against the JAX package's ``ops/rollout.py``.

Both sides get the same increments: the test recreates JAX's closed-form
draw ``jax.random.normal(key, (K, B, nx))`` and hands it to the port. On the
CPU JAX's ``_paths_pallas`` takes the closed form with the same key, so the
draw is the same for ``use_pallas`` False and True. xs is x0 + a cumulative
sum of f32 steps on both sides, in the same order: rtol = atol = 1e-6.
An equation that overrides ``transition`` takes the sequential loop, whose
draws come from different generators on the two sides: its law is checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.ops.rollout import (
    brownian_paths as jax_brownian_paths,
)
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.ops import rollout

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(b=16, nx=5, K=6, dt=0.05, seed=0):
    """t0 in [0, 1): the rows with t0 + K dt > T take the tail-shrunk step,
    as the D-DBSDE baseline makes them."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.0, 1.0, size=(b, 1)).astype(np.float32)
    x0 = rng.normal(size=(b, nx)).astype(np.float32)
    dts = np.where(t0 + K * dt <= 1.0, np.float32(dt),
                   (1.0 - t0) / K).astype(np.float32)
    assert (dts < dt).any() and (dts == np.float32(dt)).any()
    return t0, x0, dts


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paths_match_jax_on_the_same_draws(use_pallas):
    b, nx, K, alpha = 16, 5, 6, 1.3
    t0, x0, dts = _inputs(b, nx, K)
    key = jax.random.PRNGKey(3)
    jeq = jax_make_equation("Cha", nx=nx, alpha=alpha, k=1.0, T=1.0)
    jts, jxs, jxi = jax_brownian_paths(key, jeq, jnp.asarray(t0),
                                       jnp.asarray(x0), jnp.asarray(dts), K,
                                       use_pallas=use_pallas)
    xi = np.array(jax.random.normal(key, (K, b, nx), jnp.float32))
    np.testing.assert_array_equal(np.asarray(jxi), xi)  # the recreated draw

    teq = make_equation("Cha", nx=nx, alpha=alpha, k=1.0, T=1.0)
    ts, xs, txi = rollout.brownian_paths(
        None, teq, torch.from_numpy(t0), torch.from_numpy(x0),
        torch.from_numpy(dts), K, xi=torch.from_numpy(xi))
    assert ts.shape == (K + 1, b, 1) and xs.shape == (K + 1, b, nx)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), **TOL)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **TOL)
    np.testing.assert_array_equal(txi.numpy(), xi)
    # the kernel's plain version on the same draws
    pxs, _ = kernels.paths_plain(0, torch.from_numpy(x0),
                                 torch.from_numpy(np.sqrt(dts)),
                                 teq.alpha_sqrt, K, torch.from_numpy(xi))
    np.testing.assert_allclose(pxs.numpy(), np.asarray(jxs), **TOL)


def test_use_pallas_on_cpu_takes_the_kernels_plain_version():
    """On CPU tensors ``use_pallas`` reaches ``paths_cuda``, which takes the
    plain version with a torch.Generator seeded by the kernel's seed; no
    launch is counted."""
    b, nx, K = 8, 3, 5
    t0, x0, dts = (torch.from_numpy(a) for a in _inputs(b, nx, K))
    eq = make_equation("Cha", nx=nx, alpha=2.0, k=1.0, T=1.0)
    n0 = kernels.ROLLOUT.launches
    _, xs, xi = rollout.brownian_paths(None, eq, t0, x0, dts, K,
                                       use_pallas=True, seed=77)
    assert kernels.ROLLOUT.launches == n0
    ref_xs, ref_xi = kernels.paths_plain(77, x0, dts.sqrt(), eq.alpha_sqrt,
                                         K)
    assert torch.equal(xs, ref_xs) and torch.equal(xi, ref_xi)
    # the closed form with a generator of the same seed draws the same
    g = torch.Generator().manual_seed(77)
    _, xs2, _ = rollout.brownian_paths(g, eq, t0, x0, dts, K)
    assert torch.equal(xs2, xs)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_increment_relation_and_time_grid(use_pallas):
    """X_{k+1} - X_k = sqrt(dt) sqrt(alpha) xi_k and ts = t0 + k dts, as
    the JAX package's tests/test_rollout.py asks of its rollout."""
    b, nx, K = 32, 4, 7
    t0, x0, dts = (torch.from_numpy(a) for a in _inputs(b, nx, K, 0.05, 1))
    eq = make_equation("Cha", nx=nx, alpha=1.3, k=1.0, T=1.0)
    ts, xs, xi = rollout.brownian_paths(torch.Generator().manual_seed(1),
                                        eq, t0, x0, dts, K,
                                        use_pallas=use_pallas, seed=5)
    torch.testing.assert_close(ts[3], t0 + 3 * dts, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(xs[1:] - xs[:-1],
                               dts.sqrt()[None] * eq.alpha_sqrt * xi,
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(xs[0], x0)


def test_fallback_for_an_overridden_transition():
    """An equation that overrides transition (here a drift) takes the
    sequential loop through its own law, also under use_pallas: the drift
    shows, E[x_K - x_0] = K dt 1.5, on both sides (the JAX package's
    tests/test_rollout.py:47-66)."""
    b, nx, K, dt = 8, 3, 4, 0.1

    teq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)

    class Drifted(type(teq)):
        def transition(self, generator, t, s, x):
            dw = torch.randn(x.shape, generator=generator, dtype=x.dtype)
            return x + (s - t) * 1.5 + torch.sqrt(s - t) * dw, dw

    eq2 = Drifted(**{f: getattr(teq, f)
                     for f in teq.__dataclass_fields__})
    assert not rollout.uses_base_transition(eq2)
    assert rollout.uses_base_transition(teq)
    g = torch.Generator().manual_seed(9)
    t0 = torch.rand((b, 1), generator=g) * 0.5
    x0 = torch.randn((b, nx), generator=g)
    dts = torch.full_like(t0, dt)
    n0 = kernels.ROLLOUT.launches
    for use_pallas in (False, True):
        ts, xs, xi = rollout.brownian_paths(g, eq2, t0, x0, dts, K,
                                            use_pallas=use_pallas)
        assert xs.shape == (K + 1, b, nx) and xi.shape == (K, b, nx)
        drift = float((xs[-1] - xs[0]).mean())
        assert abs(drift - K * dt * 1.5) < 0.25, drift
        torch.testing.assert_close(xs[1:] - xs[:-1],
                                   dts[None] * 1.5 + dts.sqrt()[None] * xi,
                                   rtol=1e-5, atol=1e-6)
    assert kernels.ROLLOUT.launches == n0

    # the JAX package's fallback shows the same drift
    jeq = jax_make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)

    class JaxDrifted(type(jeq)):
        def transition(self, k, t, s, x):
            dw = jax.random.normal(k, x.shape, x.dtype)
            return x + (s - t) * 1.5 + jnp.sqrt(s - t) * dw, dw

    jeq2 = JaxDrifted(**{f: getattr(jeq, f)
                         for f in jeq.__dataclass_fields__})
    _, jxs, _ = jax_brownian_paths(jax.random.PRNGKey(9), jeq2,
                                   jnp.asarray(t0.numpy()),
                                   jnp.asarray(x0.numpy()),
                                   jnp.asarray(dts.numpy()), K)
    jdrift = float(jnp.mean(jxs[-1] - jxs[0]))
    assert abs(jdrift - K * dt * 1.5) < 0.25, jdrift


def test_closed_form_law_of_the_endpoint():
    """X_K ~ N(x0, alpha K dt I): the closed form's endpoint moments within
    CLT bounds, as for the JAX package's closed form."""
    b, nx, K, dt = 4096, 3, 10, 0.02
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    t0 = torch.zeros((b, 1))
    _, xs, _ = rollout.brownian_paths(torch.Generator().manual_seed(2), eq,
                                      t0, torch.zeros((b, nx)),
                                      torch.full_like(t0, dt), K)
    xk = xs[-1].double()
    var = K * dt
    assert abs(float(xk.mean())) < 4 * (var / (b * nx)) ** 0.5
    np.testing.assert_allclose(float(xk.var()), var, rtol=0.15)
