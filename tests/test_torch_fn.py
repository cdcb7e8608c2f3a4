"""The fully nonlinear (FN) family against the JAX package, on the CPU:
GBMEquationComplexExact, the Hessian machinery of ``ops/derivatives.py``,
SDGD in the chunk estimators, EVAL.TEST_HESSIAN and the DBDP baseline.

Tolerances, each with its reason:
* jax's threefry normal and GBM's w and v: bit for bit (the same integer
  arithmetic, and replicas of XLA's CPU log, log1p and erfinv);
* the equation's closed forms: rtol 1e-5, atol 1e-5 (f32 products and sums
  over nx in another order);
* the Hessian chain in f32 and the nonlinearity: rtol 1e-5, atol 2e-5
  (products and sums reassociated through a few layers);
* the chain under HESSIAN_STORE bf16: one bf16 ulp, 2^-8, per element of
  the stored blocks. Both packages round the same f32 blocks to bf16 at the
  same places, and an f32 value an ulp apart on the two sides can round to
  neighbouring bf16 values: a block entry then moves by one bf16 ulp, and
  an output element by 2^-8 of that entry's share of it. So each output
  element is held within 2^-8 (|value| + S), S its sum of the magnitudes
  of the last stored block's contributions (``_bf16_slack``), which is
  more than 2^-8 |value| where the contributions cancel;
* the estimators on the same draws: rtol 5e-5, atol 1e-5 of the outputs'
  largest magnitude (sums over M in another order, weighted by
  1 / sqrt(s - t)); on their own draws (threefry against torch.Generator):
  5 standard errors per output, from replicates;
* the slice (targets -> Adam steps -> eval): rtol 1e-4, atol 1e-5, as
  tests/test_torch_hjb.py;
* DBDP (loss, gradients, Adam steps, the whole sweep): rtol 1e-4, atol
  1e-5 (losses through a per-sample Jacobian of the gradient net, then
  Adam's normalised steps).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppicarditeration_tpu.config import default_cfg as jax_default_cfg
from deeppicarditeration_tpu.config import load_cfg as jax_load_cfg
from deeppicarditeration_tpu.equations import (
    make_equation as jax_make_equation,
)
from deeppicarditeration_tpu.evaluation import evaluator as jax_evaluator
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops import derivatives as jd
from deeppicarditeration_tpu.ops import estimators as jest
from deeppicarditeration_tpu.training import baselines as jax_baselines
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.training import trainer as jax_trainer
from deeppicarditeration_tpu.training.picard import (
    PicardRunner as JaxPicardRunner,
    gen_config_from_cfg as jax_gen_config_from_cfg,
)
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.config import default_cfg, load_cfg
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import make_traced_eval
from deeppicarditeration_torch.models.convert import (
    dbdp_pair_state_dicts_from_flax,
    mlp_state_dict_from_flax,
)
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import derivatives as td
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels, threefry
from deeppicarditeration_torch.training import baselines, checkpoint, trainer
from deeppicarditeration_torch.training.picard import (
    PicardRunner,
    gen_config_from_cfg,
)

torch.set_num_threads(1)

EQ_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_REL = 2.0 ** -8
EST_RTOL, EST_ATOL_OF_MAX = 5e-5, 1e-5
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)
DBDP_TOL = dict(rtol=1e-4, atol=1e-5)


def T_(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _gbm(nx=6, seed=3, **kw):
    return (jax_make_equation("GBMEquationComplexExact", nx=nx, seed=seed,
                              **kw),
            make_equation("GBMEquationComplexExact", nx=nx, seed=seed, **kw))


def _points(seed, shape, nx, scale=1.0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.0, shape + (1,)).astype(np.float32)
    x = (scale * rng.normal(size=shape + (nx,))).astype(np.float32)
    return t, x


def _mlp_pair(in_dim, neurons, out_dim=1, seed=0, jitter=0.3, acts=None):
    """A flax MLP (params jittered off the zero biases) and the port's MLP
    on the same weights."""
    acts = acts or ("ELU",) * len(neurons)
    jm = JaxMLP(neurons=tuple(neurons), activations=tuple(acts),
                out_dim=out_dim)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))
    leaves, tdef = jax.tree_util.tree_flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(leaves))
    p = jax.tree_util.tree_unflatten(tdef, [
        a + jitter * jax.random.normal(k, a.shape)
        for a, k in zip(leaves, keys)])
    tm = MLP(in_dim, tuple(neurons), tuple(acts), out_dim)
    tm.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, p)))
    return jm, p, tm


def _bf16_slack(js, t, x, full=False):
    """2^-8 (|value| + S) per output element of the bf16 chain's diagonal
    (or full Hessian): S contracts the magnitudes of the last stored block
    G_{z_0} with |W1x| on both sides."""
    W1x, s1, _, G = jd._mlp_second_order(js, t, x, store="bf16")
    gz = jnp.abs(s1[:, :, None] * G.astype(jnp.float32) * s1[:, None, :])
    a = jnp.abs(W1x)
    if full:
        S = jnp.einsum("io,rol,jl->rij", a, gz, a)
        value = jd.full_hessian(js, t, x, store="bf16")
    else:
        S = jnp.einsum("io,rol,il->ri", a, gz, a)
        value = jd.mlp_hessian_diag(js, t, x, store="bf16")
    value = np.asarray(value)
    return BF16_REL * (np.abs(value) + np.asarray(S).reshape(value.shape))


def _assert_within(out, ref, slack):
    over = np.abs(np.asarray(out) - np.asarray(ref)) - slack
    assert over.max() <= 0.0, float(over.max())


def _sols(nx, neurons, seed=0):
    jm, p, tm = _mlp_pair(1 + nx, neurons, seed=seed)
    return (JaxSolution.from_net(jm, p, "Value", nx),
            Solution.from_net(tm, "Value", nx))


# ---------------------------------------------------------------------------
# threefry's normal and the GBM instance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (2, 101)), (3, (300001,)),
                                        (2 ** 32 + 7, (64, 33)),
                                        (12345, (1 << 18,))])
def test_threefry_normal_is_bit_equal_to_jax(seed, shape):
    key = threefry.fold_in(threefry.PRNGKey(seed), 99)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 99)
    a = threefry.normal(key, shape)
    b = np.asarray(jax.random.normal(jkey, shape))
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_xla_log_log1p_erfinv_replicas_are_bit_equal():
    rng = np.random.default_rng(0)
    x = (rng.uniform(0, 1, 200000) * 2.0 ** rng.integers(-30, 30, 200000)
         ).astype(np.float32)
    np.testing.assert_array_equal(_bits(threefry.xla_log_f32(x)),
                                  _bits(jnp.log(x)))
    y = rng.uniform(-0.9999, 3.0, 200000).astype(np.float32)
    np.testing.assert_array_equal(_bits(threefry.xla_log1p_f32(y)),
                                  _bits(jnp.log1p(y)))
    u = rng.uniform(-0.99999, 0.99999, 200000).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(threefry.xla_erfinv_f32(u)),
        _bits(jax.scipy.special.erfinv(jnp.asarray(u))))


@pytest.mark.parametrize("seed,nx,m", [(0, 100, 2), (3, 6, 2), (7, 1, 3)])
def test_gbm_w_and_v_are_bit_equal(seed, nx, m):
    jeq = jax_make_equation("GBMEquationComplexExact", nx=nx, seed=seed,
                            num_neurons=m)
    teq = make_equation("GBMEquationComplexExact", nx=nx, seed=seed,
                        num_neurons=m)
    np.testing.assert_array_equal(_bits(teq.w.numpy()), _bits(jeq.w))
    np.testing.assert_array_equal(_bits(teq.v.numpy()), _bits(jeq.v))
    assert teq.has_hessian_term and teq.has_exact_solution
    assert teq.supported_approximate_methods == ("SDGD",)


@pytest.mark.parametrize("fn", ["exact_solution", "u_t", "u_x", "u_u_x",
                                "u_hessian", "u_hessian_diag", "laplacian",
                                "g", "g_x", "ffi", "ffi_stats", "ffh",
                                "pinn_function", "u_u_x_u_hessian"])
def test_gbm_functions_match_jax(fn):
    jeq, teq = _gbm()
    t, x = _points(1, (16,), 6)
    rng = np.random.default_rng(2)
    y = rng.normal(size=(16, 1)).astype(np.float32)
    uii = rng.normal(size=(16, 4)).astype(np.float32)
    hess = rng.normal(size=(16, 6, 6)).astype(np.float32)
    m1, m2 = (rng.normal(size=(16, 1)).astype(np.float32) for _ in "ab")
    args = {"g": (x,), "g_x": (x,), "ffi": (t, x, y, uii),
            "ffi_stats": (t, x, y, m1, m2), "ffh": (t, x, y, x, hess),
            "pinn_function": (t, x, y, y, x, uii)}.get(fn, (t, x))
    out = getattr(teq, fn)(*(T_(a) for a in args))
    ref = getattr(jeq, fn)(*args)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **EQ_TOL)


def test_gbm_singleton_sample_dims_and_defaults():
    """ffi_stats evaluates its source once per point through singleton
    sample dims; the base class's autodiff u_hessian, u_t and laplacian
    agree with the closed forms; sample_x0 is zeros on the device asked
    for; OU's ffh is its ff."""
    from deeppicarditeration_torch.equations.base import EquationMethods

    jeq, teq = _gbm()
    t, x = _points(3, (4, 1), 6)
    m = np.random.default_rng(4).normal(size=(4, 5, 1)).astype(np.float32)
    np.testing.assert_allclose(
        teq.ffi_stats(T_(t), T_(x), None, T_(m), T_(m)).numpy(),
        np.asarray(jeq.ffi_stats(t, x, None, m, m)), **EQ_TOL)
    t2, x2 = _points(5, (8,), 6)
    for name in ("u_hessian", "u_t", "laplacian"):
        np.testing.assert_allclose(
            getattr(EquationMethods, name)(teq, T_(t2), T_(x2)).numpy(),
            getattr(teq, name)(T_(t2), T_(x2)).numpy(), **EQ_TOL)
    assert torch.equal(teq.sample_x0(None, 3, torch.float32, "cpu"),
                       torch.zeros(3, 6))
    ou = make_equation("OUProcessEquation", nx=4, num_components=2)
    w = torch.randn(5, 4)
    torch.testing.assert_close(
        ou.ffh(torch.rand(5, 1), w, torch.zeros(5, 1), w, None),
        ou.ff(torch.rand(5, 1) * 0, w, torch.zeros(5, 1), w))


# ---------------------------------------------------------------------------
# the Hessian machinery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [None, "bf16"])
@pytest.mark.parametrize("neurons", [(16,), (16, 12, 16)])
def test_mlp_hessian_diag_and_full_hessian_match_jax(store, neurons):
    nx = 5
    js, ts = _sols(nx, neurons)
    t, x = _points(6, (8, 3), nx)
    for name in ("mlp_hessian_diag", "full_hessian"):
        out = getattr(td, name)(ts, T_(t), T_(x), store=store).numpy()
        ref = np.asarray(getattr(jd, name)(js, t, x, store=store))
        assert out.shape == ref.shape
        if store is None or len(neurons) == 1:  # one layer: nothing stored
            np.testing.assert_allclose(out, ref, **NET_TOL)
        else:
            _assert_within(out, ref, _bf16_slack(
                js, t, x, full=name == "full_hessian"))


def test_bf16_store_rounds_where_jax_rounds():
    """The bf16 chain differs from the f32 chain by bf16 roundings (far
    more than the f32 tolerance), and the port's bf16 chain stays within
    one bf16 ulp of JAX's: the casts sit at the same places."""
    nx = 5
    js, ts = _sols(nx, (32, 32, 32), seed=4)
    t, x = _points(7, (64,), nx)
    f32 = td.mlp_hessian_diag(ts, T_(t), T_(x)).numpy()
    b16 = td.mlp_hessian_diag(ts, T_(t), T_(x), store="bf16").numpy()
    assert np.abs(f32 - b16).max() > 1e-4 * np.abs(f32).max()
    _assert_within(b16, jd.mlp_hessian_diag(js, t, x, store="bf16"),
                   _bf16_slack(js, t, x))


def test_generic_hessians_match_the_mlp_chain():
    """The torch.func fallbacks (a net that is not a plain MLP) give the
    second-order chain's values: full_hessian by vmap(hessian) and the
    per-index diagonal by jvps of the gradient."""
    nx = 4
    js, ts = _sols(nx, (16, 16))

    class Wrapped(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, tx):
            return self.inner(tx)

    tw = Solution.from_net(Wrapped(ts.module), "Value", nx)
    assert not td._mlp_fast_path(tw)
    t, x = _points(8, (6,), nx)
    np.testing.assert_allclose(td.full_hessian(tw, T_(t), T_(x)).numpy(),
                               np.asarray(jd.full_hessian(js, t, x)),
                               **NET_TOL)
    idx = np.random.default_rng(9).integers(0, nx, (6, 3)).astype(np.int32)
    np.testing.assert_allclose(
        td.diag_hessian_entries(tw, T_(t), T_(x), T_(idx)).numpy(),
        np.asarray(jd.diag_hessian_entries(js, t, x, jnp.asarray(idx))),
        **NET_TOL)


@pytest.mark.parametrize("v", [2, 12])
def test_diag_hessian_entries_counts_and_laplacians_match_jax(v):
    """v = 2 takes the per-index jvps (4 v < 16), v = 12 the full diagonal
    and a gather; the counts are exact; the exact Laplacian and Hutchinson
    on JAX's Rademacher probes."""
    nx = 5
    js, ts = _sols(nx, (16, 16))
    t, x = _points(10, (6, 2), nx)
    idx = np.random.default_rng(11).integers(0, nx, (6, 2, v)).astype(
        np.int32)
    np.testing.assert_allclose(
        td.diag_hessian_entries(ts, T_(t), T_(x), T_(idx)).numpy(),
        np.asarray(jd.diag_hessian_entries(js, t, x, jnp.asarray(idx))),
        **NET_TOL)
    np.testing.assert_array_equal(
        td.sdgd_index_counts(T_(idx), nx).numpy(),
        np.asarray(jd.sdgd_index_counts(jnp.asarray(idx), nx)))
    assert td.sdgd_index_counts(T_(idx), nx).sum(-1).eq(v).all()
    np.testing.assert_allclose(td.exact_laplacian(ts, T_(t), T_(x)).numpy(),
                               np.asarray(jd.exact_laplacian(js, t, x)),
                               **NET_TOL)
    key = jax.random.PRNGKey(12)
    probes = jax.vmap(lambda k: jax.random.rademacher(
        k, x.shape, dtype=jnp.int32).astype(jnp.float32))(
        jax.random.split(key, 3))
    np.testing.assert_allclose(
        td.hutchinson_laplacian(None, ts, T_(t), T_(x), 3,
                                probes=T_(probes)).numpy(),
        np.asarray(jd.hutchinson_laplacian(key, js, t, x, 3)), **NET_TOL)
    zero = Solution.zero(nx)
    assert not td.diag_hessian_entries(zero, T_(t), T_(x), T_(idx)).any()


@pytest.mark.parametrize("case", ["sdgd fast", "sdgd fast bf16",
                                  "sdgd entries", "full", "zero", "ou"])
def test_get_f_matches_jax(case):
    nx = 6
    if case == "ou":
        jeq = jax_make_equation("OUProcessEquation", nx=nx, num_components=2)
        teq = make_equation("OUProcessEquation", nx=nx, num_components=2)
    else:
        jeq, teq = _gbm(nx)
    js, ts = _sols(nx, (16, 16))
    if case == "zero":
        js, ts = JaxSolution.zero(nx), Solution.zero(nx)
    t, x = _points(13, (5, 4), nx)
    v = 2 if case == "sdgd entries" else 6
    idx = np.random.default_rng(14).integers(0, nx, (5, 4, v)).astype(
        np.int32)
    kw, tkw = {}, {}
    if case.startswith("sdgd") or case == "zero":
        kw["hess_indices"], tkw["hess_indices"] = jnp.asarray(idx), T_(idx)
    if case.endswith("bf16"):
        kw["hess_store"] = tkw["hess_store"] = "bf16"
    out = td.get_f(teq, ts, T_(t), T_(x), **tkw).numpy()
    ref = np.asarray(jd.get_f(jeq, js, t, x, **kw))
    assert out.shape == ref.shape == (5, 4, 1)
    if case.endswith("bf16"):
        # f = d/4 mean_k |diag_{i_k}| - source (alpha = 1): within d/4 of
        # the sampled entries' mean slack
        slack = _bf16_slack(js, t, x)
        c = np.asarray(jd.sdgd_index_counts(jnp.asarray(idx), nx))
        bound = 0.25 * nx * np.sum(c * slack, -1, keepdims=True) / v
        _assert_within(out, ref, bound + 1e-5 * (1 + np.abs(ref)))
    else:
        np.testing.assert_allclose(out, ref, **NET_TOL)


# ---------------------------------------------------------------------------
# SDGD in the chunk estimators
# ---------------------------------------------------------------------------

def _fixed_draws(seed, b, m, nx, v):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, m, 1)).astype(np.float32),
            rng.normal(size=(b, m, nx)).astype(np.float32),
            rng.normal(size=(b, m, nx)).astype(np.float32),
            rng.integers(0, nx, (b, m, v)).astype(np.int32))


def _jax_targets_on(monkeypatch, jeq, jsol, tx, gen, u01, nt, ni, idx):
    """The JAX package's split estimators, their draw functions swapped for
    the given draws (one chunk of all M samples)."""
    b, m = u01.shape[:2]
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, *a, **k):
        if tuple(shape) == (b, m, 1):
            return jnp.asarray(u01)
        return uniform(key, shape, dtype, *a, **k)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jest, "_sdgd_indices",
                        lambda key, shape, nx: jnp.asarray(idx))
    monkeypatch.setattr(jest, "_draw_increments",
                        lambda *a: jnp.asarray(nt))
    g = jest.estimate_terminal_with_gradients(jax.random.PRNGKey(0), jeq,
                                              jnp.asarray(tx), gen)
    monkeypatch.setattr(jest, "_draw_increments",
                        lambda *a: jnp.asarray(ni))
    y = jest.estimate_integral_with_gradients(jax.random.PRNGKey(1), jeq,
                                              jsol, jnp.asarray(tx), gen)
    monkeypatch.undo()
    return np.asarray(g), np.asarray(y)


def _close_to(out, ref):
    np.testing.assert_allclose(
        out, ref, rtol=EST_RTOL,
        atol=EST_ATOL_OF_MAX * float(np.abs(ref).max()))


@pytest.mark.parametrize("net,store", [(False, None), (True, None),
                                       (True, "bf16")])
def test_sdgd_estimators_match_jax_on_the_same_draws(monkeypatch, net,
                                                     store):
    """The port's chunk estimators (4 chunks, the draws injected) against
    the JAX package's (one chunk, its draw functions swapped for the same
    draws): the terminal with GBM's g, the SDGD integral with the
    per-sample baseline on each sample's index subset."""
    nx, b, m, v = 5, 8, 16, 5
    jeq, teq = _gbm(nx)
    js, ts = _sols(nx, (16, 16)) if net else (JaxSolution.zero(nx),
                                              Solution.zero(nx))
    t, x = _points(15, (b,), nx, 0.5)
    tx = np.concatenate([t * 0.98, x], 1)
    u01, nt, ni, idx = _fixed_draws(16, b, m, nx, v)
    jgen = jest.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                          chunk_elems=10 ** 6, sdgd_v=v, hess_store=store)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=b * nx * m // 4, sdgd_v=v,
                        hess_store=store)
    assert jgen.chunk(m, b, nx) == m and gen.chunk(m, b, nx) == m // 4
    jg, jy = _jax_targets_on(monkeypatch, jeq, js, tx, jgen, u01, nt, ni,
                             idx)
    g = est.estimate_terminal_with_gradients(0, teq, T_(tx), gen, T_(nt))
    y = est.estimate_integral_with_gradients(0, teq, ts, T_(tx), gen,
                                             T_(u01), T_(ni), T_(idx))
    _close_to(g.numpy(), jg)
    _close_to(y.numpy(), jy)


def test_sdgd_integral_agrees_with_jax_within_clt():
    """Own draws (torch.Generator indices, times and normals) against the
    JAX XLA estimator (threefry): each output within 5 standard errors of
    the difference, the errors from 24 replicates of each point."""
    nx, b, m, v, reps = 4, 6, 64, 4, 24
    jeq, teq = _gbm(nx)
    js, ts = _sols(nx, (16, 16))
    t, x = _points(17, (b,), nx, 0.5)
    tx = np.tile(np.concatenate([t * 0.98, x], 1), (reps, 1))
    kw = dict(n_estimate_terminal=m, n_estimate_integral=m,
              chunk_elems=2 ** 16, sdgd_v=v)
    ref = np.asarray(jest.estimate_integral_with_gradients(
        jax.random.PRNGKey(5), jeq, js, jnp.asarray(tx),
        jest.GenConfig(**kw))).reshape(reps, b, -1)
    out = est.estimate_integral_with_gradients(
        7, teq, ts, T_(tx), est.GenConfig(**kw)).numpy().reshape(reps, b, -1)
    se = np.sqrt((out.var(0, ddof=1) + ref.var(0, ddof=1)) / reps)
    z = (out.mean(0) - ref.mean(0)) / np.maximum(se, 1e-12)
    assert np.isfinite(out).all()
    assert np.abs(z).max() < 5.0, np.abs(z).max()
    assert 0.3 < float((z * z).mean()) < 3.0


def test_fn_routes_split_and_reads_the_config():
    """Hessian equations take the split route whatever PALLAS_GENERATE
    says; the runner's GenConfig reads SDGD's v and HESSIAN_STORE as the
    JAX runner does, with its checks; SUPERVISE_HESSIAN still raises."""
    nx = 100
    _, teq = _gbm(nx)
    sol = Solution.from_net(MLP(1 + nx, (64,) * 3, ("ELU",) * 3, 1),
                            "Value", nx)
    for mode in (True, "auto", False):
        gen = est.GenConfig(n_estimate_terminal=64, n_estimate_integral=64,
                            pallas_generate=mode)
        assert est.generation_route(teq, sol, gen) == est.SPLIT
        assert est.generation_route(teq, Solution.zero(nx), gen) == est.SPLIT
    # PALLAS_INTEGRAL skips Hessian equations silently, as in JAX: the
    # chunk estimator's targets, draw for draw
    nx_s, m = 4, 8
    _, small = _gbm(nx_s)
    tx = torch.cat([torch.full((3, 1), 0.5), torch.zeros(3, nx_s)], 1)
    kw = dict(n_estimate_terminal=m, n_estimate_integral=m, sdgd_v=nx_s)
    zero = Solution.zero(nx_s)
    assert torch.equal(
        est.estimate_integral_with_gradients(
            3, small, zero, tx, est.GenConfig(pallas_integral=True, **kw)),
        est.estimate_integral_with_gradients(3, small, zero, tx,
                                             est.GenConfig(**kw)))
    yaml = "configs/fully_nonlinear/base_100d_T1.0_w0.0_nov.yaml"
    for ov in ([], ["DATA.TPU.HESSIAN_STORE", "null"]):
        gen = gen_config_from_cfg(load_cfg(yaml, ov))
        jgen = jax_gen_config_from_cfg(jax_load_cfg(yaml, ov), 1)
        assert (gen.sdgd_v, gen.hess_store) == (jgen.sdgd_v,
                                                jgen.hess_store)
    assert gen_config_from_cfg(load_cfg(yaml)).hess_store == "bf16"
    with pytest.raises(ValueError, match="HESSIAN_STORE"):
        gen_config_from_cfg(load_cfg(yaml, ["DATA.TPU.HESSIAN_STORE",
                                            "bf17"]))
    with pytest.raises(ValueError, match="kwargs.v"):
        gen_config_from_cfg(load_cfg(yaml, [
            "DATA.HESSIAN_APPROXIMATION.kwargs", "{}"]))
    with pytest.raises(NotImplementedError, match="SUPERVISE_HESSIAN"):
        PicardRunner(load_cfg(yaml, ["DEVICE", "cpu",
                                     "TRAIN.SUPERVISE_HESSIAN", "true"]))


# ---------------------------------------------------------------------------
# EVAL.TEST_HESSIAN
# ---------------------------------------------------------------------------

def test_hessian_eval_metrics_match_jax():
    nx, n = 5, 64
    jeq, teq = _gbm(nx)
    js, ts = _sols(nx, (16, 16, 16))
    te = np.linspace(0, 1, n, dtype=np.float32)[:, None]
    xe = (np.random.default_rng(18).normal(size=(n, nx)) * te).astype(
        np.float32)
    cat = jax_evaluator._eval_batch_fn(True, True)(js, jeq, te, xe)
    jnames, jvals = jax_evaluator._eval_metrics_fn(True, True)(cat)
    names, fn = make_traced_eval(True, True)
    vals = fn(ts, teq, T_(te), T_(xe))
    assert names == list(jnames)
    assert {"rRMSEh", "MSEh", "rMAEh", "MArEh"} <= set(names)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **SLICE_TOL)
    assert make_traced_eval(False, True)[0] == make_traced_eval(False,
                                                                False)[0]


# ---------------------------------------------------------------------------
# the slice as a whole: targets -> Adam steps -> eval with Hessian metrics
# ---------------------------------------------------------------------------

def test_fn_slice_targets_fit_and_eval_match_jax(monkeypatch):
    nx, b, m, v, bs, n_steps, lr = 4, 32, 16, 4, 8, 4, 1e-3
    jeq, teq = _gbm(nx)
    jfrozen, tfrozen = _sols(nx, (16, 16), seed=1)
    jm, p_fit, tmod = _mlp_pair(1 + nx, (16, 16), seed=2, jitter=0.0)
    t, x = _points(19, (b,), nx, 0.5)
    tx = np.concatenate([t * 0.98, x], 1)
    u01, nt, ni, idx = _fixed_draws(20, b, m, nx, v)
    kw = dict(n_estimate_terminal=m, n_estimate_integral=m, sdgd_v=v,
              hess_store="bf16")

    # 1. targets (the split route, bf16 Hessian store)
    jg, jy = _jax_targets_on(monkeypatch, jeq, jfrozen, tx,
                             jest.GenConfig(chunk_elems=10 ** 6, **kw),
                             u01, nt, ni, idx)
    gen = est.GenConfig(chunk_elems=b * nx * m // 2, **kw)
    y_t = (est.estimate_terminal_with_gradients(0, teq, T_(tx), gen, T_(nt))
           + est.estimate_integral_with_gradients(0, teq, tfrozen, T_(tx),
                                                  gen, T_(u01), T_(ni),
                                                  T_(idx)))
    y = jg + jy
    _close_to(y_t.numpy(), y)

    # 2. Adam steps on a fixed batch order (the recipe's loss: the value
    # alone, FixedLossScaler at weight 0.0)
    spec_kw = dict(nx=nx, supervise_gradient=True,
                   scaler_cls="FixedLossScaler",
                   scaler_kwargs=(("fixed_weight", 0.0),))
    jspec, tspec = (jax_trainer.TrainSpec(**spec_kw),
                    trainer.TrainSpec(**spec_kw))
    opt = optax.adam(lr)
    state, params = opt.init(p_fit), p_fit
    topt = trainer.make_optimizer({"cls": "Adam", "kwargs": {"lr": lr}},
                                  tmod.parameters())
    order = np.random.default_rng(21).permutation(b)
    loss_grad = jax.jit(jax.grad(lambda p, a, c: jax_trainer.compute_loss(
        jm, p, a, c, jspec)[0]))
    for s in range(n_steps):
        sel = order[s * bs:(s + 1) * bs]
        grads = loss_grad(params, tx[sel], y[sel])
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        trainer.train_step(tmod, topt, T_(tx[sel]), T_(y[sel]), tspec)
    ref = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params))
    for name, p in tmod.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), **SLICE_TOL)

    # 3. the eval with Hessian metrics on fixed points
    te = np.linspace(0, 1, 48, dtype=np.float32)[:, None]
    xe = (np.random.default_rng(22).normal(size=(48, nx)) * te).astype(
        np.float32)
    jsol = JaxSolution.from_net(jm, params, "Value", nx)
    cat = jax_evaluator._eval_batch_fn(True, True)(jsol, jeq, te, xe)
    _, jvals = jax_evaluator._eval_metrics_fn(True, True)(cat)
    _, fn = make_traced_eval(True, True)
    vals = fn(Solution.from_net(tmod, "Value", nx), teq, T_(te), T_(xe))
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(jvals),
                               **SLICE_TOL)


# ---------------------------------------------------------------------------
# DBDP
# ---------------------------------------------------------------------------

DBDP_NX, DBDP_T, DBDP_DT, DBDP_BS, DBDP_SUB = 3, 0.2, 0.05, 16, 3
DBDP_K = round(DBDP_T / DBDP_DT)
DBDP_TINY = {
    "NAME": "dbdp_tiny", "FORCE": True,
    "EQUATION": {"cls": "GBMEquationComplexExact",
                 "kwargs": {"nx": DBDP_NX, "alpha": 1.0, "T": DBDP_T}},
    "METHOD": {"cls": "FullyNonlinearSolver", "dt": DBDP_DT,
               "num_sub_iter": DBDP_SUB},
    "PICARD": {"N": 1},
    "TRAIN": {"BATCH_SIZE": DBDP_BS, "N_EPOCHS": 2},
    "NETWORK": {"NEURONS": [16, 16], "ACTIVATIONS": ["ELU", "ELU"]},
    "EVAL": {"FREQ": 1},
}


def _jax_dbdp_loss(eq, u_mod, g_mod, pair_prev, pair_next, t_prev, t_next,
                   x, x_next, dW, is_last, enforce, dt):
    """one_step_loss of the JAX package's train_dbdp
    (deeppicarditeration_tpu/training/baselines.py:271-295), written from
    its flax modules and equation."""
    def u_at(p, tk, xx):
        return eq.g(xx) + (eq.T - tk) * u_mod.apply(p, xx)

    def ux_at(p, tk, xx):
        return eq.g_x(xx) + (eq.T - tk) * g_mod.apply(p, xx)

    (up, gp), (un, gn) = pair_prev, pair_next
    u, u_x = u_at(up, t_prev, x), ux_at(gp, t_prev, x)
    if enforce:
        u_next = jnp.where(is_last, eq.g(x_next), u_at(un, t_next, x_next))
    else:
        u_next = u_at(un, t_next, x_next)

    def gnet(xx):
        if enforce:
            return jnp.where(is_last, eq.g_x(xx[None])[0],
                             ux_at(gn, t_next, xx[None])[0])
        return ux_at(gn, t_next, xx[None])[0]

    hess = jax.vmap(jax.jacrev(gnet))(x_next)
    f_hat = eq.ffh(t_prev, x, u, u_x, jax.lax.stop_gradient(hess))
    F = u - f_hat * dt + jnp.sum(u_x * eq.alpha_sqrt * dW, axis=-1,
                                 keepdims=True)
    return jnp.mean((jax.lax.stop_gradient(u_next) - F) ** 2)


def _dbdp_pairs(nx, neurons, seeds):
    """JAX (u_mod, g_mod, [pairs]) and the port's pairs on the same
    weights."""
    jpairs, tpairs = [], []
    for s in seeds:
        ju, pu, tu = _mlp_pair(nx, neurons, 1, seed=s, jitter=0.1)
        jg, pg, tg = _mlp_pair(nx, neurons, nx, seed=s + 50, jitter=0.1)
        jpairs.append((pu, pg))
        tpairs.append((tu, tg))
    return ju, jg, jpairs, tpairs


@pytest.mark.parametrize("is_last,enforce", [(False, False), (True, False),
                                             (True, True)])
def test_dbdp_one_step_loss_gradients_and_adam_step_match_jax(is_last,
                                                              enforce):
    nx, bs, dt = 4, 16, 0.05
    jeq, teq = _gbm(nx, T=0.2)
    ju, jg, jpairs, tpairs = _dbdp_pairs(nx, (16, 16), (30, 31))
    rng = np.random.default_rng(23)
    x = rng.normal(size=(bs, nx)).astype(np.float32) * 0.3
    dW = (rng.normal(size=(bs, nx)) * np.sqrt(dt)).astype(np.float32)
    x_next = x + dW
    tp = np.full((bs, 1), 0.1, np.float32)
    tn = np.full((bs, 1), 0.15, np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_dbdp_loss(jeq, ju, jg, p, jpairs[1], tp, tn, x,
                                 x_next, dW, is_last, enforce, dt))(
        jpairs[0])
    loss = baselines.dbdp_loss(teq, tpairs[0], tpairs[1], T_(tp), T_(tn),
                               T_(x), T_(x_next), T_(dW), is_last, enforce,
                               dt)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **DBDP_TOL)
    params = [p for m in tpairs[0] for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=baselines.BASELINE_LR)
    opt.zero_grad()
    loss.backward()
    for mod, g in zip(tpairs[0], jgrads):
        want = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               g))
        for name, p in mod.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6)
    jopt = optax.adam(1e-3)
    upd, _ = jopt.update(jgrads, jopt.init(jpairs[0]), jpairs[0])
    after = optax.apply_updates(jpairs[0], upd)
    opt.step()
    for mod, p in zip(tpairs[0], after):
        want = mlp_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               p))
        for name, q in mod.state_dict().items():
            np.testing.assert_allclose(q.numpy(), want[name].numpy(),
                                       **DBDP_TOL)
    # the next pair is held fixed: no gradient reaches it
    assert all(p.grad is None for m in tpairs[1] for p in m.parameters())


def _jax_dbdp_draws(cfg, jeq):
    """The JAX run's path draws in the order train_dbdp takes them: per
    epoch the terminal pre-fit's sub-iterations, then k = K .. 1 (its key
    tree: fold_in(key_iter, 31 + epoch), fold_in(., k), fold_in(., it))."""
    key_iter = jax.random.fold_in(jax.random.PRNGKey(int(cfg.SEED)), 1)
    out = []

    def draw(k):
        xi = jax.random.normal(jax.random.fold_in(k, 1),
                               (DBDP_K, DBDP_BS, DBDP_NX), jnp.float32)
        return np.asarray(xi)

    for epoch in range(int(cfg.TRAIN.N_EPOCHS)):
        kep = jax.random.fold_in(key_iter, 31 + epoch)
        out += [draw(jax.random.fold_in(kep, it)) for it in range(DBDP_SUB)]
        for kk in range(DBDP_K, 0, -1):
            kkk = jax.random.fold_in(kep, kk)
            out += [draw(jax.random.fold_in(kkk, it))
                    for it in range(DBDP_SUB)]
    return key_iter, out


def test_dbdp_sweep_matches_the_jax_run(tmp_path, monkeypatch):
    """Two epochs of the whole DBDP sweep (terminal pre-fit, is_last, warm
    starts, one Adam per pair kept across epochs) through both runners,
    the port fed the JAX run's initial pairs and path draws: every logged
    loss and the final stacked nets agree."""
    cfg = jax_default_cfg()
    cfg.merge(DBDP_TINY)
    jrunner = JaxPicardRunner(cfg, exp_root=tmp_path / "jax")
    jrunner.run_one()
    jax_ckpt.wait_all()
    jeq = jrunner.equation
    key_iter, draws = _jax_dbdp_draws(cfg, jeq)
    u_mod, g_mod = jax_baselines._dbdp_modules(cfg, jeq)
    init = []
    for kk in range(DBDP_K + 1):
        ku, kg = jax.random.split(jax.random.fold_in(key_iter, 1000 + kk))
        init.append((u_mod.init(ku, jnp.zeros((1, DBDP_NX))),
                     g_mod.init(kg, jnp.zeros((1, DBDP_NX)))))
    stacked0 = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *init)
    final = jax_ckpt.load_params(jax_ckpt.ckpt_path(jrunner.exp_dir, 1),
                                 stacked0)
    jrows = [json.loads(ln) for ln in (jrunner.exp_dir / "metrics.jsonl")
             .read_text().splitlines()]

    pairs = iter(dbdp_pair_state_dicts_from_flax(
        jax.tree_util.tree_map(np.asarray, stacked0)))
    build = baselines.build_dbdp_pair

    def build_from_jax(*a, **k):
        u, g = build(*a, **k)
        us, gs = next(pairs)
        u.load_state_dict(us)
        g.load_state_dict(gs)
        return u, g

    queue = iter(draws)

    def jax_paths(generator, eq, t0, x0, dts, K, use_pallas=False, seed=0,
                  xi=None, out=None):
        xi = T_(next(queue))
        xs, _ = kernels.paths_plain(0, x0, torch.sqrt(dts), eq.alpha_sqrt,
                                    K, xi)
        out[0].copy_(xs)
        out[1].copy_(xi)
        return None, out[0], out[1]

    monkeypatch.setattr(baselines, "build_dbdp_pair", build_from_jax)
    monkeypatch.setattr(baselines, "brownian_paths", jax_paths)
    tcfg = default_cfg()
    tcfg.merge(DBDP_TINY)
    tcfg.merge({"DEVICE": "cpu"})
    runner = PicardRunner(tcfg.freeze(), exp_root=tmp_path / "torch")
    runner.run()
    assert next(queue, None) is None
    n_roll = 2 * (DBDP_K + 1) * DBDP_SUB
    assert runner.rollout_calls == n_roll
    rows = [json.loads(ln) for ln in (runner.exp_dir / "metrics.jsonl")
            .read_text().splitlines()]
    jl = [r["loss"] for r in jrows if r["context"] == "dbdp"]
    tl = [r["loss"] for r in rows if r["context"] == "dbdp"]
    assert len(tl) == len(jl) == 2 * DBDP_K
    assert [r["k"] for r in rows if r["context"] == "dbdp"] == [
        r["k"] for r in jrows if r["context"] == "dbdp"]
    np.testing.assert_allclose(tl, jl, **DBDP_TOL)
    nets = baselines.DBDPNets(build(tcfg, runner.equation, "cpu")
                              for _ in range(DBDP_K + 1))
    checkpoint.load_params(checkpoint.ckpt_path(runner.exp_dir, 1), nets)
    want = baselines.DBDPNets(build(tcfg, runner.equation, "cpu")
                              for _ in range(DBDP_K + 1))
    want.load_pairs(dbdp_pair_state_dicts_from_flax(
        jax.tree_util.tree_map(np.asarray, final)))
    for (name, a), b in zip(nets.state_dict().items(),
                            want.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **DBDP_TOL)
    assert [tm["k"] for tm in runner.timings][:DBDP_K + 1] == list(
        range(DBDP_K + 1, 0, -1))


def test_dbdp_grid_module_and_grid_eval_match_jax():
    nx, K, dt, n = 3, 4, 0.05, 20
    jeq, teq = _gbm(nx, T=0.2)
    ju, jg, jpairs, tpairs = _dbdp_pairs(nx, (16, 16), range(40, 45))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jpairs)
    nets = baselines.DBDPNets(tpairs)
    ts_grid = jnp.arange(K + 1) * dt
    tts = torch.arange(K + 1, dtype=torch.float32) * dt
    grid = baselines.DBDPGridModule(nets.u, tts, K, dt, teq)
    rng = np.random.default_rng(24)
    # grid times, midpoints between them (round half to even), and times
    # past both ends (clipped)
    t = np.concatenate([np.asarray(ts_grid),
                        np.asarray(ts_grid[:-1]) + 0.025,
                        [-0.03, 0.26], rng.uniform(0, 0.2, 9)]).astype(
        np.float32)[:, None]
    x = rng.normal(size=(t.shape[0], nx)).astype(np.float32)
    tx = np.concatenate([t, x], 1)
    ref = jax_baselines._DBDPGridModule(ju, ts_grid, K, dt, jeq).apply(
        stacked, tx)
    np.testing.assert_allclose(grid(T_(tx)).detach().numpy(),
                               np.asarray(ref), **NET_TOL)
    key = jax.random.PRNGKey(25)
    jm = jax_baselines._make_dbdp_eval(ju, ts_grid, K, jeq, n=n)(stacked,
                                                                 key)
    keys = [jax.random.fold_in(key, kk) for kk in range(K + 1)]
    xe = np.concatenate([np.asarray(jeq.sample_x(
        keys[kk], jnp.full((n, 1), ts_grid[kk]))) for kk in range(K + 1)])
    tm = baselines.dbdp_grid_eval(teq, nets, tts, n=n, x_eval=T_(xe))
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **NET_TOL)


def _dbdp_fit(tmp_path, cls, overrides, sweeps):
    """Pairs and fit after ``sweeps`` of (epoch, grid times kk) through the
    fit class ``cls`` on DBDP_TINY, the warm start before every kk < K."""
    cfg = default_cfg()
    cfg.merge(DBDP_TINY)
    cfg.merge({"DEVICE": "cpu", **overrides})
    runner = PicardRunner(cfg.freeze(), exp_root=tmp_path / cls.__name__)
    runner.i = 1
    sw = baselines.DBDPSweep(runner)
    nets = baselines.init_dbdp_nets(runner, sw.K)
    fit = cls(sw, nets)
    for epoch, kks in sweeps:
        for kk in kks:
            if kk < sw.K:
                nets.copy_pair(kk, kk - 1)
            fit(epoch, kk)
    return nets, fit, runner


@pytest.mark.parametrize("enforce", [False, True])
def test_dbdp_working_pair_equals_the_per_pair_loop(tmp_path, enforce):
    """The captured design's static working pair, with its Adam state
    copied in and out per grid time (eagerly on the CPU), against the
    per-pair loop on the same seeds: per epoch the terminal pre-fit (none
    under a terminal-enforcing ansatz, whose k = K step takes the "last"
    graph instead) and 2 grid times, 3 sub-iterations each, over 2 epochs,
    so that a pair's Adam carries over. Pair parameters and Adam moments
    agree to rtol 1e-6, atol 1e-7 (f32: the same operations in the same
    order; equal to the bit here)."""
    K = DBDP_K
    kks = ([] if enforce else [K + 1]) + [K, K - 1]
    over = ({"NETWORK": {"cls": "PicardSolutionEnforceTerminal"}}
            if enforce else {})
    runs = [_dbdp_fit(tmp_path, cls, over, [(0, kks), (1, kks)])
            for cls in (baselines.EagerPairFit, baselines.CapturedPairFit)]
    (n_e, f_e, r_e), (n_c, f_c, r_c) = runs
    assert r_e.rollout_calls == r_c.rollout_calls == 2 * len(kks) * DBDP_SUB
    for (name, a), b in zip(n_c.state_dict().items(),
                            n_e.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)
    trained = ([K] if not enforce else []) + [K - 1, K - 2]
    for k in trained:
        ours, ref = f_c.adam_state(k), f_e.adam_state(k)
        assert len(ours) == len(ref) == 3 * len(n_e.pair_parameters(k))
        for a, b in zip(ours, ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # the steps count both epochs' sub-iterations
    assert float(f_c.adam_state(K - 1)[0]) == 2 * DBDP_SUB
    # pairs no grid time reached keep their initialization
    fresh = baselines.init_dbdp_nets(r_e, K)
    assert all(torch.equal(a, b) for a, b in zip(
        n_c.pair_parameters(0), fresh.pair_parameters(0)))


def test_optax_adam_f32_reference_equals_optax():
    """The numpy replica of optax.adam's arithmetic that the card test
    holds DBDP's capturable Adam to (tests/test_torch_gpu.py) against
    ``optax.adam(1e-3)``, the JAX package's DBDP optimizer, on the same
    parameters and 30 gradients: parameters within 1e-7 and moments
    within rtol 1e-6 (XLA's pow and fusion against numpy's: an ulp or two
    a step)."""
    from tests.test_torch_gpu import adam_case, optax_adam_f32

    params, grads = adam_case()
    want, mu, nu = optax_adam_f32(params, grads, 1e-3)
    tx = optax.adam(1e-3)
    ps = [jnp.asarray(p) for p in params]
    state = tx.init(ps)
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, ps)
        ps = optax.apply_updates(ps, updates)
    for a, b in zip(ps, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-7)
    for a, b in zip(state[0].mu, mu):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-13)
    for a, b in zip(state[0].nu, nu):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-19)


def test_dbdp_rejects_an_equation_without_ffh():
    with pytest.raises(NotImplementedError, match="ffh"):
        baselines.check_dbdp(make_equation("Cha", nx=3))
    baselines.check_dbdp(make_equation("OUProcessEquation", nx=3,
                                       num_components=2))


# ---------------------------------------------------------------------------
# the CLI end to end on the CPU
# ---------------------------------------------------------------------------

FN_TINY_YAML = {
    "NAME": "fn_e2e", "FORCE": True,
    "EQUATION": {"cls": "GBMEquationComplexExact",
                 "kwargs": {"nx": 4, "alpha": 1.0, "T": 1.0}},
    "PICARD": {"N": 3},
    "DATA": {"DATA_SIZE": 256, "CHUNK_ELEMS": 2 ** 16,
             "kwargs": {"t_always_uniform": True,
                        "n_estimate_terminal": 256,
                        "n_estimate_integral": 256},
             "HESSIAN_APPROXIMATION": {"method": "SDGD", "kwargs": {"v": 4}},
             "TPU": {"HESSIAN_STORE": "bf16"}},
    "TRAIN": {"BATCH_SIZE": 128, "N_EPOCHS": 30, "SUPERVISE_GRADIENT": True,
              "OPTIMIZER": {"kwargs": {"lr": 3e-3}},
              "LOSS": {"SCALER": {"cls": "FixedLossScaler",
                                  "kwargs": {"fixed_weight": 0.1}}}},
    "NETWORK": {"NEURONS": [48, 48], "ACTIVATIONS": ["ELU", "ELU"],
                "RELOAD": True},
    "EVAL": {"FREQ": 30, "L2_N_POINTS": 200, "TEST_GRAD": True,
             "TEST_HESSIAN": True},
}


def test_cli_train_tiny_fn_dpi_on_cpu(tmp_path, monkeypatch):
    """tests/test_hjb_fn_e2e.py's tiny FN recipe (nx 4, SDGD v = 4, 3
    iterations) through the port's CLI, with the bf16 Hessian store and
    the Hessian eval: its bar, rRMSE < 0.35, and the Hessian rows."""
    (tmp_path / "fn.yaml").write_text(json.dumps(FN_TINY_YAML))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(est, "route_calls", {est.MERGED: 0, est.SPLIT: 0})
    assert torch_cli(["train", "fn.yaml", "DEVICE", "cpu"]) == 0
    assert est.route_calls == {est.MERGED: 0, est.SPLIT: 3}
    rows = [json.loads(ln) for ln in (tmp_path / "fn_e2e" / "metrics.jsonl")
            .read_text().splitlines()]
    evals = [r for r in rows if r["context"] == "eval"]
    # 2 steps an epoch, EVAL.FREQ 30: an eval every epoch
    assert len(evals) == 3 * 30 and all("rRMSEh" in r for r in evals)
    assert np.isfinite(evals[-1]["rRMSEh"])
    assert evals[-1]["rRMSE"] < 0.35, evals[-1]
    mod = MLP(5, (48, 48), ("ELU", "ELU"), 1)
    checkpoint.load_params(checkpoint.ckpt_path(tmp_path / "fn_e2e", 3), mod)


def test_cli_train_tiny_dbdp_on_cpu(tmp_path, monkeypatch):
    """The DBDP recipe's shape at K = 4, 3 sub-iterations, 2x16 nets
    through the port's CLI: the "dbdp" and "eval" rows per grid time, the
    stacked nets in model_1 and the periodic state, the rollout's plain
    version on every sub-iteration, and runner.u_current the grid view."""
    (tmp_path / "dbdp.yaml").write_text(json.dumps(DBDP_TINY))
    monkeypatch.chdir(tmp_path)
    assert torch_cli(["train", "dbdp.yaml", "DEVICE", "cpu",
                      "TRAIN.N_EPOCHS", "1"]) == 0
    exp = tmp_path / "dbdp_tiny"
    rows = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["k"] for r in rows if r["context"] == "dbdp"] == [4, 3, 2, 1]
    evals = [r for r in rows if r["context"] == "eval"]
    assert len(evals) == 4 and np.isfinite(evals[-1]["rRMSE"])
    cfg = load_cfg(tmp_path / "dbdp.yaml", ["DEVICE", "cpu"])
    eq = make_equation("GBMEquationComplexExact", nx=DBDP_NX, T=DBDP_T)
    for name in ("model_1", "baseline_1_state"):
        nets = baselines.DBDPNets(baselines.build_dbdp_pair(cfg, eq, "cpu")
                                  for _ in range(DBDP_K + 1))
        checkpoint.load_params(exp / name, nets)
    runner = PicardRunner(cfg, exp_root=tmp_path / "again")
    runner.run()
    assert runner.rollout_calls == (DBDP_K + 1) * DBDP_SUB * 2
    assert isinstance(runner.u_current.module, baselines.DBDPGridModule)
    tx = torch.cat([torch.full((5, 1), 0.1), torch.zeros(5, DBDP_NX)], 1)
    assert torch.isfinite(runner.u_current.value(tx)).all()
