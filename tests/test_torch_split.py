"""The split-estimator generation path of the port against the JAX package.

* The standalone terminal and integral kernels' plain versions, and the
  merged kernel's with antithetic pairing, against the JAX Pallas kernels
  (interpret mode off the TPU, external noise, as tests/test_pallas.py runs
  them) at the JAX tests' own tolerances: 2e-5 (terminal), 3e-5
  (integral), 5e-5 (merged), including nx=100 with the 4x128 ELU net.
* The chunk estimators (Kahan over chunks) equal the plain kernel versions
  on injected noise (5e-5), and with their own draws agree with the JAX
  package's XLA split estimators (threefry) within 5 CLT standard errors.
* Exact ports: KahanAcc bit for bit, largest_divisor, GenConfig.chunk and
  _act_width.
* The dispatch: each flag combination takes its route; "auto" with a net
  the merged kernel does not cover takes the split path and says so.
* End to end: the port's CLI on the CPU with the split estimators and
  different terminal and integral sample counts.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops import estimators as jest
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
    integral_with_gradients_pallas,
    terminal_with_gradients_pallas,
)
from deeppicarditeration_tpu.ops.summation import KahanAcc as JaxKahanAcc
from deeppicarditeration_torch.cli import main as torch_cli
from deeppicarditeration_torch.config import load_cfg
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation.evaluator import eval_solution
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.ops.summation import KahanAcc
from deeppicarditeration_torch.training import checkpoint
from deeppicarditeration_torch.training.picard import PicardRunner

torch.set_num_threads(1)


def _eqs(nx, alpha=1.0, k=5.0):
    return (jax_make_equation("Cha", nx=nx, alpha=alpha, k=k, T=1.0),
            make_equation("Cha", nx=nx, alpha=alpha, k=k, T=1.0))


def _nets(nx, neurons, seed=0):
    """A flax MLP and the port's MLP carrying the same weights, as
    Solutions (JAX, port)."""
    jmod = JaxMLP(neurons=neurons, activations=("ELU",) * len(neurons),
                  out_dim=1)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    tmod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    tmod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (JaxSolution.from_net(jmod, params, "Value", nx),
            Solution.from_net(tmod, "Value", nx))


def _sols(nx, net):
    if net is None:
        return JaxSolution.zero(nx), Solution.zero(nx)
    return _nets(nx, net)


def _tx(rng, b, nx):
    t = (rng.uniform(size=(b, 1)) * 0.8).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    return np.concatenate([t, x], axis=1)


def _noise(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _u01(rng, b, rows):
    return rng.uniform(size=(b, rows, 1)).astype(np.float32)


T_ = torch.from_numpy


# ---------------------------------------------------------------------------
# plain kernel versions vs the JAX Pallas kernels (same external noise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,antithetic", [(5, False), (100, False),
                                           (5, True)])
def test_terminal_plain_matches_jax_pallas(nx, antithetic):
    b, m = 8, 16
    rows = m // 2 if antithetic else m
    jeq, teq = _eqs(nx, alpha=1.3)
    rng = np.random.default_rng(nx)
    tx, noise = _tx(rng, b, nx), _noise(rng, b, rows, nx)
    ref = terminal_with_gradients_pallas(
        0, jeq, jnp.asarray(tx), m, tile_b=8, mblk=8, antithetic=antithetic,
        noise=jnp.asarray(noise))
    out = kernels.terminal_with_gradients_plain(
        0, teq, T_(tx), m, T_(noise), antithetic=antithetic, chunk_rows=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("nx,net,antithetic", [
    (100, None, False),                  # the zero iterate (iteration 1)
    (100, (128, 128, 128, 128), False),  # the slice's full-width net
    (5, (16, 16), True),
])
def test_integral_plain_matches_jax_pallas(nx, net, antithetic):
    b, m = 8, 16
    rows = m // 2 if antithetic else m
    jeq, teq = _eqs(nx)
    jsol, tsol = _sols(nx, net)
    rng = np.random.default_rng(nx + 1)
    tx = _tx(rng, b, nx)
    u01, noise = _u01(rng, b, rows), _noise(rng, b, rows, nx)
    ref = integral_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        antithetic=antithetic, u01=jnp.asarray(u01),
        noise=jnp.asarray(noise))
    out = kernels.integral_with_gradients_plain(
        0, teq, tsol, T_(tx), m, T_(u01), T_(noise), antithetic=antithetic,
        chunk_rows=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("nx,net", [(100, (128, 128, 128, 128)),
                                    (5, (16, 16))])
def test_merged_antithetic_plain_matches_jax_pallas(nx, net):
    b, m = 8, 16
    jeq, teq = _eqs(nx)
    jsol, tsol = _sols(nx, net)
    rng = np.random.default_rng(3)
    tx = _tx(rng, b, nx)
    u01 = _u01(rng, b, m // 2)
    nt, ni = _noise(rng, b, m // 2, nx), _noise(rng, b, m // 2, nx)
    ref = generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8, antithetic=True,
        u01=jnp.asarray(u01), noise_t=jnp.asarray(nt),
        noise_i=jnp.asarray(ni))
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, T_(tx), m, T_(u01), T_(nt), T_(ni), antithetic=True,
        chunk_rows=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-5,
                               atol=5e-5)
    # the merged estimator is the sum of the standalone ones on its noise
    split = (kernels.terminal_with_gradients_plain(
        0, teq, T_(tx), m, T_(nt), antithetic=True)
        + kernels.integral_with_gradients_plain(
            0, teq, tsol, T_(tx), m, T_(u01), T_(ni), antithetic=True))
    torch.testing.assert_close(out, split, rtol=5e-5, atol=5e-5)


def test_plain_antithetic_variance_is_that_of_the_pairs():
    """return_var with antithetic pairing gives 2 x the variance of a pair's
    average, so that sqrt(var / m) is the mean's standard error."""
    nx, b, m = 3, 4, 24
    _, teq = _eqs(nx, k=1.0)
    rng = np.random.default_rng(5)
    tx, h = T_(_tx(rng, b, nx)), T_(_noise(rng, b, m // 2, nx))
    mean, var = kernels.terminal_with_gradients_plain(
        0, teq, tx, m, h, antithetic=True, return_var=True)
    pair = torch.stack([
        0.5 * (kernels.terminal_with_gradients_plain(
            0, teq, tx, 1, h[:, i:i + 1])
            + kernels.terminal_with_gradients_plain(
                0, teq, tx, 1, -h[:, i:i + 1]))
        for i in range(m // 2)], dim=1)
    torch.testing.assert_close(mean, pair.mean(dim=1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, 2 * pair.var(dim=1, unbiased=False),
                               rtol=1e-3, atol=1e-7)


# ---------------------------------------------------------------------------
# the chunk estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["terminal", "integral"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_chunk_estimators_equal_plain_on_injected_noise(which, antithetic):
    """Kahan over 4 chunks computes the plain kernel version's estimator."""
    nx, b, m = 4, 8, 32
    rows = m // 2 if antithetic else m
    _, teq = _eqs(nx, k=1.0)
    _, tsol = _nets(nx, (16, 16))
    rng = np.random.default_rng(7)
    tx = T_(_tx(rng, b, nx))
    u01, noise = T_(_u01(rng, b, rows)), T_(_noise(rng, b, rows, nx))
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=b * nx * 8, antithetic=antithetic)
    assert m // gen.chunk(m, b, nx) == 4
    if which == "terminal":
        out = est.estimate_terminal_with_gradients(0, teq, tx, gen, noise)
        ref = kernels.terminal_with_gradients_plain(
            0, teq, tx, m, noise, antithetic=antithetic)
    else:
        out = est.estimate_integral_with_gradients(0, teq, tsol, tx, gen,
                                                   u01, noise)
        ref = kernels.integral_with_gradients_plain(
            0, teq, tsol, tx, m, u01, noise, antithetic=antithetic)
    torch.testing.assert_close(out, ref, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("which", ["terminal", "integral"])
def test_chunk_estimators_agree_with_jax_xla_within_clt(which):
    """Own draws (torch.Generator) vs the JAX XLA split estimators
    (threefry): every output within 5 standard errors of the difference,
    with variances from the plain version (b=16, m=4096, nx=5)."""
    nx, b, m = 5, 16, 4096
    jeq, teq = _eqs(nx, k=1.0)
    jsol, tsol = _nets(nx, (16, 16))
    tx = _tx(np.random.default_rng(11), b, nx)
    jgen = jest.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                          chunk_elems=2 ** 16)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=2 ** 16)
    assert gen.chunk(m, b, nx) == jgen.chunk(m, b, nx) < m
    key = jax.random.PRNGKey(3)
    if which == "terminal":
        ref = jest.estimate_terminal_with_gradients(key, jeq,
                                                    jnp.asarray(tx), jgen)
        out = est.estimate_terminal_with_gradients(5, teq, T_(tx), gen)
        _, var = kernels.terminal_with_gradients_plain(
            9, teq, T_(tx), m, return_var=True)
    else:
        ref = jest.estimate_integral_with_gradients(key, jeq, jsol,
                                                    jnp.asarray(tx), jgen)
        out = est.estimate_integral_with_gradients(5, teq, tsol, T_(tx), gen)
        _, var = kernels.integral_with_gradients_plain(
            9, teq, tsol, T_(tx), m, return_var=True)
    z = (out - T_(np.array(ref))) / torch.sqrt(2 * var / m).clamp(
        min=1e-12)
    assert torch.isfinite(out).all()
    assert float(z.abs().max()) < 5.0, float(z.abs().max())
    assert 0.3 < float((z * z).mean()) < 3.0


# ---------------------------------------------------------------------------
# exact ports
# ---------------------------------------------------------------------------

def test_kahan_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.integers(-8, 9, size=(400, 6))
    seq = (rng.normal(size=(400, 6)) * mag).astype(np.float32)
    seq[::7] *= -1.0
    seq[3::11] = np.float32(1e8)
    seq[4::11] = np.float32(-1e8)
    jacc, tacc = JaxKahanAcc.zeros((6,)), KahanAcc.zeros((6,))
    for v in seq:
        jacc, tacc = jacc.add(jnp.asarray(v)), tacc.add(T_(v))
    for a, b in ((tacc.sum, jacc.sum), (tacc.comp, jacc.comp),
                 (tacc.value, jacc.value)):
        assert np.array_equal(a.numpy().view(np.uint32),
                              np.asarray(b).view(np.uint32))
    # the compensation recovers what plain f32 summation loses
    exact = seq.astype(np.float64).sum(axis=0)
    plain = np.zeros(6, np.float32)
    for v in seq:
        plain += v
    assert (np.abs(tacc.value.numpy() - exact).sum()
            < np.abs(plain - exact).sum())


@pytest.mark.parametrize("antithetic", [False, True])
def test_largest_divisor_chunk_and_act_width_match_jax(antithetic):
    for n in (1, 2, 7, 12, 64, 97, 4096, 8192):
        for cap in (1, 3, 8, 81, 5000):
            step = 2 if antithetic else 1
            try:
                want = jest.largest_divisor(n, cap, step)
            except ValueError as e:
                with pytest.raises(ValueError, match="even sample count"):
                    est.largest_divisor(n, cap, step)
                assert "even sample count" in str(e)
                continue
            assert est.largest_divisor(n, cap, step) == want
    nets = [None, (16, 16), (128, 128, 128, 128), (64,)]
    for net in nets:
        nx = 7
        jsol, tsol = _sols(nx, net)
        assert est._act_width(tsol) == jest._act_width(jsol)
        assert est._act_width(tsol, tsol) == jest._act_width(jsol, jsol)
        w = est._act_width(tsol)
        for m in (64, 512, 4096, 8192):
            for b in (8, 512, 4096):
                for ce in (2 ** 16, 2 ** 22, 2 ** 25):
                    kw = dict(chunk_elems=ce, antithetic=antithetic)
                    assert (est.GenConfig(**kw).chunk(m, b, nx, w)
                            == jest.GenConfig(**kw).chunk(m, b, nx, w))
    assert est._ACT_BUDGET_ELEMS == jest._ACT_BUDGET_ELEMS
    # the recipe's chunking: 64 chunks of 64 samples per estimator
    gen = est.GenConfig(chunk_elems=2 ** 25, antithetic=antithetic)
    assert gen.chunk(4096, 4096, 100, 4 * 128 + 1) == 64
    with pytest.raises(ValueError, match="even sample count"):
        est.GenConfig(antithetic=True).chunk(97, 8, 4)


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Count the calls of each kernel wrapper the estimators reach."""
    counts = {}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name in ("generate_with_gradients_cuda",
                 "terminal_with_gradients_cuda",
                 "integral_with_gradients_cuda", "normals_cuda"):
        monkeypatch.setattr(est, name, counting(name, getattr(est, name)))
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    return counts


@pytest.mark.parametrize("flags,want", [
    # "auto" leaves the zero iterate at nx < 32 to the chunk estimators
    (dict(), {}),
    (dict(pallas_generate=True), {"generate_with_gradients_cuda": 1}),
    (dict(pallas_generate=False, pallas_terminal=True,
          pallas_integral=True),
     {"terminal_with_gradients_cuda": 1, "integral_with_gradients_cuda": 1}),
    (dict(pallas_generate=False, tpu_prng=True),
     {"normals_cuda": 2 * 4}),  # the two estimators' chunk counts
    (dict(pallas_generate=False), {}),
])
def test_each_flag_combination_takes_its_route(calls, flags, want):
    nx, b, m = 4, 8, 32
    _, teq = _eqs(nx, k=1.0)
    sol = Solution.zero(nx)
    tx = T_(_tx(np.random.default_rng(2), b, nx))
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=b * nx * 8, **flags)
    out = est.generate_with_gradients(3, teq, sol, tx, gen)
    assert calls == want
    assert out.shape == (b, 1 + nx) and torch.isfinite(out).all()
    route = est.generation_route(teq, sol, gen)
    assert route == (est.MERGED if "generate_with_gradients_cuda" in want
                     else est.SPLIT)


def test_auto_takes_the_split_path_for_an_uncovered_net(calls, capsys):
    nx, b, m = 4, 8, 16
    _, teq = _eqs(nx, k=1.0)
    _, narrow = _nets(nx, (16, 16))
    tx = T_(_tx(np.random.default_rng(4), b, nx))
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m)
    assert gen.pallas_generate == "auto"
    out = est.generate_with_gradients(3, teq, narrow, tx, gen)
    assert calls == {}  # the chunk estimators, torch.Generator draws
    assert "using the split estimators" in capsys.readouterr().out
    assert est.generation_route(teq, narrow, gen) == est.SPLIT
    assert torch.isfinite(out).all()
    # the 4x128 ELU net is covered: merged
    _, wide = _nets(nx, (128,) * 4)
    assert est.generation_route(teq, wide, gen) == est.MERGED
    # forced True keeps the merged kernel (which raises on the card for a
    # net it does not cover; the CPU runs its plain version)
    forced = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                           pallas_generate=True)
    assert est.generation_route(teq, narrow, forced) == est.MERGED
    # different sample counts: split whatever the flag
    diff_m = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=2 * m,
                           pallas_generate=True)
    assert est.generation_route(teq, wide, diff_m) == est.SPLIT


# ---------------------------------------------------------------------------
# the runner and the CLI on the split path
# ---------------------------------------------------------------------------

TINY_SPLIT_YAML = """\
NAME: tiny_split
FORCE: true
EQUATION:
  cls: Cha
  kwargs: {nx: 4, alpha: 1.0, k: 1.0, T: 1.0}
PICARD:
  N: 3
DATA:
  DATA_SIZE: 512
  CHUNK_ELEMS: 65536
  kwargs: {t_always_uniform: true, n_estimate_terminal: 512,
           n_estimate_integral: 256}
  TPU: {PALLAS_GENERATE: false}
TRAIN:
  BATCH_SIZE: 128
  N_EPOCHS: 30
  SUPERVISE_GRADIENT: true
  OPTIMIZER: {kwargs: {lr: 0.003}}
  LOSS: {SCALER: {cls: FixedLossScaler, kwargs: {fixed_weight: 1.0}}}
NETWORK:
  NEURONS: [32, 32]
  ACTIVATIONS: [ELU, ELU]
  RELOAD: true
EVAL:
  L2_N_POINTS: 500
  FREQ: null
  TEST_GRAD: true
"""


def test_cli_e2e_split_path_on_cpu(tmp_path, monkeypatch):
    """tests/test_picard_e2e.py's tiny recipe with PALLAS_GENERATE: false and
    different terminal and integral sample counts: rRMSE < 0.08 and
    improving iterate over iterate."""
    (tmp_path / "tiny.yaml").write_text(TINY_SPLIT_YAML)
    monkeypatch.chdir(tmp_path)
    assert torch_cli(["train", "tiny.yaml", "DEVICE", "cpu"]) == 0
    exp = tmp_path / "tiny_split"
    _, eq = _eqs(4, k=1.0)

    def metrics_of(i):
        mod = MLP(5, (32, 32), ("ELU", "ELU"), 1)
        checkpoint.load_params(checkpoint.ckpt_path(exp, i), mod)
        return eval_solution(torch.Generator().manual_seed(99),
                             Solution.from_net(mod, "Value", 4), eq, 1000,
                             test_grad=True)

    first, final = metrics_of(1), metrics_of(3)
    assert final["rRMSE"] < 0.08, final
    assert final["rRMSE"] < first["rRMSE"]


@pytest.mark.parametrize("nx", [10, 32, 100])
@pytest.mark.parametrize("neurons", [(), (128, 128), (128,) * 4])
def test_auto_route_by_structure(nx, neurons):
    """The route "auto" takes at each cell of the route table (PERF.md,
    ``utils/route_bench.py``): the merged kernel, except for the zero
    iterate at nx < 32, where the chunk estimators were faster on the
    H100; decided from the structure alone, before any launch."""
    _, teq = _eqs(nx, k=5.0)
    sol = Solution.zero(nx)
    if neurons:
        sol = Solution.from_net(
            MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1), "Value", nx)
    gen = est.GenConfig(n_estimate_terminal=64, n_estimate_integral=64)
    want = est.SPLIT if (not neurons and nx < 32) else est.MERGED
    assert est.generation_route(teq, sol, gen) == want


@pytest.mark.parametrize("case,want", [
    ("zero nx100", est.MERGED), ("zero nx10", est.SPLIT),
    ("pis512 default", est.MERGED), ("pis512 bf16x3", est.MERGED),
    ("pis512 highest", est.SPLIT), ("pis64 default", est.SPLIT),
    ("enforce default", est.SPLIT), ("mlp default", est.SPLIT),
    ("pis512 antithetic", est.SPLIT)])
def test_auto_route_by_structure_hjb(case, want, capsys, monkeypatch):
    """The HJB cells of the route "auto" takes: the PIS kernel
    (generate_pis.cu) for the OU equation with the zero iterate at
    nx >= 32, or with a PISGradNet of width 512 in "default" or "bf16x3";
    the split route, with its notice, for what it does not cover (other
    PISGradNet widths, EnforceTerminal, plain MLPs, "highest" with a
    PISGradNet, antithetic pairing); decided from the structure alone."""
    from deeppicarditeration_torch.models.networks import (
        EnforceTerminal,
        PISGradNet,
    )

    kind, mode = case.split()
    nx = 10 if kind == "zero" and mode == "nx10" else 100
    teq = make_equation("OUProcessEquation", nx=nx, num_components=5)
    gmm = (teq.gmm_means, teq.gmm_vars, teq.gmm_log_weights)
    mods = {"pis512": lambda: PISGradNet(nx, (512,) * 4, gmm),
            "pis64": lambda: PISGradNet(nx, (64,) * 4, gmm),
            "enforce": lambda: EnforceTerminal(
                MLP(1 + nx, (64,), ("ELU",), 1), teq.g),
            "mlp": lambda: MLP(1 + nx, (64,), ("ELU",), 1)}
    sol = (Solution.zero(nx) if kind == "zero"
           else Solution.from_net(mods[kind](), "Value", nx))
    gen = est.GenConfig(
        n_estimate_terminal=64, n_estimate_integral=64,
        antithetic=mode == "antithetic",
        pallas_precision=("default" if mode in ("antithetic", "nx100",
                                                "nx10") else mode))
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    assert est.generation_route(teq, sol, gen) == want
    noticed = "using the split estimators" in capsys.readouterr().out
    assert noticed == (want == est.SPLIT and kind != "zero")


@pytest.mark.parametrize("mode", [False, True, "auto"])
@pytest.mark.parametrize("net", [False, True])
def test_auto_route_by_structure_fn(mode, net, capsys, monkeypatch):
    """The FN cells: an equation with a Hessian term (GBM) takes the split
    route, the chunk estimators with SDGD, under every PALLAS_GENERATE
    (the JAX merged kernel takes no Hessian equation), silently; decided
    from the structure alone."""
    nx = 100
    teq = make_equation("GBMEquationComplexExact", nx=nx)
    sol = (Solution.from_net(MLP(1 + nx, (64,) * 3, ("ELU",) * 3, 1),
                             "Value", nx) if net else Solution.zero(nx))
    gen = est.GenConfig(n_estimate_terminal=64, n_estimate_integral=64,
                        pallas_generate=mode, sdgd_v=nx)
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    assert est.generation_route(teq, sol, gen) == est.SPLIT
    assert "using the split estimators" not in capsys.readouterr().out


def test_runner_maps_the_flags_and_counts_routes(tmp_path, capsys,
                                                 monkeypatch):
    (tmp_path / "tiny.yaml").write_text(TINY_SPLIT_YAML)
    ov = ["DEVICE", "cpu", "PICARD.N", "2", "TRAIN.N_EPOCHS", "0",
          "DATA.kwargs.n_estimate_integral", "512",
          "DATA.TPU.PALLAS_GENERATE", "auto", "DATA.TPU.PRNG", "true",
          "DATA.TPU.ANTITHETIC", "true", "DATA.TPU.PALLAS_TERMINAL", "true"]
    cfg = load_cfg(tmp_path / "tiny.yaml", ov)
    runner = PicardRunner(cfg, exp_root=tmp_path)
    from deeppicarditeration_torch.training.picard import gen_config_from_cfg

    gen = gen_config_from_cfg(cfg)
    assert (gen.pallas_generate, gen.tpu_prng, gen.antithetic,
            gen.pallas_terminal, gen.pallas_integral) == (
                "auto", True, True, True, False)
    monkeypatch.setattr(est, "route_calls", {est.MERGED: 0, est.SPLIT: 0})
    runner.run()
    # iteration 1: the zero iterate at nx = 4 (auto: split, the chunks are
    # faster there); iteration 2: a 2x32 net the merged kernel does not
    # cover (auto: split, with a notice); the dispatch counts the route it
    # takes
    assert runner.generate_calls == 2
    assert est.route_calls == {est.MERGED: 0, est.SPLIT: 2}
    assert "using the split estimators" in capsys.readouterr().out
    for flag in ("false", "False", "0", "off"):
        cfg = load_cfg(tmp_path / "tiny.yaml",
                       ["DEVICE", "cpu", "DATA.TPU.PALLAS_GENERATE", flag])
        PicardRunner(cfg, exp_root=tmp_path)  # no longer rejected
        assert gen_config_from_cfg(cfg).pallas_generate is False
