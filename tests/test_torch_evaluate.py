"""The evaluation slice: the value-only estimators, the Monte-Carlo
self-consistency check, the Picard time law, ``cli evaluate`` and the
runner's EVAL.BATCH_SIZE, against the JAX package on the CPU.

* ``estimate_terminal`` and ``estimate_integral`` (4 chunks, Kahan over
  them) against the JAX package's (one chunk) on the same injected draws:
  Burgers and HJB with a net, FN with SDGD indices and with the zero
  iterate's full Hessian; rtol 5e-5, atol 1e-5 of the largest value (f32
  sums over the samples in another order).
* ``monte_carlo_at_zero`` against the JAX package's on their own streams:
  within 5 standard errors of the difference over replicates.
* ``sample_t_picard`` against the JAX package's law: a two-sample
  Kolmogorov-Smirnov test.
* ``cli evaluate`` end to end on CPU experiment dirs writes the JAX CLI's
  record keys for every protocol, and the PINN recipe trains through the
  CLI with no YAML package importable.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.cli import main as jax_cli
from deeppicarditeration_tpu.equations import (
    make_equation as jax_make_equation,
)
from deeppicarditeration_tpu.evaluation import evaluator as jev
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops import estimators as jest
from deeppicarditeration_tpu.ops.samplers import (
    sample_t_picard as jax_sample_t_picard,
)
from deeppicarditeration_tpu.training import checkpoint as jax_ckpt
from deeppicarditeration_tpu.utils.static_fn import StaticFn
from deeppicarditeration_torch import cli as torch_cli
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.evaluation import evaluator as tev
from deeppicarditeration_torch.evaluation.experiment import (
    ExperimentEvaluator,
)
from deeppicarditeration_torch.evaluation.plots import plot_error
from deeppicarditeration_torch.models.convert import mlp_state_dict_from_flax
from deeppicarditeration_torch.models.networks import MLP, TerminalValue
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops.samplers import sample_t_picard

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EST_RTOL, EST_ATOL_OF_MAX = 5e-5, 1e-5


def T_(a):
    return torch.from_numpy(np.array(a))


def _sols(nx, neurons=(16, 16), seed=0, jitter=0.2):
    jm = JaxMLP(neurons=tuple(neurons), activations=("ELU",) * len(neurons),
                out_dim=1)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.normal(size=a.shape).astype(
            np.float32), p)
    tm = MLP(1 + nx, tuple(neurons), ("ELU",) * len(neurons), 1)
    tm.load_state_dict(mlp_state_dict_from_flax(p))
    return (JaxSolution.from_net(jm, p, "Value", nx),
            Solution.from_net(tm, "Value", nx))


FAMILIES = {
    "burgers net": ("Cha", {"nx": 4, "alpha": 1.0, "k": 1.0}, True, None),
    "hjb net": ("OUProcessEquation", {"nx": 4, "num_components": 3,
                                      "seed": 5}, True, None),
    "fn sdgd net": ("GBMEquationComplexExact", {"nx": 4, "seed": 3}, True,
                    3),
    "fn zero full hessian": ("GBMEquationComplexExact",
                             {"nx": 4, "seed": 3}, False, None),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_value_estimators_match_jax_on_the_same_draws(monkeypatch, family):
    cls, kw, net, v = FAMILIES[family]
    nx, b, m = kw["nx"], 6, 16
    jeq, teq = jax_make_equation(cls, **kw), make_equation(cls, **kw)
    js, ts = _sols(nx) if net else (JaxSolution.zero(nx), Solution.zero(nx))
    rng = np.random.default_rng(11)
    t = rng.uniform(0, 0.95, (b, 1)).astype(np.float32)
    x = (0.5 * rng.normal(size=(b, nx))).astype(np.float32)
    tx = np.concatenate([t, x], 1)
    u01 = rng.uniform(size=(b, m, 1)).astype(np.float32)
    nt = rng.normal(size=(b, m, nx)).astype(np.float32)
    ni = rng.normal(size=(b, m, nx)).astype(np.float32)
    idx = rng.integers(0, nx, (b, m, v or 1)).astype(np.int32)
    jgen = jest.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                          chunk_elems=10 ** 6, sdgd_v=v)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=b * nx * m // 4, sdgd_v=v)
    assert jgen.chunk(m, b, nx) == m and gen.chunk(m, b, nx) == m // 4
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), dtype=jnp.float32, *a, **k):
        if tuple(shape) == (b, m, 1):
            return jnp.asarray(u01)
        return uniform(key, shape, dtype, *a, **k)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jest, "_sdgd_indices",
                        lambda key, shape, nx: jnp.asarray(idx))
    monkeypatch.setattr(jest, "_draw_normals", lambda *a: jnp.asarray(nt))
    jg = np.asarray(jest.estimate_terminal(jax.random.PRNGKey(0), jeq,
                                           jnp.asarray(tx), jgen))
    monkeypatch.setattr(jest, "_draw_normals", lambda *a: jnp.asarray(ni))
    jy = np.asarray(jest.estimate_integral(jax.random.PRNGKey(1), jeq, js,
                                           jnp.asarray(tx), jgen))
    monkeypatch.undo()
    g = est.estimate_terminal(0, teq, T_(tx), gen, T_(nt))
    y = est.estimate_integral(0, teq, ts, T_(tx), gen, T_(u01), T_(ni),
                              T_(idx) if v else None)
    for out, ref in ((g, jg), (y, jy)):
        np.testing.assert_allclose(
            out.detach().numpy(), ref, rtol=EST_RTOL,
            atol=EST_ATOL_OF_MAX * float(np.abs(ref).max()))
    # generate_values: the terminal from derive_seed(seed, 1), the integral
    # from (seed, 2)
    from deeppicarditeration_torch.device import derive_seed

    big = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        sdgd_v=v)
    assert torch.equal(
        est.generate_values(5, teq, ts, T_(tx), big),
        est.estimate_terminal(derive_seed(5, 1), teq, T_(tx), big)
        + est.estimate_integral(derive_seed(5, 2), teq, ts, T_(tx), big))


@pytest.mark.parametrize("family", ["burgers net", "hjb gx", "fn zero"])
def test_monte_carlo_at_zero_agrees_with_jax_within_clt(family):
    """Replicates of each package's estimate on its own streams (the port's
    torch.Generator chunks, the JAX package's threefry): the means within
    5 standard errors of their difference; u_net(0, 0) equal (1e-6)."""
    reps, n = 12, 2048
    if family == "burgers net":
        cls, kw = "Cha", {"nx": 4, "alpha": 1.0, "k": 1.0}
    elif family == "hjb gx":
        cls, kw = "OUProcessEquation", {"nx": 4, "num_components": 3,
                                        "seed": 5}
    else:
        cls, kw = "GBMEquationComplexExact", {"nx": 4, "seed": 3}
    jeq, teq = jax_make_equation(cls, **kw), make_equation(cls, **kw)
    nx = kw["nx"]
    if family == "burgers net":
        js, ts = _sols(nx)
    elif family == "hjb gx":
        js = JaxSolution.gx(StaticFn(jeq.g, ("g", id(jeq))), nx)
        ts = Solution.from_net(TerminalValue(teq.g), "Value", nx)
    else:
        js, ts = JaxSolution.zero(nx), Solution.zero(nx)
    ours = [tev.monte_carlo_at_zero(100 + r, teq, ts, n, device="cpu")
            for r in range(reps)]
    theirs = [jev.monte_carlo_at_zero(jax.random.PRNGKey(r), jeq, js, n)
              for r in range(reps)]
    a = np.array([o["u_mc_at_zero"] for o in ours])
    b = np.array([o["u_mc_at_zero"] for o in theirs])
    se = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / reps)
    assert abs(a.mean() - b.mean()) < 5 * se, (a.mean(), b.mean(), se)
    np.testing.assert_allclose(ours[0]["u_net_at_zero"],
                               theirs[0]["u_net_at_zero"], rtol=1e-6,
                               atol=1e-6)
    assert ours[0]["self_consistency_error"] == pytest.approx(
        abs(ours[0]["u_net_at_zero"] - ours[0]["u_mc_at_zero"]))


@pytest.mark.parametrize("k", [1, 2.5, 4])
def test_sample_t_picard_follows_the_jax_law(k):
    from scipy.stats import ks_2samp

    n = 20000
    ours = sample_t_picard(torch.Generator().manual_seed(int(2 * k)), n,
                           2.0, k).numpy().reshape(-1)
    theirs = np.asarray(jax_sample_t_picard(jax.random.PRNGKey(int(2 * k)),
                                            n, 2.0, k)).reshape(-1)
    assert ours.shape == (n,) and 0.0 <= ours.min() and ours.max() <= 2.0
    assert ks_2samp(ours, theirs).pvalue > 1e-3
    if k == 4:  # E t = T (1 - 2^-k) for an integer k
        assert abs(ours.mean() - 2.0 * (1 - 2.0 ** -4)) < 5 * ours.std() / \
            np.sqrt(n)


def test_value_batched_l2_and_plot(tmp_path):
    teq = make_equation("Cha", nx=4, alpha=1.0, k=1.0)
    _, ts = _sols(4)
    t = torch.rand((50, 1), generator=torch.Generator().manual_seed(1))
    tx = torch.cat([t, torch.randn(50, 4)], -1)
    assert torch.allclose(tev.value_batched(ts, tx, 7),
                          tev.value_batched(ts, tx), rtol=1e-6, atol=1e-6)
    a = tev.l2_at_t(torch.Generator().manual_seed(3), ts, teq, t, 7)
    b = tev.l2_at_t(torch.Generator().manual_seed(3), ts, teq, t)
    assert a["l2_error"] == pytest.approx(b["l2_error"], rel=1e-6)
    path = plot_error(tmp_path, t, tx[:, 1:], torch.rand(50), "iter_001")
    assert path.exists() and path.name == "iter_001_error_distribution.png"


TINY = {
    "NAME": "eval_tiny", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": 3, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "PICARD": {"N": 2},
    "DATA": {"DATA_SIZE": 64, "CHUNK_ELEMS": 16384,
             "kwargs": {"t_always_uniform": True, "n_estimate_terminal": 32,
                        "n_estimate_integral": 32}},
    "TRAIN": {"BATCH_SIZE": 32, "N_EPOCHS": 2, "SUPERVISE_GRADIENT": True},
    "NETWORK": {"NEURONS": [8, 8], "ACTIVATIONS": ["ELU", "ELU"]},
    "EVAL": {"FREQ": 2, "L2_N_POINTS": 32, "TEST_GRAD": True},
}


def _records(path):
    return [json.loads(ln) for ln in pathlib.Path(path).read_text()
            .splitlines()]


def test_cli_evaluate_writes_the_jax_record_keys(tmp_path, monkeypatch):
    """One tiny experiment trained by each package's CLI on the CPU, then
    each CLI's evaluate (MC at (0, 0), the L2 sweeps, the L2 against an
    .npz and an .npy solution file): the same record keys, protocol by
    protocol, the same run delimiter keys and iterations."""
    (tmp_path / "tiny.yaml").write_text(json.dumps(TINY))
    monkeypatch.chdir(tmp_path)
    jax_cli(["train", "tiny.yaml", "NAME", "jax_run"])
    jax_ckpt.wait_all()
    torch_cli.main(["train", "tiny.yaml", "DEVICE", "cpu", "NAME",
                    "torch_run"])
    teq = make_equation("Cha", nx=3, alpha=1.0, k=1.0)
    t = torch.rand((40, 1), generator=torch.Generator().manual_seed(0))
    x = torch.randn((40, 3), generator=torch.Generator().manual_seed(1))
    u = teq.exact_solution(t, x)
    np.savez(tmp_path / "sol.npz", tx=torch.cat([t, x], -1).numpy(),
             u=u.numpy())
    np.save(tmp_path / "sol.npy", torch.cat([t, x, u], -1).numpy())
    runs = {"jax": (jax_cli, "jax_run"), "torch": (torch_cli.main,
                                                  "torch_run")}
    protocols = [[], ["--do-l2", "--n-points", "64"],
                 ["--do-l2", "--sol-file", "sol.npz"],
                 ["--do-l2", "--sol-file", "sol.npy"]]
    out = {}
    for name, (main, exp) in runs.items():
        for extra in protocols:
            assert main(["evaluate", exp, "--n-estimate", "4096", "--out",
                         f"{name}.jsonl"] + extra) in (0, None)
        out[name] = _records(tmp_path / f"{name}.jsonl")
    assert [sorted(r) for r in out["torch"]] == [sorted(r)
                                                 for r in out["jax"]]
    assert [(r["protocol"], r["iter"]) for r in out["torch"]] == [
        (r["protocol"], r["iter"]) for r in out["jax"]]
    assert [r["protocol"] for r in out["torch"]] == (
        ["mc_at_zero"] * 3 + ["l2"] * 2 + ["l2_file"] * 4)
    assert all(np.isfinite(v) for r in out["torch"] for k, v in r.items()
               if isinstance(v, float))
    assert list((tmp_path / "torch_run").glob("*_error_distribution.png"))


def test_cli_trains_the_pinn_recipe_and_evaluates_without_yaml(
        tmp_path, monkeypatch):
    """The README's CPU commands: the shipped Burgers PINN recipe (nx cut to
    8, 200 epochs) through ``cli train`` with no YAML package importable,
    then ``cli evaluate`` on its experiment dir."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.chdir(tmp_path)
    assert torch_cli.main([
        "train", str(ROOT / "configs/burgers/pinn_100d_T1.0_v16_beta10.0.yaml"),
        "DEVICE", "cpu", "TRAIN.N_EPOCHS", "200",
        "EQUATION.kwargs.nx", "8"]) == 0
    (exp,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert (exp / "model_1").exists()
    rows = _records(exp / "metrics.jsonl")
    assert [r["context"] for r in rows] == ["pinn", "eval"] * 2
    assert rows[-1]["rRMSE"] < 1.0
    assert torch_cli.main(["evaluate", str(exp), "--n-estimate", "4096",
                           "--out", "mc.jsonl"]) == 0
    recs = _records(tmp_path / "mc.jsonl")
    assert [r["iter"] for r in recs] == [0, 1]
    assert sorted(recs[0]) == sorted(
        ["run_ts", "exp", "protocol", "u_net_at_zero", "u_mc_at_zero",
         "self_consistency_error", "iter"])


def test_the_loop_bounds_its_evals_by_eval_batch_size(tmp_path,
                                                      monkeypatch):
    """TRAIN.FUSED false with EVAL.BATCH_SIZE 8 (below L2_N_POINTS, which
    the fused fit's gate refuses): every eval pass holds at most 8 points,
    and the eval rows equal the unbatched loop's (1e-6)."""
    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training.picard import PicardRunner

    seen = []
    real = tev._eval_batch

    def spy(sol, eq, t, x, *a):
        seen.append(t.shape[0])
        return real(sol, eq, t, x, *a)

    evals = {}
    for bs in (None, 8):
        cfg = default_cfg()
        cfg.merge({**TINY, "NAME": f"bs_{bs}", "DEVICE": "cpu",
                   "TRAIN": {**TINY["TRAIN"], "FUSED": False},
                   "EVAL": {**TINY["EVAL"], "BATCH_SIZE": bs}},
                  allow_new=False)
        monkeypatch.setattr(tev, "_eval_batch", spy)
        seen.clear()
        run = PicardRunner(cfg.freeze(), exp_root=tmp_path)
        run.run()
        assert seen and max(seen) == (32 if bs is None else 8)
        evals[bs] = [r for r in _records(run.exp_dir / "metrics.jsonl")
                     if r["context"] == "eval"]
    for a, b in zip(evals[None], evals[8]):
        for k in ("rRMSE", "rRMSEg", "MSE"):
            assert a[k] == pytest.approx(b[k], rel=1e-6)


def test_evaluate_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The evaluator's device is the experiment config's DEVICE ("cuda"
    unless the run asked for the CPU) or its ``device=`` argument: on a
    machine without a card a "cuda" experiment raises, nothing falls back
    to the CPU."""
    from deeppicarditeration_torch.config import default_cfg

    for device in ("cuda", "cpu"):
        cfg = default_cfg()
        cfg.merge({**TINY, "DEVICE": device}, allow_new=False)
        exp = tmp_path / device
        exp.mkdir()
        (exp / "config.yaml").write_text(cfg.dump())
        if device == "cuda" and not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ExperimentEvaluator(exp)
            ev = ExperimentEvaluator(exp, device="cpu")
        else:
            ev = ExperimentEvaluator(exp)
        assert ev.device.type == ("cuda" if torch.cuda.is_available()
                                  and device == "cuda" else "cpu")
        rec = ev.monte_carlo_at_zero([0])[0]
        assert rec["u_net_at_zero"] == 0.0 and np.isfinite(
            rec["u_mc_at_zero"])
