"""RESUME on the CPU: a run stopped and continued with ``RESUME true``
equals an uninterrupted run bit for bit, as the JAX package's
(``tests/test_resume.py``) does: the Picard runner at a Picard
iteration's granularity (the latest ``model_{i}`` becomes the iterate),
D-DBSDE and PINN at a log interval's (the periodic ``{model, optimizer}``
state and its meta sidecar; the per-epoch seeds draw what an uninterrupted
run draws), DBDP by skipping its completed iterations. A readable state
that no longer matches the model raises; a torn meta sidecar or state file
starts the run afresh."""

import json

import pytest
import torch

from deeppicarditeration_torch.config import default_cfg, load_cfg
from deeppicarditeration_torch.training import baselines, checkpoint
from deeppicarditeration_torch.training.picard import PicardRunner

torch.set_num_threads(1)

PICARD = {
    "NAME": "resume_picard", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": 3, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "PICARD": {"N": 3},
    "DATA": {"DATA_SIZE": 64, "CHUNK_ELEMS": 16384,
             "kwargs": {"t_always_uniform": True, "n_estimate_terminal": 32,
                        "n_estimate_integral": 32}},
    "TRAIN": {"BATCH_SIZE": 32, "N_EPOCHS": 2, "SUPERVISE_GRADIENT": True},
    "NETWORK": {"NEURONS": [8, 8], "ACTIVATIONS": ["ELU", "ELU"],
                "RELOAD": True},
    "EVAL": {"FREQ": 2, "L2_N_POINTS": 32, "TEST_GRAD": True},
}
DIFFUSION = {
    "NAME": "resume_diffusion", "FORCE": True,
    "EQUATION": {"cls": "Cha",
                 "kwargs": {"nx": 3, "alpha": 1.0, "k": 1.0, "T": 1.0}},
    "METHOD": {"cls": "Diffusion", "K": 4, "dt": 0.05},
    "PICARD": {"N": 1},
    "TRAIN": {"BATCH_SIZE": 16, "N_EPOCHS": 6, "LOSS": {"beta": 10.0}},
    "NETWORK": {"NEURONS": [8, 8], "ACTIVATIONS": ["ELU", "ELU"]},
    "EVAL": {"FREQ": 2, "L2_N_POINTS": 32},
}
PINN = {**DIFFUSION, "NAME": "resume_pinn",
        "METHOD": {"cls": "PINN", "num_v_samples": 2}}
DBDP = {
    "NAME": "resume_dbdp", "FORCE": True,
    "EQUATION": {"cls": "GBMEquationComplexExact",
                 "kwargs": {"nx": 3, "alpha": 1.0, "T": 0.2}},
    "METHOD": {"cls": "FullyNonlinearSolver", "dt": 0.1, "num_sub_iter": 2},
    "PICARD": {"N": 2},
    "TRAIN": {"BATCH_SIZE": 16, "N_EPOCHS": 1},
    "NETWORK": {"NEURONS": [8], "ACTIVATIONS": ["ELU"]},
    "EVAL": {"FREQ": 1},
}


class Stop(Exception):
    """The run's kill."""


def _cfg(recipe, **over):
    cfg = default_cfg()
    cfg.merge({**recipe, "DEVICE": "cpu"}, allow_new=False)
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg.freeze()


def _params(path):
    return checkpoint.read(path)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_picard_run_resumes_at_an_iteration_bitwise(tmp_path):
    whole = PicardRunner(_cfg(PICARD), exp_root=tmp_path / "whole")
    whole.run()
    cut = PicardRunner(_cfg(PICARD), exp_root=tmp_path / "cut")
    cut.run_one()
    cut.run_one()  # killed during iteration 3
    cut.logger.close()
    resumed = PicardRunner(_cfg(PICARD, RESUME=True),
                           exp_root=tmp_path / "cut")
    assert resumed.i == 2 and resumed.u_current.kind == "net"
    assert _equal(resumed.u_current.module.state_dict(),
                  _params(cut.exp_dir / "model_2"))
    resumed.run()
    assert resumed.i == 3
    for i in (1, 2, 3):
        assert _equal(_params(whole.exp_dir / f"model_{i}"),
                      _params(cut.exp_dir / f"model_{i}")), i
    rows = [json.loads(ln) for ln in
            (cut.exp_dir / "metrics.jsonl").read_text().splitlines()]
    assert {r["iter"] for r in rows if r["context"] == "eval"} == {1, 2, 3}


def _killed_after(monkeypatch, intervals: int):
    """Make the periodic save raise ``Stop`` at interval ``intervals`` + 1:
    the state and meta on disk are then interval ``intervals``'s."""
    real = checkpoint.save_state
    calls = []

    def save_state(*args):
        calls.append(1)
        if len(calls) > intervals:
            raise Stop
        real(*args)

    monkeypatch.setattr(checkpoint, "save_state", save_state)
    return lambda: monkeypatch.setattr(checkpoint, "save_state", real)


@pytest.mark.parametrize("recipe", [DIFFUSION, PINN],
                         ids=["diffusion", "pinn"])
def test_baseline_resumes_at_a_log_interval_bitwise(tmp_path, monkeypatch,
                                                    recipe):
    whole = PicardRunner(_cfg(recipe), exp_root=tmp_path / "whole")
    whole.run()
    cut = PicardRunner(_cfg(recipe), exp_root=tmp_path / "cut")
    restore = _killed_after(monkeypatch, 1)
    with pytest.raises(Stop):
        cut.run()
    restore()
    meta = json.loads((cut.exp_dir / "baseline_1_meta.json").read_text())
    assert meta["epoch"] == 2 and not (cut.exp_dir / "model_1").exists()
    resumed = PicardRunner(_cfg(recipe, RESUME=True),
                           exp_root=tmp_path / "cut")
    assert resumed.i == 0  # no model_1: the baseline's iteration reruns
    resumed.run()
    assert _equal(_params(whole.exp_dir / "model_1"),
                  _params(cut.exp_dir / "model_1"))
    assert _equal(_params(whole.exp_dir / "baseline_1_state")["optimizer"]
                  ["state"][0], _params(cut.exp_dir / "baseline_1_state")
                  ["optimizer"]["state"][0])
    meta = json.loads((cut.exp_dir / "baseline_1_meta.json").read_text())
    assert meta["epoch"] == 6 and meta["wall_time"] > 0


def test_dbdp_resume_skips_its_completed_iterations(tmp_path):
    whole = PicardRunner(_cfg(DBDP), exp_root=tmp_path / "whole")
    whole.run()
    cut = PicardRunner(_cfg(DBDP), exp_root=tmp_path / "cut")
    cut.run_one()
    per_iteration = cut.rollout_calls
    resumed = PicardRunner(_cfg(DBDP, RESUME=True),
                           exp_root=tmp_path / "cut")
    assert resumed.i == 1
    resumed.run()
    assert resumed.i == 2 and resumed.rollout_calls == per_iteration
    assert _equal(_params(whole.exp_dir / "model_2"),
                  _params(cut.exp_dir / "model_2"))


def test_a_mismatched_state_raises_and_a_torn_one_starts_fresh(
        tmp_path, monkeypatch, capsys):
    cut = PicardRunner(_cfg(PINN), exp_root=tmp_path)
    restore = _killed_after(monkeypatch, 1)
    with pytest.raises(Stop):
        cut.run()
    restore()
    # a readable state of another net: raise, do not start afresh
    other = _cfg(PINN, RESUME=True, **{"NETWORK.NEURONS": [4, 4]})
    with pytest.raises(RuntimeError, match="does not match"):
        PicardRunner(other, exp_root=tmp_path).run()
    # a torn meta sidecar or state file: start afresh, as a fresh run
    fresh = PicardRunner(_cfg(PINN), exp_root=tmp_path / "fresh")
    fresh.run()
    meta = cut.exp_dir / "baseline_1_meta.json"
    state = cut.exp_dir / "baseline_1_state"
    assert checkpoint.is_readable(state)
    for torn in ("meta", "state"):
        if torn == "meta":
            meta.write_text('{"epoch": ')
        else:
            meta.write_text(json.dumps({"epoch": 2, "wall_time": 1.0}))
            state.write_bytes(state.read_bytes()[:100])
            assert not checkpoint.is_readable(state)
        (cut.exp_dir / "model_1").unlink(missing_ok=True)
        PicardRunner(_cfg(PINN, RESUME=True), exp_root=tmp_path).run()
        assert "starting fresh" in capsys.readouterr().out
        assert _equal(_params(fresh.exp_dir / "model_1"),
                      _params(cut.exp_dir / "model_1")), torn


def test_resume_keeps_the_checkpoints_and_rejects_a_saved_dataset(tmp_path):
    PicardRunner(_cfg(PICARD, **{"PICARD.N": 1}), exp_root=tmp_path).run()
    exp = tmp_path / PICARD["NAME"]
    before = _params(exp / "model_1")
    runner = PicardRunner(_cfg(PICARD, RESUME=True, FORCE=False),
                          exp_root=tmp_path)
    assert _equal(before, _params(exp / "model_1")) and runner.i == 1
    with pytest.raises(NotImplementedError, match="RESUME"):
        PicardRunner(_cfg(PICARD, RESUME=True, **{"DATA.SAVE": True}),
                     exp_root=tmp_path)
    cfg = load_cfg(exp / "config.yaml")
    assert cfg.RESUME is True and cfg.DEVICE == "cpu"
