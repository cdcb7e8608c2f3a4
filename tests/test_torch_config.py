"""The port's config module and import boundary.

* Config parity: the port's ``load_cfg`` gives the JAX ``load_cfg``'s tree
  on the shipped recipes (apart from the port-only ``DEVICE`` key), and
  chip_smoke.py's in-code Burgers w1.0 recipe equals the YAML chain.
* Guard: nothing in ``deeppicarditeration_torch/`` or ``chip_smoke.py``
  imports jax, flax, optax, orbax or the JAX package.
"""

import ast
import pathlib

import pytest

from deeppicarditeration_tpu.config import load_cfg as jax_load_cfg
from deeppicarditeration_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
W1 = ROOT / "configs/burgers/base_100d_T1.0_w1.0.yaml"


def _without_device(d):
    d = dict(d)
    assert d.pop("DEVICE") == "cuda"
    return d


@pytest.mark.parametrize("name", ["base_100d_T1.0_w1.0.yaml",
                                  "base_100d_T1.0_w0.0.yaml",
                                  "base_100d_T1.0_w1.0_best.yaml"])
def test_load_cfg_matches_jax(name):
    path = ROOT / "configs/burgers" / name
    assert (_without_device(tconfig.load_cfg(path).to_dict())
            == jax_load_cfg(path).to_dict())


def test_overrides_and_unknown_keys_match_jax():
    ov = ["PICARD.N", "3", "TRAIN.OPTIMIZER.kwargs.lr", "1e-4",
          "EVAL.FREQ", "None"]
    port = tconfig.load_cfg(W1, ov + ["DEVICE", "cpu"]).to_dict()
    assert port.pop("DEVICE") == "cpu"
    assert port == jax_load_cfg(W1, ov).to_dict()
    with pytest.raises(KeyError):
        tconfig.load_cfg(W1, ["TRAIN.NOT_A_KEY", "1"])
    with pytest.raises(ValueError):
        tconfig.load_cfg(W1, ["BASE", "x.yaml"])


def test_dump_is_json_readable_as_yaml(tmp_path):
    """``dump`` writes JSON (no PyYAML needed to write the run's
    config.yaml); PyYAML reads it back to the same tree."""
    cfg = tconfig.load_cfg(W1)
    (tmp_path / "c.yaml").write_text(cfg.dump())
    assert tconfig.load_cfg(tmp_path / "c.yaml").to_dict() == cfg.to_dict()


def test_runner_rejects_what_the_port_lacks(tmp_path):
    from deeppicarditeration_torch.training.picard import PicardRunner

    for ov in (["DATA.TPU.PALLAS_GENERATE", "false"], ["RESUME", "true"],
               ["DATA.TPU.PALLAS_PRECISION", "default"],
               ["METHOD.cls", "PINN"], ["DATA.SAVE", "true"]):
        cfg = tconfig.load_cfg(W1, ["DEVICE", "cpu"] + ov)
        with pytest.raises(NotImplementedError):
            PicardRunner(cfg, exp_root=tmp_path)


def test_chip_smoke_recipe_equals_the_yaml_chain():
    import chip_smoke

    assert (chip_smoke.burgers_w1_cfg(100).to_dict()
            == tconfig.load_cfg(W1).to_dict())


_BANNED = ("jax", "flax", "optax", "orbax", "deeppicarditeration_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "deeppicarditeration_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in _BANNED]
    assert not bad, bad
