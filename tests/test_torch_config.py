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
BEST = ROOT / "configs/burgers/base_100d_T1.0_w1.0_best.yaml"
DIFFUSION = ROOT / "configs/burgers/diffusion_100d_T1.0_beta10.0.yaml"
HJB = ROOT / "configs/hjb/base_100d_T1.0_w0.1.yaml"
HJB_DIFFUSION = ROOT / "configs/hjb/diffusion_100d_T1.0.yaml"


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
    """What the port lacks raises at the runner's construction; RESUME and
    METHOD.cls PINN, ported since, construct (RESUME with DATA.SAVE, a
    resume from a saved dataset, still raises)."""
    from deeppicarditeration_torch.training.picard import PicardRunner

    for ov in (["DATA.EXACT", "true"],
               ["RESUME", "true", "DATA.SAVE", "true"],
               ["DATA.TPU.PALLAS_ACT", "bf16"],
               ["TRAIN.SUPERVISE_HESSIAN", "true"],
               ["PICARD.FORMULA", "TwoLayer"],
               ["DATA.SAVE", "true"],
               ["METHOD.cls", "FullyNonlinearSolver"]):
        cfg = tconfig.load_cfg(W1, ["DEVICE", "cpu"] + ov)
        with pytest.raises(NotImplementedError):
            PicardRunner(cfg, exp_root=tmp_path)
    for ov in (["RESUME", "true"], ["METHOD.cls", "PINN"]):
        cfg = tconfig.load_cfg(W1, ["DEVICE", "cpu", "FORCE", "true"] + ov)
        runner = PicardRunner(cfg, exp_root=tmp_path)
        assert runner.i == 0 and runner.cfg.METHOD.cls == cfg.METHOD.cls


def test_chip_smoke_recipe_equals_the_yaml_chain():
    import chip_smoke

    assert (chip_smoke.burgers_w1_cfg(100).to_dict()
            == tconfig.load_cfg(W1).to_dict())


@pytest.mark.parametrize("path", ["B", "B'", "C", "D", "F", "G"])
def test_chip_smoke_path_recipes_equal_the_yaml(path):
    """Paths B, B', C, F and G are the w1.0 YAML with chip_smoke's overrides;
    path D is configs/burgers/base_100d_T1.0_w1.0_best.yaml. Both packages
    load them to the same tree and map the DATA.TPU flags alike."""
    import chip_smoke
    from deeppicarditeration_torch.training.picard import (
        gen_config_from_cfg,
    )
    from deeppicarditeration_tpu.training.picard import (
        gen_config_from_cfg as jax_gen_config_from_cfg,
    )

    yaml = BEST if path == "D" else W1
    overrides = list(chip_smoke.PATHS[path][1])
    port = tconfig.load_cfg(yaml, overrides)
    assert chip_smoke.path_cfg(path, 100).to_dict() == port.to_dict()
    jcfg = jax_load_cfg(yaml, overrides)
    assert _without_device(port.to_dict()) == jcfg.to_dict()
    gen, jgen = gen_config_from_cfg(port), jax_gen_config_from_cfg(jcfg, 1)
    for field in ("n_estimate_terminal", "n_estimate_integral", "tpu_prng",
                  "antithetic", "pallas_terminal", "pallas_integral",
                  "pallas_generate", "pallas_precision", "chunk_elems"):
        assert getattr(gen, field) == getattr(jgen, field), field


def test_chip_smoke_path_e_equals_the_diffusion_yaml():
    """Path E is configs/burgers/diffusion_100d_T1.0_beta10.0.yaml as it
    stands; ``--epochs 35000`` gives the recipe's own budget, and the JAX
    package loads the YAML to the same tree."""
    import chip_smoke

    overrides = list(chip_smoke.PATHS["E"][1])
    assert overrides == []
    port = tconfig.load_cfg(DIFFUSION, overrides)
    assert chip_smoke.diffusion_cfg(35000).to_dict() == port.to_dict()
    assert port.TRAIN.N_EPOCHS == 35000 and port.METHOD.cls == "Diffusion"
    assert _without_device(port.to_dict()) == jax_load_cfg(
        DIFFUSION, overrides).to_dict()
    cut = chip_smoke.diffusion_cfg(chip_smoke.DIFFUSION_EPOCHS).to_dict()
    assert cut["TRAIN"].pop("N_EPOCHS") == 3000
    full = port.to_dict()
    full["TRAIN"].pop("N_EPOCHS")
    assert cut == full


@pytest.mark.parametrize("name", ["base_100d_T1.0_w0.1.yaml",
                                  "diffusion_100d_T1.0.yaml",
                                  "hjb_control_100d_T1.0.yaml",
                                  "hjb_nest_10d_T1.0_w1.0.yaml"])
def test_load_cfg_matches_jax_on_the_hjb_recipes(name):
    path = ROOT / "configs/hjb" / name
    assert (_without_device(tconfig.load_cfg(path).to_dict())
            == jax_load_cfg(path).to_dict())


@pytest.mark.parametrize("path", ["H", "J"])
def test_chip_smoke_hjb_recipes_equal_the_yaml(path):
    """Path H is configs/hjb/base_100d_T1.0_w0.1.yaml as it stands (J with
    bf16x3); both packages load it to the same tree and map its DATA.TPU
    flags alike (PALLAS_PRECISION default)."""
    import chip_smoke
    from deeppicarditeration_torch.training.picard import (
        gen_config_from_cfg,
    )
    from deeppicarditeration_tpu.training.picard import (
        gen_config_from_cfg as jax_gen_config_from_cfg,
    )

    overrides = list(chip_smoke.PATHS[path][1])
    port = tconfig.load_cfg(HJB, overrides)
    assert chip_smoke.path_cfg(path, 40).to_dict() == port.to_dict()
    jcfg = jax_load_cfg(HJB, overrides)
    assert _without_device(port.to_dict()) == jcfg.to_dict()
    gen, jgen = gen_config_from_cfg(port), jax_gen_config_from_cfg(jcfg, 1)
    assert gen.pallas_precision == ("default" if path == "H" else "bf16x3")
    for field in ("n_estimate_terminal", "n_estimate_integral",
                  "pallas_generate", "pallas_precision", "chunk_elems",
                  "antithetic"):
        assert getattr(gen, field) == getattr(jgen, field), field


def test_chip_smoke_path_i_equals_the_hjb_diffusion_yaml():
    """Path I is configs/hjb/diffusion_100d_T1.0.yaml as it stands;
    ``--hjb-epochs 15000`` gives the recipe's own budget."""
    import chip_smoke

    assert list(chip_smoke.PATHS["I"][1]) == []
    port = tconfig.load_cfg(HJB_DIFFUSION)
    assert chip_smoke.hjb_diffusion_cfg(15000).to_dict() == port.to_dict()
    assert (port.METHOD.cls, port.METHOD.K, port.NETWORK.PISGRADNET) == (
        "Diffusion", 50, False)
    assert _without_device(port.to_dict()) == jax_load_cfg(
        HJB_DIFFUSION).to_dict()
    cut = chip_smoke.hjb_diffusion_cfg(
        chip_smoke.HJB_DIFFUSION_EPOCHS).to_dict()
    assert cut["TRAIN"].pop("N_EPOCHS") == 2000
    full = port.to_dict()
    full["TRAIN"].pop("N_EPOCHS")
    assert cut == full


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
