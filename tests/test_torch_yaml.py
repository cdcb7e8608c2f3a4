"""The port's YAML reader (``deeppicarditeration_torch/yaml_subset.py``)
against ``yaml.safe_load``: every file under ``configs/``, a dumped
``config.yaml``, the YAML the repo's tests write, and a table of edge cases
(YAML 1.1's resolver quirks included) read to the same values; every
shipped config loads with no YAML package importable; input outside the
subset raises."""

import math
import pathlib
import sys

import pytest
import torch
import yaml

from deeppicarditeration_torch import config as tconfig
from deeppicarditeration_torch.yaml_subset import YAMLSubsetError, safe_load

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[str(p.relative_to(ROOT)) for p in CONFIGS])
def test_every_shipped_config_reads_as_safe_load(path):
    text = path.read_text()
    assert _same(safe_load(text), yaml.safe_load(text))


def test_dumped_config_and_test_yaml_read_as_safe_load(tmp_path):
    for cfg_file in ("configs/hjb/pinn_100d_T1.0_v16.yaml",
                     "configs/burgers/base_100d_T1.0_w1.0_best.yaml"):
        dumped = tconfig.load_cfg(ROOT / cfg_file, [
            "TRAIN.OPTIMIZER.kwargs.lr", "1e-5",
            "EQUATION.kwargs.note", "'x: y # z'"]).dump()
        assert _same(safe_load(dumped), yaml.safe_load(dumped))
    # the YAML the repo's own tests write (tests/test_cli.py,
    # tests/test_config.py)
    for text in (
            "NAME: tiny\nFORCE: true\nEQUATION:\n  cls: Cha\n  kwargs: "
            "{nx: 3, alpha: 1.0, k: 1.0, T: 1.0}\nPICARD:\n  N: 2\n",
            "BASE: base.yaml\nNAME: child\nTRAIN:\n  N_EPOCHS: 5\n",
            "NETWORK:\n  BOUND: None\n  NEURONS: [8]\n  ACTIVATIONS: [Tanh]"
            "\nDATA:\n  N_WORKERS: 0\n  PREFETCH_FACTOR: None\n",
            "EVAL:\n  FREQ: null\n"):
        assert _same(safe_load(text), yaml.safe_load(text))


EDGES = [
    "a: 1e-3\nb: 1.0e5\nc: 1.5e-3\nd: .5\ne: 0o7\nf: 010\ng: 0x1F\n"
    "h: 1_000\ni: +1\nj: -0\nk: 0.\nl: 1e5\nm: 6.0E-3\nn: 1.0e+5\n",
    "a: ~\nb:\nc: null\nd: Null\ne: None\nf: NULL\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: true\nf: False\n",
    "a: '1'\nb: \"2.5\"\nc: 'true'\nd: \"null\"\ne: 'it''s'\n"
    "f: \"tab\\tq\\\"\\u00e9\\x41\"\n",
    "a: {x: 1, 'y': \"2\", z: [a, {b: c}]}\nb: { }\nc: []\n",
    "a: -.inf\nb: .NaN\nc: +.inf\nd: 12:30\ne: 1:30.5\n",
    "a:\n- 1\n- [2, 3]\nb:\n  - x\n  -\n  - 'y'\nc: 3\n",
    "- 1\n- two\n-\n  a: 1\n",
    "1: one\ntrue: t\nnull: n\n'k': 1\n\"k2\" : 2\n",
    "a: b # comment\nd: e#f\n# whole line\n  # indented\ng: h   \n",
    "a: http://x:y\nb: -x\nc: x-\nd: a b  c\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "{\n  \"a\": 1,\n  \"b\": [\n    1,\n    2.5\n  ],\n  \"c\": {},\n"
    "  \"d\": 1e-05\n}\n",
    "a: [1, 2,]\nb: {x: 1,}\nc: [ [ ], { } ]\n",
    "x: 1\nx: 2\n",
    "",
    "# only a comment\n",
    "plain scalar\n",
]


@pytest.mark.parametrize("text", EDGES)
def test_edge_cases_read_as_safe_load(text):
    assert _same(safe_load(text), yaml.safe_load(text))


OUTSIDE = [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n",
    "---\na: 1\n", "%YAML 1.1\n---\na: 1\n", "a: 2001-12-14\n",
    "<<: {a: 1}\n", "- a: 1\n", "- - 1\n", "a: b\n  c\n",
    "a: 'x\n  y'\n", "\ta: 1\n", "a: [a:b]\n", "? a\n: b\n", "a: [1\n",
    "a: b: c\n", "a: [x\n y]\n", "a: {x}\n", "a: - 1\n",
    "a:\n  b: 1\n   c: 2\n", "a: 1\n  b: 2\n", "[a]: 1\n", "a: =\n",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_input_outside_the_subset_raises(text):
    with pytest.raises(YAMLSubsetError):
        safe_load(text)


def test_every_shipped_config_loads_without_a_yaml_package(monkeypatch):
    """load_cfg imports no YAML package: with ``yaml`` unimportable every
    shipped config loads to the tree it loads to with PyYAML."""
    import deeppicarditeration_tpu.config as jax_config

    want = {p: jax_config.load_cfg(p).to_dict() for p in CONFIGS}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    for p in CONFIGS:
        got = tconfig.load_cfg(p).to_dict()
        assert got.pop("DEVICE") == "cuda"
        assert got == want[p], p
