"""Config system: YAML tree with single-inheritance ``BASE:`` chains.

The port's own copy of ``deeppicarditeration_tpu/config.py`` (the port
imports nothing of the JAX package). It loads the same recipe files to the
same tree, plus one port key, ``DEVICE`` (default ``"cuda"``). PyYAML is
imported inside ``load_cfg`` only, so a config built in code needs no YAML
package; ``Config.dump`` writes JSON, which YAML reads.

Semantics (as in the JAX package): configs may point at a parent file via
``BASE:``; chains are resolved deep -> shallow; ``NAME`` fields are
concatenated along the chain; CLI ``KEY.SUBKEY value`` overrides are merged
last and may not touch ``BASE``; unknown keys raise; the result is frozen.
The key layout (EQUATION/METHOD/PICARD/TRAIN/NETWORK/DATA/EVAL/LOGGING) is
the reference implementation's; its GPU-memory-probing and DataLoader keys
(NEW_SAMPLING, N_WORKERS, MEMORY.*, PRELOAD, ...) are accepted with a
warning and ignored (``_OBSOLETE_KEYS``). The TPU-specific keys (MESH,
DATA.TPU.*, chunking, precision policy) are kept so that both packages
load every recipe to the same tree.
"""

from __future__ import annotations

import ast
import copy
import json
import pathlib
from typing import Any, Dict, List, Optional


class FrozenConfigError(AttributeError):
    pass


class Config(dict):
    """A nested attribute-accessible dict that can be frozen."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, list):
            return [cls._wrap(v) for v in value]
        return value

    # --- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if object.__getattribute__(self, "_frozen"):
            raise FrozenConfigError(f"Config is frozen; cannot set {name}")
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        if object.__getattribute__(self, "_frozen"):
            raise FrozenConfigError(f"Config is frozen; cannot set {name}")
        super().__setitem__(name, self._wrap(value))

    # --- freeze -----------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, Config):
                v.defrost()
        return self

    def clone(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        """The tree as JSON text (a subset of YAML: ``load_cfg`` reads it)."""
        return json.dumps(self.to_dict(), indent=2)

    # --- merging ----------------------------------------------------------
    # Nodes holding arbitrary user-defined keys (exempt from strict-key
    # checking): every *.kwargs subtree.
    _FREEFORM = ("kwargs",)

    def merge(self, other: Dict[str, Any], allow_new: bool = True):
        """Recursively merge ``other`` into self (other wins).

        With allow_new=False a key absent from the default tree raises
        (yacs "Non-existent config key" parity, so typo'd recipe keys
        fail loudly) — except inside free-form ``kwargs`` subtrees."""
        if object.__getattribute__(self, "_frozen"):
            raise FrozenConfigError("Config is frozen; cannot merge")
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), Config):
                self[k].merge(v, allow_new=allow_new or k in self._FREEFORM)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Non-existent config key: {k}")
                self[k] = self._wrap(v)
        return self

    def merge_from_list(self, override: List[str]):
        """Merge ``["KEY.SUBKEY", "value", ...]`` pairs (CLI overrides).
        Unknown keys raise unless under a free-form kwargs subtree;
        obsolete reference keys warn and are ignored (same shim as YAML
        loading — reference users pass e.g. ``DATA.N_WORKERS 0``)."""
        assert len(override) % 2 == 0, "override list must be key/value pairs"
        for key, raw in zip(override[::2], override[1::2]):
            key = key.lstrip("-")
            if any(key == k or key.startswith(k + ".")
                   for k in _OBSOLETE_KEYS):
                import warnings

                warnings.warn(
                    f"config key {key} is obsolete; accepted for "
                    "reference-recipe compatibility and ignored",
                    stacklevel=2)
                continue
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if (parts[-1] not in node
                    and not any(p in self._FREEFORM for p in parts[:-1])):
                raise KeyError(f"Non-existent config key: {key}")
            node[parts[-1]] = _parse_value(raw)
        return self


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value: try python literal, fall back to str."""
    if raw in ("None", "none", "null"):
        return None
    if raw in ("true", "True"):
        return True
    if raw in ("false", "False"):
        return False
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def wants_float64(float_value) -> bool:
    """DATA.FLOAT string table: truthy for the double family."""
    return str(float_value).strip().lower() in (
        "double", "float64", "f64", "64")


def default_cfg() -> Config:
    """The fully-specified default tree (the JAX package's, plus DEVICE).

    Keys that only the JAX package reads (MESH, DATA.TPU.* kernel knobs
    other than ANTITHETIC, TRAIN.DISPATCH_STEPS, DATA.CHUNK_ELEMS as a
    scan size) are kept so that every recipe loads to the same tree in
    both packages. The port ignores the JAX-only speed knobs and raises on
    values that would change what it computes
    (``training/picard.py:_reject_unported``). TRAIN.DISPATCH_STEPS bounds
    the train steps of one XLA dispatch; the port's fused fit replays a
    CUDA graph per epoch, which has no dispatch length to bound, so, like
    the TPU tiling machinery, it has no counterpart. TRAIN.FUSED is read
    by both (``training/picard.py:fit_route``)."""
    c = Config()
    c.BASE = None
    c.FORCE = False
    c.RESUME = False  # continue from the latest model_{i} (not ported yet)
    c.NAME = "exp"
    c.SEED = 0
    # Port-only key: the torch device entry points run on ("cuda" | "cpu").
    # "cuda" raises when there is no card; nothing falls back to the CPU.
    c.DEVICE = "cuda"

    c.EQUATION = Config()
    c.EQUATION.cls = "Cha"
    c.EQUATION.kwargs = Config()

    c.METHOD = Config()
    c.METHOD.cls = "Picard"  # Picard | PINN | Diffusion | FullyNonlinearSolver
    c.METHOD.num_v_samples = 16  # Hutchinson probes; -1 => exact laplacian
    c.METHOD.K = 20  # rollout steps (Diffusion baseline)
    c.METHOD.dt = 0.005
    c.METHOD.num_sub_iter = 100  # DBDP sub-iterations per timestep

    c.PICARD = Config()
    c.PICARD.N = 1
    c.PICARD.FORMULA = None  # None | "TwoLayer"

    c.TRAIN = Config()
    c.TRAIN.BATCH_SIZE = 2048
    c.TRAIN.N_EPOCHS = 1
    c.TRAIN.SUPERVISE_GRADIENT = None
    c.TRAIN.SUPERVISE_HESSIAN = None
    c.TRAIN.NUM_HESS_SAMPLES = -1
    # the fit and its evals fused: one lax.scan dispatch in the JAX
    # package, CUDA-graph replays in the port ("auto" | true | false)
    c.TRAIN.FUSED = "auto"
    c.TRAIN.DISPATCH_STEPS = 65536  # JAX: train steps per dispatch
    c.TRAIN.LOSS = Config()
    c.TRAIN.LOSS.beta = 0.0  # exp(beta * t) sample weighting
    c.TRAIN.LOSS.SCALER = Config()
    c.TRAIN.LOSS.SCALER.cls = None
    c.TRAIN.LOSS.SCALER.kwargs = Config()
    c.TRAIN.LOSS.FN = Config()
    c.TRAIN.LOSS.FN.cls = None  # None => square; "LossFnLinearClip" => huber-ish
    c.TRAIN.LOSS.FN.kwargs = Config()
    c.TRAIN.LOSS.use_aux_loss = False
    c.TRAIN.LOSS.weight_aux_loss = 0.1
    c.TRAIN.OPTIMIZER = Config()
    c.TRAIN.OPTIMIZER.cls = "Adam"
    c.TRAIN.OPTIMIZER.kwargs = Config()
    c.TRAIN.OPTIMIZER.SCHEDULER = Config()
    c.TRAIN.OPTIMIZER.SCHEDULER.cls = None
    c.TRAIN.OPTIMIZER.SCHEDULER.kwargs = Config()
    c.TRAIN.OPTIMIZER.SCHEDULER.config = Config()

    c.NETWORK = Config()
    c.NETWORK.cls = None  # None => PicardSolution
    c.NETWORK.TYPE = "Value"  # Value | ValueGradient | OnlyGradient
    c.NETWORK.NEURONS = [10, 10]
    c.NETWORK.ACTIVATIONS = ["Tanh", "Tanh"]
    c.NETWORK.BOUND = None
    c.NETWORK.RELOAD = False
    c.NETWORK.PISGRADNET = False
    c.NETWORK.PRETRAIN_PATH = None
    c.NETWORK.kwargs = Config()

    c.DATA = Config()
    c.DATA.kwargs = Config()  # t_always_uniform, n_estimate_terminal/integral
    c.DATA.SAVE = False
    c.DATA.SAVE_FORMAT = "npz"  # "npz" | "h5"/"hdf5"
    c.DATA.ONLINE = True
    c.DATA.TRAIN_FILE = ""
    c.DATA.DATA_SIZE = 2048 * 5000
    c.DATA.DEVICE = None  # unused; kept for recipe compatibility
    c.DATA.FLOAT = "float"  # "float" | "double"
    c.DATA.EXACT = False
    c.DATA.SHUFFLE = None
    c.DATA.HESSIAN_APPROXIMATION = Config()
    c.DATA.HESSIAN_APPROXIMATION.method = None  # None | "SDGD"
    c.DATA.HESSIAN_APPROXIMATION.kwargs = Config()
    c.DATA.SAMPLE_BOUND = None
    # estimator-type strings; their only live effect is the epsilon of the
    # uniform t-sampler: eps = 0.01 iff "ByGx" in ESTIMATE_TERMINAL or
    # "Joint" in ESTIMATE_INTEGRAL (the defaults hit it)
    c.DATA.ESTIMATE_TERMINAL = "OU_ByGx"
    c.DATA.ESTIMATE_INTEGRAL = "OU_Simple"
    c.DATA.ESTIMATE_DELTA_T = 0.0  # >0 => TD-style short-horizon estimators
    # B * m_chunk * nx per MC chunk; also sizes DATA.GEN_BATCH's default
    c.DATA.CHUNK_ELEMS = 2 ** 22
    c.DATA.GEN_BATCH = None  # collocation points per generation call
    c.DATA.TPU = Config()  # the JAX package's estimator-kernel switches
    c.DATA.TPU.ANTITHETIC = False  # +/- dW pairs: half the draws
    c.DATA.TPU.PRNG = False
    c.DATA.TPU.PALLAS_TERMINAL = False
    c.DATA.TPU.PALLAS_INTEGRAL = False
    c.DATA.TPU.PALLAS_GENERATE = "auto"
    c.DATA.TPU.PALLAS_PRECISION = "bf16x3"
    c.DATA.TPU.PALLAS_ACT = None
    c.DATA.TPU.PALLAS_ROLLOUT = False
    c.DATA.TPU.HESSIAN_STORE = None

    c.MESH = Config()
    c.MESH.AXES = ["data"]
    c.MESH.SHAPE = None  # None => all local devices on one axis

    # f32 matmul precision: "highest"/"float32" (full f32), "high"/
    # "tensorfloat32", "bfloat16", or "default" (leave the framework's)
    c.PRECISION = Config()
    c.PRECISION.MATMUL = "highest"

    c.LOGGING = Config()
    c.LOGGING.LOGGER = "jsonl"  # jsonl | tensorboard | none
    c.LOGGING.kwargs = Config()
    c.LOGGING.TENSORBOARD_DIR = "tensorboard"

    c.EVAL = Config()
    c.EVAL.L2_N_POINTS = 10_000
    c.EVAL.FREQ = None
    c.EVAL.BATCH_SIZE = None
    c.EVAL.TEST_GRAD = False
    c.EVAL.TEST_HESSIAN = False
    c.EVAL.PLOT = False
    c.EVAL.PLOT_N_POINTS = 2000
    # precomputed reference-solution file for equations without a closed
    # form: npy columns [t, x(nx), u[, u_x(nx)]] or npz with tx/u[/ux]
    c.EVAL.REFERENCE_FILE = None
    return c


# Reference-implementation config keys accepted for recipe compatibility
# and ignored: its GPU-memory autosizing and DataLoader machinery has no
# counterpart here, and USE_T_EMBEDDING is dead in the reference itself.
# Dotted paths name a leaf or a whole subtree.
_OBSOLETE_KEYS = {
    "DATA.N_WORKERS": "DataLoader workers — no host dataloader",
    "DATA.PREFETCH_FACTOR": "DataLoader prefetch — no host dataloader",
    "DATA.PRELOAD": "cache preload — the dataset is device-resident",
    "DATA.PRELOAD_N_WORKERS": "cache preload — the dataset is "
                              "device-resident",
    "DATA.NEW_SAMPLING": "memory-probe chunk sizing — generation sizes "
                         "are static",
    "DATA.N_BUFFER": "buffer autosizing — static shapes",
    "DATA.RESERVED_MEMORY": "memory reservation — static sizes",
    "DATA.MEMORY": "memory autosizing subtree — static sizes",
    "NETWORK.USE_T_EMBEDDING": "dead key (never read by the reference "
                               "either)",
}


def _strip_obsolete(raw: Dict[str, Any], path: str = "",
                    warned: Optional[set] = None) -> Dict[str, Any]:
    """Drop-and-warn obsolete reference keys from a raw YAML dict."""
    import warnings

    out = {}
    for k, v in (raw or {}).items():
        p = f"{path}.{k}" if path else k
        if p in _OBSOLETE_KEYS:
            if warned is None or p not in warned:
                warnings.warn(
                    f"config key {p} is obsolete ({_OBSOLETE_KEYS[p]})"
                    "; accepted for reference-recipe compatibility and "
                    "ignored", stacklevel=2)
                if warned is not None:
                    warned.add(p)
            continue
        if isinstance(v, dict):
            v = _strip_obsolete(v, p, warned)
        out[k] = v
    return out


def _normalize_none(obj):
    """Map bare "None" strings to null (recursively).

    The reference YAMLs write ``BOUND: None`` / ``PREFETCH_FACTOR: None``,
    which YAML parses as the *string* 'None'; yacs's type coercion lets
    those through against None defaults, so recipe files rely on it. Same
    treatment as CLI overrides (_parse_value)."""
    if isinstance(obj, dict):
        return {k: _normalize_none(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalize_none(v) for v in obj]
    if obj in ("None", "none", "null"):
        return None
    return obj


def _read_yaml(path: pathlib.Path) -> Dict[str, Any]:
    import yaml  # here, not at module level: the card's machine lacks it

    with open(path) as f:
        return _normalize_none(yaml.safe_load(f) or {})


def load_cfg(cfg_file, override: Optional[List[str]] = None) -> Config:
    """Load a config file, resolving its BASE chain and applying overrides.

    BASE paths are resolved relative to the file that references them.
    NAME values along the chain are joined with underscores
    (reference parity: config.py:247-254).
    """
    cfg_file = pathlib.Path(cfg_file)
    chain = []  # shallow -> deep
    path = cfg_file
    seen = set()
    while path is not None:
        path = path.resolve()
        if path in seen:
            raise ValueError(f"Circular BASE chain at {path}")
        seen.add(path)
        raw = _read_yaml(path)
        chain.append(raw)
        base = raw.get("BASE")
        path = (path.parent / base) if base else None

    cfg = default_cfg()
    names = []
    warned: set = set()
    for raw in reversed(chain):  # deep -> shallow
        raw = _strip_obsolete(dict(raw), warned=warned)
        raw.pop("BASE", None)
        if "NAME" in raw:
            names.append(raw["NAME"])
        cfg.merge(raw, allow_new=False)
    cfg.NAME = "_".join(names) if names else cfg.NAME
    cfg.BASE = None

    if override:
        for k in override[::2]:
            if k.lstrip("-").split(".")[0] == "BASE":
                raise ValueError("override should not contain BASE")
        cfg.merge_from_list(override)
    cfg.freeze()
    return cfg
