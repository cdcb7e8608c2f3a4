"""Metric logging (counterpart of deeppicarditeration_tpu/training/logging.py).

An always-on JSONL stream per experiment (``metrics.jsonl``, the same
record keys as the JAX package: step, context, time and the metrics). The
TensorBoard and wandb backends come with a later slice.
"""

from __future__ import annotations

import json
import math
import pathlib
import time
from typing import Dict

_KNOWN_LOGGERS = ("jsonl", "none", None)


def _jsonable(v):
    """Floats pass through; non-finite become None (strict-JSON safe)."""
    if hasattr(v, "__float__"):
        f = float(v)
        return f if math.isfinite(f) else None
    return v


class MetricLogger:
    def __init__(self, exp_dir: pathlib.Path, logger: str = "jsonl"):
        if logger not in _KNOWN_LOGGERS:
            raise NotImplementedError(
                f"LOGGING.LOGGER {logger!r} is not ported yet; use jsonl "
                "or none")
        self.exp_dir = pathlib.Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.exp_dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict, step: int, context: str = "train") -> None:
        rec = {"step": step, "context": context, "time": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
