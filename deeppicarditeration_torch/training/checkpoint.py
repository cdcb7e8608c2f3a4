"""Per-iteration checkpoints (counterpart of deeppicarditeration_tpu/training/checkpoint.py).

One ``model_{i}`` file per Picard iteration in the experiment directory
(the JAX package's path layout; here a ``torch.save`` of the state_dict,
not an orbax directory; for DBDP the stacked per-grid-time nets, a
``training/baselines.py:DBDPNets`` state_dict), and the baselines'
periodic ``{model, optimizer}`` state. Saves are synchronous and atomic.
"""

from __future__ import annotations

import pathlib

import torch


def ckpt_path(exp_dir: pathlib.Path, i: int) -> pathlib.Path:
    return (pathlib.Path(exp_dir) / f"model_{i}").absolute()


def _save_atomic(path: pathlib.Path, obj) -> None:
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)


def save_params(path: pathlib.Path, module: torch.nn.Module) -> None:
    """Write the module's parameters; atomic (temp file, then rename)."""
    _save_atomic(path, module.state_dict())


def save_state(path: pathlib.Path, module: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> None:
    """Write ``{"model": ..., "optimizer": ...}`` state dicts; atomic."""
    _save_atomic(path, {"model": module.state_dict(),
                        "optimizer": optimizer.state_dict()})


def load_state(path: pathlib.Path, module: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> None:
    """Restore a ``save_state`` file into ``module`` and ``optimizer``."""
    device = next(module.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])


def load_params(path: pathlib.Path, module: torch.nn.Module) -> None:
    """Restore parameters into ``module`` (structure-checked, strict)."""
    device = next(module.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(state)
