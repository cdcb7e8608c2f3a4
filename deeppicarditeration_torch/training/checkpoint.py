"""Per-iteration checkpoints (counterpart of deeppicarditeration_tpu/training/checkpoint.py).

One ``model_{i}`` file per Picard iteration in the experiment directory
(the JAX package's path layout; here a ``torch.save`` of the state_dict,
not an orbax directory). Saves are synchronous.
"""

from __future__ import annotations

import pathlib

import torch


def ckpt_path(exp_dir: pathlib.Path, i: int) -> pathlib.Path:
    return (pathlib.Path(exp_dir) / f"model_{i}").absolute()


def save_params(path: pathlib.Path, module: torch.nn.Module) -> None:
    """Write the module's parameters; atomic (temp file, then rename)."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(module.state_dict(), tmp)
    tmp.replace(path)


def load_params(path: pathlib.Path, module: torch.nn.Module) -> None:
    """Restore parameters into ``module`` (structure-checked, strict)."""
    device = next(module.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(state)
