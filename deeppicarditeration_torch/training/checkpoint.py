"""Per-iteration checkpoints (counterpart of deeppicarditeration_tpu/training/checkpoint.py).

One ``model_{i}`` file per Picard iteration in the experiment directory
(the JAX package's path layout; here a ``torch.save`` of the state_dict,
not an orbax directory; for DBDP the stacked per-grid-time nets, a
``training/baselines.py:DBDPNets`` state_dict), and the baselines'
periodic ``{model, optimizer}`` state. Saves are synchronous and atomic;
RESUME reads them back (``training/picard.py:_maybe_resume``,
``training/baselines.py:_baseline_loop``).
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


def read(path: pathlib.Path):
    """A saved file's contents, on the host; raises where the file is
    missing or torn."""
    return torch.load(path, map_location="cpu", weights_only=True)


def is_readable(path: pathlib.Path) -> bool:
    """Does ``path`` hold a whole file that ``read`` loads?"""
    try:
        read(path)
    except Exception:
        return False
    return True


def restore_state(state, module: torch.nn.Module,
                  optimizer: torch.optim.Optimizer) -> None:
    """Load a ``save_state`` file's contents (``read``) into ``module`` and
    ``optimizer`` (strict: raises where they do not match). The optimizer
    keeps its own ``capturable`` setting, whatever the saving run's was:
    Adam's step counts go to the parameters' device when capturable (a
    captured step reads them there), else to the host."""
    module.load_state_dict(state["model"])
    capturable = [bool(g.get("capturable", False))
                  for g in optimizer.param_groups]
    optimizer.load_state_dict(state["optimizer"])
    for group, cap in zip(optimizer.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    dtype=torch.float32, device=p.device if cap else "cpu")


def load_state(path: pathlib.Path, module: torch.nn.Module,
               optimizer: torch.optim.Optimizer) -> None:
    """Restore a ``save_state`` file into ``module`` and ``optimizer``."""
    restore_state(read(path), module, optimizer)


def load_params(path: pathlib.Path, module: torch.nn.Module) -> None:
    """Restore parameters into ``module`` (structure-checked, strict)."""
    device = next(module.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(state)
