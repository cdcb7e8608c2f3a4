"""Carry flax parameters across to the port's networks.

Takes the flax parameter tree as numpy arrays (``{"params": {...}}`` or the
inner dict), so it needs no JAX import. A flax Dense kernel of shape (in,
out) becomes the transposed ``Linear.weight`` of shape (out, in); the bias
stays as it is. Trees: the ``MLP``'s ``Dense_i``; the ``PISGradNet``'s
``timestep_phase``, ``t_encoder_i``, ``smooth_net_i`` and ``nn_module_i``;
``EnforceTerminal``'s ``inner`` (an MLP tree); DBDP's stacked per-grid-time
(value, gradient) MLP trees, each leaf with a leading (K + 1,) axis.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a, np.float32), order="C",
                                     copy=True))


def _dense(prefix: str, leaf: dict) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _tensor(np.asarray(leaf["kernel"]).T),
            f"{prefix}.bias": _tensor(leaf["bias"])}


def _numbered(tree: dict, stem: str):
    names = sorted((k for k in tree if k.startswith(stem + "_")),
                   key=lambda k: int(k[len(stem) + 1:]))
    return names


def mlp_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """state_dict for ``MLP`` from a flax ``MLP`` parameter tree."""
    tree = params.get("params", params)
    names = _numbered(tree, "Dense")
    if not names or len(names) != len(tree):
        raise ValueError(
            f"expected only Dense_i entries, got {sorted(tree)}")
    out = {}
    for i, name in enumerate(names):
        out.update(_dense(f"layers.{i}", tree[name]))
    return out


def pisgradnet_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """state_dict for ``PISGradNet`` from a flax ``PISGradNet`` tree."""
    tree = params.get("params", params)
    out = {"timestep_phase": _tensor(tree["timestep_phase"])}
    n = 1
    for stem in ("t_encoder", "smooth_net", "nn_module"):
        names = _numbered(tree, stem)
        n += len(names)
        for i, name in enumerate(names):
            out.update(_dense(f"{stem}.{i}", tree[name]))
    if n != len(tree):
        raise ValueError(f"unexpected PISGradNet entries: {sorted(tree)}")
    return out


def enforce_terminal_state_dict_from_flax(
        params: dict) -> Dict[str, torch.Tensor]:
    """state_dict for ``EnforceTerminal`` around an MLP."""
    tree = params.get("params", params)
    return {f"inner.{k}": v
            for k, v in mlp_state_dict_from_flax(tree["inner"]).items()}


def dbdp_pair_state_dicts_from_flax(stacked) -> List[Tuple[dict, dict]]:
    """[(u state_dict, g state_dict)] per grid time, for
    ``training/baselines.py:DBDPNets.load_pairs``, from the JAX package's
    stacked DBDP tree (a (u, g) pair of MLP trees whose leaves carry a
    leading (K + 1,) axis)."""
    u_tree, g_tree = stacked
    n = len(np.asarray(_numbered_leaf(u_tree)))

    def at(tree, k):
        inner = tree.get("params", tree)
        return {name: {leaf: np.asarray(v)[k] for leaf, v in d.items()}
                for name, d in inner.items()}

    return [(mlp_state_dict_from_flax(at(u_tree, k)),
             mlp_state_dict_from_flax(at(g_tree, k))) for k in range(n)]


def _numbered_leaf(tree):
    inner = tree.get("params", tree)
    return inner[_numbered(inner, "Dense")[0]]["bias"]
