"""Carry flax MLP parameters across to the port's ``MLP``.

Takes the flax parameter tree as numpy arrays (``{"params": {"Dense_0":
{"kernel": (in, out), "bias": (out,)}, ...}}`` or the inner dict), so it
needs no JAX import. A flax Dense kernel of shape (in, out) becomes the
transposed ``Linear.weight`` of shape (out, in); the bias stays as it is.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def mlp_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """state_dict for ``MLP`` from a flax ``MLP`` parameter tree."""
    tree = params.get("params", params)
    names = sorted((k for k in tree if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    if not names or len(names) != len(tree):
        raise ValueError(
            f"expected only Dense_i entries, got {sorted(tree)}")
    out = {}
    for i, name in enumerate(names):
        kernel = np.asarray(tree[name]["kernel"], np.float32)
        bias = np.asarray(tree[name]["bias"], np.float32)
        out[f"layers.{i}.weight"] = torch.from_numpy(
            np.array(kernel.T, order="C", copy=True))
        out[f"layers.{i}.bias"] = torch.from_numpy(np.array(bias, copy=True))
    return out
