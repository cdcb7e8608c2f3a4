"""Network construction from config (NETWORK.* keys).

Counterpart of ``deeppicarditeration_tpu/models/factory.py`` for the plain
``PicardSolution`` MLP. ``PicardSolutionEnforceTerminal`` and PISGradNet
come with later slices.
"""

from __future__ import annotations

import torch

from deeppicarditeration_torch.config import wants_float64
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution, output_dim_for

_KNOWN_NETWORK_CLS = (None, "PicardSolution")


def build_network(cfg, eq, device, generator=None) -> MLP:
    """The MLP described by cfg.NETWORK for equation eq, on ``device``,
    initialized from ``generator``."""
    net_cfg = cfg.NETWORK
    if net_cfg.cls == "PicardSolutionEnforceTerminal" or net_cfg.PISGRADNET:
        raise NotImplementedError(
            "terminal-enforcing nets (PicardSolutionEnforceTerminal, "
            "PISGradNet) are not ported yet; they come with the HJB slice")
    if net_cfg.cls not in _KNOWN_NETWORK_CLS:
        raise ValueError(
            f"Unknown solution class {net_cfg.cls!r} "
            f"(known: {_KNOWN_NETWORK_CLS})")
    if wants_float64(cfg.DATA.FLOAT):
        raise NotImplementedError(
            "DATA.FLOAT double is not ported yet; the port runs f32")
    neurons = tuple(net_cfg.NEURONS)
    activations = tuple(net_cfg.ACTIVATIONS)
    if len(activations) != len(neurons):
        raise ValueError(
            f"NETWORK.ACTIVATIONS has {len(activations)} entries for "
            f"{len(neurons)} NEURONS — lengths must match")
    module = MLP(1 + eq.nx, neurons, activations,
                 output_dim_for(net_cfg.TYPE, eq.nx), bound=net_cfg.BOUND,
                 generator=generator)
    return module.to(device)


def init_solution(cfg, eq, device, generator=None) -> Solution:
    """A freshly initialized network wrapped as a Solution."""
    module = build_network(cfg, eq, device, generator)
    return Solution.from_net(module, cfg.NETWORK.TYPE, eq.nx)


def freeze(module: torch.nn.Module) -> torch.nn.Module:
    """Mark a trained module as a frozen iterate (no parameter grads)."""
    for p in module.parameters():
        p.requires_grad_(False)
    return module.eval()
