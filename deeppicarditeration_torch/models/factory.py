"""Network construction from config (NETWORK.* keys).

Counterpart of ``deeppicarditeration_tpu/models/factory.py``: the plain
``PicardSolution`` MLP, the terminal-enforcing
``PicardSolutionEnforceTerminal`` (u = g(x) + (T - t) net, Value type)
and ``NETWORK.PISGRADNET`` (the HJB recipes' ``PISGradNet``, whose g0 is
the OU equation's mixture terminal), and DBDP's per-grid-time pair of
x-only MLPs (``build_dbdp_pair``).
"""

from __future__ import annotations

import torch

from deeppicarditeration_torch.config import wants_float64
from deeppicarditeration_torch.models.networks import (
    MLP,
    EnforceTerminal,
    PISGradNet,
)
from deeppicarditeration_torch.models.solution import (
    VALUE,
    Solution,
    output_dim_for,
)

_KNOWN_NETWORK_CLS = (None, "PicardSolution", "PicardSolutionEnforceTerminal")


def _check_cls(cfg) -> None:
    if cfg.NETWORK.cls not in _KNOWN_NETWORK_CLS:
        raise ValueError(
            f"Unknown solution class {cfg.NETWORK.cls!r} "
            f"(known: {_KNOWN_NETWORK_CLS})")


def build_network(cfg, eq, device, generator=None) -> torch.nn.Module:
    """The network described by cfg.NETWORK for equation eq, on ``device``,
    initialized from ``generator``."""
    net_cfg = cfg.NETWORK
    _check_cls(cfg)
    if wants_float64(cfg.DATA.FLOAT):
        raise NotImplementedError(
            "DATA.FLOAT double is not ported yet; the port runs f32")
    neurons = tuple(net_cfg.NEURONS)
    activations = tuple(net_cfg.ACTIVATIONS)
    if len(activations) != len(neurons):
        raise ValueError(
            f"NETWORK.ACTIVATIONS has {len(activations)} entries for "
            f"{len(neurons)} NEURONS — lengths must match")
    if net_cfg.PISGRADNET:
        if net_cfg.TYPE != VALUE:
            raise ValueError("PISGradNet is a value ansatz")
        if getattr(eq, "gmm_means", None) is None:
            raise NotImplementedError(
                "PISGradNet's g0 is ported for the OU equation's mixture "
                f"terminal only (got {type(eq).__name__})")
        module = PISGradNet(eq.nx, neurons, (eq.gmm_means, eq.gmm_vars,
                                             eq.gmm_log_weights),
                            T=eq.T, generator=generator)
        return module.to(device)
    module = MLP(1 + eq.nx, neurons, activations,
                 output_dim_for(net_cfg.TYPE, eq.nx), bound=net_cfg.BOUND,
                 generator=generator)
    if net_cfg.cls == "PicardSolutionEnforceTerminal":
        if net_cfg.TYPE != VALUE:
            raise NotImplementedError(
                f"PicardSolutionEnforceTerminal with TYPE {net_cfg.TYPE!r} "
                "is not ported yet (only 'Value')")
        module = EnforceTerminal(module, eq.to(device).g, T=eq.T)
    return module.to(device)


def build_dbdp_pair(cfg, eq, device, gen_u=None, gen_g=None):
    """DBDP's (value, gradient) nets for one grid time: MLPs of x alone
    with NETWORK.NEURONS/ACTIVATIONS/BOUND, out_dim 1 and nx, on
    ``device``, initialized from ``gen_u`` and ``gen_g`` (the terminal
    anchor is applied by the baseline)."""
    neurons = tuple(cfg.NETWORK.NEURONS)
    acts = tuple(cfg.NETWORK.ACTIVATIONS)
    bound = cfg.NETWORK.BOUND
    return (MLP(eq.nx, neurons, acts, 1, bound=bound,
                generator=gen_u).to(device),
            MLP(eq.nx, neurons, acts, eq.nx, bound=bound,
                generator=gen_g).to(device))


def init_solution(cfg, eq, device, generator=None) -> Solution:
    """A freshly initialized network wrapped as a Solution."""
    module = build_network(cfg, eq, device, generator)
    return Solution.from_net(module, cfg.NETWORK.TYPE, eq.nx)


def is_enforce_terminal(cfg) -> bool:
    """Does the ansatz anchor g itself (no terminal penalty needed)?"""
    _check_cls(cfg)
    return (cfg.NETWORK.cls == "PicardSolutionEnforceTerminal"
            or bool(cfg.NETWORK.PISGRADNET))


def freeze(module: torch.nn.Module) -> torch.nn.Module:
    """Mark a trained module as a frozen iterate (no parameter grads)."""
    for p in module.parameters():
        p.requires_grad_(False)
    return module.eval()
