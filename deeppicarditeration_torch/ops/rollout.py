"""K-step Brownian path rollouts for the time-stepped baselines.

Counterpart of ``deeppicarditeration_tpu/ops/rollout.py``. For the
drift-free forward SDE with Sigma = sqrt(alpha) I (the base-class
``transition``) the K-step path is a closed form in the increments,

    X_{t_k} = x0 + sqrt(alpha) * sum_{j<k} sqrt(dt_j) * xi_j,
    xi_j ~ N(0, I),

so no step-by-step simulation is needed: one (K, B, nx) draw and a cumulative
sum, or, under ``use_pallas`` (which the D-DBSDE baseline always sets),
the rollout kernel ``csrc/rollout.cu``, which draws the increments
in-kernel and keeps the running sum in registers. An equation that overrides ``transition``
takes a sequential loop through its own law instead.

Random streams: a ``torch.Generator`` for the closed form and the loop, an
integer seed or a ``kernels.SeedTable`` for the kernel (its Philox draws
depend on (seed, k, b, j) alone; a table's seed is read on the card, so
the launch can be replayed in a CUDA graph). The closed form also takes external ``xi``, so that tests can feed
it other draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeppicarditeration_torch.equations.base import EquationMethods
from deeppicarditeration_torch.ops import kernels


def uses_base_transition(eq) -> bool:
    """True iff eq inherits the drift-free base-class transition the closed
    form assumes (x -> x + sqrt(s - t) sqrt(alpha) dW)."""
    return type(eq).transition is EquationMethods.transition


def closed_form_paths(generator: Optional[torch.Generator], eq,
                      x0: torch.Tensor, dts: torch.Tensor, K: int,
                      xi: Optional[torch.Tensor] = None):
    """(xs (K+1, B, nx), xi (K, B, nx)): one (K, B, nx) draw from
    ``generator`` (or the given ``xi``) and a cumulative sum."""
    if xi is None:
        xi = torch.randn((int(K),) + tuple(x0.shape), generator=generator,
                         dtype=x0.dtype, device=x0.device)
    return kernels.paths_plain(0, x0, torch.sqrt(dts), eq.alpha_sqrt, K, xi)


def brownian_paths(generator: Optional[torch.Generator], eq,
                   t0: torch.Tensor, x0: torch.Tensor, dts: torch.Tensor,
                   K: int, use_pallas: bool = False, seed=0,
                   xi: Optional[torch.Tensor] = None,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Exact K-step path from (t0, x0) with per-sample step dts.

    t0: (B, 1) start times, x0: (B, nx) start states, dts: (B, 1). Returns
    ts (K+1, B, 1) = t0 + k dts, xs (K+1, B, nx) the path states and xi
    (K, B, nx) the standardized N(0, I) increments. ``use_pallas`` takes
    the rollout kernel, seeded with ``seed`` (an int or a
    ``kernels.SeedTable``; on CPU tensors its plain version, drawing from a
    torch.Generator seeded with that seed); else the
    closed form draws from ``generator`` or uses ``xi``. An equation that
    overrides ``transition`` (drift, state-dependent diffusion) takes a
    sequential loop through its own law, drawing from ``generator``.
    ``out``: buffers (xs, xi) that the rollout kernel writes into (the
    DBDP sub-iteration's static inputs; ``use_pallas`` only)."""
    ks = torch.arange(K + 1, dtype=t0.dtype, device=t0.device)
    ts = t0[None] + dts[None] * ks[:, None, None]
    if out is not None and not (use_pallas and uses_base_transition(eq)):
        raise ValueError("out= is the rollout kernel's (use_pallas) only")
    if not uses_base_transition(eq):
        t, x = t0, x0
        xs, dws = [x0], []
        for _ in range(int(K)):
            t_next = t + dts
            x, dw = eq.transition(generator, t, t_next, x)
            xs.append(x)
            dws.append(dw)
            t = t_next
        xi_out = (torch.stack(dws) if dws
                  else x0.new_zeros((0,) + tuple(x0.shape)))
        return ts, torch.stack(xs), xi_out
    if use_pallas:
        xs, xi = kernels.paths_cuda(seed, x0.contiguous(),
                                    torch.sqrt(dts).contiguous(),
                                    eq.alpha_sqrt, K, out=out)
    else:
        xs, xi = closed_form_paths(generator, eq, x0, dts, K, xi)
    return ts, xs, xi
