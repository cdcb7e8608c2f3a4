"""Monte-Carlo target generation: the computational core of DPI.

Counterpart of ``deeppicarditeration_tpu/ops/estimators.py``, ported as far
as the Burgers gradient-supervised recipe needs. For each collocation point
(t, x) and M samples the Picard target is

    u_hat(t, x) = terminal + integral
    terminal = E[(g(X_T) - g(x)) (1, Y)] + (g(x), 0),   Y = dW / sqrt(T-t) / sqrt(a)
    integral = E[(T-t) (f(s, X_s, u_k, grad u_k) - f0) (1, Ys)] + (f0 (T-t), 0)
               s ~ U[t, T],  Ys = dW / sqrt(s-t) / sqrt(a),  f0 = f at (t, x)

computed by the merged estimator of ``ops/kernels.py`` (a CUDA kernel on
the card, its plain version on the CPU). Not yet ported (later slices): the
split terminal/integral estimators with Kahan accumulation, antithetic
pairing, TD estimators, Hessian targets, the two-layer formula and the
value-only mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeppicarditeration_torch.device import (
    derive_seed,
    make_generator,
    resolve_device,
)
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.kernels import generate_with_gradients_cuda
from deeppicarditeration_torch.ops.samplers import (
    sample_t_picard,
    sample_t_uniform,
)

# Floor on (s - t) wherever it appears under 1/sqrt: in f32 the uniform
# s-draw can produce s == t exactly, which makes the likelihood-ratio
# weight 0 * inf = NaN. Relative bias O(eps).
_ST_FLOOR = 1e-6


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Static generation parameters (the fields the ported path reads)."""

    n_estimate_terminal: int = 1
    n_estimate_integral: int = 1
    chunk_elems: int = 2 ** 22  # sizes DATA.GEN_BATCH's default
    t_always_uniform: bool = False
    t_uniform_eps: float = 0.0
    sample_bound: Optional[float] = None
    estimate_delta_t: float = 0.0  # >0 => TD estimators (not ported)
    antithetic: bool = False  # +/- dW pairs (not ported)


def generate_with_gradients(seed: int, eq, sol: Solution, tx: torch.Tensor,
                            gen: GenConfig) -> torch.Tensor:
    """(B, 1 + nx) value + gradient targets of the frozen iterate ``sol``.

    Every configuration this slice covers goes to the merged estimator
    (a CUDA kernel for CUDA tensors, which raises for an equation or net it
    does not cover); the others raise NotImplementedError."""
    if gen.estimate_delta_t > 0:
        raise NotImplementedError(
            "DATA.ESTIMATE_DELTA_T > 0 (TD estimators) is not ported yet")
    if gen.antithetic:
        raise NotImplementedError(
            "DATA.TPU.ANTITHETIC is not ported yet (the merged kernel's "
            "antithetic pairing comes with a later slice)")
    if gen.n_estimate_terminal != gen.n_estimate_integral:
        raise NotImplementedError(
            "different terminal and integral sample counts need the split "
            "estimators, which are not ported yet")
    if (not eq.has_gradient_term or eq.has_hessian_term
            or eq.has_laplacian_term):
        raise NotImplementedError(
            "only gradient-term equations are ported (Cha)")
    return generate_with_gradients_cuda(seed, eq, sol, tx,
                                        gen.n_estimate_terminal)


def sample_tx(generator: torch.Generator, eq, n_batch: int, gen: GenConfig,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """Draw (t, x) collocation points, (n_batch, 1 + nx), on ``device``
    (default: the card; see ``resolve_device``)."""
    device = resolve_device(device)
    if gen.t_always_uniform:
        t = sample_t_uniform(generator, n_batch, eq.T, gen.t_uniform_eps,
                             dtype, device)
    else:
        t = sample_t_picard()
    x = eq.sample_x(generator, t)
    return torch.cat([t, x], dim=-1)


def _clip(u, gen: GenConfig):
    if gen.sample_bound is not None:
        return torch.clamp(u, -gen.sample_bound, gen.sample_bound)
    return u


def sample_batch(seed: int, eq, sol: Solution, n_batch: int, gen: GenConfig,
                 mode: str = "gradient", dtype=torch.float32, device=None):
    """Draw collocation points and their MC targets: (tx, targets), on
    ``device`` (default: the card; the CPU only when asked for)."""
    if mode != "gradient":
        raise NotImplementedError(
            f"generation mode {mode!r} is not ported yet (only 'gradient')")
    device = resolve_device(device)
    tx = sample_tx(make_generator(device, seed, 0), eq, n_batch, gen, dtype,
                   device)
    u = generate_with_gradients(derive_seed(seed, 1), eq, sol, tx, gen)
    return tx, _clip(u, gen)

