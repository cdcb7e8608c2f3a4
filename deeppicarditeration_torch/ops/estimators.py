"""Monte-Carlo target generation: the computational core of DPI.

Counterpart of ``deeppicarditeration_tpu/ops/estimators.py``, ported as far
as the Burgers and HJB gradient-supervised recipes need. For each
collocation point (t, x) and M samples the Picard target is

    u_hat(t, x) = terminal + integral
    terminal = E[(g(X_T) - g(x)) (1, Y)] + (g(x), 0),   Y = dW / sqrt(T-t) / sqrt(a)
    integral = E[(T-t) (f(s, X_s, u_k, grad u_k) - f0) (1, Ys)] + (f0 (T-t), 0)
               s ~ U[t, T],  Ys = dW / sqrt(s-t) / sqrt(a),  f0 = f at (t, x)

Two routes compute it (``generate_with_gradients``):
  * the merged estimator kernel (``ops/kernels.py``: a CUDA kernel on the
    card, ``generate.cu`` for Cha and ``generate_pis.cu`` for the OU
    equation, their plain version on the CPU), when both chains take the
    same M and ``pallas_generate`` allows it;
  * the split estimators ``estimate_terminal_with_gradients`` and
    ``estimate_integral_with_gradients``: each the standalone kernel of
    ``ops/kernels.py`` under ``pallas_terminal`` / ``pallas_integral``, else
    a loop over chunks of the M samples with Kahan accumulation whose
    normals come from the normals kernel under ``tpu_prng`` and from a
    torch.Generator otherwise.
Antithetic pairing (``antithetic``) works on every route. Equations with
a Hessian term (the FN family) always take the split route with the chunk
estimators, as in the JAX package: their nonlinearity reads the frozen
net's Hessian diagonal at SDGD-sampled indices (``sdgd_v``), through the
second-order backprop of ``ops/derivatives.py`` (``hess_store``). Not yet
ported (later slices): TD estimators, Hessian targets (the
``*_and_hessians`` estimators of TRAIN.SUPERVISE_HESSIAN), the two-layer
formula and the value-only mode.
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
from deeppicarditeration_torch.equations.burgers import Cha
from deeppicarditeration_torch.equations.hjb import OUProcessEquation
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops.derivatives import (
    _mlp_fast_path,
    diag_hessian_entries,
    get_f,
    mlp_hessian_diag,
    sdgd_index_counts,
)
from deeppicarditeration_torch.ops.kernels import (
    check_precision,
    generate_pis_cuda,
    generate_with_gradients_cuda,
    integral_with_gradients_cuda,
    kernel_net,
    normals_cuda,
    normals_plain,
    pis_covers,
    terminal_with_gradients_cuda,
)
from deeppicarditeration_torch.ops.samplers import (
    sample_t_picard,
    sample_t_uniform,
)
from deeppicarditeration_torch.ops.summation import KahanAcc

# Floor on (s - t) wherever it appears under 1/sqrt: in f32 the uniform
# s-draw can produce s == t exactly, which makes the likelihood-ratio
# weight 0 * inf = NaN. Relative bias O(eps).
_ST_FLOOR = 1e-6


def largest_divisor(n: int, cap: int, step: int = 1) -> int:
    """Largest divisor of ``n`` that is <= max(cap, step) and a multiple of
    ``step``. Raises when no such divisor exists: the one reachable case is
    antithetic pairing (step=2) with an odd sample count."""
    d = min(n, max(cap, step))
    while d >= step:
        if n % d == 0 and d % step == 0:
            return d
        d -= 1
    raise ValueError(
        f"no divisor of {n} <= {max(cap, step)} is a multiple of {step}"
        + (" — antithetic pairing needs an even sample count"
           if step == 2 else ""))


_FALLBACK_NOTICED = set()


def _notice_fallback(flag: str, reason: str, action: str) -> None:
    """One line, once per (flag, reason), when a configured flag does not
    get what it asked for (``action``: what runs instead)."""
    if (flag, reason) in _FALLBACK_NOTICED:
        return
    _FALLBACK_NOTICED.add((flag, reason))
    print(f"{flag}: requested but unavailable ({reason}); {action}")


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Static generation parameters (the fields the ported paths read)."""

    n_estimate_terminal: int = 1
    n_estimate_integral: int = 1
    chunk_elems: int = 2 ** 22  # target B * m_chunk * nx elements per step
    t_always_uniform: bool = False
    t_uniform_eps: float = 0.0
    sample_bound: Optional[float] = None
    estimate_delta_t: float = 0.0  # >0 => TD estimators (not ported)
    tpu_prng: bool = False  # chunk normals from the normals kernel
    antithetic: bool = False  # +/- dW pairs: half the draws, lower variance
    pallas_terminal: bool = False  # standalone terminal kernel
    pallas_integral: bool = False  # standalone integral kernel
    # Merged terminal+integral kernel: False / True / "auto". "auto" takes
    # it where it covers the equation and the frozen net (kernel_net), and
    # the split estimators elsewhere, with a one-line notice.
    pallas_generate: object = "auto"
    # Precision of the frozen-net dots in the merged and the integral
    # estimator kernels (ops/kernels.py:PRECISIONS): "bf16x3" (the hi/lo
    # split, f32-equivalent, on the tensor cores), "default" (one bf16
    # pass) or "highest" (FP32 FMA). The chunk estimators, the fit and the
    # eval stay f32. DATA.TPU.PALLAS_PRECISION.
    pallas_precision: str = "bf16x3"
    # SDGD: sampled diagonal entries per sample for Hessian equations
    # (DATA.HESSIAN_APPROXIMATION SDGD, kwargs.v); None => the full Hessian
    sdgd_v: Optional[int] = None
    # storage of the second-order chain's (R, w, w) blocks: None (f32) or
    # "bf16" (DATA.TPU.HESSIAN_STORE)
    hess_store: Optional[str] = None

    def __post_init__(self):
        check_precision(self.pallas_precision)
        if self.hess_store not in (None, "bf16"):
            raise ValueError(f"hess_store must be None or 'bf16' (got "
                             f"{self.hess_store!r})")

    def chunk(self, m: int, batch: int, nx: int, act_width: int = 0) -> int:
        """Largest divisor of m with batch * chunk * nx <= chunk_elems
        (even when antithetic pairing is on); ``act_width`` (``_act_width``
        of the frozen nets the chunk runs) adds the bound batch * chunk *
        act_width <= _ACT_BUDGET_ELEMS. The chunk size fixes the chunk
        count, and with it each chunk's random stream."""
        target = max(1, self.chunk_elems // max(batch * nx, 1))
        if act_width:
            target = min(target, max(
                1, _ACT_BUDGET_ELEMS // max(batch * act_width, 1)))
        step = 2 if self.antithetic else 1
        return largest_divisor(m, target, step)


# Activation-element budget for GenConfig.chunk's second bound (the JAX
# package's calibration, kept so that chunk counts agree).
_ACT_BUDGET_ELEMS = 3 * 2 ** 28


def _act_width(*sols) -> int:
    """Summed matmul output widths of the frozen nets a chunk runs (0 for
    the zero solution): the act_width for GenConfig.chunk, counted as the
    JAX package counts its parameter leaves (the last dim of every leaf of
    two or more dims: a Linear weight's out, PISGradNet's phase)."""
    w = 0
    for s in sols:
        if s is None or s.module is None:
            continue
        for name, p in s.module.named_parameters():
            if p.ndim >= 2:
                w += int(p.shape[0] if name.endswith("weight")
                         else p.shape[-1])
    return w


def _safe(st):
    return torch.clamp(st, min=_ST_FLOOR)


def _scan_mean(seed: int, m: int, mc: int, out_shape, chunk_sum_fn,
               like: torch.Tensor) -> torch.Tensor:
    """sum_c chunk_sum_fn(seed_c, c) / m with Kahan accumulation; chunk c
    draws from seed_c = derive_seed(seed, c)."""
    acc = KahanAcc.zeros(out_shape, dtype=like.dtype, device=like.device)
    for ck in range(m // mc):
        acc = acc.add(chunk_sum_fn(derive_seed(seed, ck), ck))
    return acc.value / m


def _draw_normals(gen: GenConfig, seed: int, shape, device) -> torch.Tensor:
    """dW draws: the normals kernel under gen.tpu_prng (its plain version,
    torch.randn, for the CPU), else torch.randn on a torch.Generator."""
    if gen.tpu_prng:
        return normals_cuda(seed, shape, device)
    return normals_plain(seed, shape, device)


def _draw_increments(gen: GenConfig, seed: int, b: int, mc: int, nx: int,
                     device, noise: Optional[torch.Tensor] = None):
    """Chunk increments dW (b, mc, nx); antithetic => [h, -h] pairs.
    ``noise``: this chunk's injected draws (b, mc or mc / 2, nx)."""
    if noise is None:
        rows = mc // 2 if gen.antithetic else mc
        noise = _draw_normals(gen, seed, (b, rows, nx), device)
    if gen.antithetic:
        return torch.cat([noise, -noise], dim=1)
    return noise


def _chunk_rows(gen: GenConfig, mc: int, ck: int):
    """The draw rows of chunk ck in an injected (b, rows, .) array."""
    r = mc // 2 if gen.antithetic else mc
    return slice(ck * r, (ck + 1) * r)


def _sdgd_indices(seed: int, shape, nx: int, device) -> torch.Tensor:
    """SDGD indices, uniform in [0, nx) with replacement, from a
    torch.Generator seeded with ``seed``."""
    return torch.randint(0, nx, tuple(shape),
                         generator=make_generator(device, seed),
                         device=device)


# ---------------------------------------------------------------------------
# value + gradient estimators
# ---------------------------------------------------------------------------

def estimate_terminal_with_gradients(seed: int, eq, tx: torch.Tensor,
                                     gen: GenConfig,
                                     noise: Optional[torch.Tensor] = None):
    """E[(g(X_T) - g(x)) (1, Y)] + (g(x), 0); (B, 1 + nx).

    ``noise`` (B, rows, nx), rows = M or M / 2 with antithetic pairing,
    replaces the draws (the test path, as the kernels' external noise)."""
    m = gen.n_estimate_terminal
    if gen.pallas_terminal:
        return terminal_with_gradients_cuda(seed, eq, tx, m, noise,
                                            antithetic=gen.antithetic)
    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    mc = gen.chunk(m, b, nx)
    g0 = eq.g(x)  # (B, 1) control-variate baseline
    # _safe: a collocation t can hit T exactly in f32
    sqrt_Tt = torch.sqrt(_safe(eq.T - t))
    inv_y = 1.0 / (sqrt_Tt * eq.alpha_sqrt)  # Y = dW * inv_y

    def chunk_sum(ck_seed, ck):
        dW = _draw_increments(
            gen, ck_seed, b, mc, nx, tx.device,
            None if noise is None else noise[:, _chunk_rows(gen, mc, ck)])
        XT = x[:, None, :] + sqrt_Tt[:, None, :] * eq.alpha_sqrt * dW
        diff = eq.g(XT) - g0[:, None, :]  # (B, mc, 1)
        val = torch.sum(diff, dim=1)
        # sum_m diff * Y: contract over the chunk axis
        grad = torch.einsum("bmo,bmn->bn", diff, dW) * inv_y
        return torch.cat([val, grad], dim=-1)

    mean = _scan_mean(seed, m, mc, (b, 1 + nx), chunk_sum, tx)
    return torch.cat([mean[:, :1] + g0, mean[:, 1:]], dim=-1)


def _sdgd_active(eq, gen: GenConfig) -> bool:
    return bool(eq.has_hessian_term and gen.sdgd_v)


def _probe_generator(eq, device, *path):
    """The Hutchinson probes' generator for an equation that draws them
    (a Laplacian term with num_v_samples > 0), else None."""
    if eq.has_laplacian_term and eq.num_v_samples > 0:
        return make_generator(device, *path)
    return None


def _baseline_f(eq, sol: Solution, t, x, seed: int, gen: GenConfig):
    """f at the collocation point itself (the integral CV baseline):
    (f0 (B, 1), None); under SDGD (None, d0) with d0 (B, nx) the full
    Hessian diagonal at (t, x), from which ``_baseline_f_at_indices``
    evaluates the baseline on each sample's index subset."""
    if _sdgd_active(eq, gen):
        if _mlp_fast_path(sol):
            return None, mlp_hessian_diag(sol, t, x, store=gen.hess_store)
        full_idx = torch.arange(x.shape[-1], device=x.device).expand(
            x.shape)
        return None, diag_hessian_entries(sol, t, x, full_idx,
                                          store=gen.hess_store)
    f0 = get_f(eq, sol, t, x,
               hutchinson_generator=_probe_generator(eq, x.device, seed),
               hess_store=gen.hess_store)
    return f0, None


def _baseline_f_at_indices(eq, t, x, d0, idx, u0):
    """The SDGD baseline f0 on each sample's index subset, (B, mc, 1). With
    ``ffi_stats`` the subset's statistics are multiplicity counts
    contracted against the full diagonal d0 (a batched matvec, no
    gather), and the source terms are evaluated once per point through the
    (B, 1, .) singleton sample dim; ``u0`` = the value at (t, x)."""
    v = idx.shape[-1]
    if hasattr(eq, "ffi_stats"):
        c = sdgd_index_counts(idx, x.shape[-1])  # (B, mc, nx)
        m1 = torch.einsum("bmn,bn->bm", c, d0)[..., None] / v
        m2 = torch.einsum("bmn,bn->bm", c, torch.abs(d0))[..., None] / v
        return eq.ffi_stats(t[:, None, :], x[:, None, :], u0[:, None, :],
                            m1, m2)
    u_ii0 = torch.gather(d0[:, None, :].expand(idx.shape[:-1] + d0.shape[-1:]),
                         -1, idx.long())
    return eq.ffi(t[:, None, :], x[:, None, :], u0[:, None, :], u_ii0)


def _integral_kernel_applies(eq) -> bool:
    return (eq.has_gradient_term and not eq.has_hessian_term
            and not eq.has_laplacian_term)


def estimate_integral_with_gradients(seed: int, eq, sol: Solution,
                                     tx: torch.Tensor, gen: GenConfig,
                                     u01: Optional[torch.Tensor] = None,
                                     noise: Optional[torch.Tensor] = None,
                                     hess_idx: Optional[torch.Tensor] = None):
    """E[(T-t)(f - f0)(1, Ys)] + (f0 (T-t), 0); (B, 1 + nx).

    ``u01`` (B, rows, 1) and ``noise`` (B, rows, nx) replace the draws (the
    test path); antithetic pairs share their time draw s. Under SDGD each
    sample draws ``gen.sdgd_v`` indices (``hess_idx`` (B, M, v) replaces
    them) and the baseline f0 is evaluated on the sample's own subset; the
    value slot then keeps that per-sample baseline, (T - t) f0_b."""
    m = gen.n_estimate_integral
    if gen.pallas_integral and _integral_kernel_applies(eq):
        return integral_with_gradients_cuda(seed, eq, sol, tx, m, u01, noise,
                                            antithetic=gen.antithetic,
                                            precision=gen.pallas_precision)
    t, x = tx[:, :1], tx[:, 1:]
    b, nx = x.shape
    mc = gen.chunk(m, b, nx, _act_width(sol))
    f0, d0 = _baseline_f(eq, sol, t, x, derive_seed(seed, 3), gen)
    sdgd = _sdgd_active(eq, gen)
    u0 = sol.value(tx).detach() if sdgd else None  # chunk-invariant
    Tt = eq.T - t

    def chunk_sum(ck_seed, ck):
        rows = _chunk_rows(gen, mc, ck)
        if u01 is not None:
            uh = u01[:, rows]
        else:
            uh = torch.rand((b, rows.stop - rows.start, 1), dtype=x.dtype,
                            device=x.device,
                            generator=make_generator(x.device, ck_seed, 0))
        u = torch.cat([uh, uh], dim=1) if gen.antithetic else uh
        s = t[:, None, :] + u * Tt[:, None, :]
        dW = _draw_increments(gen, derive_seed(ck_seed, 1), b, mc, nx,
                              x.device,
                              None if noise is None else noise[:, rows])
        st = s - t[:, None, :]
        Xs = x[:, None, :] + torch.sqrt(st) * eq.alpha_sqrt * dW
        idx = None
        if sdgd:
            idx = (_sdgd_indices(derive_seed(ck_seed, 2), (b, mc, gen.sdgd_v),
                                 nx, x.device) if hess_idx is None
                   else hess_idx[:, ck * mc:(ck + 1) * mc])
        f = get_f(eq, sol, s, Xs, hess_indices=idx,
                  hutchinson_generator=_probe_generator(eq, x.device,
                                                        ck_seed, 3),
                  hess_store=gen.hess_store)
        if idx is not None:
            f0_b = _baseline_f_at_indices(eq, t, x, d0, idx, u0)
        else:
            f0_b = f0[:, None, :]
        diff = Tt[:, None, :] * (f - f0_b)  # (B, mc, 1)
        val = torch.sum(diff, dim=1)
        if idx is not None:
            # with a per-sample baseline the value slot keeps +f0_b (T-t)
            val = val + torch.sum(Tt[:, None, :] * f0_b, dim=1)
        inv_y = 1.0 / (torch.sqrt(_safe(st)) * eq.alpha_sqrt)  # (B, mc, 1)
        grad = torch.einsum("bmo,bmn->bn", diff * inv_y, dW)
        return torch.cat([val, grad], dim=-1)

    mean = _scan_mean(seed, m, mc, (b, 1 + nx), chunk_sum, tx)
    if f0 is None:
        return mean
    return torch.cat([mean[:, :1] + f0 * Tt, mean[:, 1:]], dim=-1)


# ---------------------------------------------------------------------------
# the route and the dispatch
# ---------------------------------------------------------------------------

MERGED, SPLIT = "merged", "split"

# "auto" leaves the zero iterate (no net) to the chunk estimators below
# this nx: on the H100 they beat the merged kernel at nx = 10 (11.5-15.3
# against 16.1 ms at B = M = 4096) and lose at nx = 32 (24.4-26.9 against
# 16.7); with a 2x128 or 4x128 net the merged kernel wins 6.5-8.4x at
# nx = 10, 32 and 100 (``utils/route_bench.py``, PERF.md). The JAX
# package's gate (``_kernel_worthwhile``) takes its chunks for every net
# at nx < 32 and for nets narrower than 512 at nx < 256: measured on a
# TPU, not on the H100.
ZERO_ITERATE_MIN_NX = 32

# Generation calls per route, counted by the dispatch as it takes them
route_calls = {MERGED: 0, SPLIT: 0}


def generation_route(eq, sol: Solution, gen: GenConfig) -> str:
    """MERGED or SPLIT, decided by the configuration and the structure of
    the equation and frozen net alone, before any launch:
      * an equation without a gradient term, or with a Hessian or
        Laplacian term (the FN family), => SPLIT, whatever the flags say
        (the JAX package's merged kernel takes neither);
      * different terminal and integral M => SPLIT;
      * pallas_generate False => SPLIT, True => MERGED (the merged kernel
        raises on the card where it does not cover the net);
      * "auto" => MERGED where a merged kernel covers the equation and the
        net: for Cha ``generate.cu`` (``kernel_net``: ELU MLPs of width
        128), for the OU equation ``generate_pis.cu`` (``pis_covers``: a
        PISGradNet of width 512 in "default" or "bf16x3"); else SPLIT with
        a printed notice (other PISGradNet widths, EnforceTerminal, plain
        MLPs on OU, "highest" with a PISGradNet, antithetic pairing on
        OU); and SPLIT, silently, for the zero iterate at nx below
        ZERO_ITERATE_MIN_NX, where the chunk estimators are faster."""
    mode = gen.pallas_generate
    if not _integral_kernel_applies(eq):
        return SPLIT
    if gen.n_estimate_terminal != gen.n_estimate_integral or mode is False:
        return SPLIT
    if mode is True:
        return MERGED
    if mode != "auto":
        raise ValueError(f"pallas_generate must be False, True or 'auto' "
                         f"(got {mode!r})")
    reason = None
    if isinstance(eq, OUProcessEquation):
        why = pis_covers(eq, sol, gen.pallas_precision, gen.antithetic)
        if why is not None:
            reason = f"the OU merged kernel (generate_pis.cu): {why}"
    elif not isinstance(eq, Cha):
        reason = (f"the merged kernels cover Cha and the OU equation, not "
                  f"{type(eq).__name__}")
    else:
        try:
            kernel_net(sol, sol.nx)
        except NotImplementedError as e:
            reason = str(e)
    if reason is not None:
        _notice_fallback("DATA.TPU.PALLAS_GENERATE: auto", reason,
                         "using the split estimators")
        return SPLIT
    if sol.kind == "zero" and sol.nx < ZERO_ITERATE_MIN_NX:
        return SPLIT
    return MERGED


def generate_with_gradients(seed: int, eq, sol: Solution, tx: torch.Tensor,
                            gen: GenConfig) -> torch.Tensor:
    """(B, 1 + nx) value + gradient targets of the frozen iterate ``sol``,
    by the route of ``generation_route``. The split route's terminal and
    integral estimators draw from derive_seed(seed, 1) and (seed, 2)."""
    if gen.estimate_delta_t > 0:
        raise NotImplementedError(
            "DATA.ESTIMATE_DELTA_T > 0 (TD estimators) is not ported yet; "
            "it comes with the TD slice")
    route = generation_route(eq, sol, gen)
    route_calls[route] += 1
    if route == MERGED:
        merged = (generate_pis_cuda if isinstance(eq, OUProcessEquation)
                  else generate_with_gradients_cuda)
        return merged(seed, eq, sol, tx, gen.n_estimate_terminal,
                      antithetic=gen.antithetic,
                      precision=gen.pallas_precision)
    g = estimate_terminal_with_gradients(derive_seed(seed, 1), eq, tx, gen)
    y = estimate_integral_with_gradients(derive_seed(seed, 2), eq, sol, tx,
                                         gen)
    return g + y


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
