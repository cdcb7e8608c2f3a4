"""Derivative operators on frozen solutions, and the nonlinearity under them.

Counterpart of ``deeppicarditeration_tpu/ops/derivatives.py``:
  - ``get_f``: the PDE nonlinearity at sample points under the frozen
    iterate, by the equation's term structure: the full Hessian (``ffh``)
    or SDGD-sampled diagonal entries (``ffi``/``ffi_stats``), the Laplacian
    (``ffl``, Hutchinson probes or the exact trace), the gradient (``ff``),
    or none (``f``);
  - the second-order backprop of a plain MLP value head
    (``_mlp_second_order``): the Hessian of the pre-activations pushed
    down the layers as (R, w, w) blocks, from which the full diagonal
    (``mlp_hessian_diag``) and the full Hessian (``full_hessian``) are two
    contractions with the first layer's x rows;
  - the generic fallbacks through ``torch.func`` (per-index jvps of the
    gradient, ``vmap(hessian)``), for other nets and narrow index sets.

The operators detach their results by default: the estimators read them
under the frozen iterate. With ``create_graph=True`` (the PINN loss) they
keep the graph to the network's parameters instead: the second-order chain
runs under autograd with the activations' derivatives taken by autograd
too, Hutchinson's probes are reverse-over-reverse passes
(Hz = d/dx <grad_x u, z>) and the generic fallbacks take one such pass per
coordinate.

``store="bf16"`` (DATA.TPU.HESSIAN_STORE) keeps every (R, w, w) block of
the chain in bf16 and rounds the weights that multiply them to bf16, where
the JAX package casts them; the arithmetic between the casts stays f32 (the
JAX einsums' ``preferred_element_type``). ``None`` is the f32 chain.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeppicarditeration_torch.models.networks import MLP, get_activation
from deeppicarditeration_torch.models.solution import ONLY_GRADIENT, Solution


def _value_fn(sol: Solution):
    """(t, x) -> u with matching leading dims."""

    def u_fn(t, x):
        tx = torch.cat([t.expand(x.shape[:-1] + (1,)), x], dim=-1)
        return sol.value(tx)

    return u_fn


def _grad_x_fn(sol: Solution, t):
    """x -> du/dx at (t, x) for a batch of x: one reverse pass of the summed
    value (the net is pointwise over the batch), through ``torch.func`` so
    that forward-mode AD can run over it."""
    u_fn = _value_fn(sol)
    return torch.func.grad(lambda xx: u_fn(t, xx).sum())


def _elementwise_d12(act, z, create_graph: bool = False):
    """(act'(z), act''(z)) of an elementwise activation by nested jvp with
    a ones tangent (exact; no per-activation closed forms); with
    ``create_graph`` by two reverse passes that keep the graph to z."""
    if create_graph:
        zz = z if z.requires_grad else z.detach().requires_grad_(True)
        (s1,) = torch.autograd.grad(act(zz).sum(), zz, create_graph=True)
        (s2,) = torch.autograd.grad(s1.sum(), zz, create_graph=True)
        return s1, s2
    ones = torch.ones_like(z)

    def d1(y):
        return torch.func.jvp(act, (y,), (ones,))[1]

    return torch.func.jvp(d1, (z,), (ones,))


def _store_cast(store):
    """The cast of the chain's (R, w, w) blocks and of the weights that
    multiply them: bf16 for ``store == "bf16"``, else none."""
    if store == "bf16":
        return lambda a: a.to(torch.bfloat16)
    return lambda a: a


def _f32(*ops):
    return [a.float() for a in ops]


def _sandwich(A, G, B):
    """einsum("io,rol,jl->rij", A, G, B) in f32: A G_r B^T for every r."""
    A, G, B = _f32(A, G, B)
    return torch.einsum("io,roj->rij", A, torch.einsum("rol,jl->roj", G, B))


def _diag_sandwich(A, curv, B):
    """einsum("io,ro,jo->rij", A, curv, B): A diag(curv_r) B^T."""
    return torch.einsum("rio,jo->rij", A[None] * curv[:, None, :], B)


def _gz_boundary(s1, G):
    """G_{z_0} = s1 G_{a_0} s1^T: the first-layer boundary that
    ``mlp_hessian_diag`` and ``full_hessian`` share."""
    return s1[:, :, None] * G * s1[:, None, :]


def _mlp_second_order(sol: Solution, t, x, store=None,
                      create_graph: bool = False):
    """The second-order backprop of a plain-MLP value head.

    Returns (W1x, s1_0, curv_0, G_{a_0}) at the first hidden layer, from
    which diag(H) and H are contractions: G_{z_0} = s1_0 G_{a_0} s1_0^T +
    diag(curv_0), H = W1x G_{z_0} W1x^T. G_{a_0} is None for a single
    hidden layer (exactly 0). Down the layers:

        G_{z_k} = s1_k G_{a_k} s1_k^T + diag(s2_k delta_{a_k})
        G_{a_{k-1}} = W_k G_{z_k} W_k^T,   delta_{a_{k-1}} = W_k delta_{z_k}

    with W_k the (in, out) kernel. No autograd graph is built, unless
    ``create_graph``: then the chain stays on the graph to the weights."""
    module: MLP = sol.module
    kernels = [_keep(lin.weight, create_graph).T for lin in module.layers]
    biases = [_keep(lin.bias, create_graph) for lin in module.layers]
    nx = x.shape[-1]
    cast = _store_cast(store)
    with _grad_mode(create_graph):
        xf = x.reshape(-1, nx)
        tf = _broadcast_t(t, x).reshape(-1, 1)
        h = torch.cat([tf, xf], dim=-1)
        zs = []
        for W, b, act in zip(kernels[:-1], biases[:-1], module.activations):
            z = h @ W + b
            zs.append(z)
            h = get_activation(act)(z)
        y = h @ kernels[-1] + biases[-1]
        # the value head's backward seed; an active bound clamp gates it
        delta = kernels[-1][:, 0].expand(h.shape)
        if module.bound is not None:
            delta = delta * (torch.abs(y[..., 0:1]) < module.bound).to(
                x.dtype)
        G = None  # d^2u/da^2 at the top is exactly 0 (a linear head)
        for W, z, act in zip(kernels[-2:0:-1], zs[::-1][:-1],
                             module.activations[::-1][:-1]):
            s1, s2 = _elementwise_d12(get_activation(act), z, create_graph)
            curv = s2 * delta
            Ga = _diag_sandwich(W, curv, W)
            if G is not None:
                Gz = cast(s1[:, :, None] * G.float() * s1[:, None, :])
                Ga = Ga + _sandwich(cast(W), Gz, cast(W))
            delta = (s1 * delta) @ W.T
            G = cast(Ga)
        s1, s2 = _elementwise_d12(get_activation(module.activations[0]),
                                  zs[0], create_graph)
        curv = s2 * delta
    return kernels[0][1:, :], s1, curv, G


def _keep(p: torch.Tensor, create_graph: bool) -> torch.Tensor:
    return p if create_graph else p.detach()


def _grad_mode(create_graph: bool):
    return torch.enable_grad() if create_graph else torch.no_grad()


def _broadcast_t(t, x):
    return torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (1,))


def _diag_by_passes(sol: Solution, t, x) -> torch.Tensor:
    """The full Hessian diagonal (..., nx) of the value head, on the graph to
    the parameters: one reverse pass for grad_x u, then one more per
    coordinate i (d/dx_i of its component i)."""
    nx = x.shape[-1]
    xx = x.detach().reshape(-1, nx).requires_grad_(True)
    tx = torch.cat([_broadcast_t(t, x).reshape(-1, 1), xx], dim=-1)
    (g,) = torch.autograd.grad(sol.value(tx).sum(), xx, create_graph=True)
    cols = [torch.autograd.grad(g[:, i].sum(), xx, create_graph=True)[0][:, i]
            for i in range(nx)]
    return torch.stack(cols, dim=-1).reshape(x.shape)


def _hessian_by_passes(sol: Solution, t, x) -> torch.Tensor:
    """The full Hessian (..., nx, nx) of the value head, on the graph to the
    parameters: one reverse pass per row of grad_x u."""
    nx = x.shape[-1]
    xx = x.detach().reshape(-1, nx).requires_grad_(True)
    tx = torch.cat([_broadcast_t(t, x).reshape(-1, 1), xx], dim=-1)
    (g,) = torch.autograd.grad(sol.value(tx).sum(), xx, create_graph=True)
    rows = [torch.autograd.grad(g[:, i].sum(), xx, create_graph=True)[0]
            for i in range(nx)]
    return torch.stack(rows, dim=-2).reshape(x.shape[:-1] + (nx, nx))


def _mlp_fast_path(sol: Solution) -> bool:
    # an OnlyGradient net's value head is identically zero: differentiating
    # its output column 0 would be wrong
    return (sol.kind == "net" and isinstance(sol.module, MLP)
            and sol.net_type != ONLY_GRADIENT
            and len(sol.module.neurons) >= 1)


def mlp_hessian_diag(sol: Solution, t, x, store=None,
                     create_graph: bool = False) -> torch.Tensor:
    """The exact full Hessian diagonal d^2u/dx_i^2 of a plain-MLP value
    head, (..., nx), by second-order backprop:
    diag(H) = rowsum((W1x G_{z_0}) * W1x)."""
    W1x, s1, curv, G = _mlp_second_order(sol, t, x, store=store,
                                         create_graph=create_graph)
    cast = _store_cast(store)
    with _grad_mode(create_graph):
        diag = curv @ (W1x ** 2).T
        if G is not None:
            Gz = cast(_gz_boundary(s1, G.float()))
            A, Gz = _f32(cast(W1x), Gz)
            diag = torch.einsum("ril,il->ri",
                                torch.einsum("io,rol->ril", A, Gz), A) + diag
    return diag.to(x.dtype).reshape(x.shape)


def sdgd_index_counts(indices, nx: int) -> torch.Tensor:
    """Multiplicity counts of sampled SDGD indices, (..., v) -> (..., nx)
    f32: c[..., i] = #{k : indices[..., k] == i}, exact (a scatter-add of
    ones, no (..., v, nx) comparison). Statistics symmetric in the sampled
    entries follow as count-weighted contractions with the full diagonal:
    sum_sampled phi(d) = c . phi(d)."""
    counts = torch.zeros(indices.shape[:-1] + (nx,), dtype=torch.float32,
                         device=indices.device)
    return counts.scatter_add_(-1, indices.long(),
                               torch.ones(indices.shape, dtype=torch.float32,
                                          device=indices.device))


def diag_hessian_entries(sol: Solution, t, x, indices, store=None,
                         create_graph: bool = False) -> torch.Tensor:
    """Sampled diagonal Hessian entries d^2u/dx_i^2 of the value head: t
    (..., 1), x (..., nx), indices (..., v) -> (..., v).

    A plain MLP with a wide index set (4 v >= its narrowest layer) takes
    the full diagonal of ``mlp_hessian_diag`` and gathers; otherwise one
    forward-over-reverse pass per sampled index (the jvp of the gradient
    along e_i, its component i). With ``create_graph`` the other nets take
    the full diagonal by reverse passes (``_diag_by_passes``) and gather."""
    if sol.kind == "zero":
        return torch.zeros(indices.shape, dtype=x.dtype, device=x.device)
    nx = x.shape[-1]
    v = indices.shape[-1]
    if _mlp_fast_path(sol) and 4 * v >= min(sol.module.neurons):
        diag = mlp_hessian_diag(sol, t, x, store=store,
                                create_graph=create_graph)
        return torch.gather(diag, -1, indices.long())
    if create_graph:
        return torch.gather(_diag_by_passes(sol, t, x), -1, indices.long())
    u_fn = _value_fn(sol)
    iota = torch.arange(nx, device=x.device)

    def per_sample(t1, x1, idx1):
        grad_fn = torch.func.grad(
            lambda xx: u_fn(t1[None, :], xx[None, :])[0, 0])

        def entry(i):
            e = (iota == i).to(x1.dtype)
            _, hcol = torch.func.jvp(grad_fn, (x1,), (e,))
            return torch.sum(hcol * e)

        return torch.func.vmap(entry)(idx1)

    t = _broadcast_t(t, x)
    flat = torch.func.vmap(per_sample)(
        t.reshape(-1, 1), x.reshape(-1, nx), indices.reshape(-1, v))
    return flat.reshape(indices.shape).detach()


def full_hessian(sol: Solution, t, x, store=None,
                 create_graph: bool = False) -> torch.Tensor:
    """Per-sample (nx, nx) Hessian of the value head, (..., nx, nx): for a
    plain MLP H = W1x G_{z_0} W1x^T from the second-order chain, else
    ``vmap(hessian)`` (with ``create_graph``: ``_hessian_by_passes``)."""
    nx = x.shape[-1]
    if sol.kind == "zero":
        return x.new_zeros(x.shape[:-1] + (nx, nx))
    if _mlp_fast_path(sol):
        W1x, s1, curv, G = _mlp_second_order(sol, t, x, store=store,
                                             create_graph=create_graph)
        cast = _store_cast(store)
        with _grad_mode(create_graph):
            H = _diag_sandwich(W1x, curv, W1x)
            if G is not None:
                H = H + _sandwich(cast(W1x), cast(_gz_boundary(s1,
                                                               G.float())),
                                  cast(W1x))
        return H.to(x.dtype).reshape(x.shape[:-1] + (nx, nx))
    if create_graph:
        return _hessian_by_passes(sol, t, x)
    u_fn = _value_fn(sol)

    def per_sample(t1, x1):
        return torch.func.hessian(
            lambda xx: u_fn(t1[None, :], xx[None, :])[0, 0])(x1)

    t = _broadcast_t(t, x)
    flat = torch.func.vmap(per_sample)(t.reshape(-1, 1), x.reshape(-1, nx))
    return flat.reshape(x.shape[:-1] + (nx, nx)).detach()


def rademacher_probes(generator: Optional[torch.Generator], num_v: int,
                      x: torch.Tensor) -> torch.Tensor:
    """(num_v, ..., nx) Rademacher probes (+-1) from ``generator``."""
    return (torch.randint(0, 2, (num_v,) + tuple(x.shape),
                          generator=generator, device=x.device)
            .to(x.dtype) * 2.0 - 1.0)


def hutchinson_laplacian(generator: Optional[torch.Generator],
                         sol: Solution, t, x, num_v: int,
                         probes: Optional[torch.Tensor] = None,
                         create_graph: bool = False):
    """Rademacher estimate of Tr Hess u at each point, (..., 1): the mean
    over ``num_v`` probes z (drawn from ``generator``, or ``probes``
    (num_v, ..., nx)) of z . (Hess u) z, each a forward-over-reverse pass
    of the whole batch. With ``create_graph``: all probes in one batch of
    num_v copies of the points, Hz = d/dx <grad_x u, z> by a second reverse
    pass, on the graph to the parameters."""
    if sol.kind == "zero":
        return x.new_zeros(x.shape[:-1] + (1,))
    if probes is None:
        probes = rademacher_probes(generator, num_v, x)
    if create_graph:
        nx, v = x.shape[-1], probes.shape[0]
        xx = x.detach().reshape(1, -1, nx).expand(v, -1, -1).reshape(
            -1, nx).requires_grad_(True)
        tt = _broadcast_t(t, x).reshape(1, -1, 1).expand(v, -1, -1).reshape(
            -1, 1)
        z = probes.reshape(-1, nx)
        u = sol.value(torch.cat([tt, xx], dim=-1))
        (g,) = torch.autograd.grad(u.sum(), xx, create_graph=True)
        (hz,) = torch.autograd.grad((g * z).sum(), xx, create_graph=True)
        quad = torch.sum(hz * z, dim=-1).reshape((v,) + x.shape[:-1] + (1,))
        return quad.mean(dim=0)
    g = _grad_x_fn(sol, t)
    out = x.new_zeros(x.shape[:-1] + (1,))
    for z in probes:
        _, hz = torch.func.jvp(g, (x,), (z,))
        out = out + torch.sum(hz * z, dim=-1, keepdim=True)
    return (out / probes.shape[0]).detach()


def exact_laplacian(sol: Solution, t, x,
                    create_graph: bool = False) -> torch.Tensor:
    """Tr Hess u from the full diagonal, (..., 1)."""
    nx = x.shape[-1]
    idx = torch.arange(nx, device=x.device).expand(x.shape[:-1] + (nx,))
    diag = diag_hessian_entries(sol, t, x, idx, create_graph=create_graph)
    return torch.sum(diag, dim=-1, keepdim=True)


def get_f(eq, sol: Solution, s, x, *, hess_indices=None,
          hutchinson_generator: Optional[torch.Generator] = None,
          hess_store=None):
    """The PDE nonlinearity at (s, x) under the frozen solution ``sol``:
      - a Hessian term: SDGD on ``hess_indices`` (..., v) -> ``ffi`` (with
        ``ffi_stats``, the counts contracted against the full diagonal,
        no gather), else the full Hessian -> ``ffh``;
      - a Laplacian term: Hutchinson (eq.num_v_samples > 0, probes from
        ``hutchinson_generator``) or the exact trace -> ``ffl``;
      - a gradient term: ``ff(s, x, u, u_x)``; else ``f(s, x, u)``."""
    if eq.has_hessian_term and hess_indices is not None:
        # ffi reads neither u_x nor (for GBM) u: the value pass only
        u = sol.value(torch.cat([s.expand(x.shape[:-1] + (1,)), x], -1))
        u = u.detach()
        v = hess_indices.shape[-1]
        if (hasattr(eq, "ffi_stats") and _mlp_fast_path(sol)
                and 4 * v >= min(sol.module.neurons)):
            diag = mlp_hessian_diag(sol, s, x, store=hess_store)
            c = sdgd_index_counts(hess_indices, x.shape[-1])
            m1 = torch.sum(c * diag, dim=-1, keepdim=True) / v
            m2 = torch.sum(c * torch.abs(diag), dim=-1, keepdim=True) / v
            return eq.ffi_stats(s, x, u, m1, m2)
        u_ii = diag_hessian_entries(sol, s, x, hess_indices,
                                    store=hess_store)
        return eq.ffi(s, x, u, u_ii)
    u, u_x = sol.value_and_grad_x(s, x)
    if eq.has_hessian_term:
        hess = full_hessian(sol, s, x, store=hess_store)
        return eq.ffh(s, x, u, u_x, hess)
    if eq.has_laplacian_term:
        if eq.num_v_samples and eq.num_v_samples > 0:
            lap = hutchinson_laplacian(hutchinson_generator, sol, s, x,
                                       eq.num_v_samples)
        else:
            lap = exact_laplacian(sol, s, x)
        return eq.ffl(s, x, u, u_x, lap)
    if eq.has_gradient_term:
        return eq.ff(s, x, u, u_x)
    return eq.f(s, x, u)
