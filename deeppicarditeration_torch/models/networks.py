"""Solution-ansatz networks (counterpart of deeppicarditeration_tpu/models/networks.py):
the plain ``MLP``, the terminal-aware ``PISGradNet`` of the HJB recipes and
the terminal-enforcing ``EnforceTerminal``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from deeppicarditeration_torch.distributions import DiagGaussianMixture


def _elu(x):
    """ELU via exp, as the JAX package writes it (``where(x>0, x,
    exp(min(x,0)) - 1)``), not torch's expm1-based ``nn.ELU``: the two
    differ by ~1 ulp near 0, and the JAX form is the reference. The
    ``where`` on the exp argument keeps the gradient free of inf * 0."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, torch.exp(safe) - 1.0)


_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ELU": _elu,
    "ReLU": torch.relu,
    "GELU": nn.functional.gelu,
    "SiLU": nn.functional.silu,
    "Swish": nn.functional.silu,
    "Sigmoid": torch.sigmoid,
    "Softplus": nn.functional.softplus,
    "Sin": torch.sin,
}


def get_activation(name: str):
    if name not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default Dense kernel init: truncated normal (at +-2 sd) with
    variance 1/fan_in."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)


class MLP(nn.Module):
    """Hidden widths ``neurons`` with ``activations`` after each hidden
    layer, a final linear head, and an optional clamp to [-bound, bound].

    ``layers`` holds the Linear layers in order (the last is the head); the
    CUDA estimator kernel reads their weights from there."""

    def __init__(self, in_dim: int, neurons: Sequence[int],
                 activations: Sequence[str], out_dim: int,
                 bound: Optional[float] = None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(neurons) != len(activations):
            raise ValueError(
                f"{len(activations)} activations for {len(neurons)} layers")
        self.neurons = tuple(int(n) for n in neurons)
        self.activations = tuple(activations)
        self.out_dim = int(out_dim)
        self.bound = bound
        widths = (int(in_dim),) + self.neurons + (self.out_dim,)
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype) for a, b in zip(widths, widths[1:]))
        for lin in self.layers:
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        self._acts = [get_activation(a) for a in self.activations]

    def forward(self, tx, dot=None):
        """``dot(a, kernel)``: the contraction of a (..., in) with the
        (in, out) kernel W^T in place of the f32 matmul (the counterpart of
        the JAX MLP's ``dot_general`` knob; ``ops/kernels.py:precision_dot``
        for the estimator kernels' precision modes)."""

        def linear(lin, h):
            if dot is None:
                return lin(h)
            return dot(h, lin.weight.t()) + lin.bias

        h = tx
        for lin, act in zip(self.layers[:-1], self._acts):
            h = act(linear(lin, h))
        h = linear(self.layers[-1], h)
        if self.bound is not None:
            if not self.bound > 0:
                raise ValueError("NETWORK.BOUND must be positive")
            h = torch.clamp(h, -self.bound, self.bound)
        return h


def _dense(lin: nn.Linear, h, dot=None):
    """``lin(h)``, or with ``dot(a, kernel)`` in place of the f32 matmul."""
    if dot is None:
        return lin(h)
    return dot(h, lin.weight.t()) + lin.bias


def _init_linear(lin: nn.Linear, generator) -> nn.Linear:
    _lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class PISGradNet(nn.Module):
    """The terminal-aware net of the HJB recipes (the JAX package's
    ``PISGradNet``): with lambda = T - t, a sinusoidal time embedding
    e(lambda) = [sin(c lambda + phase), cos(c lambda + phase)] (c = 0.1 +
    i 99.9 / (channels - 1), phase learned), a smoothing gate
    sigma = S(e(lambda))[0] - S(e(0))[0] and

        u = sigma <N([T_enc(e), x]), x> + (1 - sigma) g0(e^{-lambda/2} x)

    with ``t_encoder`` T_enc (2 Dense, ELU between), ``smooth_net`` S
    (1 + len(hidden) Dense of width ``channels`` with ELU between, then a
    head of width dim) and ``nn_module`` N (Dense + ELU of the hidden
    widths, then a head of width dim). g0 is the OU equation's terminal
    -log GMM, its mixture held as buffers of the module (not saved with
    the parameters), so that it moves with the module to the device."""

    def __init__(self, dim: int, hidden_shapes: Sequence[int], gmm,
                 T: float = 1.0, channels: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = int(dim)
        self.hidden_shapes = tuple(int(n) for n in hidden_shapes)
        self.T = float(T)
        self.channels = int(channels)
        c = self.channels
        self.timestep_phase = nn.Parameter(torch.zeros(1, c))
        # 0.1 + iota * step in f32, as the JAX module writes it
        step = (100.0 - 0.1) / max(c - 1, 1)
        self.register_buffer(
            "timestep_coeff",
            0.1 + torch.arange(c, dtype=torch.float32)[None] * step,
            persistent=False)
        means, vars_, log_weights = gmm
        self.register_buffer("gmm_means", means.detach().clone(),
                             persistent=False)
        self.register_buffer("gmm_vars", vars_.detach().clone(),
                             persistent=False)
        self.register_buffer("gmm_log_weights", log_weights.detach().clone(),
                             persistent=False)

        def stack(widths_in, widths_out):
            return nn.ModuleList(
                _init_linear(nn.Linear(a, b), generator)
                for a, b in zip(widths_in, widths_out))

        self.t_encoder = stack((2 * c, c), (c, c))
        s_out = (c,) * (1 + len(self.hidden_shapes)) + (self.dim,)
        self.smooth_net = stack((2 * c,) + s_out[:-1], s_out)
        n_out = self.hidden_shapes + (self.dim,)
        self.nn_module = stack((c + self.dim,) + n_out[:-1], n_out)

    def g0(self, x):
        return -DiagGaussianMixture(self.gmm_means, self.gmm_vars,
                                    self.gmm_log_weights).log_prob(x)

    def embedding(self, lbd):
        """e(lambda), (..., 2 channels)."""
        arg = self.timestep_coeff * lbd + self.timestep_phase
        return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)

    def smooth(self, emb, dot=None):
        """S(emb)[..., 0:1]."""
        h = _dense(self.smooth_net[0], emb, dot)
        for layer in self.smooth_net[1:]:
            h = _dense(layer, _elu(h), dot)
        return h[..., 0:1]

    def forward(self, tx, dot=None):
        """``dot``: as ``MLP.forward``'s, for every Dense of the three
        stacks (the JAX module's ``dot_general`` knob)."""
        lbd, x = self.T - tx[..., 0:1], tx[..., 1:]
        emb = self.embedding(lbd)
        zero_emb = self.embedding(torch.zeros_like(lbd))
        sigma = self.smooth(emb, dot) - self.smooth(zero_emb, dot)
        t_emb = _dense(self.t_encoder[1],
                       _elu(_dense(self.t_encoder[0], emb, dot)), dot)
        h = torch.cat([t_emb, x], dim=-1)
        for layer in self.nn_module[:-1]:
            h = _elu(_dense(layer, h, dot))
        net_out = _dense(self.nn_module[-1], h, dot)
        sp_out = torch.sum(net_out * x, dim=-1, keepdim=True)
        residual = self.g0(torch.exp(-0.5 * lbd) * x)
        return sigma * sp_out + (1.0 - sigma) * residual


class EnforceTerminal(nn.Module):
    """u(t, x) = anchor(x) + (T - t) inner(tx): ``anchor`` is the
    equation's g (a plain callable on tensors of the module's device)."""

    def __init__(self, inner: nn.Module, anchor: Callable, T: float = 1.0):
        super().__init__()
        self.inner = inner
        self.anchor = anchor
        self.T = float(T)

    def forward(self, tx):
        t, x = tx[..., 0:1], tx[..., 1:]
        return self.anchor(x) + (self.T - t) * self.inner(tx)
