"""100-d HJB benchmark: the OU-drift log-density equation with a GMM terminal.

Counterpart of ``deeppicarditeration_tpu/equations/hjb.py``. The PDE

    u_t + alpha/2 u_xx - <theta (mu - x), u_x> - alpha/2 |u_x|^2 - d theta = 0

has the exact solution u(t, x) = -log p_{GMM(T - t)}(x), the terminal
mixture propagated backward through the OU process:

    mean_i(tau) = mu + (m_i - mu) e^{-theta tau}
    var_i(tau)  = v_i e^{-2 theta tau} + alpha/(2 theta) (1 - e^{-2 theta tau})

The OU drift sits in the nonlinearity ``ff``, so the forward sampling stays
the drift-free Gaussian jump of the base class. The mixture is drawn from
the seed with the host threefry reference (``ops/threefry.py``) on the key
path of the JAX package, so one seed gives the same instance in both; its
tensors live on the CPU until ``to(device)`` moves them.
"""

from __future__ import annotations

import dataclasses

import torch

from deeppicarditeration_torch.distributions import (
    DiagGaussian,
    DiagGaussianMixture,
    make_random_gmm,
)
from deeppicarditeration_torch.equations.base import (
    SimpleDiffusionWithZ,
    param_tag,
    register_equation,
)
from deeppicarditeration_torch.ops import threefry


@register_equation
@dataclasses.dataclass(frozen=True, eq=False)
class OUProcessEquation(SimpleDiffusionWithZ):
    nx: int = 100
    T: float = 1.0
    alpha: float = 1.0
    theta: float = 1.0
    mu: float = 0.0
    alpha_scale: float = 4.0
    # the terminal mixture: (K, nx), (K, nx), (K,)
    gmm_means: torch.Tensor = None
    gmm_vars: torch.Tensor = None
    gmm_log_weights: torch.Tensor = None

    has_exact_solution = True

    @classmethod
    def create(cls, nx: int = 100, T: float = 1.0, theta: float = 1.0,
               mu: float = 0.0, alpha: float = 1.0, num_components: int = 2,
               mean_scale: float = 1.0, var_scale: float = 2.0,
               alpha_scale: float = 4.0, seed: int = 0):
        key = threefry.fold_in(threefry.PRNGKey(seed), param_tag("ou_gmm"))
        gmm = make_random_gmm(key, nx, num_components, mean_scale, var_scale)
        return cls(nx=nx, T=T, alpha=alpha, theta=theta, mu=mu,
                   alpha_scale=alpha_scale, gmm_means=gmm.means,
                   gmm_vars=gmm.vars, gmm_log_weights=gmm.log_weights)

    def to(self, device) -> "OUProcessEquation":
        """This instance with its mixture on ``device``."""
        return dataclasses.replace(
            self, gmm_means=self.gmm_means.to(device),
            gmm_vars=self.gmm_vars.to(device),
            gmm_log_weights=self.gmm_log_weights.to(device))

    # --- distributions ----------------------------------------------------
    @property
    def gmm_terminal(self) -> DiagGaussianMixture:
        return DiagGaussianMixture(self.gmm_means, self.gmm_vars,
                                   self.gmm_log_weights)

    @property
    def gaussian_init(self) -> DiagGaussian:
        var0 = self.alpha_scale * self.alpha
        return DiagGaussian(torch.zeros_like(self.gmm_means[0]),
                            torch.full_like(self.gmm_means[0], var0))

    def gmm_at(self, tau) -> DiagGaussianMixture:
        """The mixture propagated for time tau (..., 1) through the OU
        process, with leading batch dims matching tau."""
        e = torch.exp(-self.theta * tau)
        e2 = (e * e)[..., None]
        stat_var = self.alpha / (2.0 * self.theta)
        means_t = self.mu + (self.gmm_means - self.mu) * e[..., None]
        vars_t = self.gmm_vars * e2 + stat_var * (1.0 - e2)
        lw = self.gmm_log_weights.expand(
            tau.shape[:-1] + self.gmm_log_weights.shape)
        return DiagGaussianMixture(means_t, vars_t, lw)

    # --- PDE terms ---------------------------------------------------------
    def F(self, t, x):
        return self.theta * (self.mu - x)

    def ff(self, t, x, y, w):
        """-<F, w> - alpha/2 |w|^2 - d theta."""
        drift = torch.sum(self.F(t, x) * w, dim=-1, keepdim=True)
        quad = torch.sum(w * w, dim=-1, keepdim=True)
        return (-drift - 0.5 * self.alpha * quad
                - self.nx * self.theta * torch.ones_like(y))

    def fff(self, t, x, y, z):
        return self.ff(t, x, y, z / self.alpha_sqrt)

    def ffh(self, t, x, y, w, hess):
        """ff: the equation has no Hessian term (DBDP passes one)."""
        return self.ff(t, x, y, w)

    # --- terminal condition -------------------------------------------------
    def g(self, x):
        return -self.gmm_terminal.log_prob(x)

    def g_x(self, x):
        return -self.gmm_terminal.grad_log_prob(x)

    # --- exact solution ----------------------------------------------------
    def exact_solution(self, t, x):
        return -self.gmm_at(self.T - t).log_prob(x)

    def u_x(self, t, x):
        return -self.gmm_at(self.T - t).grad_log_prob(x)

    def sample_x0(self, generator, n: int, dtype, device):
        """x0 ~ N(0, alpha_scale alpha I), on the mixture's device."""
        return self.gaussian_init.sample(generator, n).to(device, dtype)
