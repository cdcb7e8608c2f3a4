"""The PDE nonlinearity under a frozen solution.

Counterpart of ``deeppicarditeration_tpu/ops/derivatives.py:get_f``, the
gradient-term branch only. The Hessian and Laplacian branches (FN family,
SDGD, Hutchinson) come with a later slice.
"""

from __future__ import annotations

from deeppicarditeration_torch.models.solution import Solution


def get_f(eq, sol: Solution, s, x):
    """ff(s, x, u, u_x) under the frozen solution ``sol``."""
    if eq.has_hessian_term or eq.has_laplacian_term:
        raise NotImplementedError(
            "get_f: Hessian/Laplacian terms are not ported yet (FN slice)")
    if not eq.has_gradient_term:
        raise NotImplementedError(
            "get_f: gradient-free equations are not ported yet")
    u, u_x = sol.value_and_grad_x(s, x)
    return eq.ff(s, x, u, u_x)
