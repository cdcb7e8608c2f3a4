"""Equation layer (counterpart of deeppicarditeration_tpu/equations)."""

from deeppicarditeration_torch.equations.base import (
    EquationMethods,
    SimpleDiffusionMethods,
    SimpleDiffusionWithHessian,
    SimpleDiffusionWithLaplacian,
    SimpleDiffusionWithZ,
    get_equation_cls,
    make_equation,
    register_equation,
)
from deeppicarditeration_torch.equations.burgers import Cha
from deeppicarditeration_torch.equations.fully_nonlinear import (
    GBMEquationComplexExact,
)
from deeppicarditeration_torch.equations.hjb import OUProcessEquation

__all__ = [
    "EquationMethods",
    "SimpleDiffusionMethods",
    "SimpleDiffusionWithZ",
    "SimpleDiffusionWithLaplacian",
    "SimpleDiffusionWithHessian",
    "register_equation",
    "get_equation_cls",
    "make_equation",
    "Cha",
    "OUProcessEquation",
    "GBMEquationComplexExact",
]
