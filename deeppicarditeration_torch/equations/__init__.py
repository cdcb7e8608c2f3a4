"""Equation layer (counterpart of deeppicarditeration_tpu/equations)."""

from deeppicarditeration_torch.equations.base import (
    EquationMethods,
    SimpleDiffusionMethods,
    SimpleDiffusionWithZ,
    get_equation_cls,
    make_equation,
    register_equation,
)
from deeppicarditeration_torch.equations.burgers import Cha

__all__ = [
    "EquationMethods",
    "SimpleDiffusionMethods",
    "SimpleDiffusionWithZ",
    "register_equation",
    "get_equation_cls",
    "make_equation",
    "Cha",
]
