"""Compensated (Kahan) accumulation for long Monte-Carlo reductions.

Counterpart of ``deeppicarditeration_tpu/ops/summation.py``. The chunk
estimators' means over up to 10^6 samples accumulate in f32 carried with a
compensation term (Kahan-Babuska / Neumaier), which restores ~f64-quality
summation over the chunks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KahanAcc(NamedTuple):
    """A compensated accumulator: value ``sum`` plus error term ``comp``."""

    sum: torch.Tensor
    comp: torch.Tensor

    @classmethod
    def zeros(cls, shape, dtype=torch.float32, device=None) -> "KahanAcc":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(sum=z, comp=torch.zeros_like(z))

    def add(self, value: torch.Tensor) -> "KahanAcc":
        """Kahan-Babuska (Neumaier) update; safe for any magnitude order."""
        t = self.sum + value
        big = torch.abs(self.sum) >= torch.abs(value)
        comp = self.comp + torch.where(big, (self.sum - t) + value,
                                       (value - t) + self.sum)
        return KahanAcc(sum=t, comp=comp)

    @property
    def value(self) -> torch.Tensor:
        return self.sum + self.comp
