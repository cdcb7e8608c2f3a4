"""Device selection and seed derivation shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the card (raises when there is none); "cpu" only
    when asked for explicitly. Nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (config key "
            "DEVICE: cpu) to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def derive_seed(*path: int) -> int:
    """A 63-bit seed from an integer path (run seed, iteration, purpose…).

    The counterpart of the JAX package's ``fold_in``/``split`` key tree:
    numpy's SeedSequence hashes the path, so sibling paths give
    independent streams and the same path the same stream in every
    process."""
    ss = np.random.SeedSequence([int(p) & 0xFFFFFFFF for p in path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_generator(device: torch.device, *path: int) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from ``derive_seed(*path)``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(*path))
    return g
