"""Device-resident dataset: generation and epoch shuffling.

Counterpart of ``deeppicarditeration_tpu/data/dataset.py``. The
per-iteration dataset is one tensor pair (tx, y) on the device; epochs
shuffle with an on-device permutation and drop the ragged tail. Saving and
offline replay (npz/h5) come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeppicarditeration_torch.device import derive_seed, resolve_device
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est


@dataclasses.dataclass
class DeviceDataset:
    tx: torch.Tensor  # (N, 1 + nx)
    y: torch.Tensor  # (N, target_dim)

    @property
    def size(self) -> int:
        return self.tx.shape[0]


def default_gen_batch(n_total: int, chunk_elems: int, nx: int) -> int:
    """Derived bound on collocation points per generation call:
    chunk_elems / (8 nx), rounded down to a multiple of 1024, as in the
    JAX package (single device)."""
    cap = max(1, chunk_elems // (8 * max(nx, 1)))
    if cap >= 2048:
        cap -= cap % 1024
    return min(n_total, cap)


def generate_dataset(seed: int, eq, sol: Solution, n_total: int,
                     gen: est.GenConfig, mode: str,
                     gen_batch: Optional[int] = None, dtype=torch.float32,
                     device=None) -> DeviceDataset:
    """The per-iteration supervised dataset, in calls of ``gen_batch``
    collocation points (chunk ``ck`` draws from ``derive_seed(seed, ck)``),
    on ``device`` (default: the card; the CPU only when asked for)."""
    device = resolve_device(device)
    gen_batch = gen_batch or n_total
    txs, ys = [], []
    n_done = ck = 0
    while n_done < n_total:
        tx, y = est.sample_batch(derive_seed(seed, ck), eq, sol, gen_batch,
                                 gen, mode=mode, dtype=dtype, device=device)
        take = min(gen_batch, n_total - n_done)
        txs.append(tx[:take])
        ys.append(y[:take])
        n_done += take
        ck += 1
    if len(txs) == 1:
        return DeviceDataset(tx=txs[0], y=ys[0])
    return DeviceDataset(tx=torch.cat(txs), y=torch.cat(ys))


def epoch_batches(generator: torch.Generator, ds: DeviceDataset,
                  batch_size: int, shuffle: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch as stacked batches: ((S, bs, 1+nx), (S, bs, ydim)); an
    on-device permutation that drops the ragged tail."""
    n = ds.size
    steps = n // batch_size
    if steps == 0:
        raise ValueError(
            f"batch_size ({batch_size}) exceeds the dataset size "
            f"({n}); no full batch can be formed (drop_last semantics)")
    if shuffle:
        idx = torch.randperm(n, generator=generator, device=ds.tx.device)
    else:
        idx = torch.arange(n, device=ds.tx.device)
    idx = idx[: steps * batch_size]
    tx = ds.tx.index_select(0, idx).reshape(steps, batch_size, -1)
    y = ds.y.index_select(0, idx).reshape(steps, batch_size, -1)
    return tx, y
