"""How close builds of the integral kernel come to f64, mode by mode.

    python -m deeppicarditeration_torch.utils.integral_precision [--source PATH ...]

For each ``--source`` (default: the package's ``csrc/integral.cu``; another
build with its headers beside it, as ``utils/generate_bench.py`` takes),
each case (B, nx, the net's seed: chip_smoke's ragged nx = 7 and path B's
nx = 100, random 4x128 ELU nets) and pairing, draws M = 128 samples a point
on the card and prints one JSON line: the max |diff| of the kernel's output
in "highest" and bf16x3, and of the plain version in f32 "highest" and in
bf16x3, from the plain version run in f64 (the net's weights and the inputs
in f64), on the value column (the mean of Tt (f - f0), where the net's u
and sum_j u_x_j enter weighted by Tt alone) and over all columns. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess

import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import build_sources

M = 128
# (B, nx, the net's seed, the least t)
CASES = ((131, 7, 0, 0.0), (4096, 100, 0, 0.0), (131, 7, 8, 0.005),
         (4096, 100, 8, 0.005))


def _dist(a, ref):
    """[max |diff| of the value column, of all columns]."""
    e = (a.double() - ref).abs()
    return [float(e[:, 0].max()), float(e.max())]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*", default=None)
    args = ap.parse_args(argv)
    sources = args.source or [str(kernels.INTEGRAL.source)]
    libs = build_sources(sources, kernels._declare_integral)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows_out = []
    for b, nx, seed, t_min in CASES:
        g = torch.Generator().manual_seed(seed)
        eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
        mod = MLP(1 + nx, (128,) * 4, ("ELU",) * 4, 1, generator=g)
        t = torch.rand((b, 1), generator=g) * 0.99 + t_min
        x = torch.randn((b, nx), generator=g) * t.sqrt()
        tx = torch.cat([t, x], 1).to(dev)
        s64 = Solution.from_net(copy.deepcopy(mod).double().to(dev), "Value",
                                nx)
        sol = Solution.from_net(mod.to(dev), "Value", nx)
        for anti in (False, True):
            rows = M // 2 if anti else M
            g = torch.Generator(device=dev).manual_seed(11)
            u01 = torch.rand((b, rows, 1), generator=g, device=dev)
            ni = torch.randn((b, rows, nx), generator=g, device=dev)

            def plain(s, precision, dtype):
                return kernels.integral_with_gradients_plain(
                    0, eq, s, tx.to(dtype), M, u01.to(dtype), ni.to(dtype),
                    antithetic=anti, precision=precision)

            ref = plain(s64, "highest", torch.float64)
            row = {"B": b, "nx": nx, "net_seed": seed, "antithetic": anti,
                   "M": M,
                   "plain highest": _dist(plain(sol, "highest",
                                                torch.float32), ref),
                   "plain bf16x3": _dist(plain(sol, "bf16x3",
                                               torch.float32), ref)}
            for src, lib in zip(sources, libs):
                for precision in ("highest", "bf16x3"):
                    out = kernels.integral_with_gradients_cuda(
                        0, eq, sol, tx, M, u01, ni, antithetic=anti,
                        precision=precision, lib=lib)
                    row[f"{src} {precision}"] = _dist(out, ref)
            print(json.dumps(row), flush=True)
            rows_out.append(row)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    return rows_out


if __name__ == "__main__":
    main()
