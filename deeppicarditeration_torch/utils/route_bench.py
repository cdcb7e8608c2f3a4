"""Time the merged route against the chunk route of target generation.

    python -m deeppicarditeration_torch.utils.route_bench [--b 4096] \
        [--m 4096] [--reps 2]

``DATA.TPU.PALLAS_GENERATE: auto`` takes the merged kernel
(``csrc/generate.cu``) wherever it covers the equation and the frozen net
(``ops/estimators.py:generation_route``); elsewhere, and under ``false``
with both standalone kernel flags off, generation takes the chunk
estimators (torch, Kahan over chunks, normals from a torch.Generator).
The JAX package's "auto" also asks whether its merged kernel beats the
chunks (``_kernel_worthwhile``: not at nx < 32, nor for nets of summed
width below 512 at nx < 256). This script times both routes of the port
through ``generate_with_gradients`` at the cells on that boundary that
the merged kernel covers: nx in {10, 32, 100} with the zero iterate and
random 2x128 and 4x128 ELU nets (Cha, k = 5, the flagship's chunk size
and precision, B = M = 4096). Times are CUDA events per call after a
warm-up, the routes timed in turns (merged, chunks, chunks, merged) and
each route's two turns averaged. Prints one JSON line per cell, with the
route "auto" takes there, and the card's name and power limit. Needs a
CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from deeppicarditeration_torch.device import Timer, make_generator
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est

NXS = (10, 32, 100)
NETS = ((), (128, 128), (128, 128, 128, 128))
CHUNK_ELEMS = 33554432  # configs/burgers/base_100d_T1.0_w0.0.yaml


def _ms(fn, reps: int, device) -> float:
    fn()  # warm-up
    with Timer(device) as tm:
        for _ in range(reps):
            fn()
    return tm.ms / reps


def cell(nx: int, neurons, b: int, m: int, reps: int, device) -> dict:
    g = torch.Generator().manual_seed(nx * 10 + len(neurons))
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    sol = Solution.zero(nx)
    if neurons:
        mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1, generator=g)
        sol = Solution.from_net(mod.to(device), "Value", nx)
    auto = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                         chunk_elems=CHUNK_ELEMS, t_always_uniform=True,
                         sample_bound=2.0)
    tx = est.sample_tx(make_generator(device, 1), eq, b, auto, device=device)
    gens = {est.MERGED: dataclasses.replace(auto, pallas_generate=True),
            "chunks": dataclasses.replace(auto, pallas_generate=False)}
    fns = {k: (lambda gen=gen: est.generate_with_gradients(5, eq, sol, tx,
                                                            gen))
           for k, gen in gens.items()}
    turns = [(k, _ms(fns[k], reps, device))
             for k in (est.MERGED, "chunks", "chunks", est.MERGED)]
    ms = {k: sum(t for kk, t in turns if kk == k) / 2 for k in fns}
    return {"nx": nx, "neurons": list(neurons), "B": b, "M": m,
            "merged_ms": ms[est.MERGED], "chunks_ms": ms["chunks"],
            "turns_ms": [t for _, t in turns],
            "chunks_over_merged": ms["chunks"] / ms[est.MERGED],
            "auto_route": est.generation_route(eq, sol, auto),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("route_bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for nx in NXS:
        for neurons in NETS:
            print(json.dumps(cell(nx, neurons, args.b, args.m, args.reps,
                                  dev)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
