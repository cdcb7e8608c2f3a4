"""Time builds of the normals kernel (``csrc/normals.cu``) in turns with
``torch.randn``.

    python -m deeppicarditeration_torch.utils.normals_bench [--source PATH ...]

Each ``--source`` (default: the package's ``csrc/normals.cu``; another
build, such as an earlier commit's file unpacked by ``git archive``, with
its headers beside it) is launched through ``ops/kernels.py:normals_cuda``
(its ``lib`` argument) at the chunk shapes of paths C (4096, 64, 100) and
L (2048, 32, 100), beside ``torch.randn`` on a CUDA generator at the same
shape. The builds must give the same values bit for bit (the value at a
flat index is a function of the seed and the index alone). Each round
times every build and ``torch.randn`` (REPS launches each) forward and
then backward, back to back (CUDA events: the host's launch overhead
included) and by device time (the kernels' time in a torch.profiler
trace); ROUNDS rounds give each one's median, least and greatest ms per
call. Prints one JSON line per shape and one, the card's
name and power limit, at the end. Needs a CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import (
    _ms,
    build_sources,
    device_ms,
)

SHAPES = ((4096, 64, 100), (2048, 32, 100))
REPS, ROUNDS, SEED = 100, 5, (7 << 32) | 5
BYTES_S = 3.35e12  # HBM3 of the H100 SXM (chip_smoke.py: PEAK_BYTES_S)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.NORMALS.source)])
    args = ap.parse_args(argv)
    libs = build_sources(args.source, kernels._declare_normals)
    dev = torch.device("cuda")
    rows = []
    for shape in SHAPES:
        ref = kernels.normals_cuda(SEED, shape, dev, lib=libs[0])
        for name, lib in zip(args.source, libs):
            if not torch.equal(kernels.normals_cuda(SEED, shape, dev,
                                                    lib=lib), ref):
                raise RuntimeError(f"{name} at {shape}: not the first "
                                   f"source's values")
        gen = torch.Generator(device=dev).manual_seed(5)
        calls = {name: (lambda lib=lib, shape=shape: kernels.normals_cuda(
            SEED, shape, dev, lib=lib)) for name, lib in zip(args.source,
                                                              libs)}
        calls["torch.randn"] = lambda shape=shape: torch.randn(
            shape, generator=gen, device=dev)
        turns = {k: [] for k in calls}
        order = list(calls)
        for _ in range(ROUNDS):
            for k in order + order[::-1]:
                turns[k].append(_ms(calls[k], dev, REPS))
        dev_turns = {k: [] for k in calls}
        for _ in range(ROUNDS):
            for k in order + order[::-1]:
                dev_turns[k].append(device_ms(calls[k], REPS))
        bound = 4 * math.prod(shape) / BYTES_S * 1e3
        row = {"shape": list(shape), "bound_ms": bound, "reps": REPS,
               "device": torch.cuda.get_device_name(dev), **{
                   key: {k: {"median": statistics.median(v), "min": min(v),
                             "max": max(v)} for k, v in t.items()}
                   for key, t in (("ms", turns), ("device_ms", dev_turns))}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rows


if __name__ == "__main__":
    main()
