"""Time builds of the rollout kernel in turns, by device time.

    python -m deeppicarditeration_torch.utils.rollout_bench \
        [--source PATH ...] [--reps 200]

Each ``--source`` (default: the package's ``csrc/rollout.cu``; another
build, such as an earlier commit's file unpacked by ``git archive`` or a
variant, with its own ``philox.cuh`` beside it) is launched through its C
entry point ``dpi_paths`` (either signature: with the seed table's
arguments or, as before it, without) at the D-DBSDE recipe's (K = 20,
B = 512, nx = 100) and the DBDP recipes' (K = 50) shapes. Its outputs must
equal the first source's (rtol = atol = 1e-5). Each build is timed in
turns (a, b, ..., b, a), ``--reps`` launches a turn into four rotating
output buffers (84-105 MB, more than the 50 MB L2, so that every launch
writes lines L2 does not hold, as after the rest of an epoch): device time
per launch from a torch.profiler trace, and host-bound back-to-back time
from CUDA events. Prints one JSON line per source and shape, each build's
ptxas lines, and the card's name and power limit. Needs a CUDA card: there
is no CPU mode.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math

import torch
from torch.profiler import ProfilerActivity, profile

from deeppicarditeration_torch.device import Timer
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import (
    build_sources,
    report_builds,
)

SHAPES = ((20, 512, 100), (50, 512, 100))
SEED, ROTATE, TOL = (7 << 32) | 5, 4, 1e-5


def launcher(lib: kernels.CudaLibrary, K: int, b: int, nx: int, dev):
    """A call that launches ``lib``'s dpi_paths into the next of ROTATE
    output pairs and returns that pair. The arguments are typed here: an
    earlier build need not have the package's other entry points."""
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((b, nx), generator=g, device=dev)
    sdt = torch.full((b, 1), math.sqrt(1.0 / K), device=dev)
    outs = [(torch.empty((K + 1, b, nx), device=dev),
             torch.empty((K, b, nx), device=dev)) for _ in range(ROTATE)]
    fn = lib.lib().dpi_paths
    table = hasattr(lib.lib(), "dpi_paths_smem_bytes")
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    turn = [0]

    def go():
        xs, xi = outs[turn[0] % ROTATE]
        turn[0] += 1
        args = [p(x0.data_ptr()), p(sdt.data_ptr()), p(xs.data_ptr()),
                p(xi.data_ptr()), i(b), i(nx), i(K), ctypes.c_uint64(SEED)]
        if table:
            args += [None, None, ctypes.c_longlong(0)]
        rc = fn(*args, ctypes.c_float(1.0), p(stream))
        if rc != 0:
            raise RuntimeError(f"dpi_paths launch failed: error {rc}")
        return xs, xi
    return go


def device_ms(fn, reps: int) -> float:
    """Device time per launch of the kernel named paths_kernel over
    ``reps`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "paths_kernel" in ev.key and ev.count:
            return ev.device_time_total / ev.count / 1e3
    raise RuntimeError("the trace shows no device time for paths_kernel")


def back_to_back_ms(fn, dev, reps: int) -> float:
    fn()
    with Timer(dev) as tm:
        for _ in range(reps):
            fn()
    return tm.ms / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.ROLLOUT.source)])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    libs = build_sources(args.source, lambda lib: None)
    dev = torch.device("cuda")
    rows = []
    for K, b, nx in SHAPES:
        calls = [launcher(lib, K, b, nx, dev) for lib in libs]
        ref = [v.clone() for v in calls[0]()]
        for name, call in zip(args.source, calls):
            for a, r in zip(call(), ref):
                if not bool(((a - r).abs() <= TOL + TOL * r.abs()).all()):
                    raise RuntimeError(f"{name} at K={K} differs from the "
                                       f"first source")
        order = list(range(len(calls)))
        dev_ms = {k: [] for k in order}
        b2b_ms = {k: [] for k in order}
        for k in order + order[::-1]:
            dev_ms[k].append(device_ms(calls[k], args.reps))
            b2b_ms[k].append(back_to_back_ms(calls[k], dev, args.reps))
        for k, name in enumerate(args.source):
            r = {"source": name, "K": K, "B": b, "nx": nx,
                 "device_ms": sum(dev_ms[k]) / 2, "device_turns": dev_ms[k],
                 "back_to_back_ms": sum(b2b_ms[k]) / 2,
                 "back_to_back_turns": b2b_ms[k], "reps": args.reps,
                 "device": torch.cuda.get_device_name(dev)}
            rows.append(r)
            print(json.dumps(r), flush=True)
    report_builds(args.source, libs, lambda lib: None)
    return rows


if __name__ == "__main__":
    main()
