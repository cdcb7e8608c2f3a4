"""Time builds of the terminal estimator kernel in turns.

    python -m deeppicarditeration_torch.utils.terminal_bench \
        [--source PATH ...]

Each ``--source`` (default: the package's ``csrc/terminal.cu``; another
build, such as an earlier commit's file unpacked by ``git archive``, with
its own ``philox.cuh`` beside it) is built with nvcc as the package's
kernels are and launched through its C entry point ``dpi_terminal`` with
its own Philox draws at path B's shapes (B = M = 4096, nx = 100), with and
without antithetic pairing. Every build must give the same result twice
and agree with the first source within rtol = atol = 5e-5 (the same draws,
summed in another order): put a build that chip_smoke has checked first.
Times are CUDA events over 50 launches after a warm-up, the builds timed in
turns (a, b, ..., b, a) and each one's two turns averaged; the SM clock is
sampled (``nvidia-smi``, every 100 ms) while they run. Prints one JSON line
per source and mode, each build's ptxas lines and the SASS instruction mix
of its draw loop (``probe_roofline.sass_mix``), and the card's name and
power limit. Needs a CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from deeppicarditeration_torch.device import Timer
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.probe_roofline import (
    library_sass,
    sass_mix,
)

B, M, NX, REPS, TOL = 4096, 4096, 100, 50, 5e-5
SEED = (7 << 32) | 5


def launcher(lib: kernels.CudaLibrary, eq, t, x, anti):
    """A call that launches ``lib``'s dpi_terminal on (t, x) with its own
    draws and returns its (B, 1 + nx) output. The arguments are typed
    here: an earlier build need not have the package's other entry
    points."""
    g0 = eq.g(x).contiguous()
    out = torch.empty((B, 1 + NX), dtype=torch.float32, device=x.device)
    p, f = ctypes.c_void_p, ctypes.c_float
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def go():  # holds t, x, g0 and out while the call lives
        rc = lib.lib().dpi_terminal(
            p(t.data_ptr()), p(x.data_ptr()), p(g0.data_ptr()), None,
            p(out.data_ptr()), B, M, NX, int(anti), ctypes.c_uint64(SEED),
            f(eq.T), f(eq.alpha_sqrt), f(eq.k), p(stream))
        if rc != 0:
            raise RuntimeError(f"dpi_terminal launch failed: error {rc}")
        return out
    return go


def _ms(fn, dev) -> float:
    fn()  # warm-up
    with Timer(dev) as tm:
        for _ in range(REPS):
            fn()
    return tm.ms / REPS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.TERMINAL.source)])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the terminal bench needs a CUDA card")
    dev = torch.device("cuda")
    libs = [kernels.CudaLibrary(str(pathlib.Path(s).resolve()),
                                lambda lib: None) for s in args.source]
    kernels.build(*libs)
    g = torch.Generator().manual_seed(4)
    eq = make_equation("Cha", nx=NX, alpha=1.0, k=5.0, T=1.0)
    t = torch.rand((B, 1), generator=g) * 0.99 + 0.005
    x = (torch.randn((B, NX), generator=g) * t.sqrt()).to(dev)
    t = t.to(dev)
    results = []
    for anti in (False, True):
        calls = [launcher(lib, eq, t, x, anti) for lib in libs]
        ref = calls[0]().clone()
        for name, call in zip(args.source, calls):
            a, c = call().clone(), call().clone()
            if not torch.equal(a, c) or not torch.isfinite(a).all() or \
                    not bool(((a - ref).abs() <= TOL + TOL * ref.abs())
                             .all()):
                raise RuntimeError(
                    f"{name} (antithetic {anti}): not deterministic, not "
                    f"finite or off the first source by "
                    f"{float((a - ref).abs().max()):.3e}")
        order = list(range(len(calls)))
        turns = {k: [] for k in order}
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            for k in order + order[::-1]:
                turns[k].append(_ms(calls[k], dev))
        finally:
            sampler.terminate()
            clocks = sorted(float(ln) for ln in
                            sampler.communicate()[0].split() if ln)
        print(json.dumps({"antithetic": anti, "sm_clock_mhz_samples":
                          len(clocks), "sm_clock_mhz_median":
                          clocks[len(clocks) // 2] if clocks else None,
                          "sm_clock_mhz_min": clocks[0] if clocks else None}),
              flush=True)
        for k, name in enumerate(args.source):
            r = {"source": name, "antithetic": anti, "B": B, "M": M,
                 "nx": NX, "ms": sum(turns[k]) / 2, "turns_ms": turns[k],
                 "max_abs_err_vs_first": float((calls[k]() - ref).abs()
                                               .max()),
                 "device": torch.cuda.get_device_name(dev)}
            results.append(r)
            print(json.dumps(r), flush=True)
    for lib, name in zip(libs, args.source):
        info = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        try:
            mix = sass_mix(library_sass(lib))
        except RuntimeError as e:
            mix = f"not read: {e}"
        print(json.dumps({"source": name, "ptxas": info,
                          "sass_per_normal": mix}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return results


if __name__ == "__main__":
    main()
