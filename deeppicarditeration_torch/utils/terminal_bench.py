"""Time builds of the terminal estimator kernel in turns.

    python -m deeppicarditeration_torch.utils.terminal_bench \
        [--source PATH ...]

Each ``--source`` (default: the package's ``csrc/terminal.cu``; another
build, such as an earlier commit's file unpacked by ``git archive``, with
its own ``philox.cuh`` beside it) is launched through its C entry point
``dpi_terminal`` with its own Philox draws at path B's shapes (B = M =
4096, nx = 100), with and without antithetic pairing, and checked and
timed by ``utils/bench_turns.py`` (50 launches a turn). The builds must
agree within rtol = atol = 5e-5 (the same draws, summed in another
order). Prints one JSON line per source and mode, each build's ptxas lines
and the SASS instruction mix of its draw loop
(``probe_roofline.sass_mix``), and the card's name and power limit. Needs
a CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import (
    build_sources,
    in_turns,
    report_builds,
)
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


def _agree(a, ref):
    """Within rtol = atol = TOL of the first source; the max |diff|."""
    d = (a - ref).abs()
    return bool((d <= TOL + TOL * ref.abs()).all()), float(d.max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.TERMINAL.source)])
    args = ap.parse_args(argv)
    libs = build_sources(args.source, lambda lib: None)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    eq = make_equation("Cha", nx=NX, alpha=1.0, k=5.0, T=1.0)
    t = torch.rand((B, 1), generator=g) * 0.99 + 0.005
    x = (torch.randn((B, NX), generator=g) * t.sqrt()).to(dev)
    t = t.to(dev)
    results = []
    for anti in (False, True):
        results += in_turns(
            {"antithetic": anti, "B": B, "M": M, "nx": NX}, args.source,
            [launcher(lib, eq, t, x, anti) for lib in libs], _agree, REPS)
    report_builds(args.source, libs,
                  lambda lib: sass_mix(library_sass(lib)))
    return results


if __name__ == "__main__":
    main()
