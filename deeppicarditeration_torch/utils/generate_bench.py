"""Time builds of the merged estimator kernel (``csrc/generate.cu``) or of
the integral kernel (``csrc/integral.cu``) in turns.

    python -m deeppicarditeration_torch.utils.generate_bench [--kernel integral] [--source PATH ...]
        [--nx NX] [--width W] [--depth L] [--b B] [--m M]

Each ``--source`` (default: the package's ``csrc/generate.cu``, or
``csrc/integral.cu`` under ``--kernel integral``; another build, such as
an earlier commit's file unpacked by ``git archive``, with its headers
beside it) is launched through ``ops/kernels.py``'s
``generate_with_gradients_cuda`` or ``integral_with_gradients_cuda`` (their
``lib`` argument) with its own Philox draws at path A's shapes (B = M =
4096, nx = 100, a random 4x128 ELU net: path B's for the integral kernel)
under bf16x3 and "default" (the integral kernel also "highest"), and with
antithetic pairing at path D's M = 8192 under bf16x3, and checked and
timed by ``utils/bench_turns.py`` (3 launches a turn). The builds must
agree within chip_smoke.py's tolerance (rtol = atol = 5e-5; 5e-4 under
"default" for the merged kernel, whose one bf16 pass can round an
activation the other way when the sums run in another order, and 1.5e-3,
chip_smoke's ONE_PASS_WIDE_TOL, for the integral kernel, whose builds take
their products in another shape). Prints one JSON line per source and
case, each build's ptxas lines and the counts of HGMMA (wgmma),
WARPGROUP.DEPBAR, STL and LDL (local-memory stores and loads: spills) in
the SASS of each instantiation of its tensor-core kernel, and the card's
name and power limit. Needs a CUDA card: there is no CPU mode.

``--nx``, ``--width``, ``--depth``, ``--b``, ``--m``: another instance of
the merged kernel (path R's: ``--nx 512 --m 16384``; path S's: ``--nx 1024
--width 256 --b 8192 --m 32768``; the dispatcher matrix's nets of paths U,
V and W: ``--nx 100 --width 512``, ``--nx 256 --width 512 --depth 6``,
``--nx 512 --width 1024 --depth 2``); ``--depth``: the net's hidden ELU
layers (default 4); D's pairing at 2 M. A build from before a width or an
nx took the kernel raises there.

``--cases``: the precision cases to run, of ``bf16x3``, ``default`` and
``antithetic`` (bf16x3 at 2 M; default: all three).

``--time-only``: time variants whose output is wrong by design (a part
of the kernel taken out, to see what it costs): each must still give the
same output twice, and its distance from the first source is printed
but not checked.

A build of ``integral.cu`` from before its six-pass instance runs its
"highest" on its FP32-FMA kernel (``dpi_integral``), launched here as its
wrapper did (``_integral``); a build of ``generate.cu`` from before its
width-256 and nx > 511 instances (no ``dpi_generate_tc_w``) is reached
through adapters of its own symbols under the new names
(``_declare_generate``). The package's wrappers have one launch path.

``--stamps``: for each build that exports ``dpi_generate_tc_stamps`` (or
``dpi_integral_tc_stamps``; a variant with ``clock64()`` stamps, kept out
of the repository), one launch per case and the cycles of each stamped
phase per 64-sample tile, summed over the grid's blocks (the symbol's
``_names`` names them). The two consumer warpgroups run their tiles side
by side, so a phase's cycles a tile are its cycles a tile pair of the
block. The wide pass's stamps (PERF.md §6 PR 18), by the consumers' first
thread: ``draw_times``, ``draws`` (the normals and layer 1's input image,
published), ``ring_wait`` (waiting for a staged chunk), ``mma`` (issuing
a stage's products and waiting for the one before), ``epi_fwd``,
``epi_bwd`` (the column blocks' epilogues), ``publish``, ``net_end``
(the whole pass), ``sample_weights``, ``accumulate``; by the producer's
lane 0: ``p_ready`` (waiting for a layer's input), ``p_empty`` (waiting
for a free stage), ``p_issue`` (issuing copies), ``p_stages``; by the
terminal warps' lane 0 (summed over the three, a point at a time):
``term_work``, ``term_wait``, ``term_points``. The stamps of the design
before it (the A fragments loaded from f32 scratch by the consumers):
``l1_build``, ``h_load``, ``b_load`` (layer 1's A from the normals, the
forward and backward layers' A), ``*_turn``, ``*_ring``, ``*_mma`` (the
products' turn, ring and wgmma waits), ``*_epi`` beside those names.
The width-128 instance's (PERF.md §6), by each consumer
warpgroup's first thread: ``draw_times``, ``l1_draws`` (layer 1's draws
into its A fragments), ``turn``, ``ring``, ``mma``, ``epi_fwd``,
``split`` (a hidden layer's A fragments), ``epi_bwd``, ``net_sync``,
``sample_weights``, ``accumulate``, ``term_sync`` (a point's end, waiting
for the terminal warps), ``point_end``; by the terminal warps' lane 0:
``term_work``, ``term_wait``. Its design before (the normals drawn to
scratch, layer 1's A read back from them, the terminal chain in two
passes): ``draws``, ``draw_sync``, ``l1_build``, ``term_p1``,
``term_p2`` beside the same names. Phases sum over both warpgroups (and
the three terminal warps) and are divided by the tiles.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import (
    build_sources,
    in_turns,
    report_builds,
    stamps,
)
from deeppicarditeration_torch.utils.pis_bench import function_counts

B, M, NX, DEPTH, REPS, SEED = 4096, 4096, 100, 4, 3, (7 << 32) | 5


def _declare_generate(lib: ctypes.CDLL) -> None:
    """``kernels._declare_generate``; an earlier build (width 128 and nx <=
    511 only: ``dpi_generate_tc``, ``dpi_generate_tc_scratch_bytes``,
    ``dpi_generate_tc_plan``, the FP32-FMA kernel's ``dpi_generate_max_nx``)
    first gets the wrapper's names as adapters of its own symbols (the
    declaration's argtypes then land on the adapters, unused)."""
    if not hasattr(lib, "dpi_generate_tc_w"):
        kernels._declare_tc(lib, "generate", 11)
        lib.dpi_generate_tc_plan.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.dpi_generate_tc_plan.restype = None
        h = kernels.KERNEL_WIDTH

        def width_128(width):
            if width != h:
                raise NotImplementedError(
                    f"this build of generate.cu has width {h} only")

        def launch(*a):  # a[18]: the width, after 11 pointers, 7 ints
            width_128(a[18])
            return lib.dpi_generate_tc(*a[:18], *a[19:])

        def scratch(nx, n_hidden, width):
            return (lib.dpi_generate_tc_scratch_bytes(nx, n_hidden)
                    if width == h else -1)

        def plan(nx, n_hidden, width, out):
            width_128(width)
            lib.dpi_generate_tc_plan(nx, n_hidden, out)

        def widths(out):
            out[0] = h
            return 1

        for name, fn in (("w", launch), ("scratch_bytes_w", scratch),
                         ("plan_w", plan), ("widths", widths),
                         ("max_nx", lambda: lib.dpi_generate_max_nx())):
            setattr(lib, f"dpi_generate_tc_{name}", fn)
    kernels._declare_generate(lib)


def _declare_integral(lib: ctypes.CDLL) -> None:
    """``kernels._declare_integral``, and an earlier build's FP32-FMA
    kernel (``dpi_integral``) where the build has one."""
    kernels._declare_integral(lib)
    if hasattr(lib, "dpi_integral"):
        lib.dpi_integral.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 6 + [ctypes.c_ulonglong] + [ctypes.c_float] * 4 \
            + [ctypes.c_void_p]
        lib.dpi_integral.restype = ctypes.c_int


def _integral(seed, eq, sol, tx, m, *, antithetic, precision, lib):
    """``integral_with_gradients_cuda`` with its own draws; an earlier
    build's "highest" on its FP32-FMA kernel (a net of at least one hidden
    layer)."""
    dll = lib.lib()
    if precision != "highest" or not hasattr(dll, "dpi_integral"):
        return kernels.integral_with_gradients_cuda(
            seed, eq, sol, tx, m, antithetic=antithetic,
            precision=precision, lib=lib)
    nx = tx.shape[1] - 1
    mod = kernels.kernel_net(sol, nx, dll.dpi_integral_hidden_width())
    t, x = tx[:, :1].contiguous(), tx[:, 1:].contiguous()
    f0 = kernels.get_f(eq, sol, t, x).contiguous()
    w = kernels.pack_mlp(mod)
    out = torch.empty((tx.shape[0], 1 + nx), dtype=torch.float32,
                      device=tx.device)
    rc = dll.dpi_integral(
        t.data_ptr(), x.data_ptr(), f0.data_ptr(), w.data_ptr(), None, None,
        out.data_ptr(), tx.shape[0], int(m), nx, len(mod.neurons), 1,
        int(antithetic), kernels._seed(seed), float(eq.T),
        float(eq.alpha_sqrt), float(eq.k), float(eq.ff_offset),
        kernels._stream(tx.device))
    if rc != 0:
        raise RuntimeError(f"dpi_integral launch failed: error {rc}")
    return out

# kernel -> (its wrapper, its declaration, the tensor-core kernel's name,
# the stamps' symbol, tolerance by mode, cases (precision, antithetic, M):
# paths A or B in each mode, and D's pairing)
KERNELS = {
    "generate": (kernels.generate_with_gradients_cuda,
                 _declare_generate, "generate_tc_kernel",
                 "dpi_generate_tc_stamps",
                 {"bf16x3": 5e-5, "default": 5e-4},
                 (("bf16x3", False, M), ("default", False, M),
                  ("bf16x3", True, 2 * M))),
    "integral": (_integral, _declare_integral, "integral",
                 "dpi_integral_tc_stamps",
                 {"bf16x3": 5e-5, "default": 1.5e-3, "highest": 5e-5},
                 (("bf16x3", False, M), ("default", False, M),
                  ("highest", False, M), ("bf16x3", True, 2 * M))),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="generate")
    ap.add_argument("--source", nargs="*", default=None)
    ap.add_argument("--stamps", action="store_true",
                    help="print the stamped builds' phases per tile")
    ap.add_argument("--time-only", action="store_true",
                    help="do not hold the builds to the first's output")
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--width", type=int, default=kernels.KERNEL_WIDTH)
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--b", type=int, default=B)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--cases", nargs="*", default=None,
                    choices=("bf16x3", "default", "highest", "antithetic"))
    args = ap.parse_args(argv)
    nx, b = args.nx, args.b
    run, declare, fn, symbol, tol, cases = KERNELS[args.kernel]
    cases = [(mode, anti, m * args.m // M) for mode, anti, m in cases
             if args.cases is None
             or ("antithetic" if anti else mode) in args.cases]
    sources = args.source or [str(
        (kernels.GENERATE if args.kernel == "generate"
         else kernels.INTEGRAL).source)]
    libs = build_sources(sources, declare)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    mod = MLP(1 + nx, (args.width,) * args.depth, ("ELU",) * args.depth, 1,
              generator=g)
    sol = Solution.from_net(mod.to(dev), "Value", nx)
    t = torch.rand((b, 1), generator=g) * 0.99 + 0.005
    x = torch.randn((b, nx), generator=g) * t.sqrt()
    tx = torch.cat([t, x], 1).to(dev)
    results = []
    for mode, anti, m in cases:
        def agree(a, ref, mode=mode):
            d = (a - ref).abs()
            ok = bool((d <= tol[mode] + tol[mode] * ref.abs()).all())
            return ok or args.time_only, float(d.max())

        calls = [lambda lib=lib, mode=mode, anti=anti, m=m:
                 run(SEED, eq, sol, tx, m, antithetic=anti, precision=mode,
                     lib=lib) for lib in libs]
        case = {"kernel": args.kernel, "precision": mode,
                "antithetic": anti, "B": b, "M": m, "nx": nx,
                "width": args.width, "depth": args.depth}
        if args.stamps:
            for name, lib, call in zip(sources, libs, calls):
                stamps(symbol, name, case, lib, call)
        results += in_turns(case, sources, calls, agree, REPS)
    report_builds(sources, libs, lambda lib: function_counts(lib, fn))
    return results


if __name__ == "__main__":
    main()
