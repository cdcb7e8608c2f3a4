"""Time builds of the merged estimator kernel (``csrc/generate.cu``) in
turns.

    python -m deeppicarditeration_torch.utils.generate_bench [--source PATH ...]

Each ``--source`` (default: the package's ``csrc/generate.cu``; another
build, such as an earlier commit's file unpacked by ``git archive``, with
its headers beside it) is launched through
``ops/kernels.py:generate_with_gradients_cuda`` (its ``lib`` argument)
with its own Philox draws at path A's shapes (B = M = 4096, nx = 100, a
random 4x128 ELU net) under bf16x3 and "default", and with antithetic
pairing at path D's M = 8192 under bf16x3, and checked and timed by
``utils/bench_turns.py`` (3 launches a turn). The builds must agree within
chip_smoke.py's tolerance (rtol = atol = 5e-5; 5e-4 under "default",
whose one bf16 pass can round an activation the other way when the sums
run in another order). Prints one JSON line per source and case, each
build's ptxas lines and the counts of HGMMA (wgmma), WARPGROUP.DEPBAR, STL
and LDL (local-memory stores and loads: spills) in its SASS, and the
card's name and power limit. Needs a CUDA card: there is no CPU mode.

``--time-only``: time variants whose output is wrong by design (a part
of the kernel taken out, to see what it costs): each must still give the
same output twice, and its distance from the first source is printed
but not checked.

``--stamps``: for each build that exports ``dpi_generate_tc_stamps`` (a
variant with ``clock64()`` stamps, kept out of the repository), one
launch per case and the cycles of each stamped phase per 64-sample tile,
summed over the grid's blocks (``dpi_generate_tc_stamps_names`` names
them).
"""

from __future__ import annotations

import argparse

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
from deeppicarditeration_torch.utils.pis_bench import sass_counts

B, M, NX, REPS, SEED = 4096, 4096, 100, 3, (7 << 32) | 5
TOL = {"bf16x3": 5e-5, "default": 5e-4}
# (precision, antithetic, M): paths A (both modes) and D
CASES = (("bf16x3", False, M), ("default", False, M), ("bf16x3", True, 2 * M))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.GENERATE.source)])
    ap.add_argument("--stamps", action="store_true",
                    help="print the stamped builds' phases per tile")
    ap.add_argument("--time-only", action="store_true",
                    help="do not hold the builds to the first's output")
    args = ap.parse_args(argv)
    libs = build_sources(args.source, kernels._declare_generate)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    eq = make_equation("Cha", nx=NX, alpha=1.0, k=5.0, T=1.0)
    mod = MLP(1 + NX, (128,) * 4, ("ELU",) * 4, 1, generator=g)
    sol = Solution.from_net(mod.to(dev), "Value", NX)
    t = torch.rand((B, 1), generator=g) * 0.99 + 0.005
    x = torch.randn((B, NX), generator=g) * t.sqrt()
    tx = torch.cat([t, x], 1).to(dev)
    results = []
    for mode, anti, m in CASES:
        def agree(a, ref, mode=mode):
            d = (a - ref).abs()
            ok = bool((d <= TOL[mode] + TOL[mode] * ref.abs()).all())
            return ok or args.time_only, float(d.max())

        calls = [lambda lib=lib, mode=mode, anti=anti, m=m:
                 kernels.generate_with_gradients_cuda(
                     SEED, eq, sol, tx, m, antithetic=anti, precision=mode,
                     lib=lib) for lib in libs]
        case = {"precision": mode, "antithetic": anti, "B": B, "M": m,
                "nx": NX}
        if args.stamps:
            for name, lib, call in zip(args.source, libs, calls):
                stamps("dpi_generate_tc_stamps", name, case, lib, call)
        results += in_turns(case, args.source, calls, agree, REPS)
    report_builds(args.source, libs, sass_counts)
    return results


if __name__ == "__main__":
    main()
