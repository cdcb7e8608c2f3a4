"""Time builds of the HJB estimator kernel (``csrc/generate_pis.cu``) in
turns.

    python -m deeppicarditeration_torch.utils.pis_bench [--source PATH ...]
        [--nx NX] [--b B] [--m M] [--cases MODE ...] [--time-only]
        [--stamps] [--narrow-nx N ...]

Each ``--source`` (default: the package's ``csrc/generate_pis.cu``; another
build, such as an earlier commit's file unpacked by ``git archive``, with
its headers beside it) is launched through
``ops/kernels.py:generate_pis_cuda`` (its ``lib`` argument) with its own
Philox draws at path H's shapes (B = M = 4096, nx = 100, 5 mixture
components, a random 4x512 PISGradNet) under "default" and bf16x3, and
checked and timed by ``utils/bench_turns.py`` (3 launches a turn). The
builds must agree within chip_smoke.py's relative tolerance
(``PIS_REL_TOL``: max |diff| / max(|first|, 1) over the value and over the
gradient columns). Prints one JSON line per source and mode, each build's
ptxas lines and the counts of HGMMA (wgmma), STL and LDL (local-memory
stores and loads: spills) in its SASS, and the card's name and power
limit. Needs a CUDA card: there is no CPU mode.

``--nx``, ``--b``, ``--m``: another instance (path T's: ``--nx 512 --b
8192 --m 8192``; the PISGradNet stays 4x512, the only width the kernel is
built for). A build from before nx > 128 (its scratch query takes the
hidden layers alone) is reached through an adapter of its own symbol
under the new name (``_declare``).

``--cases``: the precision modes to run, of ``default`` and ``bf16x3``
(default: both).

``--narrow-nx``: each source's ``NARROW_NX`` (default: the package's,
128), the nx up to which it runs the narrow instance; the net is packed
for the instance that source runs. The wide instance at path H's nx
against the narrow one: a copy of the source with ``NARROW_NX = 64`` (and
``LANE_QUADS = 128 / 16``), ``--source <the package's> <copy>
--narrow-nx 128 64 --time-only``.

``--time-only``: time variants whose output is wrong by design (a part
of the kernel taken out, to see what it costs): each must still give the
same finite output twice, and its distance from the first source is
printed but not checked.

``--stamps``: for each build that exports ``dpi_generate_pis_stamps``
(a variant with ``clock64()`` stamps, kept out of the repository), one
launch per mode and the cycles of each stamped phase per 64-sample tile,
summed over the grid's blocks (``dpi_generate_pis_stamps_names`` names
them). The wide instance's phases, as its stamped copies name them:
consumer thread 0's ``draw`` (the integral chain's times, normals and
responsibilities, e(lambda)), ``gate`` (S and T), ``h0`` (X_s and w's
mixture term), ``fwd_mma`` / ``fwd_epi`` (the hidden layers' products,
their bias, ELU and saves), ``head_mma`` / ``head_epi`` (w0),
``cot`` (the cotangent), ``bwd_mma`` / ``bwd_epi``, ``w0`` (the
accumulators' start), ``n0x_mma``, ``wf`` (f's sums per row), ``sums``,
``point_start`` / ``point_end``; ``acq_wait`` (its waits for full ring
stages), ``prod_wait`` (the producer's for free ones), ``term_work`` /
``term_wait`` (terminal warp 0's draws and its wait for the consumers);
``tiles`` counts the tiles.

Path T's shape in turns with an earlier commit's build (``git archive
<commit> deeppicarditeration_torch/csrc | tar -x -C build/old``): ``--nx
512 --b 1056 --m 8192`` (8 points a block, ~0.3-0.9 s a launch) or ``--b
8192`` (T's own B, ~2.4-3.5 s).
"""

from __future__ import annotations

import argparse
import ctypes
import re

import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import PISGradNet
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels
from deeppicarditeration_torch.utils.bench_turns import (
    build_sources,
    in_turns,
    report_builds,
    stamps,
)
from deeppicarditeration_torch.utils.probe_roofline import library_sass

B, M, NX, REPS, SEED = 4096, 4096, 100, 3, (7 << 32) | 5
REL_TOL = {"default": 1e-3, "bf16x3": 1e-4}  # chip_smoke.py: PIS_REL_TOL


def _rel(a, b) -> float:
    """max |a - b| / max(|b|, 1) over the value and the gradient columns."""
    return max(float((a[:, s] - b[:, s]).abs().max())
               / max(float(b[:, s].abs().max()), 1.0)
               for s in (slice(0, 1), slice(1, None)))


def sass_counts(lib: kernels.CudaLibrary) -> dict:
    """HGMMA, WARPGROUP.DEPBAR, STL and LDL instructions in the SASS of
    ``lib``'s kernels."""
    sass = library_sass(lib)
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
            for op in ("HGMMA", "WARPGROUP.DEPBAR", "STL", "LDL")}


def function_counts(lib: kernels.CudaLibrary, name: str) -> dict:
    """HGMMA, WARPGROUP.DEPBAR, STL and LDL instructions and all
    instructions ("SASS": its size) in the SASS of each function of ``lib``
    whose mangled name holds ``name`` (each instantiation of a kernel
    template apart), by mangled name."""
    out = {}
    for body in library_sass(lib).split("Function : ")[1:]:
        fn = body.split("\n", 1)[0].strip()
        if name in fn:
            out[fn] = {op: len(re.findall(rf"\b{re.escape(op)}\b", body))
                       for op in ("HGMMA", "WARPGROUP.DEPBAR", "STL", "LDL")}
            out[fn]["SASS"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/", body))
    return out


def _declare(lib) -> None:
    """``kernels._declare_generate_pis``; an earlier build (nx <= 128 only:
    ``dpi_generate_pis_scratch_floats(L)``) first gets the wrapper's
    scratch query as an adapter of its own (the declaration's argtypes then
    land on the adapter, unused)."""
    if not hasattr(lib, "dpi_generate_pis_scratch_floats_nx"):
        old = lib.dpi_generate_pis_scratch_floats
        old.argtypes, old.restype = [ctypes.c_int], ctypes.c_longlong
        lib.dpi_generate_pis_scratch_floats_nx = (
            lambda n_hidden, nx, ncomp, mode: old(n_hidden))
    kernels._declare_generate_pis(lib)


def _launch(narrow_nx, eq, sol, tx, m, mode, lib):
    """``generate_pis_cuda`` with the net packed for a build whose
    ``NARROW_NX`` is ``narrow_nx``."""
    default = kernels.PIS_NARROW_NX
    kernels.PIS_NARROW_NX = narrow_nx
    try:
        return kernels.generate_pis_cuda(SEED, eq, sol, tx, m,
                                         precision=mode, lib=lib)
    finally:
        kernels.PIS_NARROW_NX = default


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.GENERATE_PIS.source)])
    ap.add_argument("--stamps", action="store_true",
                    help="print the stamped builds' phases per tile")
    ap.add_argument("--time-only", action="store_true",
                    help="do not hold the builds to the first's output")
    ap.add_argument("--cases", nargs="*", default=list(REL_TOL),
                    choices=tuple(REL_TOL))
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--b", type=int, default=B)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--narrow-nx", type=int, nargs="*")
    args = ap.parse_args(argv)
    narrow = args.narrow_nx or [kernels.PIS_NARROW_NX] * len(args.source)
    if len(narrow) != len(args.source):
        ap.error("--narrow-nx takes one value a source")
    nx, b, m = args.nx, args.b, args.m
    libs = build_sources(args.source, _declare)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    eq = make_equation("OUProcessEquation", nx=nx, num_components=5).to(dev)
    mod = PISGradNet(nx, (kernels.PIS_WIDTH,) * 4,
                     (eq.gmm_means, eq.gmm_vars, eq.gmm_log_weights),
                     generator=g)
    sol = Solution.from_net(mod.to(dev), "Value", nx)
    t = torch.rand((b, 1), generator=g) * 0.99
    x = torch.randn((b, nx), generator=g) * 2.0 * (1.0 + t).sqrt()
    tx = torch.cat([t, x], 1).to(dev)
    results = []
    for mode in args.cases:
        def agree(a, ref, mode=mode):
            err = _rel(a, ref)
            return err <= REL_TOL[mode] or args.time_only, err

        calls = [lambda lib=lib, mode=mode, n=n: _launch(n, eq, sol, tx, m,
                                                         mode, lib)
                 for lib, n in zip(libs, narrow)]
        if args.stamps:
            for name, lib, call in zip(args.source, libs, calls):
                stamps("dpi_generate_pis_stamps", name,
                       {"precision": mode}, lib, call)
        results += in_turns({"precision": mode, "B": b, "M": m, "nx": nx},
                            args.source, calls, agree, REPS)
    report_builds(args.source, libs, sass_counts)
    return results


if __name__ == "__main__":
    main()
