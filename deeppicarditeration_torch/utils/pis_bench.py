"""Time builds of the HJB estimator kernel (``csrc/generate_pis.cu``) in
turns.

    python -m deeppicarditeration_torch.utils.pis_bench [--source PATH ...]

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

``--stamps``: for each build that exports ``dpi_generate_pis_stamps``
(a variant with ``clock64()`` stamps, kept out of the repository), one
launch per mode and the cycles of each stamped phase per 64-sample tile,
summed over the grid's blocks (``dpi_generate_pis_stamp_names`` names
them).
"""

from __future__ import annotations

import argparse
import ctypes
import json
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


def stamps(name: str, mode: str, lib: kernels.CudaLibrary, call) -> None:
    """One launch of ``call`` and the cycles per tile of each stamped
    phase of ``lib``'s build, printed as one JSON line (nothing for a build
    without stamps)."""
    dll = lib.lib()
    if not hasattr(dll, "dpi_generate_pis_stamps"):
        return
    dll.dpi_generate_pis_stamps.argtypes = [ctypes.c_void_p]
    dll.dpi_generate_pis_stamp_names.restype = ctypes.c_char_p
    names = dll.dpi_generate_pis_stamp_names().decode().split(",")
    buf = (ctypes.c_ulonglong * len(names))()
    for _ in range(2):  # the first clears what earlier launches left
        if dll.dpi_generate_pis_stamps(buf):
            raise RuntimeError("dpi_generate_pis_stamps failed")
        call()
    if dll.dpi_generate_pis_stamps(buf):
        raise RuntimeError("dpi_generate_pis_stamps failed")
    sums = dict(zip(names, buf))
    tiles = max(sums.get("tiles", 0), 1)
    print(json.dumps({"source": name, "precision": mode,
                      "stamps_cycles_per_tile": {
        k: round(v / tiles, 1) for k, v in sums.items() if k != "tiles"},
        "tiles": tiles}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", nargs="*",
                    default=[str(kernels.GENERATE_PIS.source)])
    ap.add_argument("--stamps", action="store_true",
                    help="print the stamped builds' phases per tile")
    args = ap.parse_args(argv)
    libs = build_sources(args.source, kernels._declare_generate_pis)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    eq = make_equation("OUProcessEquation", nx=NX, num_components=5).to(dev)
    mod = PISGradNet(NX, (512,) * 4, (eq.gmm_means, eq.gmm_vars,
                                      eq.gmm_log_weights), generator=g)
    sol = Solution.from_net(mod.to(dev), "Value", NX)
    t = torch.rand((B, 1), generator=g) * 0.99
    x = torch.randn((B, NX), generator=g) * 2.0 * (1.0 + t).sqrt()
    tx = torch.cat([t, x], 1).to(dev)
    results = []
    for mode in ("default", "bf16x3"):
        def agree(a, ref, mode=mode):
            err = _rel(a, ref)
            return err <= REL_TOL[mode], err

        calls = [lambda lib=lib, mode=mode: kernels.generate_pis_cuda(
            SEED, eq, sol, tx, M, precision=mode, lib=lib) for lib in libs]
        if args.stamps:
            for name, lib, call in zip(args.source, libs, calls):
                stamps(name, mode, lib, call)
        results += in_turns({"precision": mode, "B": B, "M": M, "nx": NX},
                            args.source, calls, agree, REPS)
    report_builds(args.source, libs, sass_counts)
    return results


if __name__ == "__main__":
    main()
