"""Rate microprobes of the card's PRNG and ELU work.

    python -m deeppicarditeration_torch.utils.probe_roofline \
        [--which bits normals elu] [--iters 1024] [--repeats 8]

Counterpart of ``scripts/probe_vpu_roofline.py``. The probe kernel
(``csrc/probe.cu``) makes units in registers and stores only their partial
sums, so its rate is the card's rate for that work alone:

  bits     Philox4x32-10 words and the mantissa-trick uniform;
  normals  Box-Muller normals (1 log, 1 sqrt, 1 sin/cos pair per 2 normals);
  elu      the ELU forward pass and its derivative (1 exp per unit),
           chained through the accumulator so it cannot be hoisted.

Prints one JSON line per mode with units per second (timed with CUDA events
over ``--repeats`` calls after a warm-up) and the instructions of the
kernel's iteration loop per unit (``cuobjdump -sass`` of the built
library), then what the rates imply for the merged estimator kernel at the
Burgers recipe's shapes. Needs a CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import subprocess
from typing import Callable, NamedTuple, Optional

import torch

from deeppicarditeration_torch.ops import kernels, philox

# the merged kernel's shapes in the Burgers 100-d recipes
MERGED_B, MERGED_M, MERGED_NX, MERGED_NEURONS = 4096, 4096, 100, (128,) * 4
# units one thread makes per iteration (probe.cu: 8 Philox calls of 4)
UNITS_PER_THREAD = philox.PROBE_BLK // philox.PROBE_ROWS
# SASS opcodes by the pipe that runs them
SASS_PIPES = {
    "int": {"IMAD", "IADD3", "LOP3", "SHF", "LEA", "ISETP", "VIADD", "IABS",
            "IMNMX", "SEL", "PRMT", "FLO", "POPC"},
    "fp32": {"FFMA", "FADD", "FMUL", "FSEL", "FSETP", "FMNMX", "FCHK"},
    "sfu": {"MUFU"},
}
# SASS opcodes counted in the terminal kernel's mix besides SASS_PIPES'
SASS_GROUPS = {**SASS_PIPES, "shfl": {"SHFL"}, "lds": {"LDS"},
               "sts": {"STS"}}
# the least a quad of normals issues in the terminal kernel's draw loop:
# Philox rounds 3-10 (two 32-bit products each) and two Box-Mullers (one
# MUFU.RSQ each)
DRAW_IMAD_PER_QUAD, DRAW_MUFU_PER_QUAD = 14, 2
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)([^;]*);")


class Ins(NamedTuple):
    """One SASS instruction: its address, opcode (without modifiers), the
    branch target of a BRA (else None), and whether a predicate guards
    it."""
    addr: int
    op: str
    target: Optional[int]
    predicated: bool


def units_per_call(grid: int, iters: int) -> int:
    return grid * philox.PROBE_BLK * philox.LANES * iters


def function_sass(sass: str, match: Callable[[str], bool]) -> list:
    """The instructions (``Ins``) of the first function in ``cuobjdump
    -sass`` output whose mangled name satisfies ``match``."""
    body = next((s for s in sass.split("Function : ")
                 if s.startswith("_Z") and match(s.split("\n", 1)[0])),
                None)
    if body is None:
        raise RuntimeError("no such function in the SASS")
    ins = []
    for a, pred, op, rest in _SASS_LINE.findall(body):
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        ins.append(Ins(int(a, 16), op, int(target.group(1), 16)
                       if target else None, bool(pred)))
    return ins


def sass_loops(ins: list) -> list:
    """(first, last) instruction indices of each loop of ``ins``
    (``function_sass``): the span of each backward branch."""
    index = {i.addr: k for k, i in enumerate(ins)}
    return [(index[i.target], k) for k, i in enumerate(ins)
            if i.target is not None and i.target < i.addr
            and i.target in index]


def fast_path(ins: list, first: int, last: int) -> list:
    """Indices of the instructions one pass through ``ins[first:last + 1]``
    issues on its fast path: a forward branch is taken where it is not
    predicated, or where the code it skips holds a loop or a CALL (the
    slow paths of sincosf's range reduction, sqrtf and the division,
    which the estimator's arguments never take); other predicated branches
    fall through (both sides count). Loops inside are left out."""
    index = {i.addr: k for k, i in enumerate(ins)}
    loops = [(s, e) for s, e in sass_loops(ins)
             if first <= s and e <= last and (s, e) != (first, last)]
    starts = {s: e for s, e in loops}
    out, k = [], first
    while k <= last:
        if k in starts:
            k = starts[k] + 1
            continue
        i = ins[k]
        out.append(k)
        if i.target is not None and i.target > i.addr:
            j = index.get(i.target, last + 1)
            slow = any(k < s and e < j for s, e in loops) or any(
                ins[n].op == "CALL" for n in range(k + 1, min(j, last + 1)))
            if not i.predicated or slow:
                k = j
                continue
        k += 1
    return out


def sass_mix(sass: str) -> dict:
    """Instructions per normal that the terminal kernel's draw loop issues,
    from ``cuobjdump -sass`` output, in all and by group (``SASS_GROUPS``,
    and "uniform": the uniform datapath's U* opcodes). The instantiation
    read is nx <= 128's (one quad per lane, the main path's); its draw loop
    is the ``fast_path`` of the loop that stores normals (STS) and holds
    the Box-Muller (MUFU), with the most IMAD (Philox's products), over 4
    normals per STS (one 128-bit store per quad). Raises unless that loop
    holds a Philox and a Box-Muller per quad
    (``DRAW_IMAD_PER_QUAD``, ``DRAW_MUFU_PER_QUAD``)."""
    ins = function_sass(sass, lambda name: "terminal_kernelILi1E" in name)
    loops = [collections.Counter(ins[k].op for k in fast_path(ins, *se))
             for se in sass_loops(ins)]
    draws = [ops for ops in loops if ops["STS"] and ops["MUFU"]]
    if not draws:
        raise RuntimeError("no loop of the terminal kernel's SASS stores "
                           "normals and holds a Box-Muller")
    ops = max(draws, key=lambda ops: ops["IMAD"])
    quads = ops["STS"]
    if (ops["IMAD"] < DRAW_IMAD_PER_QUAD * quads
            or ops["MUFU"] < DRAW_MUFU_PER_QUAD * quads):
        raise RuntimeError(
            f"the terminal kernel's draw loop holds {ops['IMAD']} IMAD and "
            f"{ops['MUFU']} MUFU for {quads} quads: not a Philox and a "
            f"Box-Muller per quad")
    mix = {"all": sum(ops.values()) / (4 * quads)}
    for group, names in SASS_GROUPS.items():
        mix[group] = sum(n for op, n in ops.items() if op in names) \
            / (4 * quads)
    mix["uniform"] = sum(n for op, n in ops.items()
                         if op.startswith("U")) / (4 * quads)
    return {"quads_per_iteration": quads, "draw_loop": mix}


def library_sass(lib: kernels.CudaLibrary) -> str:
    """``cuobjdump -sass`` of ``lib``'s built library."""
    tool = (shutil.which("cuobjdump")
            or str(pathlib.Path(kernels._nvcc()).parent / "cuobjdump"))
    lib.lib()
    return subprocess.run([tool, "-sass", str(lib.so_path)],
                          capture_output=True, text=True, check=True).stdout


def loop_opcodes(sass: str, which: str) -> collections.Counter:
    """Opcode counts of the probe kernel's iteration loop in mode ``which``
    (the body of its longest backward branch) in ``cuobjdump -sass``
    output. Static counts: both sides of a branch inside the loop count."""
    mode = kernels.PROBE_MODES.index(which)
    try:
        ins = function_sass(
            sass, lambda name: f"probe_kernelILi{mode}E" in name)
    except RuntimeError:
        raise RuntimeError(f"no probe kernel for mode {which!r} in the SASS")
    loops = sass_loops(ins)
    if not loops:
        raise RuntimeError(f"no loop in the {which} probe kernel's SASS")
    s, e = max(loops, key=lambda se: se[1] - se[0])
    return collections.Counter(i.op for i in ins[s:e + 1])


def sass_per_unit(which: str) -> dict:
    """Instructions per unit in the probe kernel's loop, in all and by
    pipe (``SASS_PIPES``), from ``cuobjdump -sass`` of the built
    library."""
    ops = loop_opcodes(library_sass(kernels.PROBE), which)
    out = {"all": sum(ops.values()) / UNITS_PER_THREAD}
    for pipe, names in SASS_PIPES.items():
        out[pipe] = sum(n for op, n in ops.items() if op in names) \
            / UNITS_PER_THREAD
    return out


def probe(which: str, iters: int = 1024, repeats: int = 8, seed: int = 3,
          device="cuda") -> dict:
    """Time ``repeats`` calls of the probe kernel in mode ``which``;
    returns units/s, seconds per call, units per call and the grid."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the rate probe needs a CUDA card")
    grid = kernels.probe_grid(which)
    out = kernels.probe_cuda(which, seed, iters, device, grid)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = kernels.probe_cuda(which, seed, iters, device, grid)
    end.record()
    end.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"the {which} probe wrote a non-finite sum")
    s = start.elapsed_time(end) / 1e3 / repeats
    units = units_per_call(grid, iters)
    return {"probe": which, "units_per_s": units / s, "s_per_call": s,
            "units": units, "grid": grid, "iters": iters,
            "sass_per_unit": sass_per_unit(which),
            "device": torch.cuda.get_device_name(device)}


def merged_decomposition(rates: dict) -> dict:
    """Least time the merged kernel's normals and ELU work would take at
    the probed rates: 2 M nx normals and 2 passes over 4 x 128 ELU units
    per point."""
    normals = MERGED_B * MERGED_M * MERGED_NX * 2
    elu = MERGED_B * MERGED_M * sum(MERGED_NEURONS) * 2
    t_rng, t_elu = normals / rates["normals"], elu / rates["elu"]
    return {"decomposition": f"merged kernel (B={MERGED_B}, M={MERGED_M}, "
            f"nx={MERGED_NX}, {len(MERGED_NEURONS)}x128 ELU)",
            "rng_ms": t_rng * 1e3, "elu_ms": t_elu * 1e3,
            "sum_ms": (t_rng + t_elu) * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--which", nargs="*", default=list(kernels.PROBE_MODES))
    ap.add_argument("--iters", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args(argv)
    results = []
    for which in args.which:
        r = probe(which, args.iters, args.repeats)
        results.append(r)
        print(json.dumps(r), flush=True)
    rates = {r["probe"]: r["units_per_s"] for r in results}
    if {"normals", "elu"} <= rates.keys():
        print(json.dumps(merged_decomposition(rates)), flush=True)
    return results


if __name__ == "__main__":
    main()
