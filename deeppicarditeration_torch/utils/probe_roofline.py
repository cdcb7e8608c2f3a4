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


def branch_paths(ins: list, first: int, last: int, fork_min: int = 64,
                 most: int = 256) -> list:
    """Like ``fast_path``, the instructions of one pass through
    ``ins[first:last + 1]``, but forking at each predicated forward branch
    that skips at least ``fork_min`` instructions and no loop or CALL (the
    runtime choice between whole variants of a loop's body): one path
    falls through, the other takes it. At most ``most`` paths, the
    fall-through first."""
    index = {i.addr: k for k, i in enumerate(ins)}
    loops = [(s, e) for s, e in sass_loops(ins)
             if first <= s and e <= last and (s, e) != (first, last)]
    starts = {s: e for s, e in loops}
    done, todo = [], [(first, [])]
    while todo and len(done) < most:
        k, out = todo.pop()
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
                if j - k >= fork_min:
                    todo.append((j, list(out)))
            k += 1
        done.append(out)
    return done


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


def _mix(ops: collections.Counter, normals: int) -> dict:
    mix = {"all": sum(ops.values()) / normals}
    for group, names in SASS_GROUPS.items():
        mix[group] = sum(n for op, n in ops.items() if op in names) / normals
    return mix


# generate.cu's width-256 instance (S's), bf16x3
GENERATE_256 = "generate_tc_kernelILi3ELi256EE"


def generate_draw_mix(sass: str, instance: str = GENERATE_256) -> dict:
    """Instructions per normal of the merged kernel's own draw loop at
    ``instance`` (mangled-name part; S's by default), from ``cuobjdump
    -sass`` output of ``csrc/generate.cu``, in all and by group: the loop
    of the width-256 instance's own draws (draw_tile256: both chains'
    normals stored to scratch, the terminal chain's summed; the most MUFU
    of the loops that hold no wgmma, shuffle or shared store), the
    ``fast_path`` of one pass over 4 normals per DRAW_MUFU_PER_QUAD MUFU
    (one MUFU.RSQ a Box-Muller pair). Raises unless it holds a Philox and
    a Box-Muller per quad."""
    ins = function_sass(sass, lambda name: instance in name)
    loops = [collections.Counter(ins[k].op for k in fast_path(ins, *se))
             for se in sass_loops(ins)]
    draws = [ops for ops in loops
             if ops["MUFU"] >= DRAW_MUFU_PER_QUAD and not ops["HGMMA"]
             and not ops["SHFL"] and not ops["STS"]]
    if not draws:
        raise RuntimeError(f"no draw loop in {instance}'s SASS")
    ops = max(draws, key=lambda ops: ops["MUFU"])
    quads = ops["MUFU"] // DRAW_MUFU_PER_QUAD
    if ops["IMAD"] < DRAW_IMAD_PER_QUAD * quads:
        raise RuntimeError(f"{instance}'s draw loop holds {ops['IMAD']} IMAD "
                           f"for {quads} quads: not a Philox per quad")
    return {"quads_per_iteration": quads, "draw_loop": _mix(ops, 4 * quads)}


# generate.cu's narrow instances, bf16x3: width 128 (paths A, D, R) and
# width 64 (path X)
GENERATE_128 = "generate_tc_kernelILi3ELi128EE"
GENERATE_64 = "generate_tc_kernelILi3ELi64EE"
# SHFL of one warp sum (five butterfly steps)
WARP_SUM_SHFL = 5


def terminal_turn(nx: int) -> tuple:
    """(QPL, D) of generate.cu's terminal warps at nx (term_point_at): QPL
    = ceil(ceil(nx / 4) / 32), rounded up to 1, 2, 4 or 8, quads a lane of
    each of D = 4, 2, 2, 1 draws a turn."""
    qpl = -(-(-(-nx // 4)) // 32)
    qpl = 1 << (qpl - 1).bit_length()
    return qpl, {1: 4, 2: 2, 4: 2, 8: 1}[qpl]


def generate_narrow_draw_mix(sass: str, nx: int,
                             instance: str = GENERATE_128) -> dict:
    """Instructions per normal of a narrow instance's own draws (width 128
    by default; ``GENERATE_64``) at nx, from ``cuobjdump -sass`` output of
    ``csrc/generate.cu``, in all and by group: static counts of each loop's
    span (both sides of its branches). "terminal": the terminal warps' loop
    over a point's draws at nx (term_point<QPL, D>, ``terminal_turn``), a
    loop without products holding D warp sums (5 D SHFL) and a Philox and
    a Box-Muller for each of its QPL D quads, the fewest MUFU of those (the
    next QPL's loop holds more quads), over the 4 QPL D normals a lane takes
    a turn. "integral": layer 1's K-slab loop, the path through its body
    (``branch_paths``: its variants, one a kind of slab) that holds
    products, no shuffle and 8 quads' Philox and Box-Mullers with the
    fewest instructions: a slab that lies in nx drawn without antithetic
    pairing and without a branch (layer1_slab<false, true, false>), without
    the products, their fences and waits (HGMMA, WARPGROUP.*, BAR,
    SYNCS.*), over 4 normals per DRAW_MUFU_PER_QUAD MUFU. Raises unless
    both are found."""
    ins = function_sass(sass, lambda name: instance in name)
    qpl, d = terminal_turn(nx)
    quads = qpl * d
    loops = sass_loops(ins)
    spans = [collections.Counter(i.op for i in ins[s:e + 1])
             for s, e in loops]
    fast = [collections.Counter(ins[k].op for k in path)
            for se in loops for path in branch_paths(ins, *se)]

    def draws(ops, n):
        return (ops["MUFU"] >= DRAW_MUFU_PER_QUAD * n
                and ops["IMAD"] >= DRAW_IMAD_PER_QUAD * n)

    term = [ops for ops in spans if not ops["HGMMA"]
            and ops["SHFL"] == WARP_SUM_SHFL * d and draws(ops, quads)]
    layer1 = [ops for ops in fast if ops["HGMMA"] and not ops["SHFL"]
              and draws(ops, 8)]
    if not term or not layer1:
        raise RuntimeError(f"no terminal or layer-1 draw loop in "
                           f"{instance}'s SASS at nx={nx}")
    t_ops = min(term, key=lambda ops: ops["MUFU"])
    i_ops = min(layer1, key=lambda ops: sum(ops.values()))
    i_ops = collections.Counter({
        op: n for op, n in i_ops.items()
        if not op.startswith(("HGMMA", "WARPGROUP", "BAR", "SYNCS"))})
    i_quads = i_ops["MUFU"] // DRAW_MUFU_PER_QUAD
    return {"terminal_quads": quads, "integral_quads": i_quads,
            "terminal": _mix(t_ops, 4 * quads),
            "integral": _mix(i_ops, 4 * i_quads)}


# generate_pis.cu's instances (T's and H's, "default": <X3, W>)
GENERATE_PIS_WIDE = "generate_pis_kernelILb0ELb1E"
GENERATE_PIS_NARROW = "generate_pis_kernelILb0ELb0E"
# the least FP32 instructions of a loop that holds a Box-Muller
DRAW_FP32_MIN = 20


def generate_pis_draw_mix(sass: str, nx: int,
                          instance: str = GENERATE_PIS_WIDE) -> dict:
    """Instructions per normal of the HJB kernel's own draw and mixture
    loops at ``instance`` (mangled-name part; T's by default) and nx, from
    ``cuobjdump -sass`` output of ``csrc/generate_pis.cu``, in all and by
    group. Static counts of each loop's body without its inner loops (both
    sides of a branch; the fast-path walk of ``fast_path`` skips these
    loops' Box-Mullers, whose sqrtf has a slow path). A quad loop holds a
    quad's Philox and Box-Mullers (at least DRAW_IMAD_PER_QUAD IMAD,
    DRAW_MUFU_PER_QUAD MUFU, DRAW_FP32_MIN FP32), no product anywhere in
    its span and no other such loop inside it (backward branches out of
    spin-waits make spans that hold them). "terminal": the loop over a
    point's draws, the least span without products holding two quad
    loops (its logits' terms, then its gradient sums; of the kernel's such
    nests, the zero
    iterate's and the net's, the one with the most instructions); a lane
    takes Q / lanes of a draw's Q = ceil(nx / 4) quads (32 lanes a draw in the
    wide instance, 4 in the narrow), so a normal costs (the nest's body +
    that many passes of each quad loop) over 4 x that many normals.
    "integral": the quad loop outside those nests that stores (the
    integral chain's normals), with the most FP32 instructions, one quad
    an iteration. Raises unless both are found."""
    ins = function_sass(sass, lambda name: instance in name)
    loops = sass_loops(ins)

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1] and a != b

    def body(se):
        inner = [o for o in loops if inside(o, se)]
        return collections.Counter(
            ins[k].op for k in range(se[0], se[1] + 1)
            if not any(o[0] <= k <= o[1] for o in inner))

    def fp32(ops):
        return sum(ops[op] for op in SASS_PIPES["fp32"])

    def products(se):
        return any(i.op == "HGMMA" for i in ins[se[0]:se[1] + 1])

    draws = [se for se in loops
             if (ops := body(se))["MUFU"] >= DRAW_MUFU_PER_QUAD
             and ops["IMAD"] >= DRAW_IMAD_PER_QUAD
             and fp32(ops) >= DRAW_FP32_MIN and not products(se)]
    quads = [se for se in draws if not any(inside(o, se) for o in draws)]

    def held(se):
        return [q for q in quads if inside(q, se)]

    nests = [se for se in loops if len(held(se)) == 2 and not products(se)
             and not any(inside(o, se) and len(held(o)) == 2
                         for o in loops)]
    stores = [q for q in quads if not any(inside(q, n) for n in nests)
              and (body(q)["STG"] or body(q)["ST"] or body(q)["STS"])]
    if not nests or not stores:
        raise RuntimeError(f"no integral or terminal draw loop in "
                           f"{instance}'s SASS")
    nest = max(nests, key=lambda se: sum(body(se).values()) + sum(
        sum(body(q).values()) for q in held(se)))
    per_lane = -(-nx // 4) / (32 if instance == GENERATE_PIS_WIDE else 4)
    terminal = body(nest)
    for q in held(nest):
        for op, n in body(q).items():
            terminal[op] += per_lane * n
    return {"integral": _mix(body(max(stores, key=lambda q: fp32(body(q)))),
                             4),
            "terminal": _mix(terminal, 4 * per_lane)}


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
