"""Time several builds of one kernel in turns, on the card.

The harness of ``utils/terminal_bench.py`` and ``utils/pis_bench.py``:
each ``--source`` is built with nvcc as the package's kernels are, must
give the same result twice and agree with the first source (put a build
that chip_smoke has checked first), and is timed with CUDA events over a
fixed number of launches after a warm-up, the builds in turns (a, b, ...,
b, a), each one's two turns averaged, while the SM clock is sampled
(``nvidia-smi``, every 100 ms). Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
from typing import Callable, Sequence

import torch

from deeppicarditeration_torch.device import Timer
from deeppicarditeration_torch.ops import kernels


def build_sources(sources: Sequence[str], declare) -> list:
    """One ``kernels.CudaLibrary`` per source file, all built in
    parallel."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card")
    libs = [kernels.CudaLibrary(str(pathlib.Path(s).resolve()), declare)
            for s in sources]
    kernels.build(*libs)
    return libs


def _ms(fn, dev, reps: int) -> float:
    fn()  # warm-up
    with Timer(dev) as tm:
        for _ in range(reps):
            fn()
    return tm.ms / reps


def in_turns(case: dict, sources: Sequence[str], calls: Sequence[Callable],
             agree: Callable, reps: int) -> list:
    """Check and time ``calls`` (one per source, each returning its output
    tensor) in turns. ``agree(out, ref)`` returns (ok, error) against the
    first source's output. Prints the SM clock's samples and one JSON line
    per source (``case`` merged in); returns those rows."""
    dev = torch.device("cuda")
    ref = calls[0]().clone()
    for name, call in zip(sources, calls):
        a, c = call().clone(), call().clone()
        ok, err = agree(a, ref)
        if not (ok and torch.equal(a, c) and bool(torch.isfinite(a).all())):
            raise RuntimeError(f"{name} ({case}): not deterministic, not "
                               f"finite or off the first source by {err:.3e}")
    order = list(range(len(calls)))
    turns = {k: [] for k in order}
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for k in order + order[::-1]:
            turns[k].append(_ms(calls[k], dev, reps))
    finally:
        sampler.terminate()
        clocks = sorted(float(ln) for ln in sampler.communicate()[0].split()
                        if ln)
    print(json.dumps({**case, "sm_clock_mhz_samples": len(clocks),
                      "sm_clock_mhz_median":
                      clocks[len(clocks) // 2] if clocks else None,
                      "sm_clock_mhz_min": clocks[0] if clocks else None}),
          flush=True)
    rows = []
    for k, name in enumerate(sources):
        r = {"source": name, **case, "ms": sum(turns[k]) / 2,
             "turns_ms": turns[k], "err_vs_first": agree(calls[k](), ref)[1],
             "reps": reps, "device": torch.cuda.get_device_name(dev)}
        rows.append(r)
        print(json.dumps(r), flush=True)
    return rows


def report_builds(sources: Sequence[str], libs: Sequence, sass: Callable):
    """Each build's ptxas lines and ``sass(lib)``, then the card's name and
    power limit."""
    for lib, name in zip(libs, sources):
        info = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln or "wgmma" in ln]
        try:
            mix = sass(lib)
        except RuntimeError as e:
            mix = f"not read: {e}"
        print(json.dumps({"source": name, "ptxas": info, "sass": mix}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
