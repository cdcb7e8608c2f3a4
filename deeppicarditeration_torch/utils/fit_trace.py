"""torch.profiler traces of path A's fit, of path E's epochs, of the
DBDP paths' sub-iterations and of path K's generation on the card.

    python -m deeppicarditeration_torch.utils.fit_trace [--epochs 100] \
        [--fused auto|false] [--out build/traces] \
        [--only fit|epochs|dbdp|generate]

Run from a checkout's root: the paths are ``chip_smoke.py``'s (its
``PATHS`` recipes, imported from the working directory). Path A, the
Burgers 100-d w1.0 recipe at full width, runs 3 Picard iterations with
``TRAIN.FUSED`` set to ``--fused``; iteration 2's fit (128 train steps and
16 evals) is traced, and iteration 3's is timed untraced (the runner's
CUDA events). Path E, the D-DBSDE recipe, runs 3 x ``--epochs`` epochs
with one log interval per ``--epochs``; the second interval's epochs are
traced (the eval and checkpoint between intervals are not), the third's
timed untraced. The first iteration or interval pays the set-up (cuBLAS
handles, a CUDA graph's capture), so neither is traced. Paths M and N, the
DBDP recipes, run their sweep with ``chip_smoke.DBDP_SUB_ITER``
sub-iterations a grid time; the third grid time's sub-iterations are
traced (the grid eval after each grid time is not), the fourth's timed
untraced. Path K, the FN
recipe, runs 3 Picard iterations; iteration 2's generation call (the SDGD
chunk estimators through the frozen net's second-order chain) is traced,
iteration 3's timed untraced. The profiler
records device activity and the CUDA runtime calls only, to keep its cost
on the host small.

For each trace it prints one JSON line: device kernels, and kernel
launches, graph launches and copies issued by the host; per train step
(path A, the evals included) or per epoch (path E): kernels, host ms (the
traced window's wall time, ended by a synchronize) and device ms (the
union of the device's busy intervals); the device's idle share of the
window; the kernels with the most device time; and the untraced time per
train step or epoch. Each chrome trace is
written under ``--out``. Needs a CUDA card: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HOST_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def _cfg(path: str, overrides):
    import chip_smoke

    from deeppicarditeration_torch.config import default_cfg

    layers, path_overrides = chip_smoke.PATHS[path]
    cfg = default_cfg()
    for layer in layers:
        cfg.merge(layer, allow_new=False)
    cfg.merge_from_list(list(path_overrides) + list(overrides))
    cfg.DEVICE = "cuda"
    return cfg.freeze()


def summarize(prof, wall_ms: float, units: int, unit: str, name: str,
              out_dir: pathlib.Path) -> dict:
    """Counts and times of one trace, per ``unit`` (``units`` of them)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    runtime = [e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime"]
    busy, end = 0.0, None
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy / 1e3
    return {
        "trace": name, "unit": unit, "units": units,
        "device_kernels": len(kernels),
        "host_kernel_launches": sum(r in HOST_LAUNCH for r in runtime),
        "host_graph_launches": sum(r.startswith("cudaGraphLaunch")
                                   for r in runtime),
        "host_copies": sum(r.startswith("cudaMemcpy") for r in runtime),
        f"kernels_per_{unit}": len(kernels) / units,
        f"host_ms_per_{unit}": wall_ms / units,
        f"device_ms_per_{unit}": busy_ms / units,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms": [(k[:90], v / 1e3) for k, v in top],
        "device": torch.cuda.get_device_name(0),
        "chrome_trace": str(trace)}


def _traced(fn):
    """(result, profiler, wall ms) of ``fn()``, synchronized at both ends."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, prof, wall


def trace_fit(fused: str, out_dir: pathlib.Path) -> dict:
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = _cfg("A", ["PICARD.N", "3", "TRAIN.FUSED", fused])
    runner = PicardRunner(cfg, exp_root=out_dir / "runs" / "A")
    inner = runner._train_iteration
    seen = {}

    def train_iteration(*args, **kwargs):
        if runner.i != 2:
            return inner(*args, **kwargs)
        out, seen["prof"], seen["wall"] = _traced(
            lambda: inner(*args, **kwargs))
        return out

    runner._train_iteration = train_iteration
    runner.run()
    steps = (int(cfg.TRAIN.N_EPOCHS) * int(cfg.DATA.DATA_SIZE)
             // int(cfg.TRAIN.BATCH_SIZE))
    out = summarize(seen["prof"], seen["wall"], steps, "step",
                    f"fit_A_fused_{fused}", out_dir)
    out["untraced_ms_per_step"] = runner.timings[-1]["fit_ms"] / steps
    out["graph_replays"] = getattr(runner, "graph_replays", None)
    return out


def trace_epochs(epochs: int, out_dir: pathlib.Path) -> dict:
    from deeppicarditeration_torch.device import Timer
    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = _cfg("E", ["TRAIN.N_EPOCHS", str(3 * epochs),
                     "EVAL.FREQ", str(epochs)])
    seen = {"n": 0}

    class TracedInterval(Timer):
        """The baseline loop's interval timer; traces the second
        interval."""

        def __enter__(self):
            seen["n"] += 1
            if seen["n"] == 2:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._t0_wall = time.perf_counter()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            if seen["n"] == 2:
                torch.cuda.synchronize()
                seen["wall"] = (time.perf_counter() - self._t0_wall) * 1e3
                self._prof.__exit__(*exc)
                seen["prof"] = self._prof
            return False

    runner = PicardRunner(cfg, exp_root=out_dir / "runs" / "E")
    timer = baselines.Timer
    baselines.Timer = TracedInterval
    try:
        runner.run()
    finally:
        baselines.Timer = timer
    out = summarize(seen["prof"], seen["wall"], epochs, "epoch",
                    "epochs_E", out_dir)
    last = runner.timings[-1]
    out["untraced_ms_per_epoch"] = last["interval_ms"] / last["epochs"]
    out["graph_replays"] = getattr(runner, "graph_replays", None)
    return out


def trace_dbdp(path: str, out_dir: pathlib.Path) -> dict:
    import chip_smoke

    from deeppicarditeration_torch.device import Timer
    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.picard import PicardRunner

    sub_iter = chip_smoke.DBDP_SUB_ITER
    cfg = _cfg(path, ["METHOD.num_sub_iter", str(sub_iter)])
    seen = {"n": 0}

    class TracedGridTime(Timer):
        """The DBDP sweep's per-grid-time timer; traces the third."""

        def __enter__(self):
            seen["n"] += 1
            if seen["n"] == 3:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._t0_wall = time.perf_counter()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            if seen["n"] == 3:
                torch.cuda.synchronize()
                seen["wall"] = (time.perf_counter() - self._t0_wall) * 1e3
                self._prof.__exit__(*exc)
                seen["prof"] = self._prof
            return False

    runner = PicardRunner(cfg, exp_root=out_dir / "runs" / path)
    timer = baselines.Timer
    baselines.Timer = TracedGridTime
    try:
        runner.run()
    finally:
        baselines.Timer = timer
    out = summarize(seen["prof"], seen["wall"], sub_iter, "sub_iteration",
                    f"dbdp_{path}", out_dir)
    fourth = runner.timings[3]
    out["untraced_ms_per_sub_iteration"] = fourth["ms"] / fourth["sub_iters"]
    out["traced_grid_time"] = runner.timings[2]["k"]
    return out


def trace_generate(out_dir: pathlib.Path) -> dict:
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = _cfg("K", ["PICARD.N", "3"])
    runner = PicardRunner(cfg, exp_root=out_dir / "runs" / "K")
    inner = runner._make_dataset
    seen = {}

    def make_dataset(*args, **kwargs):
        if runner.i != 2:
            return inner(*args, **kwargs)
        out, seen["prof"], seen["wall"] = _traced(
            lambda: inner(*args, **kwargs))
        return out

    runner._make_dataset = make_dataset
    runner.run()
    out = summarize(seen["prof"], seen["wall"], 1, "call", "generate_K",
                    out_dir)
    out["untraced_ms_per_call"] = runner.timings[-1]["generate_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--fused", default="auto", choices=("auto", "false"))
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build") / "traces")
    ap.add_argument("--only", choices=("fit", "epochs", "dbdp", "generate"),
                    default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fit_trace: needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.only in (None, "fit"):
        print(json.dumps(trace_fit(args.fused, args.out)), flush=True)
    if args.only in (None, "epochs"):
        print(json.dumps(trace_epochs(args.epochs, args.out)), flush=True)
    if args.only in (None, "dbdp"):
        for path in ("M", "N"):
            print(json.dumps(trace_dbdp(path, args.out)),
                  flush=True)
    if args.only in (None, "generate"):
        print(json.dumps(trace_generate(args.out)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
