"""The final grid rRMSE of the DBDP paths over cut budgets, on the card.

    python -m deeppicarditeration_torch.utils.dbdp_sweep

Run from a checkout's root: the paths are ``chip_smoke.py``'s M and N (the
FN and HJB DBDP recipes, imported from the working directory). Each runs
once per (sub-iterations a grid time, seed) of ``RUNS``, through the CLI's
runner, and prints one JSON line: the path, the budget, the seed, the
final grid rRMSE (100 points at each of the 51 grid times, after the
sweep), the first grid eval's (one grid time trained: the other nets at
their initialisation or the terminal pre-fit) and the run's seconds. It
shows where the cut budget's rRMSE can tell a working sweep from a weak
one (``chip_smoke.DBDP_RRMSE_MAX``). Needs a CUDA card: there is no CPU
mode.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import torch

# (sub-iterations a grid time, SEED)
RUNS = ((1, 0), (2, 0), (5, 0), (10, 0), (20, 0), (10, 1), (10, 2), (2, 1))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dbdp_sweep: needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    from deeppicarditeration_torch.training.picard import PicardRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    root = pathlib.Path("build") / "dbdp_sweep"
    for path in ("M", "N"):
        for sub, seed in RUNS:
            cfg = chip_smoke.path_cfg(path, overrides=[
                "METHOD.num_sub_iter", str(sub), "SEED", str(seed)])
            runner = PicardRunner(cfg, exp_root=root / f"{path}_{sub}_{seed}")
            t0 = time.perf_counter()
            runner.run()
            torch.cuda.synchronize()
            rows = [json.loads(ln) for ln in
                    (runner.exp_dir / "metrics.jsonl").read_text()
                    .splitlines()]
            evals = [r for r in rows if r["context"] == "eval"]
            print(json.dumps({
                "path": path, "sub_iter": sub, "seed": seed,
                "final_rRMSE": evals[-1]["rRMSE"],
                "first_eval_rRMSE": evals[0]["rRMSE"],
                "seconds": time.perf_counter() - t0}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
