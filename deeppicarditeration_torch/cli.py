"""CLI: ``python -m deeppicarditeration_torch.cli train <cfg.yaml> [KEY value ...]``
and ``python -m deeppicarditeration_torch.cli evaluate <exp_dir> [...]``.

Counterpart of ``deeppicarditeration_tpu/cli.py``. Overrides are
``KEY.SUBKEY value`` pairs merged last (leading dashes on keys tolerated);
``DEVICE cpu`` runs on the CPU, and ``RESUME true`` continues a run in its
experiment directory. ``evaluate`` reads an experiment directory (its
``config.yaml`` and ``model_{i}``) on the device its config names: the MC
self-consistency check at (0, 0) by default, the L2 sweeps with
``--do-l2``; ``--out`` appends its records as JSON lines, each with a run
delimiter (timestamp, experiment, protocol).
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dpi-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    p_train = sub.add_parser("train", help="run the Picard training loop")
    p_train.add_argument("configfile")
    p_train.add_argument("overrides", nargs="*",
                         help="KEY value pairs, e.g. PICARD.N 4")
    p_eval = sub.add_parser("evaluate", help="evaluate an experiment dir")
    p_eval.add_argument("exp_dir")
    p_eval.add_argument("--do-l2", action="store_true")
    p_eval.add_argument("--sol-file", default=None,
                        help="h5/npz/npy (tx, u) file for l2_file sweeps")
    p_eval.add_argument("--n-points", type=int, default=1000)
    p_eval.add_argument("--n-estimate", type=int, default=1_000_000)
    p_eval.add_argument("--out", default=None,
                        help="append the per-iteration records as JSON "
                             "lines to this file")
    args = parser.parse_args(argv)

    if args.command == "evaluate":
        return _evaluate(args)
    from deeppicarditeration_torch.config import load_cfg
    from deeppicarditeration_torch.training.picard import PicardRunner

    if not pathlib.Path(args.configfile).exists():
        raise FileNotFoundError(f"config file {args.configfile} does not exist")
    # strip leading dashes from KEYS only: stripping values would flip the
    # sign of negative numbers
    overrides = [a.lstrip("-") if i % 2 == 0 else a
                 for i, a in enumerate(args.overrides)]
    cfg = load_cfg(args.configfile, overrides or None)
    PicardRunner(cfg).run()
    return 0


def _evaluate(args) -> int:
    import json
    import time

    from deeppicarditeration_torch.evaluation.experiment import (
        ExperimentEvaluator,
    )

    ev = ExperimentEvaluator(args.exp_dir,
                             n_estimate_terminal=args.n_estimate,
                             n_estimate_integral=args.n_estimate)
    if args.do_l2:
        if args.sol_file is not None:
            recs, kind = ev.l2_file(args.sol_file), "l2_file"
        else:
            recs, kind = ev.l2(args.n_points), "l2"
    else:
        recs, kind = ev.monte_carlo_at_zero(), "mc_at_zero"
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        # --out appends: each record carries a run delimiter
        run_id = {"run_ts": round(time.time(), 3),
                  "exp": pathlib.Path(args.exp_dir).name,
                  "protocol": kind}
        with open(out, "a") as f:
            for r in recs:
                f.write(json.dumps({**run_id, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
