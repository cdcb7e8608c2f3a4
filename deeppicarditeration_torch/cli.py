"""CLI: ``python -m deeppicarditeration_torch.cli train <cfg.yaml> [KEY value ...]``.

Counterpart of ``deeppicarditeration_tpu/cli.py``. Overrides are
``KEY.SUBKEY value`` pairs merged last (leading dashes on keys tolerated);
``DEVICE cpu`` runs on the CPU. ``evaluate`` comes with a later slice.
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
    sub.add_parser("evaluate", help="not ported yet")
    args = parser.parse_args(argv)

    if args.command == "evaluate":
        raise NotImplementedError(
            "evaluate is not ported yet; it comes with a later slice")
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


if __name__ == "__main__":
    sys.exit(main())
