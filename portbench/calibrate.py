"""Readings for the comparison's limits: the program's compared numbers on
many seeds, the control's (the reference in TF32 in the program's place)
and the planted faults' on some of them, at the cell's own size, in one
process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 --faults 3 --seconds 8 [--fault <name>]

Prints one JSON line per reading: {"seed", "what", "compared"}. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell_def, config, seed, seconds, device, what="program"):
    from portbench import faults
    from portbench.common.cellbase import judged_run

    fault = faults.FAULTS[cell_def["driver"]].get(what)
    checks, details = judged_run(cell_def, config, seed, device, seconds, fault, control=what == "control")
    return {c.name: c.value for c in checks}, details


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--fault", action="append", help="read only these faults (default: every fault of the cell)")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--first_seed", type=int, default=2_200_000_001)
    args = ap.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.run import load_cell, set_cache_env

    set_cache_env()
    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _bench, cell_def, config = load_cell(args.workload)
    plan = [(args.first_seed + i, "program") for i in range(args.seeds)]
    plan += [(args.first_seed + i, "control") for i in range(args.control)]
    for what in args.fault or faults.FAULTS[cell_def["driver"]]:
        plan += [(args.first_seed + i, what) for i in range(args.faults)]
    for seed, what in plan:
        got, details = readings(cell_def, config, seed, args.seconds, device, what)
        print(json.dumps({"seed": seed, "what": what, "compared": got, "details": details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
