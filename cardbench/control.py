#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's numbers and
its control's, seed after seed, in one process.

    python3 cardbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds`` at the cell's own load, the reference's
judgement), then the control: the reference put in the program's place,
computing the same answers from the same window one precision below the
configuration's (bfloat16 for float32), judged by the same comparison.
One JSON line a seed: {"seed", "program": {name: value}, "control":
{name: value}}.  Needs the card, as ``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cardbench import core, run

    run._fix_caches()
    c = core.cell(core.load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        core.log("cardbench: the control runs on the card")
        return 2
    for seed in args.seeds:
        out = run.run_cell(c, seed, args.seconds, False, "cuda",
                           time.perf_counter(), control=True)
        line = {"seed": seed,
                "program": {k: v["value"] for k, v in
                            out["result"]["checks"].items()},
                "control": {k: v["value"] for k, v in
                            out["control_checks"].items()}}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
