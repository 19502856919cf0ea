"""Readings of the program and of the control on several seeds, one JSON
line a seed: the control is the reference put in the program's place in
the precision below the configuration's (float32 with TF32 for float32
with TF32 off). Each seed is a full run of the cell at its own size with a
short window, so that the frames compared are the cell's own.

    python3 benchmark/control.py --workload <name> [--seconds 10] --seeds <n> [<n> ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    lines = []
    for seed in a.seeds:
        out = run.run_cell(a.workload, seed, a.seconds, False, control=True)
        line = {"workload": a.workload, "seed": seed,
                "correct": out["correct"], "program": out["_readings"],
                "control": out["_control"], "metrics": out["metrics"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
