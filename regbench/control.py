"""The readings that a cell's limits are set from, taken on the card at
the cell's own sizes through the harness's own run and comparison
(``harness.run`` with ``--seconds 0``: one registration of each size in
the window, each checked against the plain reference, as a run checks
them), over several seeds, with one of these in the program's place:

* ``program``: the program itself, ``tpuslam_torch.register``;
* ``control``: the plain reference computed in the precision below the
  one the configuration states (bfloat16 for float32);
* ``half``: the program with half of each cloud's points left out.

    python3 regbench/control.py --workload <cell> --seeds 1,2,3 --modes program,control,half [--out f]

Prints one JSON object a run (the readings of every number of
``compare.NUMBERS`` and the checks) and, last, each mode's worst and best
reading of each number over the seeds.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import compare  # noqa: E402
import harness  # noqa: E402

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def in_place(mode: str, cell: harness.Cell, device):
    """What runs in the program's place in ``mode`` (None: the program)."""
    cfg = cell.config
    if mode == "program":
        return None
    if mode == "control":
        low = LOWER[cfg["precision"]]
        return lambda before, after: harness.reference(cfg, before, after, low, device)
    if mode == "half":
        sut = harness.System(cfg["registration"], device)
        return lambda before, after: sut(before[::2], after[::2])
    raise ValueError(f"unknown mode {mode!r}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--modes", default="program,control,half")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = harness.load_cell(HERE, args.workload)
    runs = []
    for mode in args.modes.split(","):
        system = in_place(mode, cell, device)
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = harness.run(HERE, args.workload, seed, 0.0, False, t0, device,
                              system=system, log=lambda *a, **k: None)
            one = {"mode": mode, "seed": seed, "correct": out["correct"],
                   "failed": out["failed"], "readings": out["readings"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(one), flush=True)
            runs.append(one)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(device)}
    for mode in args.modes.split(","):
        rows = [r["readings"] for r in runs if r["mode"] == mode]
        summary[mode] = {"worst": compare.worst(rows),
                         "best": {k: min(r[k] for r in rows) for k in compare.NUMBERS},
                         "correct": [r["correct"] for r in runs if r["mode"] == mode]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
