"""Control readings of one cell on the card (core/control.py).

    python3 portbench/control.py --workload <cell> --seeds a,b,c
        [--kinds program,fp8,half]

One JSON line a seed: {"seed", "readings": {kind: {number: value}},
"limits"}. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="fp8")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core.control import readings
    from portbench.core.spec import find_cell, load_benchmark

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(load_benchmark(), args.workload)
    for s in args.seeds.split(","):
        out = readings(cell, int(s), args.kinds.split(","), "cuda:0")
        print(json.dumps({"workload": cell.name, "seed": int(s),
                          "readings": out,
                          "limits": cell.workload["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
