"""Readings that the checks' limits are set from: for each seed, a short run of
the cell with its check, and the control (the reference in fp8, in the
program's place) judged by the same comparison, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds 1,2,3 [--out F]

Prints one JSON line per seed (the program's and the control's readings) and
writes them all to ``--out``. The benchmark's own runs do not run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: calibration needs a CUDA device", file=sys.stderr)
        return 1
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", t0,
                               control=True)
        row = dict(seed=seed, attempted=out["attempted"], failed=out["failed"],
                   metrics={k: v["value"] for k, v in out["metrics"].items()},
                   checks={k: v["value"] for k, v in out["checks"].items()},
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
