"""The serving knee: an open-loop serving cell run at a list of arrival rates,
one after another in one process, to find the highest rate the engine
sustains without a growing backlog. A cell's fixed rate is set from it.

    python3 portbench/knee.py --workload serve-128-poisson --rates 16,20,24 --seconds 20

For each rate, one JSON line: the rate offered and the rows per second
served, the latency's median and 95th percentile, the median latency of the
first and the last third of the requests by due time (a backlog that grows
makes the last third's much longer), and the rows per dispatch.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.drivers import serve

    if not torch.cuda.is_available():
        print("portbench: the knee sweep needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.find_cell(args.workload, harness.benchmark())
    for rate in (float(r) for r in args.rates.split(",")):
        cell.params = dict(cell.params, rate_per_s=rate)
        ctx = harness.Ctx(cell, args.seed, args.seconds, False, "cuda:0")
        res = serve.run(ctx)
        lat = np.asarray(res.counts["latency_s"])
        third = len(lat) // 3
        print(json.dumps(dict(
            rate_per_s=rate, requests=len(lat), failed=res.failed,
            rows_per_s=res.counts["n_rows"] / res.counts["window_s"],
            p50_ms=1e3 * float(np.median(lat)), p95_ms=1e3 * float(np.percentile(lat, 95)),
            first_third_p50_ms=1e3 * float(np.median(lat[:third])),
            last_third_p50_ms=1e3 * float(np.median(lat[-third:])),
            rows_per_dispatch=res.counts["n_rows"] / max(1, res.counts["n_dispatches"]),
            wall_s=time.perf_counter() - ctx.window_t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
