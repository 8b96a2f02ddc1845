"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA card. The cell's files are found by
its name in ``BENCHMARK.json`` (see ``portbench/harness.py``). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch at the start of
the window. The numbers that decide ``correct`` are printed, each beside its
limit, as the last lines of standard error and under ``checks``, the last key
of the result, which is the last line of standard output. Without a CUDA
card, or with a forbidden module loaded once the window has closed (JAX, Flax
or the JAX package, by whole top-level name), it prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "_cache"  # fixed build and kernel caches inside the checkout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.benchmark()
    cell = harness.find_cell(args.workload, bench)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           T_START, bench=bench, cell=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    print(harness.check_lines(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
