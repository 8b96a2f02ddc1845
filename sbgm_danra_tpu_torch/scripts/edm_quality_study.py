"""Run the PC-vs-EDM sampler quality study on the port and print the
BASELINE.md table (counterpart of ``scripts/edm_quality_study.py``, same
arguments and defaults).

Exact-score synthetic regimes (no trained model, so no model-error confound);
see ``evaluate/quality_study.py``. The JAX script pins JAX to the CPU; here
the study's samplers run on the card, each on its CUDA graph, unless given
``--device cpu``.

    python -m sbgm_danra_tpu_torch.scripts.edm_quality_study [--members 64] [--truths 256]
        [--size 16] [--seed 0] [--device cpu]

``main(argv)`` returns the study's results (regime -> sampler -> metrics).
"""

import argparse
import json

from sbgm_danra_tpu_torch.evaluate.quality_study import format_table, run_study


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--truths", type=int, default=256)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run_study(n_members=args.members, size=args.size, n_truths=args.truths,
                        seed=args.seed, device=args.device)
    print(format_table(results))
    print()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
