"""Tiny copies of the two configurations and of the cells, run by the
harness on the CPU."""

import copy
import time

from portbench import harness

SEED = 2**31 + 12345  # beyond 32 signed bits, as the driver's seeds are


def tiny_config(name: str) -> dict:
    """A configuration at CPU size: the same layers, narrower, in float32."""
    cfg = copy.deepcopy(harness.load_json(harness.PACKAGE / "configs" / f"{name}.json"))
    cfg["model"].update(last_fmap_channels=32, time_embedding=16, num_heads=2,
                        compute_dtype="float32")
    if name == "flagship-domain":
        cfg["image_hw"], cfg["sampler"]["num_steps"] = [40, 72], 3
    else:
        cfg["image_hw"], cfg["sampler"]["num_steps"] = [32, 32], 4
        cfg["full_domain_dims"], cfg["crop"] = [48, 64], [4, 44, 8, 56]
        cfg["training"].update(batch_size=4, steps_per_epoch=4, fused_steps=2, train_days=3)
    return cfg


TINY_PARAMS = {
    "domain-edm18": dict(dates=3, trace_seconds=0.2),
    "gen-128-ensemble": dict(dates=2, members=3, pools=2, trace_seconds=0.2),
    "serve-128-poisson": dict(rate_per_s=12.0, dates=3, clients=8, trace_seconds=0.3),
    "train-128-fused": dict(trace_seconds=0.2),
}


def tiny_cell(name: str) -> harness.Cell:
    bench = harness.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    params = dict(harness.load_json(harness.PACKAGE / "workloads" / f"{name}.json"),
                  **TINY_PARAMS[name])
    return harness.Cell(name, entry, params, tiny_config(entry["config"]))


def run_tiny(name: str, seconds: float = 0.6, trace: bool = False, control: bool = False,
             seed: int = SEED) -> dict:
    return harness.run_cell(name, seed, seconds, trace, "cpu", time.perf_counter(),
                            cell=tiny_cell(name), control=control)
