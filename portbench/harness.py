"""The harness: finds a cell's files by name, runs its driver, reads its
per-layer metrics and prints the result line.

Everything that belongs to one cell, configuration or metric sits in a file of
its own, found by the name ``BENCHMARK.json`` gives it:

- ``portbench/configs/<config>.json``: the model's sizes, its sampler and its
  precision (the path is the configuration's ``file``);
- ``portbench/workloads/<cell>.json``: the traffic's parameters, which driver
  of ``portbench/drivers/`` runs them, the checks' limits and the trace's length;
- ``portbench/metrics/<metric>.py``: a reader ``read(run) -> float | None``.

A driver's ``run(ctx)`` builds the program from the inputs of
``portbench/inputs.py``, calls ``ctx.window_opened()`` when the timed window
starts, brackets every call with ``ctx.tracer``'s ``begin_call`` /
``end_call``, and returns a ``Result``. End-to-end metrics are the driver's,
taken on the host's clock; ``setup_s`` is the harness's.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent

# Top-level module names that must not be loaded in a run's process, compared
# whole: the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "sbgm_danra_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the workload's entry in BENCHMARK.json
    params: dict  # portbench/workloads/<name>.json
    cfg: dict  # the configuration's file


def find_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(name, entry, load_json(PACKAGE / "workloads" / f"{name}.json"),
                load_json(root / config["file"]))


def cell_metrics(cell: str, bench: dict) -> tuple:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names

    return e2e, [m for m in bench["per_layer"] if reports(m)]


def reader(metric: str) -> Callable:
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Result:
    """What a driver's run hands back."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, dict]  # name -> {"value", "limit"}: correct when value <= limit
    memory_peak_bytes: int
    counts: Dict[str, Any]  # the readers' inputs: calls, evaluations, spans, counters


class Ctx:
    """A driver's view of the run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 control: bool = False):
        from portbench.trace import Tracer

        self.cfg, self.params = cell.cfg, cell.params
        self.seed, self.seconds, self.device, self.control = seed, seconds, device, control
        self.tracer = Tracer(cell.params.get("trace_seconds", 2.0) if trace else None, device)
        self.window_t0: Optional[float] = None

    def window_opened(self) -> float:
        """Marks the window's start (the end of set-up); a traced run first
        starts and stops the profiler once, so that its first start, which
        sets up the device's tracing, lies outside the window."""
        self.tracer.warm_up()
        self.window_t0 = time.perf_counter()
        return self.window_t0

    def window_closed(self, t0: float) -> bool:
        """Whether the window has run its seconds and the traced stretch its own."""
        return time.perf_counter() - t0 >= self.seconds and not self.tracer.active


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.params['driver']}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: Optional[dict] = None, cell: Optional[Cell] = None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result line's object."""
    bench = bench or benchmark()
    cell = cell or find_cell(name, bench)
    e2e_defs, layer_defs = cell_metrics(cell.name, bench)
    ctx = Ctx(cell, seed, seconds, trace, device, control)
    res = driver(cell).run(ctx)
    ctx.tracer.stop()
    e2e = dict(res.e2e, setup_s=ctx.window_t0 - t_start)
    metrics = {}
    if not trace:
        for m in e2e_defs:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = Run(cell, res.counts, ctx.tracer.trace)
        for m in layer_defs:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in res.checks.values())
    out = {"correct": bool(correct and res.failed == 0), "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": device_info(device, res)}
    if trace and ctx.tracer.trace is not None:
        t = ctx.tracer.trace
        out["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
        out["breakdown"] = t.breakdown()
    out["checks"] = res.checks
    return out


class Run:
    """What a per-layer reader reads: the cell, the driver's counts and the trace."""

    def __init__(self, cell: Cell, counts: Dict[str, Any], trace):
        self.cell, self.cfg, self.counts, self.trace = cell, cell.cfg, counts, trace


def device_info(device, res: Result) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": res.memory_peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": res.memory_peak_bytes}


def check_lines(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                     for k, v in checks.items())
