"""The harness on the CPU at tiny sizes: every cell runs and is correct, its
control and each fault that a generation cell can have make ``correct``
false, a run loads no JAX, and a cell, a configuration and a per-layer metric
are added with new files alone."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import TINY_PARAMS, run_tiny, tiny_config

GEN_CELLS = ("domain-edm18", "serve-128-poisson", "gen-128-ensemble")
CELLS = ("domain-edm18", "train-128-fused", "serve-128-poisson", "gen-128-ensemble")
ROOT = harness.ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    out = run_tiny(cell)
    bench = harness.benchmark()
    e2e, _ = harness.cell_metrics(cell, bench)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics(cell):
    out = run_tiny(cell, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    # on the CPU no device event is traced: the device's readers find nothing
    assert all(not k.startswith(("idle_share", "k1_roofline", "k2_roofline"))
               for k in out["metrics"])
    assert any(k.startswith("mfu.") for k in out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference computed with fp8 operands, in the program's place, fails
    one of the cell's numbers; the program passes every one."""
    checks = run_tiny(cell, control=True)["checks"]
    own = {k: v for k, v in checks.items()
           if not k.startswith(("control_", "half_batch_", "emulated_bf16_"))}
    assert all(v["value"] <= v["limit"] for v in own.values()), own
    assert any(checks[f"control_{k}"]["value"] > v["limit"] for k, v in own.items()), checks


def _unchanged(monkeypatch):
    """Each sampler step returns its state unchanged: the call gives back its start."""
    from sbgm_danra_tpu_torch.sampling import samplers as S

    def start(score_fn, rng, shape, sde, config, cond=None, draws=None, **kw):
        return S._Noise(rng, shape, draws)() * S._schedule("prior", sde, config)

    for name in ("edm_sampler", "dpmpp_sampler"):
        monkeypatch.setitem(S._SAMPLERS, name, start)


def _half_batch(monkeypatch):
    """The UNet computes the first half of its batch and repeats it for the rest."""
    from sbgm_danra_tpu_torch.models.unet import ScoreUNet

    forward = ScoreUNet.forward

    def half(self, x, t, **cond):
        k = max(1, x.shape[0] // 2)
        out = forward(self, x[:k], t[:k], **{key: None if v is None else v[:k]
                                              for key, v in cond.items()})
        return out.repeat(-(-x.shape[0] // k), 1, 1, 1)[: x.shape[0]]

    monkeypatch.setattr(ScoreUNet, "forward", half)


def _altered(monkeypatch):
    """Every answer shifted by its own standard deviation where the sampler makes it."""
    from sbgm_danra_tpu_torch.sampling import samplers as S

    for name in ("edm_sampler", "dpmpp_sampler"):
        fn = S._SAMPLERS[name]

        def shifted(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            return out + out.std()

        monkeypatch.setitem(S._SAMPLERS, name, shifted)


def _one_date_altered(monkeypatch):
    """Only the last date's members of the ensemble's call come out shifted: a
    fault confined to one block of the batch."""
    from sbgm_danra_tpu_torch.sampling import samplers as S

    block = TINY_PARAMS["gen-128-ensemble"]["members"]
    fn = S._SAMPLERS["dpmpp_sampler"]

    def shifted(*a, **kw):
        out = fn(*a, **kw).clone()
        out[-block:] += out[-block:].std()
        return out

    monkeypatch.setitem(S._SAMPLERS, "dpmpp_sampler", shifted)


def _step_unchanged(monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _loss_half_batch(monkeypatch):
    """The DSM loss over the first half of the batch, its mean taken over those rows."""
    from sbgm_danra_tpu_torch.training import train_step

    loss = train_step.dsm_loss

    def half(score_fn, x, t=None, z=None, sdf=None, **kw):
        k = x.shape[0] // 2
        cond = {key: v[:k] if isinstance(v, torch.Tensor) and v.dim() else v
                for key, v in kw.items()}
        return loss(score_fn, x[:k], t=t[:k], z=z[:k], sdf=None if sdf is None else sdf[:k],
                    **cond)

    monkeypatch.setattr(train_step, "dsm_loss", half)


FAULTS = [(c, f) for c in GEN_CELLS for f in (_unchanged, _half_batch, _altered)] + \
    [("gen-128-ensemble", _one_date_altered)] + \
    [("train-128-fused", f) for f in (_step_unchanged, _loss_half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]


def test_loader_copy_sets_the_constructors_fields(monkeypatch):
    """The training driver builds the port's device loader over stacks of its
    own: it sets the fields that the constructor sets, and refuses to run when
    the constructor gains one."""
    from sbgm_danra_tpu_torch.data.device_data import DeviceDataLoader

    from portbench.drivers import train

    cfg = tiny_config("flagship-128")
    loader = train.resident_loader(cfg, None, 1, "cpu")
    assert set(vars(loader)) == train.constructor_fields(DeviceDataLoader)
    fields = train.constructor_fields(DeviceDataLoader) | {"pin"}
    monkeypatch.setattr(train, "constructor_fields", lambda cls: fields)
    with pytest.raises(RuntimeError, match="pin"):
        train.resident_loader(cfg, None, 1, "cpu")


def test_run_needs_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "domain-edm18",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout == ""


THROWAWAY = """
import json, sys, time
sys.path.insert(0, {copy!r})
sys.path.append({root!r})
import torch
torch.backends.mkldnn.enabled = False
from portbench import harness
from portbench.tests import tiny
assert harness.ROOT == __import__("pathlib").Path({copy!r})
bench = harness.benchmark()
cell = harness.find_cell("throwaway", bench)
for trace in (False, True):
    out = harness.run_cell("throwaway", tiny.SEED, 0.5, trace, "cpu", time.perf_counter(),
                           bench=bench, cell=cell)
    print(json.dumps(out["metrics"]))
print(json.dumps(dict(correct=out["correct"], forbidden=harness.forbidden_modules(),
                      modules=sorted({{m.split(".")[0] for m in sys.modules}}))))
"""


def test_throwaway_cell_config_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a per-layer
    metric by new files and new BENCHMARK.json entries alone; the harness
    finds them by name and runs them. The run's process loads no JAX, Flax or
    JAX package (whole top-level names)."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = harness.benchmark()
    before = {p.relative_to(copy).as_posix(): p.read_bytes()
              for p in (copy / "portbench").rglob("*") if p.is_file()}
    (copy / "portbench" / "configs" / "throwaway-config.json").write_text(
        json.dumps(dict(tiny_config("flagship-128"), name="throwaway-config")))
    params = dict(harness.load_json(ROOT / "portbench" / "workloads" / "gen-128-ensemble.json"),
                  dates=2, members=2, pools=1)
    (copy / "portbench" / "workloads" / "throwaway.json").write_text(json.dumps(params))
    (copy / "portbench" / "metrics" / "calls.throwaway.py").write_text(textwrap.dedent('''
        def read(run):
            return run.counts["traced_evals"]
        '''))
    bench["configs"].append(dict(bench["configs"][0], name="throwaway-config",
                                 file="portbench/configs/throwaway-config.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="throwaway",
                                   config="throwaway-config", traffic="throwaway"))
    bench["per_layer"].append(dict(name="calls.throwaway", unit="evals", better="higher",
                                   source="program_counter", layer="whole step (UNet)",
                                   moves="gen_fields_per_s", workloads=["throwaway"]))
    for m in bench["end_to_end"]:
        if m["name"] == "gen_fields_per_s":
            m["workloads"].append("throwaway")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run([sys.executable, "-c", THROWAWAY.format(copy=str(copy),
                                                                  root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced, last = (json.loads(line) for line in proc.stdout.splitlines()[-3:])
    assert set(plain) == {"gen_fields_per_s", "setup_s"}
    assert traced["calls.throwaway"]["value"] > 0
    assert last["correct"] and last["forbidden"] == []
    assert "sbgm_danra_tpu_torch" in last["modules"]
    after = {p.relative_to(copy).as_posix(): p.read_bytes()
             for p in (copy / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sbgm_danra_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "sbgm_danra_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.version", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
