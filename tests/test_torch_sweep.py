"""Torch port: the sweep engine (``sweep/study.py``, a copy of the JAX
package's) and the port's runner (``sweep/run_sweep.py``) on the CPU.

- the Random, Halton and GP samplers give JAX's exact suggestions for the
  same seed and objective (the GP's after its Halton start too);
- ``SuccessiveHalvingPruner`` decides as JAX's on random rungs and peers;
- a port worker and a JAX worker share one study file, and each package
  reads the other's study (trials, values, intermediate reports);
- a failed trial is recorded and re-raised;
- a tiny end-to-end sweep on the port's trainer: 2 trials, 1 epoch, 2 steps,
  fp32, oneDNN off (F5), trial configs dumped; each trial's pipeline is
  collected when it ends, also when it is pruned for a broken architecture
  (``release_trial_memory``: the rule for the card's memory across trials).
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch
import yaml

from sbgm_danra_tpu.sweep import study as jax_study
from sbgm_danra_tpu_torch.sweep import run_sweep as rs
from sbgm_danra_tpu_torch.sweep import study
from tests.test_torch_data import config_dict, spec_for
from tests.torch_parity import one_thread  # noqa: F401 (a module fixture)


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _objective(trial):
    """Every parameter kind, and a value that depends on all of them."""
    x = trial.suggest_float("x", -2.0, 2.0)
    lr = trial.suggest_float("lr", 1e-5, 3e-3, log=True)
    n = trial.suggest_int("n", 200, 1500)
    c = trial.suggest_categorical("c", [(1, 1), (2, 2), (3, 3)])
    return (x - 0.5) ** 2 + abs(np.log10(lr) + 3.5) + n / 1500 + c[0] / 10


def _sampler(module, name: str, seed: int):
    if name == "gp":
        return module.GPSampler(seed=seed, n_startup=4, n_candidates=64)
    return getattr(module, name)(seed=seed)


@pytest.mark.parametrize("name,seed", [("RandomSampler", 3), ("HaltonSampler", 0), ("gp", 1)])
def test_samplers_suggest_what_jax_suggests(tmp_path, name, seed):
    runs = []
    for module, tag in ((jax_study, "jax"), (study, "port")):
        s = module.Study(str(tmp_path / f"{tag}.db"), sampler=_sampler(module, name, seed))
        s.optimize(_objective, n_trials=8)
        runs.append(s.trials)
    want, got = runs
    assert [t["params"] for t in got] == [t["params"] for t in want]
    assert [t["value"] for t in got] == [t["value"] for t in want]


def test_pruner_decides_as_jax():
    rng = np.random.default_rng(0)
    for eta, min_resource in ((2, 1), (3, 1), (4, 2)):
        mine = study.SuccessiveHalvingPruner(min_resource, eta)
        ref = jax_study.SuccessiveHalvingPruner(min_resource, eta)
        for _ in range(50):
            peers = [[(int(s), float(v)) for s, v in zip(range(1, rng.integers(1, 6)),
                                                         rng.random(5))]
                     for _ in range(int(rng.integers(0, 9)))]
            step, value = int(rng.integers(1, 6)), float(rng.random())
            assert mine.rungs(step) == ref.rungs(step)
            assert mine.should_prune(step, value, peers) == ref.should_prune(step, value, peers)


def test_workers_of_both_packages_share_one_study(tmp_path):
    path = str(tmp_path / "shared.db")
    mine = study.Study(path, sampler=study.HaltonSampler(0),
                       pruner=study.SuccessiveHalvingPruner(1, 2))
    ref = jax_study.Study(path, sampler=jax_study.HaltonSampler(0), load_if_exists=True)

    def reporting(trial):
        v = _objective(trial)
        for step in (1, 2):
            trial.report(v + step, step)
        return v

    mine.optimize(reporting, n_trials=2)
    ref.optimize(reporting, n_trials=2)
    mine.optimize(reporting, n_trials=1)
    assert len(mine.trials) == len(ref.trials) == 5
    assert mine.trials == ref.trials
    assert mine.best_trial == ref.best_trial
    assert mine._observed_units() == ref._observed_units()
    assert [t["trial_id"] for t in mine.trials] == list(range(5))
    assert all(len(t["intermediate"]) == 2 for t in mine.trials)


def test_each_package_reads_the_others_study(tmp_path):
    for writer, reader in ((jax_study, study), (study, jax_study)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.db")
        writer.Study(path, sampler=writer.RandomSampler(5)).optimize(_objective, n_trials=3)
        theirs = reader.Study(path, load_if_exists=True)
        ours = writer.Study(path, load_if_exists=True)
        assert theirs.trials == ours.trials and len(theirs.trials) == 3
        assert theirs.best_trial == ours.best_trial


def test_failed_trial_is_recorded_and_reraised(tmp_path):
    s = study.Study(str(tmp_path / "f.db"))

    def objective(trial):
        trial.suggest_float("x", 0.0, 1.0)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        s.optimize(objective, n_trials=1)
    assert s.trials[0]["state"] == "failed" and "x" in s.trials[0]["params"]
    assert jax_study.Study(str(tmp_path / "f.db")).trials == s.trials


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from sbgm_danra_tpu.data import synthetic as jax_synthetic

    root = str(tmp_path_factory.mktemp("torch_sweep"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    return root


def _base(root):
    d = config_dict(root, data_handling={"device_dataset": True})
    d["training"].update(batch_size=2, learning_rate=1e-3, monitor_extremes=False)
    d["model"] = {"compute_dtype": "float32"}
    return d


class _Tracked:
    """Weak references to every pipeline a trial builds."""

    def __init__(self, monkeypatch, fail_after_init=False):
        from sbgm_danra_tpu_torch.training import pipeline as pl

        self.refs = []
        tracked = self

        class Pipeline(pl.TrainingPipeline):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                tracked.refs.append(weakref.ref(self))
                if fail_after_init:
                    raise ValueError("broken architecture")

        monkeypatch.setattr(pl, "TrainingPipeline", Pipeline)

    def alive(self):
        gc.collect()
        return [r for r in self.refs if r() is not None]


def test_tiny_end_to_end_sweep_releases_each_trial(data, tmp_path, monkeypatch):
    """Two trials through ``run_sweep`` on the CPU: both end (complete or
    pruned), their frozen configs are written, and when each ends its
    pipeline is gone (its model, state, steps and card stacks with it), as
    are the sampler graphs and K1's packs."""
    from sbgm_danra_tpu_torch.ops import fused_conv_gn
    from sbgm_danra_tpu_torch.sampling import graphs

    tracked = _Tracked(monkeypatch)
    alive_at_end = []
    path = tmp_path / "base.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(_base(data), f)
    s = rs.run_sweep(str(path), str(tmp_path / "study.db"), n_trials=2, epochs=1,
                     steps_per_epoch=2, device="cpu",
                     after_trial=lambda trial: alive_at_end.append(len(tracked.alive())))
    assert len(s.trials) == 2 and alive_at_end == [0, 0] and len(tracked.refs) == 2
    assert {t["state"] for t in s.trials} <= {"complete", "pruned"}
    assert all(np.isfinite(t["value"]) for t in s.trials if t["state"] == "complete")
    assert not graphs._caches and not fused_conv_gn._packed
    generated = sorted(os.listdir(tmp_path / "generated"))
    assert generated == ["trial_00000.yaml", "trial_00001.yaml"]
    with open(tmp_path / "generated" / generated[0]) as f:
        dumped = yaml.safe_load(f)
    assert dumped["training"]["learning_rate"] == s.trials[0]["params"]["learning_rate"]
    assert tuple(dumped["sampler"]["block_layers"]) == tuple(s.trials[0]["params"]["block_layers"])


def test_a_broken_architecture_is_pruned_and_released(data, tmp_path, monkeypatch):
    tracked = _Tracked(monkeypatch, fail_after_init=True)
    objective = rs.make_objective(_base(data), epochs=1, steps_per_epoch=1, device="cpu")
    s = study.Study(str(tmp_path / "b.db"))
    s.optimize(objective, n_trials=1)
    assert s.trials[0]["state"] == "pruned" and len(tracked.refs) == 1
    assert not tracked.alive()


def test_main_runs_a_worker(data, tmp_path):
    path = tmp_path / "base.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(_base(data), f)
    storage = str(tmp_path / "m.db")
    s = rs.main(["--config_path", str(path), "--storage", storage, "--n_trials", "1",
                 "--epochs", "1", "--steps_per_epoch", "1", "--device", "cpu"])
    assert len(s.trials) == 1 and len(jax_study.Study(storage).trials) == 1
