"""Torch port: tracing and throughput instrumentation
(sbgm_danra_tpu_torch/utils/profiling.py, ``training.profile_dir`` in
``TrainingPipeline.train_batches``) against the JAX package's
``utils/profiling.py`` and ``training/pipeline.py:217-237``.

``StepTimer`` runs on the same fake clock in both packages and must give the
same numbers. A 2-step epoch of a tiny UNet on the CPU with ``profile_dir``
writes a Chrome trace there and logs the throughput line; without it nothing
is written.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from sbgm_danra_tpu.utils import profiling as jax_profiling
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from sbgm_danra_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after): the suite's
    workers share the cores (see ``tests/test_torch_windowed.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    """``time.perf_counter`` stepping through fixed increments."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


DURATIONS = [0.0, 0.5, 0.25, 0.125, 1.0, 0.75, 0.3]


@pytest.mark.parametrize("window", [50, 3])
def test_step_timer_matches_jax(monkeypatch, window):
    out = []
    for module in (jax_profiling, profiling):
        monkeypatch.setattr(module.time, "perf_counter", FakeClock(DURATIONS))
        timer = module.StepTimer(window=window)
        ticks = [timer.tick() for _ in DURATIONS]
        out.append((ticks, list(timer.durations), timer.steps_per_sec, timer.items_per_sec(16)))
        timer.reset()
        out[-1] += (timer.tick(),)
        monkeypatch.undo()
    assert out[0] == out[1]
    assert out[1][0][0] is None and out[1][2] > 0


def test_step_timer_empty_matches_jax():
    for module in (jax_profiling, profiling):
        timer = module.StepTimer()
        assert timer.steps_per_sec == 0.0 and timer.items_per_sec(8) == 0.0


def test_trace_off_is_a_no_op(tmp_path):
    with profiling.trace("", "cpu") as path:
        pass
    assert path is None and not os.listdir(tmp_path)


def test_config_reader_keeps_profile_dir():
    assert from_dict({}).training.profile_dir == ""
    assert from_dict({"training": {"profile_dir": "/runs/p"}}).training.profile_dir == "/runs/p"


def _pipeline(profile_dir: str) -> TrainingPipeline:
    cfg = from_dict({
        "highres": {"variable": "temp", "data_size": [32, 32]},
        "lowres": {"condition_variables": ["temp"]},
        "sampler": {"time_embedding": 32, "last_fmap_channels": 64, "num_heads": 2,
                    "block_layers": [1, 1, 1, 1]},
        "training": {"learning_rate": 1e-3, "batch_size": 2, "monitor_extremes": False,
                     "profile_dir": profile_dir},
        "stationary_conditions": {"seasonal_conditions": {"sample_w_cond_season": False}},
    })
    rng = np.random.default_rng(0)

    def field(c):
        return rng.normal(size=(2, 32, 32, c)).astype(np.float32)

    train = [{"x": field(1), "sdf": np.abs(field(1)), "cond_img": field(1),
              "lsm_cond": field(2), "topo_cond": field(2)} for _ in range(2)]
    return TrainingPipeline(cfg, train, device="cpu")


def test_epoch_zero_trace_and_throughput(tmp_path, caplog, monkeypatch):
    """Epoch 0 with ``profile_dir``: one Chrome trace holding the steps' ops,
    the path logged, and the throughput line; epoch 1 is not traced. Without
    ``profile_dir`` nothing is written and the throughput line is logged."""
    trace_dir = tmp_path / "trace"
    pipe = _pipeline(str(trace_dir))
    with caplog.at_level(logging.INFO):
        loss = pipe.train_batches(2)
    files = glob.glob(str(trace_dir / "*.json"))
    assert np.isfinite(loss) and len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)
    messages = [r.getMessage() for r in caplog.records]
    assert f"profiler trace written to {files[0]}" in messages
    assert any(m.startswith("epoch 0 throughput: ") and m.endswith(" samples/s)")
               for m in messages)
    pipe.epoch = 1
    pipe.train_batches(2)
    assert len(glob.glob(str(trace_dir / "*.json"))) == 1

    plain = _pipeline("")
    plain_dir = tmp_path / "plain"
    plain_dir.mkdir()
    monkeypatch.chdir(plain_dir)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        plain.train_batches(2)
    assert not os.listdir(plain_dir)
    assert any(r.getMessage().startswith("epoch 0 throughput: ") for r in caplog.records)
    assert not any("profiler trace" in r.getMessage() for r in caplog.records)
