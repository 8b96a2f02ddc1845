"""Torch port: the program's spans (``utils/profiling.span``) on the CPU.

With no profiler on, a span makes no ``RecordFunction``. Under a
``torch.profiler`` of every thread, a tiny eager ``InferenceEngine`` records
one ``serve.queued`` per request on the callers' threads, its dispatches'
children inside ``serve.dispatch``, and ``serve.idle`` while it waits; a
fused epoch records a ``train.chunk`` per chunk with its draw, replay and
sync; ``sample_full_domain`` records ``domain.field`` with its children. A
profiler changes no result.
"""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.data import factory, synthetic
from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.serve import InferenceEngine, ServeSettings
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from sbgm_danra_tpu_torch.utils import profiling
from tests.test_torch_data import config_dict, spec_for
from tests.torch_parity import TINY, one_thread  # noqa: F401 (a module fixture)

HW = (32, 32)
SETTINGS = ServeSettings(spec=ModelSpec(**TINY), sampler_type="dpmpp_sampler",
                         sampler=SamplerConfig(num_steps=2, guidance_scale=3.0), sample_hw=HW,
                         n_lr=2, model_string="tiny")
DOMAIN = (40, 50)  # padded to 64x64


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def engine():
    weights = build_score_model(SETTINGS.spec, generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(SETTINGS, weights.state_dict(), device="cpu", max_members=4)
    eng.warmup()
    yield eng
    eng.close()


def every_thread():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def spans(prof):
    """The recorded spans: (name less the prefix, start ns, end ns, thread)."""
    out = [(e.name()[len(profiling.SPAN_PREFIX):], e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda s: s[1])


def named(recorded, *names):
    return [s for s in recorded if s[0] in names]


def inside(child, parents):
    return [p for p in parents if p[1] <= child[1] and child[2] <= p[2] and p[3] == child[3]]


def conditions(seed):
    rng = np.random.default_rng(seed)
    return {"y": np.int64(seed % 4), "cond_img": rng.normal(size=(*HW, 2)).astype(np.float32),
            "lsm_cond": np.ones((*HW, 2), np.float32),
            "topo_cond": np.zeros((*HW, 2), np.float32)}


def requests(eng, members=(1, 2, 1)):
    """Concurrent requests, one caller thread each; their fields by request."""
    out = [None] * len(members)

    def call(i):
        out[i] = eng.generate(conditions(i), n_members=members[i], seed=10 + i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(members))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def exact_score(x, t, cond_img=None, **_):
    """A closed-form score: no model, so the field costs a few milliseconds."""
    mean = 0.0 if cond_img is None else 0.1 * cond_img[..., :1]
    return -(x - mean) / (1.0 + t.reshape(-1, 1, 1, 1) ** 2)


def domain_field(seed):
    rng = np.random.default_rng(seed)
    cond = {"cond_img": torch.from_numpy(rng.normal(size=(1, *DOMAIN, 2)).astype(np.float32)),
            "lsm_cond": torch.ones(1, *DOMAIN, 2)}
    return sample_full_domain(exact_score, torch.Generator().manual_seed(seed), cond,
                              domain_hw=DOMAIN, config=SamplerConfig(num_steps=3),
                              sampler="dpmpp_sampler")


class Raises:
    def __init__(self, name):
        raise AssertionError(f"a RecordFunction ({name}) with no profiler on")


@pytest.mark.parametrize("path", ["span", "engine", "full_domain"])
def test_no_profiler_makes_no_record_function(monkeypatch, engine, path):
    monkeypatch.setattr(profiling, "record_function", Raises)
    assert not profiling.recording()
    if path == "span":
        with profiling.span("x") as entered:
            assert entered is None
    elif path == "engine":
        assert [o.shape for o in requests(engine)] == [(1, *HW), (2, *HW), (1, *HW)]
    else:
        assert domain_field(0).shape == (1, *DOMAIN)


def test_span_records_a_prefixed_range_under_a_profiler():
    with every_thread() as prof:
        assert profiling.recording()
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(3).add_(1)
    got = spans(prof)
    assert [s[0] for s in got] == ["outer", "inner"] and inside(got[1], got[:1])
    assert not profiling.recording()


def test_engine_spans(engine):
    """Three concurrent requests: a ``serve.queued`` each on its caller's
    thread, every child of a dispatch inside one ``serve.dispatch`` on the
    dispatcher's thread, and a wait for arrivals as ``serve.idle``."""
    members = (1, 2, 1)
    before = engine.n_dispatches
    with every_thread() as prof:
        requests(engine, members)
        requests(engine, (3,))  # the dispatcher waited for this one
    got = spans(prof)
    queued = named(got, "serve.queued")
    dispatches = named(got, "serve.dispatch")
    assert len(queued) == len(members) + 1
    assert len(dispatches) == engine.n_dispatches - before >= 2
    dispatcher = {d[3] for d in dispatches}
    assert len(dispatcher) == 1 and not dispatcher & {q[3] for q in queued}
    children = named(got, "serve.pack", "serve.sync", "serve.fetch", "sample.inputs",
                     "sample.replay")
    assert len(children) == 3 * len(dispatches)  # eager on the CPU: no sampler spans
    assert all(len(inside(c, dispatches)) == 1 for c in children)
    for d in dispatches:
        assert [c[0] for c in children if inside(c, [d])] == \
            ["serve.pack", "serve.sync", "serve.fetch"]
    idle = named(got, "serve.idle")
    assert idle and {i[3] for i in idle} == dispatcher
    assert not any(inside(i, dispatches) for i in idle)


def test_fused_epoch_spans(tmp_path):
    """A fused epoch of 2 chunks of 2 steps: a ``train.chunk`` each with its
    draw, replay and sync, in that order, and the epoch's end (the loader's
    last draw) as a chunk that holds only a draw."""
    root = str(tmp_path)
    synthetic.generate(spec_for(synthetic.SyntheticSpec, root))
    cfg = from_dict(config_dict(root, data_handling={"device_dataset": True},
                                training={"batch_size": 2, "fused_steps": 2,
                                          "steps_per_epoch": 4, "weight_init": False}))
    train, _, _ = factory.make_loaders(cfg, device="cpu")
    pipe = TrainingPipeline(cfg, train, device="cpu")
    with every_thread() as prof:
        loss = pipe.train_batches()
    assert np.isfinite(loss) and pipe.state.step == 4
    got = spans(prof)
    chunks = named(got, "train.chunk")
    assert len(chunks) == 3
    for chunk in chunks[:2]:
        assert [s[0] for s in got if s is not chunk and inside(s, [chunk])] == \
            ["train.draw", "train.replay", "train.sync"]
    assert [s[0] for s in got if s is not chunks[2] and inside(s, chunks[2:])] == ["train.draw"]


def test_full_domain_spans():
    with every_thread() as prof:
        domain_field(1)
    got = spans(prof)
    field = named(got, "domain.field")
    assert len(field) == 1
    assert [s[0] for s in got if s is not field[0] and inside(s, field)] == \
        ["domain.pad", "domain.sync", "domain.fetch"]


@pytest.mark.parametrize("path", ["engine", "full_domain"])
def test_profiler_changes_no_result(engine, path):
    def run():
        return requests(engine) if path == "engine" else [domain_field(2)]

    plain = run()
    with every_thread():
        traced = run()
    assert len(plain) == len(traced)
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced))


def test_trace_records_every_thread(tmp_path, engine):
    """``profiling.trace`` around a serving engine: the callers' and the
    dispatcher's spans are in the Chrome trace."""
    with profiling.trace(str(tmp_path), "cpu") as path:
        requests(engine, (2,))
    assert glob.glob(str(tmp_path / "*.json")) == [path]
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"sbgm:serve.queued", "sbgm:serve.dispatch", "sbgm:serve.fetch"} <= names
