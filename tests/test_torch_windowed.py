"""Torch port: the rotating-window card loader (``data/windowed_data.py``)
against the JAX package's ``WindowedDeviceLoader`` on the CPU.

- the window blocks (both layouts, wrap-around) and the epoch schedule (a
  numpy permutation seeded by (seed, epoch), rotated to the resident window)
  equal JAX's for several seeds and layouts;
- window contents are bit-equal to JAX's ``_load_window_host`` in fp32, and
  in bf16 after the host cast (torch's against ``ml_dtypes``': both round to
  nearest even), on the host and in the slot;
- a batch at injected draws ``(day, ox, oy, keep)`` equals JAX's sampler at
  the same draws (the RNG streams differ, F4), in fp32 and bf16, with JAX's
  dtypes: every key equal, the SDF within 1e-6 (fp32) or one bf16 ulp at 1
  (2^-8);
- fixed mode's windows step by step and chunk by chunk, and its swaps, equal
  JAX's over two epochs; swap-on-ready visits every window; the
  ``steps_per_epoch`` budget; a staging failure surfaces;
- one window over the whole split (fp32) gives ``DeviceDataLoader``'s batches
  and chunk draws bit for bit;
- the factory builds it for ``device_window_days > 0``;
- ``TrainingPipeline`` with ``fused_steps = 2`` over fixed windows, two epochs
  with swaps between chunks, trains what the one-step route trains, bit for
  bit.

One synthetic dataset (the JAX generator, 64x96, 12 days: 8 train days, 3
windows of 3) serves the module; JAX's sampler is compiled twice (fp32 and
bf16); no other JAX loader samples.
"""

import copy

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.data import factory as jax_factory
from sbgm_danra_tpu.data import synthetic as jax_synthetic
from sbgm_danra_tpu.data.windowed_data import WindowedDeviceLoader as JaxWindowed
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.data import device_data as dd
from sbgm_danra_tpu_torch.data import factory
from sbgm_danra_tpu_torch.data.windowed_data import WindowedDeviceLoader
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline
from tests.test_torch_data import config_dict, spec_for
from tests.test_torch_device_data import BATCH, DROP, KEYS, jax_draws
from tests.test_torch_training import TRAIN
from tests.torch_parity import one_thread  # noqa: F401 (a module fixture)

WINDOW = 3


@pytest.fixture(autouse=True)
def _onednn_off():
    """oneDNN corrupts the heap in the tiny UNet's training backward on this
    CPU (ROADMAP F5)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="session", autouse=True)
def _first_sqrt():
    """This CPU build's first float32 ``torch.sqrt`` of a process, on several
    threads at once, returns ~12-bit results in some elements (ROADMAP F14, a
    test-environment fault like F5; the card computes its own sqrt): one call
    first, so that the SDF comparisons below see the exact sqrt. Session
    scope: it runs before the module's switch to one thread (``one_thread``)."""
    torch.sqrt(torch.rand(16, 32, 32))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_windowed"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    d = config_dict(root, data_handling={"device_dataset": True},
                    classifier_free_guidance={"drop_prob": DROP})
    return dict(root=root, cfg=d)


def _pair(env, jax_dtype=jnp.float32, dtype=torch.float32, **kw):
    """A JAX loader and the port's (on the CPU) over the same train split."""
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("window_days", WINDOW)
    kw.setdefault("cfg_dropout_prob", DROP)
    ref = JaxWindowed(jax_factory.make_dataset(jax_from_dict(env["cfg"]), "train"),
                      dtype=jax_dtype, **kw)
    mine = WindowedDeviceLoader(factory.make_dataset(from_dict(env["cfg"]), "train"),
                                dtype=dtype, device="cpu", **kw)
    return ref, mine


@pytest.mark.parametrize("seed,layout", [(0, "consecutive"), (7, "consecutive"),
                                         (0, "strided"), (3, "strided")])
def test_blocks_and_schedule_equal_jax(env, seed, layout):
    ref, mine = _pair(env, seed=seed, layout=layout)
    assert (mine.n_windows, mine.window_days, mine.dates) == (3, WINDOW, ref.dates)
    for b in range(mine.n_windows):
        assert mine._block_dates(b) == ref._block_dates(b)
    assert sorted(d for b in range(3) for d in mine._block_dates(b))[0] == ref.dates[0]
    for epoch in range(4):
        assert mine._schedule(epoch) == ref._schedule(epoch)
    if layout == "consecutive":  # the tail window wraps to the start
        assert mine._block_dates(2) == [*ref.dates[6:8], ref.dates[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_contents_bit_equal_jax(env, dtype):
    """Each block's host window and its slot against JAX's host load, cast
    to the staging dtype as JAX's upload casts it (numpy with ml_dtypes)."""
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ref, mine = _pair(env, jax_dtype=jnp.dtype(dtype), dtype=getattr(torch, dtype))
    bits = np.int16 if dtype == "bfloat16" else np.int32
    for block in range(mine.n_windows):
        hr, lr, classes = ref._load_window_host(block)
        fields, got_classes = mine._load_window_host(block)
        want = np.concatenate([hr[..., None], lr], axis=-1).astype(np_dtype)
        got = fields.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
        assert np.array_equal(got, want.view(bits)), block
        assert np.array_equal(got_classes.numpy(), classes)
    slot = mine.buffers()[0]
    assert slot.dtype == getattr(torch, dtype) and mine.current_block == 0
    hr, lr, _ = ref._load_window_host(0)
    want = np.concatenate([hr[..., None], lr], axis=-1).astype(np_dtype).view(bits)
    assert np.array_equal(slot.view(torch.int16 if dtype == "bfloat16" else torch.int32)
                          .numpy(), want)
    statics = mine.buffers()[1].float().numpy()
    assert np.array_equal(statics[..., 0], np.asarray(ref._lsm, np.float32))
    assert np.array_equal(statics[..., 1], np.asarray(ref._topo, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_at_injected_draws_equals_jax(env, dtype):
    ref, mine = _pair(env, jax_dtype=jnp.dtype(dtype), dtype=getattr(torch, dtype))
    key = jax.random.PRNGKey(5)
    want = {k: np.asarray(v) for k, v in ref.sample(key).items()}
    draws = jax_draws(key, WINDOW)
    got = mine.sample_from(*draws)
    assert sorted(got) == sorted(want)
    assert 0 < int(draws[3].sum()) < BATCH  # kept and dropped samples
    for k in KEYS:
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        w = want[k].astype(np.float32) if want[k].dtype == ml_dtypes.bfloat16 else want[k]
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert np.array_equal(g, w), k
    sdf_err = np.abs(got["sdf"].float().numpy() - want["sdf"].astype(np.float32)).max()
    assert str(got["sdf"].dtype).split(".")[-1] == str(want["sdf"].dtype)
    assert sdf_err <= (2.0 ** -8 if dtype == "bfloat16" else 1e-6)


def _walk(loader, jax_side: bool, chunks: int = 0):
    """The block each step (or chunk) of one epoch ran on."""
    if jax_side:
        loader.sample = lambda key: None  # the schedule only: no JAX sampler compile
        current = lambda: loader._current.block  # noqa: E731
    else:
        current = lambda: loader.current_block  # noqa: E731
    if chunks:
        return [current() for _ in loader.iter_chunks(chunks)]
    return [current() for _ in loader]


def test_fixed_mode_windows_and_swaps_equal_jax(env):
    ref, mine = _pair(env, batch_size=2, window_steps=2, seed=5)
    for epoch in range(2):
        want, got = _walk(ref, True), _walk(mine, False)
        assert got == want and len(got) == len(mine) == 6
        assert sorted(set(got)) == [0, 1, 2]
        assert mine.n_swaps == ref.n_swaps == 2 * (epoch + 1)  # n_windows - 1 an epoch
    for epoch in range(2):  # chunks of 3 steps: ceil(2 / 3) = 1 chunk a window
        want, got = _walk(ref, True, chunks=3), _walk(mine, False, chunks=3)
        assert got == want and len(got) == 3
    assert mine.n_swaps == ref.n_swaps == 8 and mine.epoch == ref.epoch == 4


def test_swap_on_ready_visits_every_window(env):
    _, mine = _pair(env, batch_size=2, min_window_steps=1)
    blocks = _walk(mine, False)
    assert sorted(set(blocks)) == [0, 1, 2] and len(blocks) >= 3
    assert mine.n_swaps == 2 and mine.epoch == 1 and mine.stall_s >= 0.0
    chunked = _walk(mine, False, chunks=2)
    assert sorted(set(chunked)) == [0, 1, 2] and mine.n_swaps == 4
    assert len(mine.load_s) == 1 + 4  # the first window, then one a swap


def test_steps_per_epoch_budget_and_staging_failure(env):
    _, mine = _pair(env, batch_size=2, window_steps=4, steps_per_epoch=5)
    assert len(mine) == 5 and len(_walk(mine, False)) == 5
    assert len(_walk(mine, False, chunks=2)) == 3  # ceil(5 / 2) chunks

    def boom(block):
        raise OSError("disk gone")

    mine._load_window_host = boom
    with pytest.raises(RuntimeError, match="window staging failed") as info:
        for _ in mine:
            pass
    assert isinstance(info.value.__cause__, OSError)


def test_one_window_over_the_split_equals_the_resident_loader(env):
    cfg = from_dict(env["cfg"])
    resident = dd.DeviceDataLoader(factory.make_dataset(cfg, "train"), 4, steps_per_epoch=3,
                                   seed=2, cfg_dropout_prob=DROP, device="cpu")
    windowed = WindowedDeviceLoader(factory.make_dataset(cfg, "train"), 4, window_days=999,
                                    steps_per_epoch=3, seed=2, cfg_dropout_prob=DROP,
                                    device="cpu")
    assert windowed.n_windows == 1 and windowed.window_days == 8
    for loader in (resident, windowed):
        loader.set_epoch(1)
    a, b = list(resident), list(windowed)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(s, w) for s, w in zip(resident.buffers(), windowed.buffers()))
    for (_, d1), (_, d2) in zip(resident.iter_chunks(3), windowed.iter_chunks(3)):
        assert all(torch.equal(p, q) for p, q in zip(d1, d2))


def test_factory_builds_the_windowed_train_loader(env):
    d = copy.deepcopy(env["cfg"])
    d["data_handling"].update(device_window_days=WINDOW, device_window_steps=2)
    train, valid, _ = factory.make_loaders(from_dict(d), device="cpu")
    assert isinstance(train, WindowedDeviceLoader) and isinstance(valid, dd.DeviceDataLoader)
    assert train.buffers()[0].dtype == torch.bfloat16  # device_window_dtype's default
    assert train.window_steps == 2 and train.layout == "consecutive"
    batch = next(iter(train))
    assert batch["x"].dtype == torch.bfloat16 and batch["y"].dtype == torch.int32
    d["data_handling"]["device_window_dtype"] = "float16"
    with pytest.raises(ValueError, match="device_window_dtype"):
        factory.make_loaders(from_dict(d), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            WindowedDeviceLoader(factory.make_dataset(from_dict(env["cfg"]), "train"), 2,
                                 window_days=WINDOW, device="cuda")


def test_fused_pipeline_across_swaps_equals_the_one_step_route(env):
    """Two epochs of 3 fixed windows x 2 steps: the fused route (K = 2, one
    chunk a window, a swap between chunks) and the one-step route from the
    same seed give the same losses, weights, EMA and step, bit for bit."""
    runs = {}
    for fused in (0, 2):
        d = copy.deepcopy(env["cfg"])
        d["data_handling"].update(device_window_days=WINDOW, device_window_steps=2,
                                  device_window_dtype="float32")
        d["training"] = {**d["training"], **TRAIN, "batch_size": 2, "fused_steps": fused,
                         "steps_per_epoch": None, "epochs": 2}
        cfg = from_dict(d)
        train, _, _ = factory.make_loaders(cfg, device="cpu")
        pipe = TrainingPipeline(cfg, train, device="cpu")
        history = pipe.train()
        runs[fused] = (history["train_loss"], pipe.state.step, train.n_swaps,
                       {k: v.clone() for k, v in pipe.model.state_dict().items()},
                       {k: v.clone() for k, v in pipe.state.ema_params.items()})
    (l0, s0, n0, w0, e0), (l2, s2, n2, w2, e2) = runs[0], runs[2]
    assert s0 == s2 == 12 and n0 == n2 == 4
    assert l0 == l2 and all(np.isfinite(l0))
    assert all(torch.equal(w0[k], w2[k]) for k in w0)
    assert all(torch.equal(e0[k], e2[k]) for k in e0)
