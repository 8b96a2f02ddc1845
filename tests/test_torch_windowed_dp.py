"""Torch port: day-sharded data-parallel sampling (``parallel/windowed_dp.py``)
on two gloo CPU ranks, with the properties ``tests/test_windowed_dp.py`` pins
for the JAX package: the day stacks sharded and the static maps replicated,
a day count trimmed and too few days rejected, the global batch's shape and
each rank's rows from its own days, ranks drawing independent days, the
classifier matching the day, the batch required to divide; each rank's batch
function at local dims against JAX's ``make_sample_fn`` on the same draws;
and one step of a windowed loader's window, day-sharded, through the
data-parallel train step.

One launch of two processes (``tests/torch_parallel_cases.py``'s
``windowed_module``) does every check; JAX's sampler runs here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbgm_danra_tpu.data import synthetic as jax_synthetic
from sbgm_danra_tpu.data.device_data import make_sample_fn as jax_make_sample_fn
from sbgm_danra_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sbgm_danra_tpu.parallel.windowed_dp import day_sharded_buffers as jax_day_sharded
from sbgm_danra_tpu.parallel.windowed_dp import make_dp_batch_sampler as jax_dp_sampler
from sbgm_danra_tpu_torch.parallel.launch import spawn
from tests.test_torch_data import config_dict, spec_for

D, H, W = 32, 24, 24
CROP = (8, 8)
B = 16  # global batch: 8 rows a rank
LOCAL_DAYS, LOCAL_B = D // 2, B // 2


def _toy():
    """fields[d, ..., 0] == d everywhere: a crop's value is its source day."""
    hr = np.broadcast_to(np.arange(D, dtype=np.float32)[:, None, None], (D, H, W))
    rng = np.random.default_rng(0)
    lr = rng.normal(size=(D, H, W, 2)).astype(np.float32)
    lsm = (rng.random((H, W)) > 0.5).astype(np.float32)
    topo = rng.normal(size=(H, W)).astype(np.float32)
    classifier = (np.arange(D) % 4 + 1).astype(np.int32)
    return hr, lr, lsm, topo, classifier


def _jax_local_draws(key):
    """The draws JAX's make_sample_fn makes from ``key`` at local dims."""
    kd, kx, ky, _ = jax.random.split(key, 4)
    day = jax.random.randint(kd, (LOCAL_B,), 0, LOCAL_DAYS)
    ox = jax.random.randint(kx, (LOCAL_B,), 0, H - CROP[0] + 1)
    oy = jax.random.randint(ky, (LOCAL_B,), 0, W - CROP[1] + 1)
    keep = np.ones((LOCAL_B,), np.float32)
    return [np.array(day), np.array(ox), np.array(oy), keep]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    hr, lr, lsm, topo, classifier = _toy()
    fields = np.concatenate([hr[..., None], lr], axis=-1)
    statics = np.stack([lsm, topo], axis=-1)
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), r) for r in range(2)]
    root = str(tmp_path_factory.mktemp("torch_windowed_dp"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    step_cfg = config_dict(root, data_handling={"device_dataset": True},
                           training={"batch_size": 8, "learning_rate": 1e-3})
    payload = dict(toy=(fields, statics, classifier), crop=CROP, batch=B,
                   local_draws=[_jax_local_draws(k) for k in keys], step={"cfg": step_cfg})
    ranks = spawn("tests.torch_parallel_cases:windowed_module", 2, payload, backend="gloo",
                  device="cpu", timeout=300)
    return dict(ranks=ranks, keys=keys, toy=(hr, lr, lsm, topo, classifier))


def test_buffers_shard_and_replicate(env):
    for r in env["ranks"]:
        assert r["shapes"] == ((LOCAL_DAYS, H, W, 3), (H, W, 2), (LOCAL_DAYS,))
        assert r["statics_same"]


def test_nondivisible_days_trimmed_and_too_few_rejected(env, devices):
    """29 days over 2 ranks: 28 kept, 14 a rank (JAX: 24 over 8 devices); one
    day for two ranks raises, as JAX's "at least"."""
    hr, lr, lsm, topo, classifier = env["toy"]
    jax_trim = jax_day_sharded((hr[:29], lr[:29], lsm, topo, classifier[:29]),
                               jax_make_mesh({"data": 8}))
    assert jax_trim[0].shape[0] == 24
    for r in env["ranks"]:
        assert r["trimmed_days"] == 14
        assert "at least 2 days" in r["few_days_error"]


def test_global_batch_shape_and_rows_from_local_days(env):
    """Each rank draws its 8 of the 16 rows from its own days [16 r, 16 r + 16)."""
    for rank, r in enumerate(env["ranks"]):
        x = r["batch"]["x"].numpy()
        assert x.shape == (LOCAL_B, *CROP, 1) and r["batch"]["y"].shape == (LOCAL_B,)
        days = x[:, 0, 0, 0].astype(int)
        assert (days >= rank * LOCAL_DAYS).all() and (days < (rank + 1) * LOCAL_DAYS).all()


def test_ranks_draw_independent_days(env):
    local = [tuple(r["batch"]["x"].numpy()[:, 0, 0, 0].astype(int) % LOCAL_DAYS)
             for r in env["ranks"]]
    assert local[0] != local[1]
    step1 = tuple(env["ranks"][0]["batch_step1"]["x"].numpy()[:, 0, 0, 0].astype(int))
    assert step1 != tuple(env["ranks"][0]["batch"]["x"].numpy()[:, 0, 0, 0].astype(int))


def test_classifier_matches_sampled_day(env):
    for r in env["ranks"]:
        days = r["batch"]["x"].numpy()[:, 0, 0, 0].astype(int)
        np.testing.assert_array_equal(r["batch"]["y"].numpy(), days % 4 + 1)


def test_global_batch_must_divide(env, devices):
    for r in env["ranks"]:
        assert "devices" in r["odd_batch_error"]
    with pytest.raises(ValueError, match="devices"):
        jax_dp_sampler(jax_make_mesh({"data": 8}), D, (H, W), 2, CROP, None, 12)


def test_local_batch_function_matches_jax_make_sample_fn(env):
    """Each rank's batch function on its day shard, at JAX's draws, equals
    JAX's per-device body (make_sample_fn at local dims) on the same shard
    and key: every key equal."""
    hr, lr, lsm, topo, classifier = env["toy"]
    fn = jax_make_sample_fn(LOCAL_DAYS, (H, W), 2, CROP, None, LOCAL_B, with_sdf=False)
    for rank, r in enumerate(env["ranks"]):
        days = slice(rank * LOCAL_DAYS, (rank + 1) * LOCAL_DAYS)
        want = fn(env["keys"][rank], *map(jnp.asarray, (hr[days], lr[days], lsm, topo,
                                                         classifier[days])))
        got = r["from_draws"]
        for key in ("x", "cond_img", "lsm_cond", "topo_cond", "y"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_windowed_buffers_through_the_dp_train_step(env):
    """The windowed loader's window (8 train days), day-sharded (4 a rank),
    sampled per rank (4 rows each) and fed to the data-parallel step: a
    finite global loss and the same parameters on both ranks."""
    a, b = (r["step"] for r in env["ranks"])
    assert a["window_days"] == 8 and a["local_days"] == 4 and a["rows"] == 4
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert np.array_equal(a["first_param"].numpy(), b["first_param"].numpy())
