"""Torch port: the card-resident data path against the JAX package's on the CPU.

The stacks, the batched jump-flood SDF (within 1e-6 of JAX's
``generate_sdf_device``, within 1e-4 of the host EDT: JAX's own bound), the
batch sampler fed JAX's draws (every key ``array_equal`` to JAX's batch, the
SDF within 1e-6), the loader's epochs, its refusals, and the DSM loss of the
tiny bridged UNet on the first device-loader batch with JAX's t and z
(within rtol 1e-5). One tiny synthetic dataset (64x96 grid, 12 days, 32x32
crops, written by the JAX generator) and one compiled JAX sampler serve the
module.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu import sde as jax_sde
from sbgm_danra_tpu.config import from_dict as jax_from_dict
from sbgm_danra_tpu.data import device_data as jax_dd
from sbgm_danra_tpu.data import factory as jax_factory
from sbgm_danra_tpu.data import synthetic as jax_synthetic
from sbgm_danra_tpu.ops.sdf import generate_sdf_device as jax_sdf_device
from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.data import device_data as dd
from sbgm_danra_tpu_torch.data import factory
from sbgm_danra_tpu_torch.ops.sdf import generate_sdf_device, jump_flood_neighbours, sdf_from_mask
from sbgm_danra_tpu_torch.sde import VESDE, dsm_loss
from tests.test_torch_data import CROP_REGION, config_dict, spec_for
from tests.test_torch_training import _jax_draws
from tests.torch_parity import TINY, jax_model_and_variables, torch_model

BATCH = 16
DROP = 0.5  # CFG dropout here, so that both kept and dropped samples are drawn
KEYS = ("x", "cond_img", "lsm_cond", "topo_cond", "y", "lsm_hr")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The data, both packages' train datasets and stacks, and JAX's compiled
    sampler at batch 16."""
    root = str(tmp_path_factory.mktemp("torch_device_data"))
    jax_synthetic.generate(spec_for(jax_synthetic.SyntheticSpec, root))
    d = config_dict(root, data_handling={"device_dataset": True},
                    classifier_free_guidance={"drop_prob": DROP})
    ref_ds = jax_factory.make_dataset(jax_from_dict(d), "train")
    ref_stacks = jax_dd.build_device_stacks(ref_ds)
    sampler = jax_dd.make_batch_sampler(ref_stacks, (32, 32), CROP_REGION, BATCH,
                                        cfg_dropout_prob=DROP)
    loader = dd.DeviceDataLoader(factory.make_dataset(from_dict(d), "train"), BATCH,
                                 cfg_dropout_prob=DROP, device="cpu")
    return dict(root=root, cfg=d, ref_stacks=ref_stacks, sampler=sampler, loader=loader)


def jax_draws(key, n_days, batch=BATCH, p=DROP):
    """The draws of ``sbgm_danra_tpu/data/device_data.py`` sample() from ``key``."""
    x1, x2, y1, y2 = CROP_REGION
    kd, kx, ky, kdrop = jax.random.split(key, 4)
    day = jax.random.randint(kd, (batch,), 0, n_days)
    ox = x1 + jax.random.randint(kx, (batch,), 0, x2 - x1 - 32 + 1)
    oy = y1 + jax.random.randint(ky, (batch,), 0, y2 - y1 - 32 + 1)
    keep = (jax.random.uniform(kdrop, (batch,)) >= p).astype(jnp.float32)
    return [torch.from_numpy(np.array(a)) for a in (day, ox, oy, keep)]


def test_stacks_match_jax(env):
    mine, ref = env["loader"].stacks, env["ref_stacks"]
    assert mine.dates == ref.dates and mine.lr_names == ref.lr_names
    f, st = mine.fields, mine.statics
    for got, want in ((f[..., 0], ref.hr), (f[..., 1:], ref.lr), (st[..., 0], ref.lsm),
                      (st[..., 1], ref.topo), (mine.classifier, ref.classifier)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert mine.nbytes() == ref.nbytes()


@pytest.fixture(scope="module")
def masks(env):
    """Random blobs, the synthetic lsm's crops, all land and all sea, with
    JAX's jump flood of each (one compiled call per shape)."""
    rng = np.random.default_rng(4)
    lsm = env["loader"].stacks.statics[..., 0].numpy()
    square = {
        "blobs_32x32": (rng.random((6, 32, 32)) > 0.6).astype(np.float32),
        "sparse_blobs_32x32": (rng.random((4, 32, 32)) > 0.97).astype(np.float32),
        "lsm_crops": np.stack([lsm[x:x + 32, y:y + 32]
                               for x, y in ((8, 16), (24, 48), (20, 30), (0, 0), (32, 64))]),
        "all_land": np.ones((2, 32, 32), np.float32),
        "all_sea": np.zeros((2, 32, 32), np.float32),
    }
    odd = {"blobs_13x21": (rng.random((3, 13, 21)) > 0.7).astype(np.float32)}
    flood = jax.jit(jax.vmap(jax_sdf_device))
    cases = {}
    for group in (square, odd):
        out, at = np.asarray(flood(np.concatenate(list(group.values())))), 0
        for name, m in group.items():
            cases[name] = (m, out[at:at + len(m)])
            at += len(m)
    return cases


@pytest.mark.parametrize("case", ["blobs_32x32", "sparse_blobs_32x32", "blobs_13x21",
                                  "lsm_crops", "all_land", "all_sea"])
def test_batched_jump_flood_matches_jax_and_the_edt(masks, case):
    """All masks in one call: within 1e-6 of JAX's jump flood (it is the same
    arithmetic), within 1e-4 of the host EDT (JAX's bound). An all-sea mask is
    all zeros on both devices' floods; scipy's EDT has no seed there and
    measures from a phantom one, so the host SDF is not zero (both packages)."""
    masks, want = masks[case]
    got = generate_sdf_device(torch.from_numpy(masks)).numpy()
    assert got.shape == masks.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    if case == "all_sea":
        assert not got.any()
        return
    host = np.stack([sdf_from_mask(m) for m in masks])
    assert np.abs(got - host).max() <= 1e-4


def test_jump_flood_schedule():
    """JAX's 11 rounds of 8 neighbours at 128x128; the round of step 128
    reaches past the field and is not computed."""
    assert len(jump_flood_neighbours(128, 128)) == 10 * 8
    assert len(jump_flood_neighbours(24, 24)) == 8 * 8
    assert len(jump_flood_neighbours(13, 21)) == 7 * 8 + 2  # step 16: only (0, +-16)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_matches_jax_with_jax_draws(env, seed):
    key = jax.random.PRNGKey(seed)
    want = {k: np.asarray(v) for k, v in env["sampler"](key).items()}
    got = env["loader"].sample_from(*jax_draws(key, env["loader"].stacks.n_days))
    assert sorted(got) == sorted(want)
    for k in KEYS:
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert np.abs(got["sdf"].numpy() - want["sdf"]).max() <= 1e-6
    keep = jax_draws(key, env["loader"].stacks.n_days)[3]
    assert 0 < int(keep.sum()) < BATCH  # both branches of CFG dropout are in the batch


def test_loader_draws_epochs_and_windows(env):
    loader = env["loader"]
    x1, x2, y1, y2 = CROP_REGION
    day, ox, oy, keep = loader.draws(torch.Generator().manual_seed(0))
    assert day.max() < loader.stacks.n_days and day.min() >= 0
    assert ox.min() >= x1 and ox.max() <= x2 - 32 and oy.min() >= y1 and oy.max() <= y2 - 32
    assert set(keep.tolist()) <= {0.0, 1.0}
    assert len(loader) == 1  # 8 train days // batch 16, at least one
    loader.set_epoch(3)
    a = list(loader)
    loader.set_epoch(3)
    b = list(loader)
    c = list(loader)  # epoch 4
    assert loader.epoch == 5
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert not torch.equal(a[0]["x"], c[0]["x"])


def test_refusals_and_sdf_gate(env):
    d = env["cfg"]
    ds = factory.make_dataset(from_dict(d), "train")
    ds.resize_factor = 2
    with pytest.raises(ValueError, match="resize_factor"):
        dd.build_device_stacks(ds, "cpu")
    windowed = config_dict(env["root"], lowres={"data_size": [32, 32],
                                                "cutout_domains": list(CROP_REGION)})
    with pytest.raises(ValueError, match="HR grid"):
        dd.build_device_stacks(factory.make_dataset(from_dict(windowed), "train"), "cpu")
    whole = config_dict(env["root"], transforms={"sample_w_cutouts": False})
    with pytest.raises(ValueError, match="sample_w_cutouts"):
        dd.build_device_stacks(factory.make_dataset(from_dict(whole), "train"), "cpu")
    no_sdf = config_dict(env["root"], training={"sdf_weighted_loss": False})
    loader = dd.DeviceDataLoader(factory.make_dataset(from_dict(no_sdf), "train"), 4,
                                 device="cpu")
    assert "sdf" not in next(iter(loader))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dd.DeviceDataLoader(factory.make_dataset(from_dict(d), "train"), 4, device="cuda")


def test_dsm_loss_on_the_first_device_batch_matches_jax(env):
    """The tiny UNet bridged from random Flax variables, the first batch of
    both samplers from one key, JAX's t and z: the same loss (rtol 1e-5)."""
    key = jax.random.PRNGKey(11)
    jb = env["sampler"](key)
    tb = env["loader"].sample_from(*jax_draws(key, env["loader"].stacks.n_days))
    cond_keys = ("y", "cond_img", "lsm_cond", "topo_cond")
    init = {k: np.asarray(jb[k]) for k in ("x", *cond_keys)}
    init["t"] = np.full((BATCH,), 0.5, np.float32)
    model, variables = jax_model_and_variables(TINY, init, seed=2)
    loss_key = jax.random.PRNGKey(12)

    @jax.jit
    def jax_loss(v, batch):
        score = lambda x_t, t, **cond: model.apply(v, x_t, t, **cond, train=False)  # noqa: E731
        return jax_sde.dsm_loss(score, batch["x"], loss_key, sdf=batch["sdf"],
                                **{k: batch[k] for k in cond_keys})

    want = jax_loss(variables, jb)
    t, z = _jax_draws(loss_key, tuple(jb["x"].shape))
    net = torch_model(TINY, variables).eval()
    with torch.no_grad():
        got = dsm_loss(lambda x_t, t_, **c: net(x_t, t_, **c, train=False), tb["x"], t=t, z=z,
                       sde=VESDE(), sdf=tb["sdf"], **{k: tb[k] for k in cond_keys})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
