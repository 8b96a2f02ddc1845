"""Torch port: the float32 precision rule (``precision.exact_fp32``).

TF32 is off for cuDNN and cuBLAS inside the calls of a float32 model's entry
points (full-domain sampling, the serving engine's dispatch, the trainer's
steps and score function) and the flags are back as they were after each
call; a bf16 model changes nothing.
"""

import numpy as np
import pytest
import torch

from sbgm_danra_tpu_torch.config import from_dict
from sbgm_danra_tpu_torch.evaluate.full_domain import sample_full_domain
from sbgm_danra_tpu_torch.precision import exact_fp32
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_on():
    """Both flags on around the test, as they were after it."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dtype, inside", [("float32", (False, False)),
                                           (torch.float32, (False, False)),
                                           ("bfloat16", (True, True)),
                                           (torch.bfloat16, (True, True))])
def test_exact_fp32_scopes_the_flags(tf32_on, dtype, inside):
    with exact_fp32(dtype):
        assert _flags() == inside
    assert _flags() == (True, True)

    @exact_fp32(dtype)
    def fails():
        assert _flags() == inside
        raise RuntimeError("inside")

    with pytest.raises(RuntimeError, match="inside"):
        fails()
    assert _flags() == (True, True)


def _recording(fn, seen):
    def wrapped(*args, **kwargs):
        seen.append(_flags())
        return fn(*args, **kwargs)
    return wrapped


def test_sample_full_domain_fp32(tf32_on):
    seen = []
    score = _recording(lambda x, t, **c: -x, seen)
    cond = {"cond_img": torch.zeros(1, 37, 45, 1)}
    for dtype, inside in (("float32", (False, False)), (None, (True, True))):
        seen.clear()
        out = sample_full_domain(score, torch.Generator().manual_seed(0), cond,
                                 domain_hw=(37, 45), config=SamplerConfig(num_steps=3),
                                 sampler="edm_sampler", compute_dtype=dtype)
        assert out.shape == (1, 37, 45) and seen and set(seen) == {inside}
        assert _flags() == (True, True)


def test_pipeline_steps_and_score_fn_fp32(tmp_path, tf32_on):
    hw = (32, 32)
    cfg = from_dict({
        "paths": {"checkpoint_dir": str(tmp_path)},
        "highres": {"variable": "prcp", "data_size": list(hw)},
        "lowres": {"condition_variables": ["temp", "prcp"]},
        "sampler": {"last_fmap_channels": 64, "time_embedding": 32, "num_heads": 2,
                    "block_layers": [1, 1, 1, 1]},
        "model": {"compute_dtype": "float32"},
    })
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(2, *hw, 1)), "y": np.array([1, 3]),
             "cond_img": rng.normal(size=(2, *hw, 2)), "lsm_cond": rng.normal(size=(2, *hw, 2)),
             "topo_cond": rng.normal(size=(2, *hw, 2)), "sdf": rng.normal(size=(2, *hw, 1))}
    batch = {k: torch.as_tensor(v, dtype=torch.int32 if k == "y" else torch.float32)
             for k, v in batch.items()}
    pipe = TrainingPipeline(cfg, [batch], valid_loader=[batch], device="cpu")
    seen = []
    pipe.model.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's CPU backward: ROADMAP F5
        assert np.isfinite(pipe.train_batches()) and np.isfinite(pipe.validate_batches())
    pipe.score_fn()(batch["x"], torch.full((2,), 0.5),
                    **{k: batch[k] for k in ("y", "cond_img", "lsm_cond", "topo_cond")})
    assert len(seen) >= 3 and set(seen) == {(False, False)}
    assert _flags() == (True, True)


def test_serving_engine_dispatch_fp32(tf32_on):
    from sbgm_danra_tpu_torch.serve import InferenceEngine
    from tests.test_torch_serve import SETTINGS, _conditions, _weights

    assert SETTINGS.spec.compute_dtype == "float32"
    eng = InferenceEngine(SETTINGS, _weights(), device="cpu", max_members=2)
    try:
        seen = []
        eng.model.register_forward_pre_hook(lambda *_: seen.append(_flags()))
        out = eng.generate(_conditions(), n_members=2, seed=1)
        assert out.shape == (2, *SETTINGS.sample_hw) and np.isfinite(out).all()
        assert seen and set(seen) == {(False, False)}
        assert _flags() == (True, True)
    finally:
        eng.close()
