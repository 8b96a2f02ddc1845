"""Torch port: ring attention (``parallel/ring_attention.py``) on two gloo CPU
ranks against the JAX package's ``ring_self_attention`` on 8 virtual
devices and dense attention, forward and gradient; the 'ring' attention
backend in a module and in a whole UNet forward, and which layers ran
ring-sharded.

One launch of two processes (``tests/torch_parallel_cases.py``'s
``ring_module``) does every check; the JAX references are computed here.
Tolerances: 3e-5 for the attention outputs and the module (JAX's own test's),
5e-5 for the UNet forward (JAX's), 1e-5 for the gradients against dense
attention's (fp32 sums in another order).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbgm_danra_tpu.models.attention import SpatialSelfAttention as JaxAttention
from sbgm_danra_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sbgm_danra_tpu.parallel.ring_attention import ring_self_attention as jax_ring
from sbgm_danra_tpu_torch.convert import state_dict_from_flax
from sbgm_danra_tpu_torch.models.attention import SpatialSelfAttention
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model
from sbgm_danra_tpu_torch.parallel import ring_attention as ra
from sbgm_danra_tpu_torch.parallel.launch import spawn
from sbgm_danra_tpu_torch.parallel.mesh import make_mesh
from tests.torch_parity import (TINY, jax_apply, jax_model_and_variables, model_inputs,
                                random_variables)

SHAPE = (2, 128, 2, 16)  # 64 tokens a port rank, 16 a JAX device
CHANNELS = 32
MODEL_HW = (96, 96)  # attended maps 6x6, 3x3 (odd: dense), 6x6 and 12x12


def _qkv(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def env():
    qkv = _qkv()
    attention = JaxAttention(CHANNELS, 2, backend="xla")
    abstract = jax.eval_shape(lambda: attention.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 4, 4, CHANNELS))))
    att_vars = random_variables(abstract, seed=3)
    att_x = np.random.default_rng(4).normal(size=(2, 8, 16, CHANNELS)).astype(np.float32)
    inputs = model_inputs(batch=2, hw=MODEL_HW, seed=5)
    model, variables = jax_model_and_variables(TINY, inputs, seed=6)
    port = build_score_model(ModelSpec(**TINY))
    module = SpatialSelfAttention(CHANNELS, 2, "ring")
    payload = dict(
        qkv=qkv, odd_qkv=_qkv((1, 101, 2, 16), seed=1),
        cotangent=np.random.default_rng(2).normal(size=SHAPE).astype(np.float32),
        channels=CHANNELS, attention_state=state_dict_from_flax(att_vars, module),
        attention_x=att_x, spec=TINY, model_state=state_dict_from_flax(variables, port),
        model_inputs=inputs)
    ranks = spawn("tests.torch_parallel_cases:ring_module", 2, payload, backend="gloo",
                  device="cpu", timeout=300)
    return dict(payload=payload, ranks=ranks, att_vars=att_vars, model=model,
                variables=variables)


def _dense(q, k, v):
    return np.asarray(jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v))))


def test_ring_matches_jax_ring_and_dense_attention(env, devices):
    """Each rank's output block, gathered, equals JAX's ring_self_attention on
    {data: 8} and dense attention; the blocks travelled over gloo (CPU)."""
    q, k, v = env["payload"]["qkv"]
    want_ring = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v)), jax_make_mesh({"data": 8}),
                                    "data"))
    got = np.concatenate([r["blocks"].numpy() for r in env["ranks"]], axis=1)
    assert env["ranks"][0]["blocks"].shape == (2, 64, 2, 16)
    np.testing.assert_allclose(got, want_ring, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, _dense(q, k, v), atol=3e-5, rtol=3e-5)
    assert {r["route"] for r in env["ranks"]} == {"gloo"}


def test_token_count_that_does_not_divide(env, devices):
    """``ring_self_attention`` raises as JAX's does; the inline ring under a
    context runs the layer dense (exact)."""
    for r in env["ranks"]:
        assert "not divisible by mesh axis data=2" in r["odd_error"]
        q = env["payload"]["odd_qkv"][0]
        np.testing.assert_allclose(r["inline_odd"].numpy(), _dense(q, q, q), atol=1e-5)
    with pytest.raises(ValueError):
        x = jnp.zeros((1, 100, 2, 16))
        jax_ring(x, x, x, jax_make_mesh({"data": 8}), "data")


def test_inline_under_a_context_and_without_one(env):
    """Inside ``ring_context`` every rank gets the whole output; without a
    context the layer is dense attention."""
    q, k, v = env["payload"]["qkv"]
    want = _dense(q, k, v)
    for r in env["ranks"]:
        np.testing.assert_allclose(r["inline"].numpy(), want, atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(r["no_context"].numpy(), want, atol=1e-5, rtol=1e-5)


def test_no_context_in_process_is_dense_and_logged(caplog):
    q, k, v = map(torch.from_numpy, _qkv())
    with caplog.at_level(logging.INFO, logger=ra.__name__):
        out = ra.ring_attention_inline(q, k, v)
    assert "this layer traces DENSE" in caplog.text
    np.testing.assert_allclose(out.numpy(), _dense(*_qkv()), atol=1e-5, rtol=1e-5)
    with ra.ring_context(make_mesh(device="cpu")):  # a one-rank ring: dense
        assert not ra.ring_shards(SHAPE[1])
        np.testing.assert_allclose(ra.ring_attention_inline(q, k, v).numpy(),
                                   _dense(*_qkv()), atol=1e-5, rtol=1e-5)


def test_gradient_matches_dense_attention(env):
    """The ring's backward (the blocks travel with their dK/dV), the token
    split's and the gather's: every rank holds the whole gradient of
    sum(out * cotangent), equal to jax.grad of dense attention's."""
    q, k, v = env["payload"]["qkv"]
    g = env["payload"]["cotangent"]
    want = jax.grad(lambda a, b, c: jnp.sum(jax.nn.dot_product_attention(a, b, c) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for r in env["ranks"]:
        for got, w in zip(r["grads"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_ring_module_matches_jax_xla_module(env):
    """SpatialSelfAttention(backend='ring') under a context equals JAX's 'xla'
    module with the same (bridged) weights; the call counted as ring-sharded."""
    want = np.asarray(JaxAttention(CHANNELS, 2, backend="xla").apply(
        env["att_vars"], jnp.asarray(env["payload"]["attention_x"])))
    for r in env["ranks"]:
        np.testing.assert_allclose(r["module"].numpy(), want, atol=3e-5, rtol=3e-5)
        assert r["module_calls"] == (1, 0)


def test_model_forward_with_the_ring_backend(env):
    """The tiny UNet with attention 'ring' on two ranks equals JAX's 'xla'
    forward; ``ring_stats`` lists each attention layer: ring-sharded where its
    token count divides 2 (36, 36, 144 tokens), dense at 3x3 = 9 tokens."""
    want = jax_apply(env["model"], env["variables"], env["payload"]["model_inputs"])
    for r in env["ranks"]:
        np.testing.assert_allclose(r["model"].numpy(), want, atol=5e-5, rtol=5e-5)
        stats = r["ring_stats"]
        assert stats == {
            "encoder.attn3": {"ring": 1, "dense": 0, "tokens": 36},
            "encoder.attn4": {"ring": 0, "dense": 1, "tokens": 9},
            "decoder.block0.attention": {"ring": 1, "dense": 0, "tokens": 36},
            "decoder.block1.attention": {"ring": 1, "dense": 0, "tokens": 144},
        }
