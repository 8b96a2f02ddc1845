"""Torch port: the inference engine and its HTTP API on the CPU."""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from sbgm_danra_tpu_torch.config import get_model_string, load_config
from sbgm_danra_tpu_torch.convert import flatten, state_dict_from_flax
from sbgm_danra_tpu_torch.models.unet import ModelSpec, build_score_model, model_spec_from_config
from sbgm_danra_tpu_torch.sampling.samplers import SamplerConfig
from sbgm_danra_tpu_torch.serve import (
    FLAGSHIP_SYNTH,
    InferenceEngine,
    ServeSettings,
    _Ticket,
    make_handler,
    settings_from_config,
)
from tests.torch_parity import TINY, jax_model_and_variables, model_inputs

HW = (32, 32)
SETTINGS = ServeSettings(
    spec=ModelSpec(**TINY),
    sampler_type="dpmpp_sampler",
    sampler=SamplerConfig(num_steps=4, guidance_scale=3.0),
    sample_hw=HW,
    n_lr=2,
    model_string="tiny",
)


def _weights(seed=0):
    model = build_score_model(SETTINGS.spec, generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(SETTINGS, _weights(), device="cpu", max_members=4)
    eng.warmup()
    yield eng
    eng.close()


def _conditions():
    rng = np.random.default_rng(0)
    return {
        "y": np.int64(2),
        "cond_img": rng.normal(size=(*HW, 2)).astype(np.float32),
        "lsm_cond": np.ones((*HW, 2), np.float32),
        "topo_cond": np.zeros((*HW, 2), np.float32),
    }


class TestInferenceEngine:
    def test_generate_members(self, engine):
        out = engine.generate(_conditions(), n_members=3, seed=1)
        assert out.shape == (3, *HW)
        assert np.isfinite(out).all()
        assert np.std(out.mean(axis=(1, 2))) > 0  # distinct members

    def test_seed_determinism(self, engine):
        a = engine.generate(_conditions(), n_members=2, seed=5)
        b = engine.generate(_conditions(), n_members=2, seed=5)
        np.testing.assert_array_equal(a, b)

    def test_capacity_guard(self, engine):
        with pytest.raises(ValueError, match="capacity"):
            engine.generate(_conditions(), n_members=99)

    def test_partial_conditions_serve(self, engine):
        cond = _conditions()
        cond.pop("topo_cond")
        cond.pop("y")
        assert engine.generate(cond, n_members=2, seed=7).shape == (2, *HW)
        assert np.isfinite(engine.generate({}, n_members=1, seed=7)).all()

    def test_spread_calibration(self, engine):
        raw = engine.generate(_conditions(), n_members=3, seed=8)
        scaled = engine.generate(_conditions(), n_members=3, seed=8, spread_calibration=2.0)
        mean = raw.mean(axis=0, keepdims=True)
        np.testing.assert_allclose(scaled, mean + 2.0 * (raw - mean), rtol=1e-5, atol=1e-5)

    def test_loads_torch_file_and_bridged_npz(self, tmp_path):
        """The engine takes a state_dict, a torch.save file, or Flax variables
        in an .npz, which it bridges."""
        sd = _weights()
        torch.save(sd, tmp_path / "w.pt")
        _, variables = jax_model_and_variables(TINY, model_inputs())
        np.savez(tmp_path / "w.npz", **flatten(variables))
        for source, want in ((str(tmp_path / "w.pt"), sd),
                             (str(tmp_path / "w.npz"), None)):
            eng = InferenceEngine(SETTINGS, source, device="cpu", max_members=2)
            try:
                want = want or state_dict_from_flax(variables, eng.model)
                for key, value in want.items():
                    torch.testing.assert_close(eng.model.state_dict()[key], value,
                                               rtol=0, atol=0)
            finally:
                eng.close()


class TestCoalescing:
    def test_cobatched_equals_solo(self, engine):
        """One shared dispatch with a stranger's rows gives the request the
        same rows, bit for bit, as running alone."""
        solo = engine.generate(_conditions(), n_members=2, seed=21)
        row = engine._zero_row()
        cond = _conditions()
        row.update({k: np.asarray(v, np.float32) for k, v in cond.items() if k != "y"})
        row["y"] = np.asarray(cond["y"], np.int64)
        mine = _Ticket(21, row, 2)
        other = _Ticket(99, engine._zero_row(), 2)
        before = engine.n_dispatches
        engine._dispatch([other, mine])
        assert engine.n_dispatches == before + 1
        np.testing.assert_array_equal(mine.out, solo)

    def test_concurrent_requests_all_served(self, engine):
        results = {}

        def client(seed):
            results[seed] = engine.generate(_conditions(), n_members=1, seed=seed)

        threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 6
        for seed, out in results.items():
            np.testing.assert_array_equal(
                out, engine.generate(_conditions(), n_members=1, seed=seed)
            )

    def test_pc_sampler_per_member_step(self):
        """With pc_sampler the engine takes the Langevin step per member (the
        JAX engine's vmapped batch-of-one), so co-batching changes nothing."""
        settings = dataclasses.replace(SETTINGS, sampler_type="pc_sampler",
                                       sampler=SamplerConfig(num_steps=2, guidance_scale=3.0))
        eng = InferenceEngine(settings, _weights(), device="cpu", max_members=3)
        try:
            solo = eng.generate(_conditions(), n_members=1, seed=3)
            mine = _Ticket(3, eng._zero_row(), 1)
            mine.row.update({k: np.asarray(v) for k, v in _conditions().items()})
            eng._dispatch([_Ticket(8, eng._zero_row(), 2), mine])
            np.testing.assert_array_equal(mine.out, solo)
        finally:
            eng.close()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class TestHTTP:
    def test_round_trip(self, engine):
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
                health = json.loads(resp.read())
            assert health["status"] == "ok" and health["platform"] == "cpu"
            assert health["model"] == "tiny" and health["sample_hw"] == list(HW)
            cond = {k: np.asarray(v).tolist() for k, v in _conditions().items()}
            out = _post(base + "/generate", {"conditions": cond, "n_members": 2, "seed": 4})
            assert out["shape"] == [2, *HW]
            np.testing.assert_allclose(np.asarray(out["generated"], np.float32),
                                       engine.generate(_conditions(), n_members=2, seed=4))
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + "/generate", {"conditions": cond, "n_members": 99})
            assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/nope", timeout=30)
            assert err.value.code == 404
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)


CONFIGS = [os.path.join(os.path.dirname(__file__), "..", "configs", name)
           for name in ("flagship_synth.yaml", "full_scale_demo.yaml")]


class TestSettings:
    def test_flagship_synth_matches_config(self):
        """The settings chip_smoke.py serves with are what the port's config
        reader makes of configs/flagship_synth.yaml."""
        assert settings_from_config(load_config(CONFIGS[0])) == FLAGSHIP_SYNTH

    @pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
    def test_port_reads_configs_as_the_jax_package_does(self, path):
        """The port's own reader and the JAX package's reader give the same
        ServeSettings, ModelSpec fields and model string for one file."""
        from sbgm_danra_tpu.config import load_config as jax_load_config
        from sbgm_danra_tpu.training.pipeline import model_spec_from_config as jax_spec
        from sbgm_danra_tpu.utils.naming import get_model_string as jax_model_string

        ours, theirs = load_config(path), jax_load_config(path)
        assert settings_from_config(ours) == settings_from_config(theirs)
        assert dataclasses.asdict(model_spec_from_config(ours)) == dataclasses.asdict(
            jax_spec(theirs))
        assert get_model_string(ours) == jax_model_string(theirs)
