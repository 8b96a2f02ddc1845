"""Torch port: the CLI end to end on the CPU, as ``tests/test_cli.py`` drives
the JAX package's: synthetic data -> train -> generate -> evaluate, at the
same tiny config (32x32 crops of a 48x64 grid, ``block_layers [1,1,1,1]``,
``last_fmap_channels`` 64, em 8 steps), with the existence gates, previews
every epoch and the sentinel on. One environment, trained once, is shared by
the module (``cli_env``).
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from sbgm_danra_tpu_torch.cli import main_app
from sbgm_danra_tpu_torch.cli.main_app import check_generated_samples_exist, check_model_exists
from sbgm_danra_tpu_torch.config import get_model_string, load_config
from sbgm_danra_tpu_torch.parallel import ensemble
from sbgm_danra_tpu_torch.training.pipeline import TrainingPipeline


def _cfg_dict(root: str) -> dict:
    return {
        "experiment": {"name": "cli_e2e", "config_name": "cli_e2e"},
        "paths": {
            "data_dir": os.path.join(root, "data"),
            "checkpoint_dir": os.path.join(root, "ckpt"),
            "sample_dir": os.path.join(root, "samples"),
            "lsm_path": os.path.join(root, "data/data_lsm/truth_fullDomain/lsm_full.npz"),
            "topo_path": os.path.join(root, "data/data_topo/truth_fullDomain/topo_full.npz"),
            "stats_load_dir": os.path.join(root, "data/stats"),
        },
        "highres": {
            "model": "DANRA", "variable": "prcp", "data_size": [32, 32],
            "scaling_method": "log_zscore", "full_domain_dims": [48, 64],
            "cutout_domains": [8, 40, 16, 56], "buffer_frac": 0.2,
        },
        "lowres": {
            "model": "ERA5", "condition_variables": ["temp"],
            "scaling_methods": ["zscore"], "full_domain_dims": [48, 64],
            "buffer_frac": 0.2,
        },
        "sampler": {
            "sampler_type": "em_sampler", "n_timesteps": 10,
            "time_embedding": 32, "last_fmap_channels": 64,
            "num_heads": 2, "block_layers": [1, 1, 1, 1],
        },
        "data_handling": {"num_workers": 2, "n_gen_samples": 2},
        "training": {
            "seed": 0, "batch_size": 4, "learning_rate": 1e-3, "epochs": 1,
            "steps_per_epoch": 2, "with_ema": True, "ema_decay": 0.99,
            "early_stopping": False, "lr_scheduler": "none",
            "monitor_extremes": True, "verbose": False,
        },
        "classifier_free_guidance": {"enabled": True, "drop_prob": 0.1, "guidance_scale": 1.0},
        "evaluation": {
            "n_gen_samples": 2, "n_steps": 8, "seed": 0,
            "gen_type": ["multiple", "single", "repeated"], "n_repeats": 4,
            "eval_stat_methods": ["pixel_stats", "spatial_stats", "crps", "power_spectrum"],
        },
        "visualization": {"preview_every": 1},
    }


def _write(root, d, name="cfg.yaml"):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """The gates before anything exists, then synthetic data and
    ``full_pipeline`` on the CPU (oneDNN off while training: ROADMAP F5)."""
    root = str(tmp_path_factory.mktemp("torch_cli"))
    d = _cfg_dict(root)
    path = _write(root, d)
    cfg = load_config(path)
    gates = (check_model_exists(cfg), check_generated_samples_exist(cfg))
    with pytest.raises(SystemExit):
        main_app.main(["--config_path", path, "--mode", "generate", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main_app.main(["--config_path", path, "--mode", "evaluate"])
    main_app.main(["--config_path", path, "--mode", "synthetic_data", "--n_days", "16"])
    previews = []  # each preview training ran: its (N, H, W) fields
    run_preview = TrainingPipeline.generate_previews
    with torch.backends.mkldnn.flags(enabled=False), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TrainingPipeline, "generate_previews",
                   lambda self, *a, **kw: previews.append(run_preview(self, *a, **kw)))
        out = main_app.main(["--config_path", path, "--mode", "full_pipeline", "--device", "cpu"])
    sample_path = os.path.join(root, "samples", "generation", get_model_string(cfg),
                               "generated_samples")
    return dict(root=root, d=d, path=path, cfg=cfg, gates=gates, out=out,
                sample_path=sample_path, previews=previews)


def _load(env, key, suffix):
    return np.load(os.path.join(env["sample_path"], f"{key}_{suffix}.npz"))["arr_0"]


def test_gates_closed_before_training(cli_env):
    assert cli_env["gates"] == (False, False)
    assert check_model_exists(cli_env["cfg"]) and check_generated_samples_exist(cli_env["cfg"])
    assert set(cli_env["out"]) == {"train", "generate", "evaluate"}


@pytest.mark.parametrize("suffix,n", [("multi_n_2", 2), ("single", 1), ("repeated_4", 4)])
def test_artifacts_finite_and_back_transformed(cli_env, suffix, n):
    """Every npz of a mode: the generated and truth fields (n, 32, 32), finite,
    back-transformed prcp >= 0; the LR condition, land-sea mask and seasons
    beside them."""
    gen = _load(cli_env, "gen_samples", suffix)
    truth = _load(cli_env, "eval_samples", suffix)
    assert gen.shape == truth.shape == (n, 32, 32)
    assert np.isfinite(gen).all() and np.isfinite(truth).all()
    assert gen.min() >= 0.0 and truth.min() >= 0.0
    assert _load(cli_env, "cond_samples_temp", suffix).shape == (n, 32, 32)
    assert _load(cli_env, "lsm_samples", suffix).shape == (n, 32, 32, 2)
    assert _load(cli_env, "seasons", suffix).shape == (n,)


def test_repeated_members_differ_on_one_condition(cli_env):
    gen = _load(cli_env, "gen_samples", "repeated_4")
    truth = _load(cli_env, "eval_samples", "repeated_4")
    assert all(np.array_equal(truth[0], t) for t in truth)
    assert len({g.tobytes() for g in gen}) == 4


@pytest.mark.parametrize("gen_type,methods", [
    ("multiple", {"pixel_stats", "spatial_stats", "power_spectrum"}),
    ("single", {"pixel_stats", "spatial_stats", "power_spectrum"}),
    ("repeated", {"pixel_stats", "spatial_stats", "power_spectrum", "crps"}),
])
def test_evaluation_written_and_finite(cli_env, gen_type, methods):
    results = cli_env["out"]["evaluate"][gen_type]
    assert set(results) == methods
    fig_path = os.path.join(cli_env["root"], "samples", "generation",
                            get_model_string(cli_env["cfg"]), "evaluation_figures")
    for name in ("pixel_stats", "spatial_stats"):
        saved = np.load(os.path.join(fig_path, f"{name}_{gen_type}.npz"))
        assert all(np.isfinite(saved[k]).all() for k in saved.files)
    assert np.isfinite(results["power_spectrum"]["log_mse"])
    if gen_type == "repeated":
        assert all(np.isfinite(v) and v >= 0 for v in results["crps"].values())


def test_training_ran_previews(cli_env):
    pipe = cli_env["out"]["train"]
    assert pipe.state.step == 2 and np.isfinite(pipe.history["train_loss"][0])
    assert pipe.gen_loader is not None and len(cli_env["previews"]) == 1  # preview_every 1
    assert all(p.shape == (2, 32, 32) and np.isfinite(p).all() for p in cli_env["previews"])
    previews = pipe.generate_previews(n_steps=2)
    assert previews.shape == (2, 32, 32) and np.isfinite(previews).all()


def test_generation_reports_each_mode(cli_env):
    gen = cli_env["out"]["generate"]
    assert set(gen["generators"]) == {"multiple", "single", "repeated"}
    assert list(gen["mode_s"]) == ["multiple", "single", "repeated"]
    assert gen["load_s"] > 0 and all(s > 0 for s in gen["mode_s"].values())


def test_full_domain_generation(cli_env):
    """gen_type full_domain: whole-domain conditioning padded to 64x64, the
    artifact cropped back to the 48x64 domain."""
    d = dict(cli_env["d"], evaluation={**cli_env["d"]["evaluation"], "gen_type": ["full_domain"]})
    path = _write(cli_env["root"], d, "cfg_fd.yaml")
    out = main_app.main(["--config_path", path, "--mode", "generate", "--device", "cpu"])
    fd = _load(cli_env, "gen_samples", "full_domain")
    assert fd.shape == (1, 48, 64) and np.isfinite(fd).all() and fd.min() >= 0.0
    assert _load(cli_env, "eval_samples", "full_domain").shape == (1, 48, 64)
    assert list(out["mode_s"]) == ["full_domain"] and out["mode_s"]["full_domain"] > 0


def test_modes_on_a_card_request_without_one(cli_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main_app.main(["--config_path", cli_env["path"], "--mode", "generate"])


def test_ensemble_mesh_raises(cli_env, caplog):
    """``generation_main`` with ``parallel.mesh_shape``: {data: 1} makes a
    one-rank mesh in this one process, and the repeated mode's members run
    over it (the same call as without one); {data: 2} needs more ranks than
    the run has: ``make_mesh`` raises, and ``generation_main`` logs JAX's
    warning and runs on one device."""
    from sbgm_danra_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        ensemble.generate_ensemble(lambda x, t, **c: x, torch.Generator(), 2, (4, 4, 1),
                                   mesh=pmesh.make_mesh({"data": 2}, device="cpu"))
    gens = {}
    for name, shape in (("one_rank", {"data": 1, "model": 1}), ("too_big", {"data": 2})):
        d = dict(cli_env["d"], parallel={"mesh_shape": shape},
                 evaluation={**cli_env["d"]["evaluation"], "gen_type": ["repeated"]},
                 paths={**cli_env["d"]["paths"],
                        "sample_dir": os.path.join(cli_env["root"], f"mesh_{name}")})
        path = _write(cli_env["root"], d, f"cfg_mesh_{name}.yaml")
        with caplog.at_level("WARNING"):
            out = main_app.main(["--config_path", path, "--mode", "generate", "--device", "cpu"])
        gens[name] = out
        dirs = glob.glob(os.path.join(d["paths"]["sample_dir"], "generation", "*",
                                      "generated_samples", "gen_samples_repeated_4.npz"))
        gen = np.load(dirs[0])["arr_0"]
        assert gen.shape == (4, 32, 32) and np.isfinite(gen).all()
    assert gens["one_rank"]["mesh"].shape == {"data": 1, "model": 1}
    assert gens["too_big"]["mesh"] is None
    assert "Mesh construction failed" in caplog.text


def test_each_mode_writes_every_artifact(cli_env):
    names = {os.path.basename(p) for p in glob.glob(os.path.join(cli_env["sample_path"], "*"))}
    for suffix in ("multi_n_2", "single", "repeated_4"):
        assert {f"{k}_{suffix}.npz" for k in ("gen_samples", "eval_samples", "lsm_samples",
                                              "seasons", "cond_samples_temp")} <= names


def test_figures_under_jax_names(cli_env):
    """matplotlib is present here: each mode's grid, the evaluation's
    histograms and examples, the preview and the loss curves, under the
    names and directories the JAX package uses."""
    out = os.path.join(cli_env["root"], "samples")
    ms = get_model_string(cli_env["cfg"])
    gen_dir = os.path.join(out, "generation", ms)
    want = {os.path.join(gen_dir, "generated_figures", f"gen_samples_{s}.png")
            for s in ("multi_n_2", "single", "repeated_4")}
    want |= {os.path.join(gen_dir, "evaluation_figures", f"{k}_{t}.png")
             for k in ("pixel_hist", "rmse_mae_hist", "examples")
             for t in ("multiple", "single", "repeated")}
    want |= {os.path.join(out, f"preview_{ms}_epoch1.png"), os.path.join(out, f"losses_{ms}.png"),
             os.path.join(out, f"config_{ms}.yaml"), os.path.join(out, f"losses_{ms}.json")}
    assert not [p for p in sorted(want) if not os.path.getsize(p)]
