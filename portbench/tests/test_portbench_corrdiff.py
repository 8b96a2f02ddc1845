"""The CorrDiff cell on the CPU: its plain reference against the port at a
tiny size, built as the driver builds it; the work module's count against a
hand count; the span reader on a synthetic trace; and a tiny run of the
cell, plain and traced, with its control."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, work_corrdiff
from portbench.drivers import corrdiff as driver
from portbench.reference import corrdiff as ref
from portbench.reference.unet import exact
from portbench.tests.test_portbench_spans import calls
from portbench.trace import Trace

CELL = "corrdiff-448-ens"
SEED = 2**31 + 12345
METRICS = ("mfu.corrdiff", "idle_share.corrdiff", "k1_roofline.corrdiff",
           "call_host_ms.corrdiff")


def full_config() -> dict:
    return harness.load_json(harness.PACKAGE / "configs" / "corrdiff-448.json")


def tiny_config() -> dict:
    cfg = copy.deepcopy(full_config())
    cfg["model"].update(img_resolution=16, model_channels=16, channel_mult=[1, 2],
                        num_blocks=1, attn_resolutions=[8], compute_dtype="float32")
    cfg["image_hw"] = [16, 16]
    cfg["sampler"]["num_steps"] = 4
    return cfg


def tiny_cell() -> harness.Cell:
    entry = {w["name"]: w for w in harness.benchmark()["workloads"]}[CELL]
    params = dict(harness.load_json(harness.PACKAGE / "workloads" / f"{CELL}.json"),
                  members=3, trace_seconds=0.2)
    return harness.Cell(CELL, entry, params, tiny_config())


def test_reference_matches_the_port_built_as_the_driver_builds_it():
    """The port from the port's own config reader and build_corrdiff, with the
    reference's weights: the mean, the score and a 4-point sample."""
    cfg = tiny_config()
    weights = ref.make_weights(cfg, SEED, "cpu")
    net, sde, scfg = driver.build(cfg, weights, torch.device("cpu"))
    assert (sde.sigma_max, scfg.num_steps, scfg.eps, scfg.guidance_scale) == (800.0, 4, 0.002,
                                                                               None)
    g = torch.Generator().manual_seed(1)
    cond = {k: torch.randn(2, 16, 16, 2, generator=g) for k in ("cond_img", "lsm_cond",
                                                                 "topo_cond")}
    z = torch.randn(2, 16, 16, 1, generator=g)
    from sbgm_danra_tpu_torch.sampling.samplers import edm_sampler

    with torch.no_grad(), exact(), torch.backends.mkldnn.flags(enabled=False):
        got = net.mean(**cond) + edm_sampler(net, None, z.shape, sde, scfg, cond=cond,
                                             draws=z[None])
        want = ref.sample(weights, cfg, z, cond, rows=1)
    # fp32 both sides; the port's GroupNorms take the one-pass variance, some 60
    # of them an evaluation over 6 evaluations
    assert (got[..., 0] - want).abs().max() <= 1e-4 * want.abs().max()


def test_flops_of_one_block_by_hand():
    """A 448x448 decoder block, 384 -> 128 channels, no attention: conv0
    2 x 9 x 384 x 128 per pixel, conv1 2 x 9 x 128 x 128, the 1x1 skip 2 x 384
    x 128, the affine 2 x 512 x 128 once; and an attention block at 28x28, 256
    channels: qkv 2 x 256 x 768, proj 2 x 256 x 256 per pixel, the two
    products 4 x 784^2 x 256."""
    px = 448 * 448
    hand = px * (2 * 9 * 384 * 128 + 2 * 9 * 128 * 128 + 2 * 384 * 128) + 2 * 512 * 128
    assert work_corrdiff.block_flops(384, 128, 512, 448, 448) == hand
    px = 28 * 28
    hand = (px * (2 * 9 * 256 * 256 * 2 + 2 * 256 * 768 + 2 * 256 * 256) + 2 * 512 * 256
            + 4 * px * px * 256)
    assert work_corrdiff.block_flops(256, 256, 512, 28, 28, attention=True) == hand


def test_net_and_call_flops_at_the_published_widths():
    """One row of a net is 4.0-4.2 TFLOP at 448x448 (the residual net's
    embedding adds 0.66 MFLOP); a call of 1 date x 8 members, 1 + 34 x 8
    evaluations; 55 K1 chains a net, the 448x448 ones the largest."""
    cfg = full_config()
    reg, res = (work_corrdiff.net_flops(cfg, 448, 448, p) for p in (False, True))
    assert 4.0e12 < reg < 4.2e12
    assert res - reg == 2.0 * (128 * 512 + 512 * 512)
    assert work_corrdiff.call_flops(cfg, 448, 448, 1, 8) == reg + 34 * 8 * res
    chains = work_corrdiff.k1_chains(cfg, 448, 448)
    assert len(chains) == 55 and (448, 448, 384, 128) in chains and (448, 448, 256, 256) in chains
    assert work_corrdiff.k1_least_s_per_call(cfg, 448, 448, 1, 8) > 34 * work_corrdiff.k1_least_s(
        cfg, 448, 448, 8)


def test_call_host_ms_reads_each_call_less_its_replay_and_sync():
    read = harness.reader("call_host_ms.corrdiff")
    run = SimpleNamespace(trace=Trace([], calls("corrdiff.call", "sample.replay",
                                                "corrdiff.sync"), 1.0, calls=1))
    assert read(run) == pytest.approx(1e3 * ((0.04 - 0.005 - 0.03) + (0.06 - 0.015 - 0.02)) / 2)
    assert read(SimpleNamespace(trace=None)) is None


def test_entries():
    bench = harness.benchmark()
    e2e, layer = harness.cell_metrics(CELL, bench)
    assert [m["name"] for m in e2e] == ["gen_fields_per_s", "setup_s"]
    assert sorted(m["name"] for m in layer) == sorted(METRICS)
    assert all(m["moves"] == "gen_fields_per_s" for m in layer)


def run_tiny(trace=False, control=False) -> dict:
    return harness.run_cell(CELL, SEED, 0.6, trace, "cpu", time.perf_counter(),
                            cell=tiny_cell(), control=control)


def test_cell_runs_and_is_correct_and_its_control_fails():
    with torch.backends.mkldnn.flags(enabled=False):
        out = run_tiny(control=True)
    checks = out["checks"]
    assert out["attempted"] > 0 and out["metrics"]["gen_fields_per_s"]["value"] > 0
    assert checks["fields_rel_l2"]["value"] < 1e-4
    assert checks["control_fields_rel_l2"]["value"] > 10 * checks["fields_rel_l2"]["value"]
    assert checks["emulated_bf16_fields_rel_l2"]["value"] > 0


def test_traced_run_reads_its_metrics():
    with torch.backends.mkldnn.flags(enabled=False):
        out = run_tiny(trace=True)
    assert out["correct"]
    # no device events on the CPU: no idle share and no K1 kernel to read
    assert set(out["metrics"]) == {"mfu.corrdiff", "call_host_ms.corrdiff"}
    assert out["metrics"]["mfu.corrdiff"]["value"] > 0
    assert out["metrics"]["call_host_ms.corrdiff"]["value"] > 0
