"""The yardstick's work counts held against ``torch.utils.flop_counter`` and
against the kernels' shapes as the port calls them."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, inputs, program, work
from portbench.reference.unet import UNet, param_shapes
from portbench.tests.tiny import SEED, tiny_config


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops()


def _args(cfg, h, w, device="cpu"):
    cond = {"y": torch.ones(1, dtype=torch.long, device=device),
            **{k: torch.zeros(1, h, w, c, device=device)
               for k, c in (("cond_img", cfg["lr_channels"]), ("lsm_cond", 2), ("topo_cond", 2))}}
    return torch.zeros(1, h, w, 1, device=device), torch.full((1,), 0.5, device=device), cond


def test_unet_flops_match_the_ports_forward():
    """At a tiny size, with attention through the port's flash dispatcher, whose
    CPU route is plain products the counter sees (it does not count the CPU's
    fused attention)."""
    cfg = tiny_config("flagship-domain")
    weights = inputs.make_weights(cfg, SEED, "cpu")
    x, t, cond = _args(cfg, 64, 96)
    want = work.unet_flops(cfg, 64, 96)
    assert _counted(lambda: program.model(cfg, weights, "cpu")(x, t, **cond)) == want
    assert _counted(lambda: UNet(weights, cfg)(x, t, **cond)) == want


# 5.27 GFLOP a row at 128 px and 156.5 at 608x800 are the counter on the
# port's CPU forward with dense attention, which leaves out attention's two
# products (the CPU's fused attention is not counted): 0.0425 and 37.43 GFLOP.
@pytest.mark.parametrize("name,hw,gflop", [("flagship-128", (128, 128), 5.27 + 0.0425),
                                           ("flagship-domain", (608, 800), 156.5 + 37.43)])
def test_unet_flops_at_the_cells_sizes(name, hw, gflop):
    """The reference's forward on meta tensors at the configuration's widths."""
    cfg = harness.load_json(harness.PACKAGE / "configs" / f"{name}.json")
    params = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    x, t, cond = _args(cfg, *hw, device="meta")
    counted = _counted(lambda: UNet(params, cfg)(x, t, **cond))
    assert counted == pytest.approx(work.unet_flops(cfg, *hw), rel=1e-9)
    assert counted / 1e9 == pytest.approx(gflop, rel=2e-3)


def test_kernel_shapes_at_the_full_domain():
    cfg = harness.load_json(harness.PACKAGE / "configs" / "flagship-domain.json")
    assert work.k1_chains(cfg, 608, 800) == [
        (38, 50, 512, 512), (38, 50, 512, 256), (76, 100, 256, 256), (76, 100, 256, 128),
        (152, 200, 128, 128), (152, 200, 128, 64), (304, 400, 64, 64), (304, 400, 64, 64)]
    big = [a for a in work.attention_layers(cfg, 608, 800) if a[0] >= work.K2_MIN_TOKENS]
    assert big == [(7600, 128)]  # decoder block 1: [2, 7600, 4, 32] with CFG
    k2 = work.k2_work(2, 7600, 128, "bfloat16")
    assert k2["flops"] / 1e9 == pytest.approx(59.1, rel=1e-3)
    assert work.k2_least_s(cfg, 608, 800, 2) == pytest.approx(k2["flops"] / 989e12)
    assert work.evals_per_call(cfg["sampler"]) == 34


def test_no_k2_at_128():
    cfg = harness.load_json(harness.PACKAGE / "configs" / "flagship-128.json")
    assert work.k2_least_s(cfg, 128, 128, 16) == 0.0
    assert work.evals_per_call(cfg["sampler"]) == 24
    assert len(work.k1_chains(cfg, 128, 128)) == 8
