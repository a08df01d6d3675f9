"""The plain reference against the port at a small size on the CPU, with the
same seeded weights: the forward of both configurations' layouts, a train
step's losses, gradients and Adam, and the served answers."""

import pytest
import torch

from perfbench import generators, harness
from perfbench.drivers.common import build_model, load_weights
from perfbench.reference import model as ref
from perfbench.tests import tiny

SEED = 2**40 + 17


@pytest.mark.parametrize("name", ["modelnet_nolbo", "pascal_nolbo"])
def test_forward_matches_the_port(name):
    cfg = tiny.config(name)
    m = cfg["model"]
    model, _, weights = build_model(cfg, SEED, "cpu", torch.float32)
    load_weights(model, weights)
    model.eval()
    g = torch.Generator().manual_seed(1)
    if m["encoder"] == "voxel":
        vox = (torch.rand((3, 32, 32, 32, 1), generator=g) > 0.6).float()
        got, want = model.encode(vox).mean, ref.encode_voxels(weights, m, vox.permute(0, 4, 1, 2, 3))[:, :8]
    else:
        images = torch.rand((3, 48, 48, 3), generator=g)
        enc = model.encode(images)
        got = torch.cat([enc.mean_category, enc.log_var_category, enc.mean_inst, enc.log_var_inst], -1)
        want = ref.encode_images(weights, m, images).clamp(-10, 10)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    z = torch.randn((3, m["decoder"]["input_dim"]), generator=g)
    blocked = model.decode(z, blocked_output=True)  # (B, D/4, H/4, W/4, 64), channels (bd, bh, bw)
    torch.testing.assert_close(blocked.permute(0, 4, 1, 2, 3), torch.sigmoid(ref.decode_logits(weights, m, z)),
                               rtol=1e-4, atol=1e-5)


def test_seeded_weights_are_the_same_on_every_call_and_fill_every_leaf():
    cfg = tiny.config("modelnet_nolbo")
    spec = ref.param_spec(cfg["model"])
    a, b = generators.weights(spec, SEED, "cpu"), generators.weights(spec, SEED, "cpu")
    assert list(a) == list(spec) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder3d.conv_0.weight"], generators.weights(spec, SEED + 1, "cpu")["encoder3d.conv_0.weight"])


@pytest.mark.parametrize("workload", ["modelnet_nolbo.train_b32", "pascal_nolbo.train_b32_ms"])
def test_train_steps_match_the_port_in_float32(workload):
    cell = tiny.cell(workload, compute="f32")
    drv = harness.driver_class("train")(cell, SEED, "cpu")
    drv.setup()
    drv.release()
    numbers, _ = drv.check()
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-4, numbers


def test_served_answers_match_the_port_in_float32():
    cell = tiny.cell("modelnet_nolbo.serve_b32_anytime", compute="f32")
    drv = harness.driver_class("serve")(cell, SEED, "cpu")
    drv.setup()
    drv.window(1.0)
    drv.release()
    numbers, _ = drv.check()
    assert numbers["category_gap"] == 0.0 and numbers["latent_gap"] < 1e-4 and numbers["voxel_gap"] < 1e-3, numbers
