"""The benchmark's plain references against the port's plain path on the
CPU, at small sizes, in fp32: the models, the preprocessing, the cascade,
the tiled blend and the seeded weights' names."""

import numpy as np
import pytest
import torch

from portbench import harness, weights as W
from portbench.micrographs import micrographs
from portbench.reference import common

CELLS = {"enhanced_unet_b5b4": ("eunet_tiled_2048", "enhanced_unet")}


def cell_of(workload):
    return harness.Cell(harness.manifest(), workload)


@pytest.fixture(scope="module")
def built():
    """config -> (cell, reference, port model), both fp32 on the CPU with
    the same seeded weights."""
    from enhanced_unet_tpu_torch.models import get_model

    out = {}
    for config, (workload, model_name) in CELLS.items():
        cell = cell_of(workload)
        cell.config["calibration"]["size"] = 64
        state = W.seeded_weights(cell, 2 ** 31 + 5, "cpu")
        ref = cell.reference().build(cell.config)
        ref.load_state_dict(state)
        port = get_model(model_name, dtype=torch.float32, device="cpu")
        port.load_state_dict(state)
        out[config] = (cell, ref.eval(), port.eval())
    return out


@pytest.mark.parametrize("config", sorted(CELLS))
def test_reference_names_are_the_ports(built, config):
    _, ref, port = built[config]
    assert W.spec_of(ref) == W.spec_of(port)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_reference_forward_matches_the_port(built, config):
    _, ref, port = built[config]
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = port(x)[0].permute(0, 3, 1, 2)
        got = ref(x.permute(0, 3, 1, 2))[0]
    scale = want.abs().max().item()
    assert scale > 1.0                       # the calibration makes the logits reach units
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_enhance_matches_the_ports_preprocessing():
    from enhanced_unet_tpu_torch.ops.preprocess import eval_preprocess

    images, _ = micrographs(2, 128, 96, 11, "cpu")
    for im in images:
        want = (eval_preprocess(im * 255.0) / 255.0).numpy()
        got = common.enhance(im.numpy())
        levels = np.abs(got - want) * 255.0
        # the reference blends CLAHE's tile LUTs in OpenCV's order of
        # products, the port in another: a rounding at .5 can move an L level
        # by one, which LAB -> RGB and the sharpen's 1.35 carry to a few
        assert levels.max() <= 4.0 + 1e-3
        assert (levels > 0.5).mean() <= 0.02


def test_cascade_matches_the_ports():
    from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask

    g = torch.Generator().manual_seed(4)
    for scale in (0.5, 2.0, 6.0):
        logits = torch.randn(3, 3, 64, 80, generator=g) * scale
        logits[1, 2] += 2.0                  # one image with many dead pixels
        probs = torch.softmax(logits, 1)
        want = convert_probs_to_mask(probs.permute(0, 2, 3, 1))
        for p, w in zip(probs, want):
            assert torch.equal(common.cascade(p)[0].int(), w)


def test_admissible_masks_cover_a_density_rule_turned():
    probs = torch.zeros(3, 10, 10)
    probs[2] = 0.7
    probs[0] = 0.25
    probs[1] = 0.05
    probs[2, :, 8:] = 0.56                   # dead but not "high" when the rule is on
    probs[0, :, 8:] = 0.39
    masks = common.admissible_masks(probs, margin=0.01)
    assert len(masks) == 1                   # the dead ratio (1.0) is far from 0.15
    assert common.mismatch_share(masks[0], masks) == 0.0


def test_tiled_blend_matches_the_ports():
    from enhanced_unet_tpu_torch.ops.tiling import tiled_inference

    g = torch.Generator().manual_seed(5)
    image = torch.rand(3, 150, 230, generator=g)
    weight = torch.randn(3, 3, 3, 3, generator=g)

    def logits(x):                          # NCHW -> NCHW, a fixed conv
        return torch.nn.functional.conv2d(x, weight, padding=1)

    want = tiled_inference(lambda t: logits(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                           image.permute(1, 2, 0), tile=96, overlap=32, batch_size=4)
    got = common.tiled_probs(lambda t: torch.softmax(logits(t), 1), image, 96, 32, 4)
    assert (got.permute(1, 2, 0) - want).abs().max().item() <= 1e-6


def test_fp8_rounding_keeps_the_scale_and_loses_bits():
    t = torch.randn(1000, generator=torch.Generator().manual_seed(6)) * 7
    r = common.fp8_round(t)
    assert r.abs().max().item() == pytest.approx(t.abs().max().item(), rel=1e-6)
    rel = ((r - t).abs() / t.abs().clamp_min(1e-3)).median().item()
    assert 1e-3 < rel < 0.1
