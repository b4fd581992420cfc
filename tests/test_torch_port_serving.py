"""PyTorch port vs JAX package: the serving path (CLAHE+sharpen, the
threshold cascade, and the whole Evaluator batch pipeline with TTA).

Tolerances:
- preprocessing within +/-1 grey level of the JAX functions evaluated op
  by op (`jax.disable_jit()`), on the fixture image of
  tests/test_preprocess.py: the port's CLAHE equals JAX's exactly there,
  and the 3x3 sharpen sums in another order.  The jitted JAX program
  differs from its own op-by-op run by up to 3 grey levels (XLA contracts
  the multiply-adds of its fused loops, and CLAHE's LUT and the sharpen
  amplify a flipped rounding), so against it the bound is 3;
- the cascade bit-equal on the same probabilities;
- the single-image TTA paths within 1e-5 on a per-pixel stand-in model,
  and the single-image Evaluator mask equal to the batched one;
- pipeline probabilities within 1e-5 (fp32), masks equal on at least 99.9%
  of pixels (a pixel may flip only where a probability lies within fp32
  noise of a cascade threshold).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.ops import preprocess as jpre
from enhanced_unet_tpu.ops.thresholding import convert_probs_to_mask as jcascade
from enhanced_unet_tpu.ops.tta import run_model_single as jrun_single
from enhanced_unet_tpu.ops.tta import tta_probs as jtta_single
from enhanced_unet_tpu.ops.tta import tta_probs_batch as jtta
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.ops import preprocess as pre
from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask
from enhanced_unet_tpu_torch.ops.tta import (
    run_model_single,
    tta_probs,
    tta_probs_batch,
)
from enhanced_unet_tpu_torch.train.evaluator import Evaluator

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")


def _img_u8(rng, h=64, w=96):
    # the fixture of tests/test_preprocess.py
    yy, xx = np.mgrid[:h, :w]
    base = 120 + 40 * np.sin(yy / 9.0) * np.cos(xx / 7.0)
    noise = rng.normal(0, 12, size=(h, w, 3))
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)


def _maxdiff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()


def test_lab_both_ways_within_one_level(rng):
    img = _img_u8(rng).astype(np.float32)
    lab = pre.rgb_to_lab_u8(torch.from_numpy(img))
    assert _maxdiff(lab, jpre.rgb_to_lab_u8(jnp.asarray(img))) <= 1.0
    assert _maxdiff(pre.lab_to_rgb_u8(lab),
                    jpre.lab_to_rgb_u8(jnp.asarray(lab.numpy()))) <= 1.0


@pytest.mark.parametrize("clip", [2.0, 2.5, 3.0])
def test_clahe_within_one_level(rng, clip):
    gray = _img_u8(rng)[..., 1].astype(np.float32)
    ours = pre.clahe_u8(torch.from_numpy(gray), clip_limit=clip)
    assert _maxdiff(ours, jpre.clahe_u8(jnp.asarray(gray), clip_limit=clip)) <= 1.0
    flat = np.full((64, 64), 128, np.float32)
    assert _maxdiff(pre.clahe_u8(torch.from_numpy(flat), clip),
                    jpre.clahe_u8(jnp.asarray(flat), clip_limit=clip)) <= 1.0


def test_sharpen_within_one_level(rng):
    img = _img_u8(rng).astype(np.float32)
    assert _maxdiff(pre.sharpen_filter(torch.from_numpy(img)),
                    jpre.sharpen_filter(jnp.asarray(img))) <= 1.0


def test_eval_preprocess_within_one_level_and_batched(rng):
    imgs = np.stack([_img_u8(rng), _img_u8(rng)]).astype(np.float32)
    ours = pre.eval_preprocess(torch.from_numpy(imgs))
    for i in range(2):
        x = jnp.asarray(imgs[i])
        with jax.disable_jit():
            assert _maxdiff(pre.clahe_u8(ours.new_tensor(np.asarray(
                jpre.rgb_to_lab_u8(x))[..., 0]), 2.0),
                jpre.clahe_u8(jpre.rgb_to_lab_u8(x)[..., 0], 2.0)) == 0.0
            assert _maxdiff(ours[i], jpre.eval_preprocess(x)) <= 1.0
        assert _maxdiff(ours[i], jpre.eval_preprocess(x)) <= 3.0
        np.testing.assert_array_equal(
            ours[i].numpy(), pre.eval_preprocess(torch.from_numpy(imgs[i])).numpy())


def test_cascade_bit_equal(rng):
    # three images in different density regimes of the cascade
    logits = rng.normal(size=(3, 40, 48, 3)).astype(np.float32) * 3.0
    logits[1, ..., 1] += 2.5          # mostly live
    logits[2, ..., 2] += 2.0          # mostly dead
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ours = convert_probs_to_mask(torch.from_numpy(probs)).numpy()
    assert ours.dtype == np.int32
    for i in range(3):
        np.testing.assert_array_equal(ours[i], np.asarray(jcascade(probs[i])))
    assert len(np.unique(ours)) == 3


class _Pixelwise(torch.nn.Module):
    """A cheap stand-in model: per-pixel logits tanh(x @ m) * 3."""

    def __init__(self, m):
        super().__init__()
        self.m = torch.from_numpy(m)

    def forward(self, x):
        return torch.tanh(x @ self.m) * 3.0, {}


def test_single_image_paths_match_jax(rng):
    m = (rng.normal(size=(3, 3)) * 4).astype(np.float32)
    img = rng.random((40, 56, 3)).astype(np.float32)   # pads to 64x64
    model = _Pixelwise(m)

    def j_apply(x):
        return jnp.tanh(x @ m) * 3.0

    def t_apply(x):
        return model(x)[0]

    x_t, x_j = torch.from_numpy(img), jnp.asarray(img)
    assert _maxdiff(run_model_single(t_apply, x_t), jrun_single(j_apply, x_j)) <= 1e-5
    for tta in (True, False):
        assert _maxdiff(tta_probs(t_apply, x_t, tta),
                        jtta_single(j_apply, x_j, tta)) <= 1e-5
    ev = Evaluator(model, "enhanced_unet", device="cpu")
    np.testing.assert_array_equal(ev.predict_semantic_mask(img),
                                  ev.predict_semantic_masks(img[None])[0])


def test_batch_pipeline_matches_jax(rng):
    port = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=8,
                     encoder_names=TINY)
    with torch.no_grad():  # sharper logits, so the cascade sees real decisions
        for layer in (port.fusion_head[11], port.fusion_residual):
            layer.weight.mul_(20.0)
    params, stats = convert_enhanced_unet(port.state_dict(), TINY)
    ref = JEnhancedUNet(encoder_names=TINY, dtype=jnp.float32)
    variables = {"params": params, "batch_stats": stats}
    imgs = np.stack([_img_u8(rng, 64, 64), _img_u8(rng, 64, 64)]
                    ).astype(np.float32) / 255.0

    @jax.jit
    def jax_pipeline(v, x):
        # the body of enhanced_unet_tpu Evaluator.batch_pipeline
        def apply_fn(t):
            return ref.apply(v, t, False)[0]
        enhanced = jax.vmap(lambda im: jpre.eval_preprocess(im * 255.0) / 255.0)(x)
        probs = jtta(apply_fn, enhanced, True)
        return enhanced, probs, jax.vmap(jcascade)(probs)

    j_enh, j_probs, j_masks = jax_pipeline(variables, jnp.asarray(imgs))
    ev = Evaluator(port, "enhanced_unet", device="cpu")
    assert ev.enable_tta
    masks = ev.predict_semantic_masks(imgs)
    enhanced = pre.eval_preprocess(torch.from_numpy(imgs) * 255.0) / 255.0
    assert _maxdiff(enhanced * 255.0, np.asarray(j_enh) * 255.0) <= 3.0 + 1e-3
    # probabilities from the same enhanced input, so the forward is compared
    with torch.no_grad():
        probs = tta_probs_batch(ev._apply, torch.from_numpy(np.asarray(j_enh)))
    assert _maxdiff(probs, j_probs) <= 1e-5
    assert masks.shape == (2, 64, 64) and masks.dtype == np.int32
    agree = np.mean(masks == np.asarray(j_masks))
    assert agree >= 0.999, agree
    assert len(np.unique(masks)) >= 2
