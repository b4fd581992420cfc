"""PyTorch port vs JAX package: tiled full-resolution serving
(`ops/tiling.py`, the tiled paths of `train/evaluator.py`) and the
Evaluator's `predict_probs` / `update_state`.

The tiny flagship (`efficientnet-tiny` encoders) in fp32, its weights
carried to JAX by `convert_enhanced_unet`; the JAX Evaluators are built
once per module so each of their programs compiles once.

Tolerances:
- `_tile_positions` and `hann_window_2d` equal;
- tile probabilities within 1e-5 (fp32), from the same enhanced image: the
  port's CLAHE runs op by op and the jitted JAX one differs by up to 3
  grey levels (tests/test_torch_port_serving.py), so the probabilities are
  held on JAX's enhanced image and the masks, each side enhancing its own,
  on at least 99.9% of pixels;
- the JAX reference mask is the cascade of the JAX Evaluator's
  host-stitched probabilities, which the JAX package pins equal to its
  device program (tests/test_round2_features.py);
- within the port (without TTA, for time), the device-stitched mask
  equals the host-stitched one (forwards of 8 tiles), a batch equals its
  images one by one, and `tile_batch=4` (chunks of 4 and 2 tiles) equals
  the whole grid in one forward (probabilities within 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.ops import tiling as jtiling
from enhanced_unet_tpu.ops.thresholding import convert_probs_to_mask as jcascade
from enhanced_unet_tpu.train.evaluator import Evaluator as JEvaluator
from enhanced_unet_tpu.train.trainer import TrainState as JTrainState
from enhanced_unet_tpu_torch.config import get_preset
from enhanced_unet_tpu_torch.models import blocks, encoders, get_model
from enhanced_unet_tpu_torch.ops import tiling
from enhanced_unet_tpu_torch.ops.thresholding import convert_probs_to_mask
from enhanced_unet_tpu_torch.train.evaluator import Evaluator
from enhanced_unet_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
H, W, TILE, OVERLAP = 160, 224, 96, 32


def _maxdiff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()


def _port_model(seed=8):
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=seed,
                      encoder_names=TINY)
    with torch.no_grad():  # sharper logits, so the cascade sees real decisions
        for layer in (model.fusion_head[11], model.fusion_residual):
            layer.weight.mul_(20.0)
    return model


def _jax_state(state_dict):
    # copies: a JAX array made from a numpy view may alias the torch storage
    params, stats = convert_enhanced_unet({k: v.clone() for k, v in state_dict.items()},
                                          TINY)
    ref = JEnhancedUNet(encoder_names=TINY, dtype=jnp.float32)
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=(), apply_fn=ref.apply, tx=None)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    model = _port_model()
    return {"model": model, "state": _jax_state(model.state_dict()),
            "img": rng.random((H, W, 3)).astype(np.float32),
            "img2": rng.random((H, W, 3)).astype(np.float32), "cases": {}}


def _case(world, tta):
    """The JAX tiled Evaluator's enhanced image, host-stitched probabilities
    and mask, and the port's tiled Evaluator on the same weights."""
    if tta not in world["cases"]:
        jev = JEvaluator(world["state"], "enhanced_unet", enable_tta=tta, verbose=False,
                         tiled=True, tile=TILE, overlap=OVERLAP)
        j_enh = np.array(jev._enhance(jnp.asarray(world["img"])))
        j_probs = jev.predict_probs_tiled(world["img"])
        world["cases"][tta] = {
            "jev": jev, "j_enh": j_enh, "j_probs": j_probs,
            "j_mask": np.asarray(jcascade(j_probs)),
            "ev": Evaluator(world["model"], "enhanced_unet", enable_tta=tta, device="cpu",
                            tiled=True, tile=TILE, overlap=OVERLAP)}
    return world["cases"][tta]


@pytest.mark.parametrize("size,tile,stride", [(128, 64, 64), (100, 64, 48), (32, 64, 48),
                                              (511, 64, 48), (2048, 512, 448),
                                              (224, 96, 64), (160, 96, 64)])
def test_tile_positions_equal(size, tile, stride):
    assert tiling._tile_positions(size, tile, stride) == \
        jtiling._tile_positions(size, tile, stride)


@pytest.mark.parametrize("tile", [64, 96, 512])
def test_hann_window_equal(tile):
    np.testing.assert_array_equal(tiling.hann_window_2d(tile), jtiling.hann_window_2d(tile))


def _pixelwise(m):
    """A cheap stand-in model: per-pixel logits tanh(x @ m) * 3, in both
    frameworks."""
    return (lambda t: torch.tanh(t @ torch.from_numpy(m)) * 3.0,
            lambda t: jnp.tanh(t @ m) * 3.0)


@pytest.mark.parametrize("h,w,tile,overlap,batch", [(100, 140, 64, 16, 4),
                                                    (90, 70, 64, 32, 3),
                                                    (40, 52, 64, 16, 8),
                                                    (20, 70, 64, 16, 8)])
def test_tiled_inference_matches_jax(rng, h, w, tile, overlap, batch):
    # the last two are smaller than a tile on one or both sides (reflect
    # padding; 20 rows padded by 44, more than the image holds)
    m = (rng.normal(size=(3, 3)) * 4).astype(np.float32)
    img = rng.random((h, w, 3)).astype(np.float32)
    t_apply, j_apply = _pixelwise(m)
    ours = tiling.tiled_inference(t_apply, torch.from_numpy(img), tile, overlap, batch)
    ref = jtiling.tiled_inference(j_apply, jnp.asarray(img), tile, overlap, batch)
    assert ours.shape == (h, w, 3)
    assert _maxdiff(ours, ref) <= 1e-5
    np.testing.assert_array_equal(
        tiling.tiled_semantic_mask(t_apply, torch.from_numpy(img), tile, overlap, batch).numpy(),
        np.asarray(jcascade(ref)))


@pytest.mark.parametrize("overlap", [64, 65])
def test_overlap_at_least_tile_raises(rng, overlap):
    t_apply, _ = _pixelwise(np.eye(3, dtype=np.float32))
    img = rng.random((80, 80, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="overlap must be smaller than tile"):
        tiling.tiled_inference(t_apply, torch.from_numpy(img), 64, overlap)
    ev = Evaluator(_Pixelwise(), "enhanced_unet", device="cpu", tiled=True, tile=64,
                   overlap=overlap)
    with pytest.raises(ValueError, match="overlap must be smaller than tile"):
        ev.predict_semantic_mask(img)
    with pytest.raises(ValueError, match="overlap must be smaller than tile"):
        ev.predict_probs_tiled(img)


class _Pixelwise(torch.nn.Module):
    def forward(self, x):
        return torch.tanh(x * 3.0 - 1.5), {}


def test_tiled_evaluator_on_an_image_smaller_than_a_tile(rng):
    ev = Evaluator(_Pixelwise(), "enhanced_unet", device="cpu", tiled=True, tile=64,
                   overlap=16)
    img = rng.random((40, 56, 3)).astype(np.float32)
    mask = ev.predict_semantic_mask(img)
    probs = ev.predict_probs_tiled(img)
    assert mask.shape == (40, 56) and mask.dtype == np.uint8
    assert probs.shape == (40, 56, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(mask, convert_probs_to_mask(torch.from_numpy(probs)).numpy())


def _port_results(world, tta):
    """The port's tiled probabilities on JAX's enhanced image and its
    tiled mask of the raw image (each computed once)."""
    case = _case(world, tta)
    if "probs" not in case:
        with torch.inference_mode():
            case["probs"] = case["ev"].tiled_probs(torch.from_numpy(case["j_enh"])[None])[0]
        case["mask"] = case["ev"].predict_semantic_mask(world["img"])
    return case


@pytest.mark.parametrize("tta", [False, True])
def test_tiled_probabilities_and_masks_match_jax(world, tta):
    case = _port_results(world, tta)
    assert case["ev"].enable_tta == tta and case["ev"].tile_batch is None
    assert case["probs"].shape == (H, W, 3)
    assert _maxdiff(case["probs"], case["j_probs"]) <= 1e-5
    mask = case["mask"]
    assert mask.shape == (H, W) and mask.dtype == np.uint8
    agree = np.mean(mask == case["j_mask"])
    assert agree >= 0.999, agree
    assert len(np.unique(mask)) >= 2


def test_device_stitching_equals_host_stitching(world):
    case = _port_results(world, False)
    host = case["ev"].predict_probs_tiled(world["img"])
    assert host.shape == (H, W, 3)
    np.testing.assert_array_equal(case["mask"],
                                  convert_probs_to_mask(torch.from_numpy(host)).numpy())


def test_batch_equals_images_one_by_one(world):
    case = _port_results(world, False)
    imgs = np.stack([world["img"], world["img2"]])
    batched = case["ev"].predict_semantic_masks_tiled(imgs)
    assert batched.shape == (2, H, W) and batched.dtype == np.uint8
    np.testing.assert_array_equal(batched[0], case["mask"])
    np.testing.assert_array_equal(batched[1], case["ev"].predict_semantic_mask(world["img2"]))


def test_tile_batch_equals_whole_grid(world):
    case = _port_results(world, False)
    chunked = Evaluator(world["model"], "enhanced_unet", enable_tta=False, device="cpu",
                        tiled=True, tile=TILE, overlap=OVERLAP, tile_batch=4)
    with torch.inference_mode():
        probs = chunked.tiled_probs(torch.from_numpy(case["j_enh"])[None])[0]
    assert _maxdiff(probs, case["probs"]) <= 1e-6
    np.testing.assert_array_equal(convert_probs_to_mask(probs).numpy(),
                                  convert_probs_to_mask(case["probs"]).numpy())


def test_update_state_changes_predictions_and_repacks(world, rng):
    # JAX's side: the untiled evaluator's tile forward (softmax of one
    # forward, as `predict_probs`), compiled for 8 tiles of 96^2, with the
    # parameters passed in
    jev = _case(world, False)["jev"]

    def jax_probs(state_dict, img):
        state = _jax_state(state_dict)
        tiles = jnp.asarray(np.repeat(img[None], 8, axis=0))
        return np.asarray(jev._tile_fwd(state.params, state.batch_stats, tiles))[0]

    model = _port_model(seed=11)
    ev = Evaluator(model, "enhanced_unet", device="cpu")
    img = rng.random((TILE, TILE, 3)).astype(np.float32)
    counts = {"packs": 0, "folds": 0}
    pack, fold = blocks.pack_conv3x3, encoders.fold_mbconv_weights

    def counting_pack(*a):
        counts["packs"] += 1
        return pack(*a)

    def counting_fold(*a, **k):
        counts["folds"] += 1
        return fold(*a, **k)

    def predict():
        counts.update(packs=0, folds=0)
        out = ev.predict_probs(img)
        return out, dict(counts)

    blocks.pack_conv3x3, encoders.fold_mbconv_weights = counting_pack, counting_fold
    try:
        p1, first = predict()
        j1 = jax_probs(model.state_dict(), img)
        _, again = predict()
        bumped = {k: (v + 0.05 if v.is_floating_point() and "running" not in k else v)
                  for k, v in model.state_dict().items()}
        ev.update_state(bumped)
        p2, after = predict()
        twin = _port_model(seed=0)
        twin.load_state_dict(bumped)
        ev.update_state(create_train_state(twin, get_preset("enhanced_unet"), 10,
                                           device="cpu"))
        p3, _ = predict()
    finally:
        blocks.pack_conv3x3, encoders.fold_mbconv_weights = pack, fold
    assert first["packs"] > 0 and first["folds"] > 0, first
    assert again == {"packs": 0, "folds": 0}, again
    assert after == first, after           # every layer packed and folded again
    assert p1.shape == (TILE, TILE, 3)
    assert _maxdiff(p1, j1) <= 1e-5
    assert not np.allclose(p1, p2)
    assert _maxdiff(p2, jax_probs(bumped, img)) <= 1e-5
    np.testing.assert_array_equal(p3, p2)
