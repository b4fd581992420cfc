"""PyTorch port vs JAX package: the host half of evaluation (RLE, instance
extraction, instance metrics, COCO mAP, viability, the native host ops)
and `Evaluator.evaluate`.

Tolerances:
- RLE dicts, strings, decoded masks, bboxes, areas and viability equal;
- instance metrics and COCO mAP within 1e-12 on the same instance lists;
- `semantic_to_instances` against the JAX package run with OpenCV: the same
  masks and labels, scores within 1e-9; the port's morphology, contours
  and contour lengths equal to OpenCV's (these skip without `cv2`);
- the native host ops equal to their numpy versions (skip without `g++`):
  the RLE counts, and the IoUs, both integer ratios in float64;
- `evaluate` equal to JAX's (1e-12) when both are handed the same predicted
  masks; with each side's own forward (tiny flagship, fp32, TTA), every
  value within 0.02 (the port's CLAHE is within 3 grey levels of JAX's
  jitted one, so a few pixels of a mask may differ).
"""

import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import jax.numpy as jnp

from synthdata import make_synthetic_dataset

from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.data import rle as jrle
from enhanced_unet_tpu.data.dataset import CellDataset
from enhanced_unet_tpu.data.loader import BatchLoader
from enhanced_unet_tpu.metrics.coco import calculate_coco_metrics as jcoco
from enhanced_unet_tpu.metrics.instance import calculate_instance_metrics as jinstance
from enhanced_unet_tpu.metrics.viability import calculate_viability_metrics as jviability
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.postprocess import instances as jinst
from enhanced_unet_tpu.train.evaluator import Evaluator as JEvaluator
from enhanced_unet_tpu.train.trainer import TrainState as JTrainState
from enhanced_unet_tpu_torch import native
from enhanced_unet_tpu_torch.data import rle
from enhanced_unet_tpu_torch.metrics.coco import calculate_coco_metrics
from enhanced_unet_tpu_torch.metrics.instance import _pairwise_iou, calculate_instance_metrics
from enhanced_unet_tpu_torch.metrics.viability import calculate_viability_metrics
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.postprocess import instances
from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS, Evaluator

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")


def _cv2():
    cv2 = pytest.importorskip("cv2")
    assert jinst._HAS_CV2
    return cv2


def _blobs(seed, size, n, r_max=18, margin=5):
    """A seeded semantic mask: `n` disks of class 1 or 2, radius 2..r_max,
    centres up to `margin` px outside the image (so some touch the edge)."""
    rng = np.random.default_rng(seed)
    h, w = size
    sem = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        cy, cx = rng.uniform(-margin, h + margin), rng.uniform(-margin, w + margin)
        r = rng.uniform(2, r_max)
        sem[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(1, 3)
    return sem


def _tiny_model():
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=8,
                      encoder_names=TINY)
    with torch.no_grad():  # sharper logits, so the cascade sees real decisions
        for layer in (model.fusion_head[11], model.fusion_residual):
            layer.weight.mul_(20.0)
    return model


def _jax_state(model):
    params, stats = convert_enhanced_unet(
        {k: v.clone() for k, v in model.state_dict().items()}, TINY)
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=(), apply_fn=JEnhancedUNet(encoder_names=TINY,
                                                            dtype=jnp.float32).apply,
                       tx=None)


# ---- RLE and viability ------------------------------------------------------

def _rle_masks():
    rng = np.random.default_rng(4)
    full = np.ones((7, 5), np.uint8)
    first = np.zeros((6, 9), np.uint8)
    first[0, 0] = first[3:, 4:] = 1
    return {"random": (rng.random((33, 47)) > 0.6).astype(np.uint8),
            "blobs": (_blobs(1, (64, 80), 12) > 0).astype(np.uint8),
            "empty": np.zeros((12, 10), np.uint8), "full": full, "first_pixel": first,
            "values_over_1": (rng.integers(0, 4, (9, 11))).astype(np.uint8)}


@pytest.mark.parametrize("name", list(_rle_masks()))
def test_rle_equal_to_jax(name):
    mask = _rle_masks()[name]
    ours = rle.encode_rle(mask)
    assert ours == jrle.encode_rle(mask)
    np.testing.assert_array_equal(rle.decode_rle(ours), jrle.decode_rle(ours))
    np.testing.assert_array_equal(rle.decode_rle(ours), (mask > 0).astype(np.uint8))
    assert rle.mask_to_bbox(mask) == jrle.mask_to_bbox(mask)
    assert rle.rle_to_bbox(ours) == jrle.rle_to_bbox(ours)
    assert rle.rle_area(ours) == jrle.rle_area(ours) == int((mask > 0).sum())
    other = rle.encode_rle(np.roll(mask, 3, axis=1))
    assert rle.rle_iou(ours, other) == jrle.rle_iou(ours, other)
    counts = jrle._mask_to_counts(mask)
    assert rle.rle_to_string(counts) == jrle.rle_to_string(counts)
    np.testing.assert_array_equal(rle.rle_from_string(ours["counts"]),
                                  jrle.rle_from_string(ours["counts"]))


@pytest.mark.parametrize("counts", [(3, 1, 2, 2), (0, 0, 0, 0), (0, 2, 0, 0), (5, 0, 3, 4),
                                    (0, 0, 2, 1), (7, 3, 7, 3)])
def test_viability_equal_to_jax(counts):
    assert calculate_viability_metrics(*counts) == jviability(*counts)


# ---- instance extraction ----------------------------------------------------

_FIXTURES = {
    # name: (seed, size, disks, largest radius)
    "touching": (5, (96, 96), 30, 9),
    "large_regions": (6, (128, 128), 14, 20),
    "edge": (7, (80, 112), 25, 14),
    "dense": (8, (160, 160), 70, 16),
    "thin_necks": (1000, (145, 145), 54, 12.5),
}


@pytest.mark.parametrize("name", list(_FIXTURES))
def test_semantic_to_instances_equal_to_jax_with_cv2(name):
    _cv2()
    seed, size, n, r_max = _FIXTURES[name]
    sem = _blobs(seed, size, n, r_max)
    _check_instances(sem)


def _check_instances(sem):
    masks, labels, scores = instances.semantic_to_instances(sem)
    j_masks, j_labels, j_scores = jinst.semantic_to_instances(sem)
    assert len(masks) == len(j_masks) > 0
    assert labels == j_labels
    for ours, ref in zip(masks, j_masks):
        assert ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(scores, j_scores, rtol=0, atol=1e-9)
    return masks, labels, scores


def _split_paths(sem):
    """The branches of `semantic_to_instances` that `sem` goes through."""
    k3, k5 = instances.ellipse(3), instances.ellipse(5)
    seen = set()
    for c in (1, 2):
        markers, k = instances._label(instances.morph_open(
            (sem == c).astype(np.uint8), instances.ellipse(2)))
        for i in range(1, k + 1):
            region = (markers == i).astype(np.uint8)
            if region[[0, -1]].any() or region[:, [0, -1]].any():
                seen.add("on the edge")
            area = int(region.sum())
            if area < instances.LARGE_REGION:
                continue
            iters = max(2, min(area // 1000, 8))
            sub, n = instances._label(instances.erode(region, k3, iters))
            if n > 1:
                seen.add("erosion split")
                for j in range(1, n + 1):
                    grown = instances.dilate((sub == j).astype(np.uint8), k3, iters) & region
                    if grown.sum() > instances.LARGE_REGION:
                        seen.add("large piece")
                continue
            eroded = region
            for _ in range(3):
                eroded = instances.erode(eroded, k3, 1)
                if instances._label(eroded)[1] > 1:
                    seen.add("small-kernel split")
                    break
            else:
                split = instances._label(instances.erode(region, k5, 3))[1] > 1
                seen.add("5x5 split" if split else "kept whole")
    return seen


def test_fixtures_reach_the_split_paths():
    # between them the fixtures take every branch but the re-split of a
    # large piece into more pieces (which no seeded fixture searched
    # reached: a piece that erosion by 3 or more kept whole rarely falls
    # apart under erosion by 2)
    seen = set().union(*(_split_paths(_blobs(*f)) for f in _FIXTURES.values()))
    assert seen == {"on the edge", "erosion split", "large piece", "small-kernel split",
                    "5x5 split", "kept whole"}, seen


def _two_cells_on_a_neck(width):
    """Two disks of radius 11 joined by a horizontal neck `width` pixels
    thick: erosion by 2 cuts the neck, and each piece grows back to more
    than 200 pixels."""
    yy, xx = np.mgrid[:40, :64]
    sem = np.zeros((40, 64), np.uint8)
    for cx in (16, 46):
        sem[(yy - 20) ** 2 + (xx - cx) ** 2 <= 121] = 1
    sem[20 - width // 2:20 - width // 2 + width, 16:47] = 1
    return sem


@pytest.mark.parametrize("width", [2, 3])
def test_large_pieces_reach_the_resplit(width):
    """A piece over 200 px after the first split enters the one-level
    re-split (reference train_eval.py:716-735), which erodes it by 2 and
    keeps it whole; held against the JAX package run with OpenCV."""
    _cv2()
    sem = _two_cells_on_a_neck(width)
    assert "large piece" in _split_paths(sem)
    k3 = instances.ellipse(3)
    region = instances._label(instances.morph_open(sem, instances.ellipse(2)))[0] == 1
    area = int(region.sum())
    assert instances.LARGE_REGION <= area < 3000          # erosion by 2 splits it
    sub, n = instances._label(instances.erode(region.astype(np.uint8), k3, 2))
    assert n == 2
    for j in (1, 2):
        grown = instances.dilate((sub == j).astype(np.uint8), k3, 2) & region
        assert grown.sum() > instances.LARGE_REGION
        assert instances._label(instances.erode(grown, k3, 2))[1] == 1
    masks, labels, _ = _check_instances(sem)
    assert len(masks) == 2 and labels == [0, 0]


def test_resplit_never_finds_two_pieces():
    """Why no mask reaches the re-split's second split: a piece P of the
    region's erosion by `iters` has its grown region dilate(P, iters)
    inside the region, and eroding that by 2 is the closing of
    dilate(P, iters - 2), which stays in one piece for every connected P
    tried (seeded random walks, in the interior and against the border)."""
    k3 = instances.ellipse(3)
    rng = np.random.default_rng(0)
    moves = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    for t in range(300):
        size = 16
        piece = np.zeros((size, size), np.uint8)
        y, x = (int(v) for v in rng.integers(0, size, 2))
        for _ in range(int(rng.integers(3, 40))):
            piece[y, x] = 1
            dy, dx = moves[int(rng.integers(8))]
            y, x = min(max(y + dy, 0), size - 1), min(max(x + dx, 0), size - 1)
        assert instances._label(piece)[1] == 1
        iters = int(rng.integers(2, 5))
        grown = instances.dilate(piece, k3, iters)
        assert instances._label(instances.erode(grown, k3, 2))[1] == 1, (t, iters)


def test_semantic_to_instances_on_the_tiny_flagships_masks(rng):
    _cv2()
    ev = Evaluator(_tiny_model(), "enhanced_unet", device="cpu", enable_tta=False)
    masks = ev.predict_semantic_masks(rng.random((2, 96, 96, 3)).astype(np.float32))
    for sem in masks:
        _check_instances(sem)


_MASKS = hnp.arrays(np.uint8, hnp.array_shapes(min_dims=2, max_dims=2, min_side=1,
                                                max_side=24),
                    elements=st.integers(0, 1))


@settings(max_examples=150, deadline=None, database=None)
@given(mask=_MASKS, size=st.sampled_from([2, 3, 5]), iterations=st.integers(1, 3))
def test_morphology_equals_cv2(mask, size, iterations):
    cv2 = _cv2()
    kernel = instances.ellipse(size)
    np.testing.assert_array_equal(
        kernel, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))
    np.testing.assert_array_equal(instances.erode(mask, kernel, iterations),
                                  cv2.erode(mask, kernel, iterations=iterations))
    np.testing.assert_array_equal(instances.dilate(mask, kernel, iterations),
                                  cv2.dilate(mask, kernel, iterations=iterations))
    np.testing.assert_array_equal(instances.morph_open(mask, kernel),
                                  cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel))


@settings(max_examples=200, deadline=None, database=None)
@given(mask=_MASKS)
def test_contours_and_their_length_equal_cv2(mask):
    cv2 = _cv2()
    ref, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    ours = instances.external_contours(mask)
    assert [[list(p) for p in c] for c in ours] == [c.reshape(-1, 2).tolist() for c in ref]
    for c, r in zip(ours, ref):
        assert instances.arc_length_closed(c) == cv2.arcLength(r, True)


# ---- instance metrics, COCO, native -----------------------------------------

def _instance_lists():
    """Predicted instances of one fixture against the ground truth of a
    shifted, re-drawn copy, so matches, misses and false positives mix."""
    pred = jinst.semantic_to_instances(_blobs(5, (96, 96), 30, 9))
    gt_sem = np.roll(_blobs(5, (96, 96), 30, 9), 2, axis=0)
    gt_sem[40:60, 40:60] = 0
    gt_masks, gt_labels, _ = jinst.semantic_to_instances(gt_sem)
    return pred, (gt_masks, gt_labels)


@pytest.mark.parametrize("use_native", [False, True])
def test_instance_metrics_and_coco_equal_to_jax(use_native):
    if use_native and shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native host ops")
    (masks, labels, scores), (gt_masks, gt_labels) = _instance_lists()
    ours = calculate_instance_metrics(masks, labels, scores, gt_masks, gt_labels,
                                      native=use_native)
    ref = jinstance(masks, labels, scores, gt_masks, gt_labels)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-12, k
    assert 0 < ours["live_recall"] < 1 or 0 < ours["dead_recall"] < 1

    def annotations(ms, ls, ss=None):
        return [{"image_id": i % 2, "category_id": int(l), "bbox": rle.mask_to_bbox(m),
                 "segmentation": rle.encode_rle(m, use_native), "area": int(m.sum()),
                 **({"score": float(ss[i])} if ss is not None else {"iscrowd": 0})}
                for i, (m, l) in enumerate(zip(ms, ls))]

    pred_ann, gt_ann = annotations(masks, labels, scores), annotations(gt_masks, gt_labels)
    ours, ref = calculate_coco_metrics(pred_ann, gt_ann), jcoco(pred_ann, gt_ann)
    assert ours.keys() == ref.keys() == {"bbox_mAP", "segm_mAP"}
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-12, k
    assert ours["segm_mAP"] > 0


@pytest.mark.parametrize("name", list(_rle_masks()))
def test_native_host_ops_equal_numpy(name):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the native host ops")
    mask = _rle_masks()[name]
    counts = rle._mask_to_counts(mask)
    np.testing.assert_array_equal(native.rle_counts(mask), counts)
    np.testing.assert_array_equal(native.rle_decode(counts, *mask.shape),
                                  (mask > 0).astype(np.uint8))
    assert rle.encode_rle(mask, native=True) == rle.encode_rle(mask)
    stack = np.stack([mask, np.roll(mask, 2, 0), np.zeros_like(mask), mask.T[:mask.shape[0],
                                                                          :mask.shape[1]]
                      if mask.shape[0] == mask.shape[1] else 1 - mask])
    np.testing.assert_array_equal(_pairwise_iou(stack, stack[::-1], native=True),
                                  _pairwise_iou(stack, stack[::-1]))


def test_native_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "hostops")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.rle_counts(np.ones((3, 3), np.uint8))


# ---- evaluate -----------------------------------------------------------------

@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cells_port_eval"))
    make_synthetic_dataset(d, n_images=4, size=96, cells_per_image=6, seed=3)
    ds = CellDataset(d, split="train", max_size=96,
                     files=[f"cell_{i:03d}.jpg" for i in range(4)])
    return list(BatchLoader(ds, 2, (96, 96), train=False, preprocess=False, prefetch=0))


def _patch_predictions(ev, table):
    """Make `ev` predict the masks of `table` (image bytes -> mask)."""
    ev.predict_semantic_mask = lambda img: table[np.asarray(img, np.float32).tobytes()]
    ev.predict_semantic_masks = lambda imgs: np.stack(
        [table[np.asarray(im, np.float32).tobytes()] for im in imgs])


def test_evaluate_matches_jax(batches):
    model = _tiny_model()
    ev = Evaluator(model, "enhanced_unet", device="cpu", verbose=False)
    jev = JEvaluator(_jax_state(model), "enhanced_unet", verbose=False)
    assert ev.enable_tta and jev.enable_tta
    ours = ev.evaluate(batches)
    ref = jev.evaluate(batches)
    assert set(ours) == set(ref) == set(_METRIC_KEYS)
    assert all(np.isfinite(v) for v in ours.values())
    for k in _METRIC_KEYS:
        assert abs(ours[k] - ref[k]) <= 0.02, (k, ours[k], ref[k])

    # the metric half alone, on the same predicted masks: the ground truth
    # moved by a pixel, the classes swapped in one image (matches, misses
    # and wrong classes mix)
    table = {}
    for i, item in enumerate(it for b in batches for it in b["batch_items"][:b["n_real"]]):
        pred = np.roll(np.asarray(item["semantic_mask"]), 1, axis=1)
        if i == 1:
            pred = np.where(pred > 0, 3 - pred, 0)
        table[np.asarray(item["image"], np.float32).tobytes()] = pred
    for e in (ev, jev):
        _patch_predictions(e, table)
    ours, ref = ev.evaluate(batches), jev.evaluate(batches)
    for k in _METRIC_KEYS:
        assert abs(ours[k] - ref[k]) <= 1e-12, (k, ours[k], ref[k])
    assert ours["segm_mAP"] > 0 and ours["live_recall"] > 0 and ours["dead_recall"] > 0, ours


def test_evaluate_tiled_gives_the_whole_dict(batches):
    ev = Evaluator(_tiny_model(), "enhanced_unet", device="cpu", verbose=False,
                   enable_tta=False, tiled=True, tile=64, overlap=16)
    out = ev.evaluate(batches[:1])
    assert set(out) == set(_METRIC_KEYS)
    assert all(np.isfinite(v) for v in out.values())
