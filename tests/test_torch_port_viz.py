"""The port's reports (`viz/visualizer.py`) against the JAX package's.

Rendering the suite through both packages would take minutes on the CPU,
so `_save_figure` is patched in both to record the file name and close
the figure; the two packages must ask for the same files.  What the suite
computes and writes itself is compared exactly: `_roc`, `_pr`, the
training-history CSV, the cell-count CSV and `load_evaluation_results`.
`tests/test_torch_port_viz_render.py` renders the port's suite for real.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from enhanced_unet_tpu.cli import write_results_csv
from enhanced_unet_tpu.viz import visualizer as jviz
from enhanced_unet_tpu_torch.viz import Visualizer
from enhanced_unet_tpu_torch.viz import visualizer as viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny"


def _inputs(seed=0, n=3, h=48, w=48):
    rng = np.random.default_rng(seed)
    images = [rng.random((h, w, 3)).astype(np.float32) for _ in range(n)]
    gts, preds, probs = [], [], []
    for i in range(n):
        gt = np.zeros((h, w), np.int32)
        gt[5:15, 5:15] = 1
        gt[30:40, 30 - i:40] = 2
        pred = gt.copy()
        pred[5:10, 5:8] = 0
        pred[20:24, 20 + i:24 + i] = 1
        gts.append(gt)
        preds.append(pred)
        p = rng.random((h, w, 3)).astype(np.float32)
        probs.append(p / p.sum(-1, keepdims=True))
    names = [f"img_{i}.jpg" for i in range(n)]
    return images, gts, preds, probs, names


HISTORY = {
    "train_loss": [3.0, 2.0, 1.5, 1.2],
    "val_loss": [3.1, 2.2, 1.7, 1.4],
    "val_iou": [[0.2, 0.1, 0.05], [0.4, 0.3, 0.2], [0.5, 0.4, 0.3], [0.6, 0.5, 0.4]],
    "val_dice": [[0.3, 0.2, 0.1], [0.5, 0.4, 0.3], [0.6, 0.5, 0.4], [0.7, 0.6, 0.5]],
    "learning_rate": [1e-4, 1e-3, 8e-4, 5e-4],
    "epoch_time_sec": [1.5, 1.25, 1.0],
    "grad_norms": {"a.weight": 1e-3},
}
COMPARISON = [
    {"filename": f"{c}.jpg", "gt_live_count": 5 + i, "gt_dead_count": 2,
     "gt_total_count": 7 + i, "gt_viability": 100 * (5 + i) / (7 + i),
     "pred_live_count": 4, "pred_dead_count": 3 - i % 2, "pred_total_count": 7 - i % 2,
     "pred_viability": 400 / (7 - i % 2), "live_error": -1 - i, "dead_error": 1 - i % 2,
     "viability_error": 400 / (7 - i % 2) - 100 * (5 + i) / (7 + i)}
    for i, c in enumerate("abcd")]
RESULTS = {
    name: {"sem_mean_iou": 0.5 + i * 0.05, "sem_mean_dice": 0.6 + i * 0.05,
           "sem_background_iou": 0.9, "sem_background_dice": 0.95,
           "sem_live_iou": 0.5, "sem_live_dice": 0.6, "sem_dead_iou": 0.4,
           "sem_dead_dice": 0.5, "live_iou": 0.45, "dead_iou": 0.35,
           "live_precision": 0.7, "dead_precision": 0.6, "live_recall": 0.65,
           "dead_recall": 0.55, "viability_accuracy": 0.9, "bbox_mAP": 0.3,
           "segm_mAP": 0.28}
    for i, name in enumerate(("unet", "enhanced_unet"))}


def _single_model(v, inputs):
    """Every single-model chart, as `evaluate_model` and `visualize_model`
    call them."""
    images, gts, preds, probs, names = inputs
    v.plot_training_curves(HISTORY, MODEL)
    v.plot_learning_rate_schedule(HISTORY, MODEL)
    v.plot_class_wise_metrics(HISTORY, MODEL)
    v.save_training_history_csv(HISTORY, MODEL)
    v.plot_gradient_flow({"enc.weight": 1e-3, "dec.weight": 2e-4}, MODEL)
    v.plot_sample_grid(images, gts, preds, MODEL, filenames=names)
    v.plot_sample_predictions_grid(images, gts, preds, names, MODEL)
    v.visualize_predictions(images, gts, preds, names, MODEL)
    v.plot_confusion_matrix(gts, preds, MODEL)
    v.plot_cell_statistics(gts, preds, MODEL)
    v.plot_per_image_metrics(gts, preds, MODEL)
    v.plot_error_analysis(gts, preds, MODEL)
    v.plot_class_distribution(gts, preds, MODEL)
    v.plot_feature_importance(gts, preds, images, MODEL)
    v.plot_roc_curves(probs, gts, MODEL)
    v.plot_pr_curves(probs, gts, MODEL)
    v.plot_calibration_curve(probs, gts, MODEL)
    v.plot_boundary_accuracy(gts, preds, MODEL)
    v.plot_size_based_performance(gts, preds, MODEL)
    v.create_paper_figures(images, gts, preds, MODEL, filenames=names)
    v.plot_cell_count_comparison(COMPARISON, MODEL)


def _comparison(v):
    v.plot_model_comparison(RESULTS)
    v.plot_comprehensive_comparison(RESULTS)


def _recording(monkeypatch, module):
    saved = []

    def save(self, fig, filename, dpi=300):
        assert dpi == 300
        saved.append(filename)
        module.plt.close(fig)

    monkeypatch.setattr(module.Visualizer, "_save_figure", save)
    return saved


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def test_suite_asks_for_the_files_the_jax_package_does(tmp_path, monkeypatch):
    Visualizer(str(tmp_path / "warm"))            # matplotlib loaded, so `viz.plt` is set
    names = {}
    for pkg, module in (("jax", jviz), ("port", viz)):
        saved = _recording(monkeypatch, module)
        v = module.Visualizer(str(tmp_path / pkg))
        _single_model(v, _inputs())
        _comparison(v)
        names[pkg] = saved
    assert names["port"] == names["jax"]
    assert len(set(names["port"])) == 35          # 22 single-model (one twice) + 13
    assert names["port"].count(f"{MODEL}_sample_grid") == 2
    for csv_name in (f"{MODEL}_training_history.csv", f"{MODEL}_cell_count_comparison.csv"):
        assert _read(tmp_path / "port" / csv_name) == _read(tmp_path / "jax" / csv_name)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("seed,n,share", [(0, 1000, 0.3), (1, 257, 0.02), (2, 64, 0.9)])
def test_roc_and_pr_equal_jax(seed, n, share):
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < share
    scores = np.round(rng.random(n), 2)           # ties included
    for ours, ref in ((viz._roc, jviz._roc), (viz._pr, jviz._pr)):
        for a, b in zip(ours(labels, scores), ref(labels, scores)):
            np.testing.assert_array_equal(a, b)


def test_flattened_probabilities_equal_jax(tmp_path):
    _, gts, _, probs, _ = _inputs(seed=3)
    gts[0][0, :7] = 255                           # the ignore index
    probs = [np.transpose(probs[0], (2, 0, 1))] + probs[1:]   # CHW is taken too
    for c in range(3):
        for max_px in (200_000, 1000):
            ours = Visualizer(str(tmp_path))._flatten_class(probs, gts, c, max_px)
            ref = jviz.Visualizer(str(tmp_path))._flatten_class(probs, gts, c, max_px)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)


def test_evaluation_results_load_equal_jax(tmp_path, monkeypatch):
    write_results_csv(RESULTS, str(tmp_path / "evaluation_results.csv"))
    ours = Visualizer(str(tmp_path)).load_evaluation_results()
    assert ours == jviz.Visualizer(str(tmp_path)).load_evaluation_results()
    assert [r["模型"] for r in ours] == list(RESULTS)
    names = {}
    for pkg, module in (("jax", jviz), ("port", viz)):
        saved = _recording(monkeypatch, module)
        assert module.Visualizer(str(tmp_path)).plot_comprehensive_comparison_from_csv()
        names[pkg] = saved
    assert names["port"] == names["jax"] and len(names["port"]) == 12
    assert Visualizer(str(tmp_path / "empty")).load_evaluation_results() == []
    assert Visualizer(str(tmp_path / "empty")).plot_comprehensive_comparison_from_csv() is False


def test_matplotlib_loads_with_the_first_visualizer():
    probe = ("import sys\n"
             "import enhanced_unet_tpu_torch.viz, enhanced_unet_tpu_torch.train.api\n"
             "assert 'matplotlib' not in sys.modules\n"
             "from enhanced_unet_tpu_torch.viz import Visualizer\n"
             "import tempfile\n"
             "Visualizer(tempfile.mkdtemp())\n"
             "assert 'matplotlib.pyplot' in sys.modules\n"
             "import matplotlib\n"
             "assert matplotlib.get_backend().lower() == 'agg'\n"
             "print('LAZY OK')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "LAZY OK" in out.stdout
