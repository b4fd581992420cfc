"""The port's reports rendered for real: every chart of the single-model
suite and of the comparison suite writes a non-empty PNG and SVG (dpi
300) and the two CSVs.  `tests/test_torch_port_viz.py` holds the same
suite against the JAX package with the rendering patched out; the
rendering alone takes about 50 s on one CPU core, so it is split in two
tests here."""

import os

import pytest

from enhanced_unet_tpu_torch.viz import Visualizer
from test_torch_port_viz import MODEL, _comparison, _inputs
from test_torch_port_viz import _single_model as _single_model_suite


def _single_model(v):
    _single_model_suite(v, _inputs(n=2, h=40, w=40))


@pytest.mark.parametrize("suite,figures,csvs", [
    (_single_model, 22, {f"{MODEL}_training_history.csv",
                         f"{MODEL}_cell_count_comparison.csv"}),
    (_comparison, 13, set()),
])
def test_port_suite_renders(tmp_path, suite, figures, csvs):
    suite(Visualizer(str(tmp_path)))
    files = os.listdir(tmp_path)
    bases = {os.path.splitext(f)[0] for f in files if f.endswith(".png")}
    assert len(bases) == figures
    for b in bases:
        for ext in ("png", "svg"):
            assert os.path.getsize(tmp_path / f"{b}.{ext}") > 0, (b, ext)
    assert {f for f in files if f.endswith(".csv")} == csvs
    assert len(files) == 2 * figures + len(csvs)
