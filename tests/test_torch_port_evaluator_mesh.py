"""The port's Evaluator with a mesh (`train/evaluator.py`,
`Evaluator(..., mesh=...)`) against the JAX package's
(`enhanced_unet_tpu/train/evaluator.py`, `Evaluator(..., mesh=make_mesh(2))`).

The port's two ranks are spawned gloo processes on the CPU, one thread each
(their function is `tp_ranks.evaluator_mesh_rank`, which imports no JAX);
the JAX side runs here on the virtual devices of `conftest.py`.
`unet_basic` with weights drawn into the flax tree and carried by
`state_dict_from_jax`, tile 64, overlap 16, on a 152 x 144 image (a 3 x 3
grid: nine tiles, an odd count, so that the chunks are padded).  Held:

- `predict_probs_tiled` within 1e-4 of JAX's on the same enhanced image
  (JAX's: the port's CLAHE differs from the jitted JAX one by a few grey
  levels, `test_torch_port_tiling.py`), with `tile_batch` None (chunks of
  8: 16 tiles, 4 a rank a chunk) and 3 (rounded to 2, the mesh's size: 10
  tiles, 1 a rank a chunk), the same on both ranks;
- `predict_semantic_mask` equal to JAX's, through the host-stitched path;
- `evaluate` with the mesh equal to the port's tiled Evaluator without it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_ranks import JOIN
from synthdata import make_synthetic_dataset
from test_torch_port_spatial import jax_variables
from tp_ranks import evaluator_mesh_rank

from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.parallel import make_mesh as jmake_mesh
from enhanced_unet_tpu.train.evaluator import Evaluator as JEvaluator
from enhanced_unet_tpu.train.trainer import TrainState as JTrainState
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.data import BatchLoader, CellDataset
from enhanced_unet_tpu_torch.parallel import spawn

torch.set_num_threads(1)
H, W, TILE, OVERLAP = 152, 144, 64, 16


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("evalmesh"))
    jmodel = jget_model("unet_basic", dtype=jnp.float32)
    v = jax_variables(jmodel, (64, 64), 11)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=(), apply_fn=jmodel.apply,
                        tx=None)
    img = np.random.default_rng(12).random((H, W, 3)).astype(np.float32)
    want, tiled = {}, {}
    for key, tile_batch in (("auto", None), ("three", 3)):
        jev = JEvaluator(state, "unet_basic", verbose=False, tiled=True, tile=TILE,
                         overlap=OVERLAP, tile_batch=tile_batch, mesh=jmake_mesh(2))
        enhanced = np.array(jev._enhance(jnp.asarray(img)))
        want[key] = {"probs": jev.predict_probs_tiled(img),
                     "mask": jev.predict_semantic_mask(img)}
        tiled[key] = (tile_batch, img, enhanced)
    data = os.path.join(tmp, "cells")
    make_synthetic_dataset(data, n_images=2, size=96, cells_per_image=6, seed=13)
    ds = CellDataset(data, split="train", max_size=96, files=["cell_000.jpg", "cell_001.jpg"])
    loader = list(BatchLoader(ds, 2, (96, 96), train=False, preprocess=False, prefetch=0,
                              device="cpu"))
    sd = state_dict_from_jax(v["params"], v["batch_stats"], model_name="unet_basic")
    path = os.path.join(tmp, "inputs.pt")
    torch.save({"model": ("unet_basic", sd, {}), "tile": TILE, "overlap": OVERLAP,
                "tiled": tiled, "loader": loader}, path)
    spawn(evaluator_mesh_rank, 2, (path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"eval{r}.pt"), weights_only=False)
            for r in range(2)], want


@pytest.mark.parametrize("key,shares", [("auto", [4, 4]), ("three", [1] * 5)])
def test_probs_tiled_match_jax(served, key, shares):
    ranks, want = served
    for r in ranks:
        got = r[key]
        assert got["probs"].shape == (H, W, 3)
        np.testing.assert_allclose(got["probs"], want[key]["probs"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["probs"], ranks[0][key]["probs"])
        # predict_probs_tiled's chunks, then predict_semantic_mask's
        assert got["shares"] == shares + shares


@pytest.mark.parametrize("key", ["auto", "three"])
def test_semantic_mask_matches_jax(served, key):
    ranks, want = served
    for r in ranks:
        mask = r[key]["mask"]
        assert mask.dtype == np.uint8 and mask.shape == (H, W)
        np.testing.assert_array_equal(mask, np.asarray(want[key]["mask"]))


def test_evaluate_with_the_mesh_equals_without(served):
    ranks, _ = served
    for r in ranks:
        got, ref = r["evaluate"]["mesh"], r["evaluate"]["none"]
        assert set(got) == set(ref) and all(np.isfinite(v) for v in got.values())
        assert got == ref
