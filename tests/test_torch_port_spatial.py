"""The port's spatial partitioning (`parallel/spatial.py`) against the JAX
package's (`enhanced_unet_tpu/parallel/spatial.py`).

The port's ranks are spawned gloo processes on the CPU, one thread each
(their functions are in `spatial_ranks.py`, which imports no JAX); the JAX
side runs here on the virtual devices of `conftest.py`
(`make_mesh(n, axis_name="space")`).  Weights are drawn with numpy into the
flax tree `jax.eval_shape` gives and carried by
`convert/jax_params.state_dict_from_jax`.  Held:

- `halo_exchange`'s rows, "zero" and "edge", at 4 and 8 ranks: exact;
- at 4 ranks: `make_spatial_conv3x3` at 64 x 32 x 8 -> 16 (atol 1e-5),
  `make_spatial_basic_unet` at 128 x 32 (atol 2e-4, rtol 1e-3),
  `make_spatial_apply` of `unet_basic` and of the flagship with
  efficientnet-tiny encoders at 64^2 (1e-4 and 2e-4; the flagship's stride-16
  maps are one row a band there, so ASPP's dilated convolutions take the
  gathered path, and its stride-32 maps are held whole), and the flagship
  with `fusion_stride=2` against the port's own unsharded forward (1e-5 of
  max |logit|); a `unet_basic` input whose bands do not halve raises
  `ValueError` on the ranks;
- at 8 ranks, JAX's own spatial test shape (`tests/test_spatial.py:106-127`,
  there with b0 encoders): the flagship with efficientnet-tiny encoders on
  one 64^2 image against JAX's `make_spatial_apply` on `make_mesh(8)`
  (2e-4; its stride-8 maps are one row a band);
- K1's windowed pass 1 and the block on haloed bands (plain versions): the
  bands' sums add up to the whole map's, and the bands' rows of the block
  are the whole map's (fp32 1e-5);
- at world size 1 (in this process): `make_spatial_apply` equals each
  model's own forward and `make_spatial_basic_unet` BasicUNet's (1e-5 of
  max |logit|), every resize the mode rewrites equals `F.interpolate`
  (1e-6; both also with their rows in chunks of about 64 elements), an
  operation that reads along H and that the mode does not know raises
  `NotImplementedError`, and H that does not split raises `ValueError`.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import PartitionSpec as P

from spatial_ranks import JOIN, apply_rank, halo_rank, port_model, spatial_rank

from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.models.unet import BasicUNet as JBasicUNet
from enhanced_unet_tpu.parallel import make_mesh as jmake_mesh
from enhanced_unet_tpu.parallel import spatial as jspatial
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.models import init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import mbconv
from enhanced_unet_tpu_torch.parallel import make_mesh, spatial, spawn
from enhanced_unet_tpu_torch.parallel.spatial import (
    halo_exchange,
    make_spatial_apply,
    make_spatial_basic_unet,
    shard_image_h,
)

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
RANKS = 4


def draw(shapes, seed):
    """numpy leaves for a `jax.eval_shape` tree: kernels N(0, 1/fan_in),
    biases and means N(0, 1/4), scales and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if s.ndim > 1 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(model, hw, seed):
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 3), jnp.float32))
    return draw(shapes, seed)


def close(ours, ref, rel):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = np.abs(ours - ref).max()
    assert diff <= rel * np.abs(ref).max(), (diff, np.abs(ref).max())


# ---- halo_exchange at 4 and 8 ranks ----------------------------------------

@functools.lru_cache(maxsize=None)
def _halos(n, tmp):
    os.makedirs(tmp, exist_ok=True)
    x = np.arange(64 * 4 * 2, dtype=np.float32).reshape(64, 4, 2)
    spawn(halo_rank, n, (torch.from_numpy(x), 1, tmp), device="cpu", init_dir=tmp,
          timeout=JOIN)
    ours = [torch.load(os.path.join(tmp, f"halo{r}.pt")) for r in range(n)]
    mesh = jmake_mesh(n, axis_name="space")
    want = {}
    for mode in ("zero", "edge"):
        f = shard_map(lambda xl: jspatial.halo_exchange(xl, 1, "space", mode), mesh=mesh,
                      in_specs=P("space", None, None), out_specs=P("space", None, None),
                      check_vma=False)
        got = jax.jit(f)(jspatial.shard_image_h(jnp.asarray(x), mesh, "space"))
        want[mode] = np.asarray(got).reshape(n, 64 // n + 2, 4, 2)
    return x, ours, want


@pytest.mark.parametrize("mode", ["zero", "edge"])
@pytest.mark.parametrize("n", [4, 8])
def test_halo_exchange_matches_jax(n, mode, tmp_path_factory):
    x, ours, want = _halos(n, str(tmp_path_factory.getbasetemp() / f"halo{n}"))
    hl = 64 // n
    for r in range(n):
        got = ours[r][mode].numpy()
        np.testing.assert_array_equal(got, want[mode][r])
        np.testing.assert_array_equal(got[1:-1], x[r * hl:(r + 1) * hl])


# ---- the 4-rank run against JAX's spatial functions ------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, both ranks' whole results and JAX's."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    rng = np.random.default_rng(0)
    jmesh = jmake_mesh(RANKS, axis_name="space")
    want, inputs = {}, {"apply": {}}

    x = rng.normal(size=(64, 32, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 16)) * 0.1).astype(np.float32)
    want["conv"] = np.asarray(jspatial.make_spatial_conv3x3(jmesh, "space")(
        jspatial.shard_image_h(jnp.asarray(x), jmesh, "space"), jnp.asarray(w)))
    inputs["conv"] = (torch.from_numpy(x), torch.from_numpy(w))

    x = rng.normal(size=(128, 32, 3)).astype(np.float32)
    jmodel = JBasicUNet(num_classes=3, dtype=jnp.float32)
    v = jax_variables(jmodel, (128, 32), 1)
    want["basic_unet"] = np.asarray(jspatial.make_spatial_basic_unet(jmesh, "space")(
        v, jspatial.shard_image_h(jnp.asarray(x), jmesh, "space")))
    inputs["basic_unet"] = (state_dict_from_jax(v["params"], v["batch_stats"],
                                                model_name="unet_basic"), torch.from_numpy(x))

    for key, name, kwargs in (("unet_basic", "unet_basic", {}),
                              ("flagship", "enhanced_unet", {"encoder_names": TINY})):
        jmodel = jget_model(name, dtype=jnp.float32, **kwargs)
        v = jax_variables(jmodel, (64, 64), 2)
        x = rng.random((1, 64, 64, 3)).astype(np.float32)
        want[key] = np.asarray(jspatial.make_spatial_apply(jmodel, jmesh, "space")(
            v, jnp.asarray(x)))
        sd = state_dict_from_jax(v["params"], v["batch_stats"], model_name=name,
                                 **({"variants": TINY} if name == "enhanced_unet" else {}))
        inputs["apply"][key] = (name, sd, kwargs, torch.from_numpy(x))
    x = torch.from_numpy(rng.random((1, 64, 64, 3)).astype(np.float32))
    fs2 = {"encoder_names": TINY, "fusion_stride": 2}
    inputs["apply"]["flagship_fs2"] = ("enhanced_unet", None, fs2, x)
    with torch.no_grad():
        want["flagship_fs2"] = port_model("enhanced_unet", **fs2)(x)[0].numpy()
    inputs["no_split"] = ("unet_basic", torch.from_numpy(rng.random((1, 48, 32, 3),
                                                                     dtype=np.float32)))
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    spawn(spatial_rank, RANKS, (path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"out{r}.pt")) for r in range(RANKS)], want


def test_spatial_conv3x3_matches_jax(run):
    ranks, want = run
    np.testing.assert_allclose(ranks[0]["conv"].numpy(), want["conv"], atol=1e-5)


def test_spatial_basic_unet_matches_jax(run):
    ranks, want = run
    np.testing.assert_allclose(ranks[0]["basic_unet"].numpy(), want["basic_unet"],
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("key,tol", [("unet_basic", 1e-4), ("flagship", 2e-4)])
def test_spatial_apply_matches_jax(run, key, tol):
    ranks, want = run
    np.testing.assert_allclose(ranks[0][key].numpy(), want[key], rtol=tol, atol=tol)


def test_spatial_apply_fusion_stride_2_matches_unsharded(run):
    ranks, want = run
    close(ranks[0]["flagship_fs2"].numpy(), want["flagship_fs2"], 1e-5)


def test_every_rank_gathers_the_same_result(run):
    ranks, _ = run
    for key in ("conv", "basic_unet", "unet_basic", "flagship", "flagship_fs2"):
        for r in range(1, RANKS):
            assert torch.equal(ranks[r][key], ranks[0][key]), (key, r)


def test_bands_that_do_not_halve_raise_on_every_rank(run):
    ranks, _ = run
    for r in range(RANKS):
        assert ranks[r]["no_split"] is not None
        assert "does not split bands of 3 rows" in ranks[r]["no_split"]


# ---- the flagship at 8 ranks, JAX's own spatial test shape ---------------------

@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    """The port's 8 ranks' whole logits and JAX's."""
    tmp = str(tmp_path_factory.mktemp("spatial8"))
    jmodel = jget_model("enhanced_unet", dtype=jnp.float32, encoder_names=TINY)
    v = jax_variables(jmodel, (64, 64), 8)
    x = np.random.default_rng(8).random((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jspatial.make_spatial_apply(jmodel, jmake_mesh(8, axis_name="space"),
                                                  "space")(v, jnp.asarray(x)))
    sd = state_dict_from_jax(v["params"], v["batch_stats"], variants=TINY)
    path = os.path.join(tmp, "inputs.pt")
    torch.save({"flagship": ("enhanced_unet", sd, {"encoder_names": TINY},
                             torch.from_numpy(x))}, path)
    spawn(apply_rank, 8, (path, tmp), device="cpu", init_dir=tmp, timeout=JOIN)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"))["flagship"] for r in range(8)], want


def test_spatial_apply_flagship_8_ranks_matches_jax(run8):
    ranks, want = run8
    np.testing.assert_allclose(ranks[0].numpy(), want, rtol=2e-4, atol=2e-4)


def test_spatial_apply_flagship_8_ranks_gather_the_same(run8):
    ranks, _ = run8
    assert all(torch.equal(r, ranks[0]) for r in ranks[1:])


# ---- K1 on haloed bands (plain versions) ------------------------------------

def _bands(x, n):
    """The n bands of x [N, C, H, W], each haloed by one row (zeros beyond
    the map)."""
    hl = x.shape[2] // n
    xp = F.pad(x, (0, 0, 1, 1))
    return [xp[:, :, r * hl:(r + 1) * hl + 2] for r in range(n)]


@pytest.mark.parametrize("n,c,cout,h,w", [(2, 24, 24, 16, 12), (1, 16, 8, 12, 20)])
@torch.no_grad()
def test_k1_windowed_pass1_bands_add_up(n, c, cout, h, w):
    blk = init_random_weights_(MBConvBlock(c, cout, 1, 1, 3, fused=True,
                                           dtype=torch.float32), 3).eval()
    p = blk.fold()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(n, c, h, w))
                         .astype(np.float32))
    whole = mbconv.mbconv_pass1_plain(x, p)
    hl = h // 4
    sums = sum(mbconv.mbconv_pass1_plain(xb, p, (1, 1 + hl)) for xb in _bands(x, 4))
    close(sums.numpy(), whole.numpy(), 1e-5)
    # the block on each haloed band: pass 1 windowed, the four bands' sums
    # added (an all-reduce), the gate over the whole map's pixels
    bands = _bands(x, 4)
    partial = [mbconv.mbconv_pass1_plain(xb, p, (1, 1 + hl)) for xb in bands]
    total = sum(partial)
    want = mbconv.mbconv_infer_nchw(x, p, residual=blk.residual)
    for r, xb in enumerate(bands):
        got = mbconv.mbconv_infer_nchw(xb, p, residual=blk.residual, rows=(1, 1 + hl),
                                       reduce=lambda s: s.copy_(total), hw=h * w)
        close(got[:, :, 1:-1].numpy(), want[:, :, r * hl:(r + 1) * hl].numpy(), 1e-5)
    with pytest.raises(ValueError, match="not inside"):
        mbconv.mbconv_pass1_plain(x, p, (2, h + 1))


# ---- world size 1, in this process ------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    mesh = make_mesh(1, "space", device="cpu", init_dir=str(tmp_path_factory.mktemp("ws1")))
    yield mesh
    dist.destroy_process_group()


_WS1 = {"unet_basic": ((64, 48), {}), "enhanced_unet": ((64, 64), {"encoder_names": TINY}),
        "linknet": ((64, 40), {}), "pspnet": ((48, 64), {}), "fcn": ((64, 32), {}),
        "segnet": ((48, 32), {})}


@pytest.mark.parametrize("name", sorted(_WS1))
def test_world_size_1_equals_the_model(mesh1, name):
    hw, kwargs = _WS1[name]
    model = port_model(name, **kwargs)
    x = torch.from_numpy(np.random.default_rng(4).random((2, *hw, 3), dtype=np.float32))
    with torch.no_grad():
        want = model(x)[0]
    got = make_spatial_apply(model, mesh1)(x)
    close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunks"])
def test_world_size_1_basic_unet_equals_the_model(mesh1, monkeypatch, chunk):
    if chunk is not None:             # the upsamples' rows in chunks
        monkeypatch.setattr(spatial, "_CHUNK", chunk)
    model = port_model("unet_basic")
    x = torch.from_numpy(np.random.default_rng(6).random((32, 40, 3), dtype=np.float32))
    with torch.no_grad():
        want = model(x[None])[0][0]
    close(make_spatial_basic_unet(mesh1)(model, x).numpy(), want.numpy(), 1e-5)


class _Resize(nn.Module):
    """The NHWC input resized as `kwargs` say, to a size read from the band
    or by a scale factor."""

    def __init__(self, **kwargs):
        super().__init__()
        self.kwargs = kwargs

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        kw = dict(self.kwargs)
        if "size" in kw:
            kw["size"] = (x.shape[2] * kw["size"][0] // 8, x.shape[3] * kw["size"][1] // 8)
        return F.interpolate(x, **kw).permute(0, 2, 3, 1)


@pytest.mark.parametrize("kwargs", [
    dict(size=(20, 12), mode="bilinear", align_corners=False),     # up by 5/2, 3/2
    dict(size=(3, 5), mode="bilinear", align_corners=False),       # down
    dict(size=(28, 28), mode="bilinear", align_corners=True),
    dict(size=(12, 4), mode="nearest"),
    dict(scale_factor=2, mode="nearest"),
], ids=["bilinear-up", "bilinear-down", "align-corners", "nearest", "nearest-2x"])
@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunks"])
def test_world_size_1_resizes_equal_interpolate(mesh1, monkeypatch, kwargs, chunk):
    if chunk is not None:             # output rows in chunks of about 64 elements
        monkeypatch.setattr(spatial, "_CHUNK", chunk)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 16, 24, 3))
                         .astype(np.float32))
    model = _Resize(**kwargs).eval()
    with torch.no_grad():
        want = model(x)
    close(make_spatial_apply(model, mesh1)(x).numpy(), want.numpy(), 1e-6)


class _ReadsH(nn.Module):
    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x):
        return self.op(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("op,name", [
    (lambda t: torch.flip(t, [2]), "flip"),
    (lambda t: torch.roll(t, 1, 2), "roll"),
    (lambda t: t.cumsum(2), "cumsum"),
    (lambda t: t[:, :, 1:], "indexing a band along H"),
    (lambda t: F.avg_pool2d(t, 3, 1, 1), "avg_pool2d"),
    (lambda t: torch.cat([t, t], 2), "cat of bands along H"),
    (lambda t: t.permute(0, 1, 3, 2), "permute moves a band's H to dim 3"),
    (lambda t: t.reshape(t.shape[0], t.shape[1], 1, -1), "reshape of a band"),
    (lambda t: t.view(t.shape[0], t.shape[1], t.shape[2] // 2, -1), "view of a band"),
    (lambda t: F.interpolate(t, size=(4, 4)), "interpolate to 4 rows"),
    (lambda t: F.interpolate(t, size=(t.shape[2] + 2, 4)), "interpolate to 10 rows"),
])
def test_an_unknown_op_along_h_raises(mesh1, op, name):
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(NotImplementedError, match=name):
        make_spatial_apply(_ReadsH(op).eval(), mesh1)(x)


class _NHWCOp(nn.Module):
    """An operation on the model's NHWC input itself, H at dim 1."""

    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x):
        return self.op(x)


@pytest.mark.parametrize("op,name", [
    (lambda t: t.mean(1, keepdim=True), "mean of a band along H"),
    (lambda t: t[:, 1:], "indexing a band along H"),
    (lambda t: t.permute(0, 3, 2, 1), "permute moves a band's H to dim 3"),
    (lambda t: torch.cat([t, t], 1), "cat of bands along H"),
    (lambda t: t[..., :1] * t.permute(0, 3, 1, 2)[:, :1], "NHWC band with another map"),
])
def test_an_op_along_h_of_the_nhwc_input_raises(mesh1, op, name):
    x = torch.zeros(1, 8, 8, 8)
    with pytest.raises(NotImplementedError, match=name):
        make_spatial_apply(_NHWCOp(op).eval(), mesh1)(x)


def test_the_nhwc_input_reads_its_own_w_and_c(mesh1):
    """On the NHWC input, W and C are no band's: a mean over W and a
    channel slice are local (the mode once took its dim 2 for H)."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 8, 6, 3))
                         .astype(np.float32))
    model = _NHWCOp(lambda t: t.mean(2, keepdim=True)[..., :2] * t[..., 1:]).eval()
    with torch.no_grad():
        want = model(x)
    close(make_spatial_apply(model, mesh1)(x).numpy(), want.numpy(), 1e-6)


def test_h_that_does_not_split_raises(mesh1):
    class _Mesh:
        rank, size, device = 0, 4, torch.device("cpu")

    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        shard_image_h(torch.zeros(66, 8, 3), _Mesh())
    with pytest.raises(ValueError, match="not a multiple of 8"):
        make_spatial_basic_unet(mesh1)(port_model("unet_basic"), torch.zeros(12, 16, 3))
    with pytest.raises(ValueError, match="eval mode"):
        make_spatial_apply(port_model("unet_basic").train(), mesh1)(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError, match="unknown halo mode"):
        halo_exchange(torch.zeros(8, 4, 2), 1, mesh1, "reflect")
