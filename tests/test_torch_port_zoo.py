"""PyTorch port vs JAX package: the ten zoo models beside the flagship
(segnet, unet, unet_basic, enhanced_unet_basic, fcn, fcn_basic, pspnet,
pspnet_basic, linknet, linknet_basic), the ResNet encoders and the zoo's
blocks.

Every flax leaf is drawn with numpy into the tree `jax.eval_shape` of the
model's `init` gives (BatchNorm statistics not the identity) and carried
into the port by `convert.jax_params.state_dict_from_jax(...,
model_name=...)`, loaded strictly.  fp32 on the CPU; tolerance: max |diff|
<= 1e-4 of the reference's max |value| (fp32 summation-order noise only).
In eval mode the port's 3x3 ConvBNActs run through K2's wrapper, i.e. its
plain version here.  Train mode is held against the JAX model computed in
fp64 (its own fp32 noise reaches 1e-4 there), the fp32 port at 1e-4 and the
fp64 port at 1e-6; FCN's and PSPNet's dropout is off in both packages (their
draws differ).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as fnn

from enhanced_unet_tpu.convert.torch_import import _conv2drelu, convert_resnet
from enhanced_unet_tpu.models import blocks as jblocks
from enhanced_unet_tpu.models import get_model as jget_model
from enhanced_unet_tpu.models.encoders import ResNetEncoder as JResNetEncoder
from enhanced_unet_tpu.models.encoders import build_encoder as jbuild_encoder
from enhanced_unet_tpu.ops import resize as jresize
from enhanced_unet_tpu_torch.convert.jax_params import state_dict_from_jax
from enhanced_unet_tpu_torch.models import blocks, get_model, init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import ResNetEncoder, build_encoder
from enhanced_unet_tpu_torch.models.linknet import conv_transpose_same
from enhanced_unet_tpu_torch.ops import resize

torch.set_num_threads(1)
F32 = torch.float32
ZOO = ("segnet", "unet", "unet_basic", "enhanced_unet_basic", "fcn", "fcn_basic",
       "pspnet", "pspnet_basic", "linknet", "linknet_basic")


def _close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = np.abs(ours - ref).max()
    assert diff <= rel * np.abs(ref).max() + 1e-6, (diff, np.abs(ref).max())


def _draw(shapes, seed):
    """numpy leaves for a `jax.eval_shape` tree: kernels N(0, 1/fan_in),
    biases and means N(0, 1/4), scales and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 4
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _variables(name, seed=3):
    ref = jget_model(name, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: ref.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    return ref, _draw(shapes, seed)


def _pair(name):
    """(flax model, its numpy variables, the port model on the CPU with the
    same weights)."""
    ref, v = _variables(name)
    port = get_model(name, dtype=F32, device="cpu", seed=99)
    sd = state_dict_from_jax(v["params"], v.get("batch_stats", {}), model_name=name)
    port.load_state_dict(sd, strict=True)
    return ref, v, port


def _input(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (2, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_eval_matches_jax(name, hw):
    ref, v, port = _pair(name)
    x = _input(*hw)
    with torch.no_grad():
        logits, aux = port(torch.from_numpy(x))
    want, _ = jax.jit(lambda v, x: ref.apply(v, x, False))(v, jnp.asarray(x))
    assert aux == {} and logits.dtype == F32
    assert tuple(logits.shape) == (2, *hw, 3)
    _close(logits.numpy(), want)


class _NoDropout(fnn.Module):
    """flax `nn.Dropout` with the rate ignored: the identity."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def _train_forward(port, x, dtype):
    port = port.to(dtype).train()
    for m in port.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    with torch.no_grad():
        logits, _ = port(torch.from_numpy(x).to(dtype),
                         generator=torch.Generator().manual_seed(0))
    return logits.numpy(), {k: v.double().numpy() for k, v in port.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", ZOO)
def test_zoo_train_matches_jax(name, monkeypatch):
    """Train mode (batch statistics, the running statistics' update),
    against the JAX model computed in fp64: JAX's own fp32 train-mode
    logits sit up to about 1e-4 of max |logit| from its fp64 ones (ResNet-50
    UNet: 1.02e-4; its BatchNorm takes E[x^2] - E[x]^2 over 8 values at
    s32), so the fp32 port is held against the fp64 reference, and the fp64
    port against it as well."""
    ref, v, _ = _pair(name)
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)   # FCN's and PSPNet's dropout off
    x = _input(64, 64, seed=1)
    with jax.enable_x64(True):
        ref64 = jget_model(name, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        (want, _), new_vars = ref64.apply(v64, jnp.asarray(x, jnp.float64), True,
                                          mutable=["batch_stats"])
        want = np.asarray(want, np.float64)
        stats = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             new_vars.get("batch_stats", {}))
    want_sd = state_dict_from_jax(v["params"], stats, model_name=name)
    start_sd = state_dict_from_jax(v["params"], v.get("batch_stats", {}), model_name=name)
    for dtype, rel in ((torch.float32, 1e-4), (torch.float64, 1e-6)):
        _, _, port = _pair(name)
        if name == "fcn":
            port.model["decoder"].dropout = 0.0
        if name == "pspnet":
            port.dropout = 0.0
        logits, running = _train_forward(port, x, dtype)
        _close(logits, want, rel)
        assert len(running) == sum(k.endswith(("running_mean", "running_var"))
                                   for k in want_sd)
        assert len(running) > 0 or name == "fcn_basic"
        for k, r in running.items():
            _close(r, want_sd[k].numpy(), rel)
            assert not np.array_equal(r, start_sd[k].numpy()), k


@pytest.mark.parametrize("variant", ["resnet18", "resnet34", "resnet50"])
def test_resnet_encoder_matches_jax_through_convert_resnet(variant):
    """A port state dict read by JAX's own `convert_resnet`: this holds the
    torchvision names by themselves."""
    port = init_random_weights_(ResNetEncoder(variant, dtype=F32), 5).eval()
    params, stats = convert_resnet(port.state_dict(), variant)
    x = _input(64, 96)
    with torch.no_grad():
        ours = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    ref = JResNetEncoder(variant=variant, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    assert len(ours) == len(ref) == 6
    assert [f.shape[1] for f in ours] == port.out_channels
    for a, b in zip(ours, ref):
        _close(a.permute(0, 2, 3, 1).numpy(), b)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_max_pool_with_indices_takes_the_first_maximum_like_jax(rng):
    # values from a coarse grid: most 2x2 windows hold ties
    x = rng.integers(0, 3, (2, 8, 12, 5)).astype(np.float32)
    pooled, idx = blocks.max_pool_with_indices(_nchw(x))
    ref_pooled, ref_idx = jblocks.max_pool_with_indices(jnp.asarray(x))
    ties = (x.reshape(2, 4, 2, 6, 2, 5) == np.asarray(ref_pooled)[:, :, None, :, None]
            ).sum(axis=(2, 4))
    assert (ties > 1).mean() > 0.3
    np.testing.assert_array_equal(_nhwc(pooled), np.asarray(ref_pooled))
    np.testing.assert_array_equal(_nhwc(idx), np.asarray(ref_idx))
    np.testing.assert_array_equal(_nhwc(blocks.max_unpool_2x2(pooled, idx)),
                                  np.asarray(jblocks.max_unpool_2x2(ref_pooled, ref_idx)))


def test_max_pool_2x2_matches_jax(rng):
    x = rng.normal(size=(2, 10, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(blocks.max_pool_2x2(_nchw(x))),
                                  np.asarray(jblocks.max_pool_2x2(jnp.asarray(x))))


@pytest.mark.parametrize("hw,out", [((8, 8), 2), ((4, 4), 3), ((4, 6), 6), ((7, 5), 3),
                                    ((32, 32), 6)])
def test_adaptive_avg_pool_matches_jax(rng, hw, out):
    x = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    _close(_nhwc(blocks._adaptive_avg_pool(_nchw(x), out)),
           jblocks._adaptive_avg_pool(jnp.asarray(x), out))


@pytest.mark.parametrize("hw", [(5, 7), (8, 8)])
def test_upsample2x_matches_jax(rng, hw):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    _close(resize.upsample2x(torch.from_numpy(x)).numpy(), jresize.upsample2x(jnp.asarray(x)))
    _close(_nhwc(resize.upsample2x_nchw(_nchw(x))), jresize.upsample2x(jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
def test_conv_transpose_recipe_matches_flax(rng, hw):
    ref = fnn.ConvTranspose(6, (3, 3), strides=(2, 2), padding="SAME")
    x = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    v = _draw(jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    layer = torch.nn.ConvTranspose2d(4, 6, 3, stride=2)
    k = v["params"]["kernel"]
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))))
        layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
    ours = conv_transpose_same(_nchw(x), layer, F32)
    want = ref.apply(v, jnp.asarray(x))
    assert tuple(ours.shape) == (2, 6, 2 * hw[0], 2 * hw[1])
    _close(_nhwc(ours), want)


def test_conv_bn_act_without_bn_on_k2_plain_matches_flax(rng):
    port = init_random_weights_(blocks.ConvBNAct(8, 12, use_bn=False, dtype=F32), 1).eval()
    ref = jblocks.ConvBNAct(12, use_bn=False, dtype=jnp.float32)
    v = {"params": {"Conv_0": {
        "kernel": np.transpose(port[0].weight.detach().numpy(), (2, 3, 1, 0)),
        "bias": port[0].bias.detach().numpy()}}}
    x = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
    calls = []
    real = blocks.fused_conv3x3_bn_relu_packed

    def spy(xh, packed, relu=True):
        calls.append(packed)
        return real(xh, packed, relu)

    blocks.fused_conv3x3_bn_relu_packed = spy
    try:
        with torch.no_grad():
            ours = port(_nchw(x))
    finally:
        blocks.fused_conv3x3_bn_relu_packed = real
    assert len(port) == 1 and len(calls) == 1
    np.testing.assert_array_equal(calls[0].scale.numpy(), np.ones(12, np.float32))
    np.testing.assert_array_equal(calls[0].shift.numpy(), port[0].bias.detach().numpy())
    _close(_nhwc(ours), ref.apply(v, jnp.asarray(x), False))
    # train mode: the plain conv with its bias, then ReLU
    with torch.no_grad():
        trained = port.train()(_nchw(x))
        want = F.relu(F.conv2d(_nchw(x), port[0].weight, port[0].bias, padding=1))
    _close(trained.numpy(), want.numpy())


@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (1, 2), (7, 1)])
def test_conv_bn_act_strided_matches_flax_torch_padding(rng, k, stride):
    port = init_random_weights_(blocks.ConvBNAct(4, 8, k, stride, dtype=F32), 2).eval()
    p, s = _conv2drelu({f"m.{n}": t for n, t in port.state_dict().items()}, "m")
    ref = jblocks.ConvBNAct(8, (k, k), (stride, stride), padding="torch", dtype=jnp.float32)
    x = rng.normal(size=(2, 11, 14, 4)).astype(np.float32)
    with torch.no_grad():
        ours = _nhwc(port(_nchw(x)))
    _close(ours, ref.apply({"params": p, "batch_stats": s}, jnp.asarray(x), False))


@pytest.mark.parametrize("name,depth", [("resnet34", 4), ("efficientnet-tiny", 5)])
def test_build_encoder_matches_jax(name, depth):
    port = build_encoder(name, depth, dtype=F32)
    ref = jbuild_encoder(name, depth, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: ref.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    x = _input(64, 64)
    with torch.no_grad():
        ours = port.eval()(_nchw(x))
    want = ref.apply(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                     jnp.asarray(x), False)
    assert [tuple(f.permute(0, 2, 3, 1).shape) for f in ours] == [f.shape for f in want]
    with pytest.raises(ValueError, match="unknown encoder"):
        build_encoder("vgg16")


def test_get_model_builds_all_eleven_names_of_the_jax_registry():
    from enhanced_unet_tpu.models import _REGISTRY as JREG
    from enhanced_unet_tpu_torch.models import PORT_ONLY, _REGISTRY

    # the JAX package's eleven names, and the names only the port serves
    assert not set(PORT_ONLY) & set(JREG)
    assert sorted(_REGISTRY) == sorted([*JREG, *PORT_ONLY])
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("resnet", device="cpu")
