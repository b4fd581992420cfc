"""The fused MBConv's expand blocks (`variant_for` "nhwc_expand": bf16, an
expand, Cin and Cout multiples of 8 up to 64, mid a multiple of 8), on the
CPU.

On the CPU the wrapper runs its plain version, the plain version of every
kernel variant.  These tests hold it, through the port's `MBConvBlock` on a
channels_last input, against the JAX package at EfficientNet's stage-1
expand blocks (B5: 40 -> 240 -> 40, B4: 32 -> 192 -> 32, both residual),
with H and W that are not multiples of the kernels' 16- or 8-row x 32-column
tiles.  The weights are drawn with numpy from a seed in the flax block's
variable tree and carried into the port by `convert/jax_params.py`.

- the flax `MBConvBlock` stock path (fp32: 1e-5 of the reference's max
  |value|; bf16: 2e-2);
- the Pallas `mbconv_infer_nchw` in interpret mode (bf16, 2e-2; its H must
  be a multiple of 8).

Also: which variant each block reaches, the kernels' tile rows, and that
the new entry points refuse a CPU or an fp32 tensor without launching.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enhanced_unet_tpu.models.encoders import MBConvBlock as JMBConv
from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
from enhanced_unet_tpu_torch.convert import jax_params
from enhanced_unet_tpu_torch.models import init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import copy, mbconv

torch.set_num_threads(1)

# (cin, ratio, cout) of the stride-1 3x3 expand blocks of stage 1 (B5, B4)
STAGE1_BLOCKS = [(40, 6, 40), (32, 6, 32)]


def _flax_vars(cin, ratio, cout, dtype, seed):
    """A flax MBConvBlock and its variables, every leaf drawn with numpy
    (BatchNorm variances positive)."""
    ref = JMBConv(cin, cout, ratio, (1, 1), 3,
                  dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    shapes = jax.eval_shape(lambda k, x: ref.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, cin), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 4
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return ref, jax.tree_util.tree_map_with_path(draw, shapes)


def _port_block(v, cin, ratio, cout, dtype):
    """The port's fused block with the flax variables, carried by
    `convert/jax_params.py`'s conv and BatchNorm maps."""
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for j, name in enumerate(["_expand_conv", "_depthwise_conv", "_se_reduce",
                              "_se_expand", "_project_conv"]):
        jax_params._conv(sd, name, p[f"Conv_{j}"])
    for j, name in enumerate(["_bn0", "_bn1", "_bn2"]):
        jax_params._bn(sd, name, p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
    block = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
    block.load_state_dict(sd)
    return block.eval()


def _channels_last(rng, n, c, h, w):
    x = (rng.normal(size=(n, h, w, c)) * 0.5).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)   # NHWC memory, NCHW shape


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["b5_stage1", "b4_stage1", "b1_stage1", "expand6"])
def test_expand_blocks_reach_nhwc_expand(case):
    if case == "b1_stage1":        # the prototype's stage-1 case, its own weights
        g = torch.Generator().manual_seed(0)
        p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, 40, 240, 40, 10), True)
        x = torch.empty(16, 40, 8, 8, dtype=torch.bfloat16)
    else:
        cin, ratio, cout = {"b5_stage1": (40, 6, 40), "b4_stage1": (32, 6, 32),
                            "expand6": (24, 6, 24)}[case]
        blk = init_random_weights_(MBConvBlock(cin, cout, ratio, 1, 3, fused=True), 3)
        p = blk.eval().fold()
        x = torch.empty(6, cin, 8, 8, dtype=torch.bfloat16)
    assert mbconv.variant_for(x, p) == "nhwc_expand"


@pytest.mark.parametrize("case", ["fp32", "cin128", "cout72", "mid_not_8"])
def test_other_expand_blocks_reach_nchw(case):
    g = torch.Generator().manual_seed(1)
    cin, mid, cout, dtype = {"fp32": (40, 240, 40, torch.float32),
                             "cin128": (128, 768, 128, torch.bfloat16),
                             "cout72": (40, 240, 72, torch.bfloat16),
                             "mid_not_8": (40, 244, 40, torch.bfloat16)}[case]
    p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, cin, mid, cout, 4), True)
    assert mbconv.variant_for(torch.empty(2, cin, 8, 8, dtype=dtype), p) == "nchw"


# (n, h, w, slots16, slots8, rows): the stage-1 serving shapes (128^2 of the
# TTA trio, 96^2 and 160^2 of the rescaled views) and B1 stage 1 on an H100
# (132 SMs) holding one or two blocks of a tile height per SM
@pytest.mark.parametrize("n,h,w,slots16,slots8,rows", [
    (6, 128, 128, 132, 132, 8),     # 192 tiles of 16 rows: 2 waves (32 rows) > 3 of 8
    (6, 128, 128, 264, 264, 16),    # 1 wave of 16 rows = 2 of 8
    (2, 96, 96, 132, 132, 8),       # 1 wave of either
    (2, 160, 160, 132, 132, 16),    # 1 wave of 16 rows = 2 of 8
    (16, 128, 128, 132, 264, 8),    # 4 waves of 16 rows, 4 of 8
])
def test_expand_tile_rows(n, h, w, slots16, slots8, rows):
    assert mbconv.nhwc_tile_rows(n, h, w, slots16, slots8) == rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,ratio,cout", STAGE1_BLOCKS)
def test_expand_block_matches_flax_block(rng, dtype, cin, ratio, cout):
    ref, v = _flax_vars(cin, ratio, cout, dtype, 21)
    port = _port_block(v, cin, ratio, cout, dtype)
    assert port.residual
    x, xt = _channels_last(rng, 2, cin, 20, 36)
    with torch.no_grad():
        got = port(xt)
    want = np.asarray(ref.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x),
                                False), np.float32)
    assert got.dtype == dtype and got.shape == (2, cout, 20, 36)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _max_rel(got.float().permute(0, 2, 3, 1).numpy(), want) <= tol


@pytest.mark.parametrize("cin,ratio,cout", STAGE1_BLOCKS)
def test_expand_block_matches_pallas_interpret(rng, cin, ratio, cout):
    from enhanced_unet_tpu.ops.pallas.mbconv import fold_mbconv_weights, mbconv_infer_nchw

    _, v = _flax_vars(cin, ratio, cout, torch.bfloat16, 22)
    port = _port_block(v, cin, ratio, cout, torch.bfloat16)
    P, S = v["params"], v["batch_stats"]

    def bn(i):
        return {k: jnp.asarray(a) for k, a in {**P[f"BatchNorm_{i}"],
                                                **S[f"BatchNorm_{i}"]}.items()}

    def conv(i):
        return {k: jnp.asarray(a) for k, a in P[f"Conv_{i}"].items()}

    w = {"expand": conv(0)["kernel"], "bn0": bn(0), "dw": conv(1)["kernel"], "bn1": bn(1),
         "se1": conv(2), "se2": conv(3), "project": conv(4)["kernel"], "bn2": bn(2)}
    x, xt = _channels_last(rng, 2, cin, 24, 36)
    want = mbconv_infer_nchw(jnp.asarray(np.transpose(x, (0, 3, 1, 2)), jnp.bfloat16),
                             fold_mbconv_weights(w, 24, 36), residual=True)
    with torch.no_grad():
        got = port(xt)
    assert _max_rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2


def test_expand_entry_points_refuse_a_cpu_or_fp32_tensor():
    blk = init_random_weights_(MBConvBlock(16, 16, 6, 1, 3, fused=True), 4).eval()
    p = blk.fold()
    x = torch.zeros(1, 16, 8, 8, dtype=torch.bfloat16)
    wpp = torch.zeros(1, 96, 16, dtype=torch.bfloat16)
    before = dict(mbconv.LAUNCHES)
    for t, err in ((x, ValueError), (x.float(), ValueError)):
        with pytest.raises(err, match="device"):
            mbconv.mbconv_nhwc_expand_pass1(t, p)
        with pytest.raises(err, match="device"):
            mbconv.mbconv_nhwc_expand_pass2(t, p, wpp, True)
    meta = torch.empty(1, 16, 8, 8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_expand_pass1(meta, p)
    assert mbconv.LAUNCHES == before


def test_copy_on_the_cpu_is_the_plain_copy():
    # an odd byte count: whole 16-byte vectors and a tail on the card
    x = torch.arange(37, dtype=torch.float32).bfloat16()
    before = dict(copy.LAUNCHES)
    got = copy.copy(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert copy.LAUNCHES == before
