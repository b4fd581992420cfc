"""The fused MBConv blocks that take the `nchw` kernels (`variant_for`
"nchw": fp32, and bf16 blocks wider than 64 channels or with channel counts
that are not multiples of 8), on the CPU.

On the CPU the wrapper runs its plain version, the function the `nchw`
kernels compute.  These tests hold it, through the port's `MBConvBlock`,
against the JAX package at the shapes the kernels newly take: a stage-3
block (128 -> 768 -> 128, residual), stage 6's first block (304 -> 1824 ->
512, no residual), odd channel counts (20 -> 120 -> 36) and, in fp32, a
stage-0 block without an expand (48 -> 24).  The weights are drawn with
numpy from a seed in the flax block's variable tree and carried into the
port by `convert/jax_params.py`.

- the flax `MBConvBlock` stock path (fp32: 1e-5 of the reference's max
  |value|; bf16: 2e-2);
- the Pallas `mbconv_infer_nchw` in interpret mode (bf16, 2e-2; its H must
  be a multiple of 8).

Also: which variant each block reaches, that the `nchw` entry points
refuse a CPU tensor without launching, and that a library's name follows
the headers its source includes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enhanced_unet_tpu.models.encoders import MBConvBlock as JMBConv
from enhanced_unet_tpu_torch.convert import jax_params
from enhanced_unet_tpu_torch.models import init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
from enhanced_unet_tpu_torch.ops.kernels import mbconv

torch.set_num_threads(1)

# (cin, ratio, cout, h, w): B5's stage-3 block, stage 6's first block, odd
# channel counts, a stage-0 block without an expand
WIDE = (128, 6, 128, 8, 12)
STAGE6_FIRST = (304, 6, 512, 8, 8)
ODD = (20, 6, 36, 8, 12)
NO_EXPAND = (48, 1, 24, 16, 20)


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
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 4
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return ref, jax.tree_util.tree_map_with_path(draw, shapes)


def _names(ratio):
    expand = ratio != 1
    convs = (["_expand_conv"] if expand else []) + [
        "_depthwise_conv", "_se_reduce", "_se_expand", "_project_conv"]
    bns = (["_bn0"] if expand else []) + ["_bn1", "_bn2"]
    return convs, bns


def _port_block(v, cin, ratio, cout, dtype):
    """The port's fused block with the flax variables, carried by
    `convert/jax_params.py`'s conv and BatchNorm maps."""
    p, s = v["params"], v["batch_stats"]
    sd = {}
    convs, bns = _names(ratio)
    for j, name in enumerate(convs):
        jax_params._conv(sd, name, p[f"Conv_{j}"])
    for j, name in enumerate(bns):
        jax_params._bn(sd, name, p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
    block = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
    block.load_state_dict(sd)
    return block.eval()


def _nchw(rng, n, c, h, w):
    x = (rng.normal(size=(n, c, h, w)) * 0.5).astype(np.float32)
    return x, torch.from_numpy(x)


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["stage3", "stage6", "stage6_first", "odd", "fp32_stage0"])
def test_blocks_reach_nchw(case):
    cin, ratio, cout, dtype = {"stage3": (128, 6, 128, torch.bfloat16),
                               "stage6": (512, 6, 512, torch.bfloat16),
                               "stage6_first": (304, 6, 512, torch.bfloat16),
                               "odd": (20, 6, 36, torch.bfloat16),
                               "fp32_stage0": (48, 1, 24, torch.float32)}[case]
    blk = init_random_weights_(MBConvBlock(cin, cout, ratio, 1, 3, fused=True,
                                           dtype=dtype), 5).eval()
    x = torch.empty(2, cin, 8, 8, dtype=dtype)
    assert mbconv.variant_for(x, blk.fold()) == "nchw"


@pytest.mark.parametrize("dtype,block", [
    (torch.float32, WIDE), (torch.bfloat16, WIDE),
    (torch.float32, STAGE6_FIRST), (torch.bfloat16, STAGE6_FIRST),
    (torch.float32, ODD), (torch.bfloat16, ODD),
    (torch.float32, NO_EXPAND)], ids=lambda v: str(v).replace("torch.", ""))
def test_block_matches_flax_block(rng, dtype, block):
    cin, ratio, cout, h, w = block
    ref, v = _flax_vars(cin, ratio, cout, dtype, 31)
    port = _port_block(v, cin, ratio, cout, dtype)
    assert port.residual == (cin == cout)
    x, xt = _nchw(rng, 2, cin, h, w)
    with torch.no_grad():
        got = port(xt)
    want = np.asarray(ref.apply(jax.tree_util.tree_map(jnp.asarray, v),
                                jnp.asarray(np.transpose(x, (0, 2, 3, 1))), False), np.float32)
    assert got.dtype == dtype and got.shape == (2, cout, h, w)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _max_rel(got.float().permute(0, 2, 3, 1).numpy(), want) <= tol


@pytest.mark.parametrize("block", [WIDE, STAGE6_FIRST, ODD], ids=["wide", "stage6_first", "odd"])
def test_block_matches_pallas_interpret(rng, block):
    from enhanced_unet_tpu.ops.pallas.mbconv import fold_mbconv_weights, mbconv_infer_nchw

    cin, ratio, cout, h, w = block
    _, v = _flax_vars(cin, ratio, cout, torch.bfloat16, 32)
    port = _port_block(v, cin, ratio, cout, torch.bfloat16)
    P, S = v["params"], v["batch_stats"]

    def bn(i):
        return {k: jnp.asarray(a) for k, a in {**P[f"BatchNorm_{i}"],
                                                **S[f"BatchNorm_{i}"]}.items()}

    def conv(i):
        return {k: jnp.asarray(a) for k, a in P[f"Conv_{i}"].items()}

    wts = {"expand": conv(0)["kernel"], "bn0": bn(0), "dw": conv(1)["kernel"], "bn1": bn(1),
           "se1": conv(2), "se2": conv(3), "project": conv(4)["kernel"], "bn2": bn(2)}
    x, xt = _nchw(rng, 2, cin, h, w)
    want = mbconv_infer_nchw(jnp.asarray(x, jnp.bfloat16), fold_mbconv_weights(wts, h, w),
                             residual=cin == cout)
    with torch.no_grad():
        got = port(xt.bfloat16())
    assert _max_rel(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2


def test_nchw_entry_points_refuse_a_cpu_tensor():
    blk = init_random_weights_(MBConvBlock(20, 36, 6, 1, 3, fused=True), 6).eval()
    p = blk.fold()
    x = torch.zeros(1, 20, 8, 8, dtype=torch.bfloat16)
    wpp = torch.zeros(1, 120, 36, dtype=torch.bfloat16)
    before = dict(mbconv.LAUNCHES)
    for t in (x, x.float()):
        with pytest.raises(ValueError, match="device"):
            mbconv.mbconv_pass1(t, p)
        with pytest.raises(ValueError, match="device"):
            mbconv.mbconv_pass2(t, p, wpp, False)
    assert mbconv.LAUNCHES == before


def test_library_name_follows_included_headers(monkeypatch, tmp_path):
    # an edit to a header that a source includes (directly or through
    # another header) renames its library, so it is rebuilt; nothing is built
    from enhanced_unet_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// inner\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    first = build.library_path("k")
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    edited = build.library_path("k")
    (csrc / "inner.cuh").write_text("// inner\n")
    assert edited != first and build.library_path("k") == first
    assert first.parent == tmp_path / "kernels" and not first.parent.exists()
