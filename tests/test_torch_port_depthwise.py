"""The depthwise kernels' plain versions against the TPU scripts' kernels,
on the CPU.

The row-streaming kernels of `enhanced_unet_tpu_torch/csrc/depthwise.cu`
run only on the card, where `tests/test_torch_port_gpu.py` (`gpu` marker)
holds every path of them against these plain versions.
Here the plain versions are held against the Pallas kernels of
`benchmarks/pallas_dw_variants.py` (v1, v3, v4) and
`benchmarks/pallas_mbconv_instr.py` (`_dw_only_kernel`) in interpret mode,
at an odd width and several slab heights, within 2e-2 (the TPU kernels round
every tap product and partial sum to bf16).

The TPU scripts are loaded by file from this checkout's `benchmarks/`, as in
`tests/test_torch_port_benches.py`; their kernels read the module globals
`N, C, H, W, BH`, so those are set per test.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from enhanced_unet_tpu_torch.ops.kernels import depthwise

torch.set_num_threads(1)
BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks")
DT = jnp.bfloat16
VM = pltpu.VMEM


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.fixture(scope="module")
def scripts():
    """`pallas_dw_variants` and `pallas_mbconv_instr`, loaded by file with
    the neighbours they import by bare name; `sys.path` and `sys.modules`
    are restored afterwards."""
    loaded = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        for name in ("microtime", "pallas_mbconv_proto", "pallas_dw_variants",
                     "pallas_mbconv_instr"):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(BENCHMARKS, name + ".py"))
            module = importlib.util.module_from_spec(spec)
            mp.setitem(sys.modules, name, module)
            spec.loader.exec_module(module)
            loaded[name] = module
    return loaded


def _tpu_call(kernel, shape, args, scratch=()):
    n, c, h, w = shape
    spec = pl.BlockSpec((1, c, h, w), lambda i: (i, 0, 0, 0), memory_space=VM)
    return pl.pallas_call(
        kernel, grid=(n,), in_specs=[spec] + [pl.BlockSpec(memory_space=VM)] * (len(args) - 1),
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(shape, DT),
        scratch_shapes=list(scratch), interpret=True)(*args)


def _inputs(rng, shape):
    """x bf16 (numpy), wdw [C,3,3] and bdw [C] fp32, and the TPU scripts'
    lane layouts of the weights: [3,3,C,1,W] bf16 and [C,1,W] fp32."""
    c, w = shape[1], shape[3]
    x = (rng.normal(size=shape) * 0.5).astype(np.float32).astype(DT)
    wdw = (rng.normal(size=(c, 3, 3)) * 0.1).astype(np.float32)
    bdw = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    wl = np.broadcast_to(np.transpose(wdw, (1, 2, 0))[:, :, :, None, None], (3, 3, c, 1, w))
    bl = np.ascontiguousarray(np.broadcast_to(bdw[:, None, None], (c, 1, w)))
    return x, wdw, bdw, jnp.asarray(wl.astype(DT)), jnp.asarray(bl)


def _torch(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("bh", [8, 16])
@pytest.mark.parametrize("variant", ["v1", "v3", "v4"])
def test_dw3x3_plain_matches_dw_variants_at_an_odd_width(scripts, monkeypatch, rng, variant,
                                                        bh):
    # the TPU kernels' slabs: two of 8 rows, or one of 16 (= H)
    dwv = scripts["pallas_dw_variants"]
    shape = (2, 3, 16, 13)
    for name, value in zip("NCHW", shape):
        monkeypatch.setattr(dwv, name, value)
    x, wdw, bdw, wl, bl = _inputs(rng, shape)
    slab = pltpu.VMEM((3, bh + 2, 13 + 2), DT)
    if variant == "v1":
        want = _tpu_call(functools.partial(dwv.v1_kernel, bh=bh, bf16=False), shape,
                         (jnp.asarray(x), wl, bl), [slab])
    elif variant == "v3":
        want = _tpu_call(functools.partial(dwv.v3_kernel, bh=bh), shape,
                         (jnp.asarray(x), wl, bl), [slab, pltpu.VMEM((3, 3, bh + 2, 13), DT)])
    else:
        # the column taps as a banded 0/1 product: band[v, j + v, j] = 1
        band = np.zeros((3, 13 + 2, 13), np.float32)
        for v in range(3):
            band[v, np.arange(13) + v, np.arange(13)] = 1.0
        want = _tpu_call(functools.partial(dwv.v4_kernel, bh=bh), shape,
                         (jnp.asarray(x), wl, bl, jnp.asarray(band, DT)), [slab])
    got = depthwise.dw3x3_bias_silu_plain(_torch(x).bfloat16(), _torch(wdw), _torch(bdw))
    assert _rel(got, _torch(want)) <= 2e-2


@pytest.mark.parametrize("bh", [2, 4, 16])
def test_dw_rows_plain_matches_dw_only_kernel_at_an_odd_width(scripts, monkeypatch, rng, bh):
    # bh 2, 4: eight or four slabs, the last one clamped; bh 16 = H: one
    # slab, every tap row after the first clamped to the image's top
    instr = scripts["pallas_mbconv_instr"]
    shape = (2, 3, 16, 13)
    for name, value in zip("NCHW", shape):
        monkeypatch.setattr(instr, name, value)
    monkeypatch.setattr(instr, "BH", bh)
    x, wdw, bdw, wl, bl = _inputs(rng, shape)
    want = _tpu_call(instr._dw_only_kernel, shape, (jnp.asarray(x), wl, bl))
    got = depthwise.dw_rows_silu_plain(_torch(x).bfloat16(), _torch(wdw), _torch(bdw), bh)
    assert _rel(got, _torch(want)) <= 2e-2
    # and the wrapper on the CPU is that plain version
    assert torch.equal(depthwise.dw_rows_silu(_torch(x).bfloat16(), _torch(wdw),
                                              _torch(bdw), bh), got)
