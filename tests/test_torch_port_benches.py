"""The port's kernel benches against the TPU scripts they replace.

The three scripts `benchmarks/pallas_dw_variants.py`,
`benchmarks/pallas_mbconv_instr.py` and `benchmarks/pallas_mbconv_proto.py`
are loaded by file from this checkout's `benchmarks/` folder.  Their Pallas
kernels run in interpret mode on the CPU at a small size: the kernels read
the scripts' module globals `N, C, H, W, BH` when traced, so those are set
per test.  On the CPU each port wrapper runs its plain version.

Tolerances, relative to the reference's max |value|:
- depthwise kernels 2e-2: the TPU kernels round every tap product and
  partial sum to bf16, the port sums in fp32 and rounds once;
- the copy is exact;
- the MBConv block 3e-2, as in tests/test_pallas_mbconv.py (the rounding
  points are the same; bf16 roundings flipped by the summation order
  remain);
- the library yardstick against the prototype's XLA path 3e-2 (both round
  every intermediate to bf16, in different orders).
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

from enhanced_unet_tpu_torch.benchmarks import dw_variants, mbconv_instr, mbconv_nchw, microtime
from enhanced_unet_tpu_torch.benchmarks import mbconv_proto as port_proto
from enhanced_unet_tpu_torch.ops.kernels import copy, depthwise

torch.set_num_threads(1)
BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks")
DT = jnp.bfloat16
VM = pltpu.VMEM
N, C, H, W, BH = 2, 4, 16, 16, 8


@pytest.fixture(scope="module")
def scripts():
    """The three TPU scripts, loaded by file from this checkout's
    `benchmarks/`.  Each script puts a fixed folder on `sys.path` and
    imports its neighbours by bare name, so the neighbours are loaded first,
    from here, and registered under those names: the scripts' imports then
    find them in `sys.modules`.  `sys.path` and `sys.modules` are restored
    afterwards."""
    loaded, path = {}, list(sys.path)
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
    assert sys.path == path
    assert all(sys.modules.get(name) is not module for name, module in loaded.items())
    for module in loaded.values():
        assert os.path.dirname(os.path.abspath(module.__file__)) == BENCHMARKS
    for name in ("pallas_mbconv_proto", "pallas_dw_variants", "pallas_mbconv_instr"):
        assert loaded[name].time_op is loaded["microtime"].time_op
    instr, proto = loaded["pallas_mbconv_instr"], loaded["pallas_mbconv_proto"]
    assert instr.mbconv_pallas is proto.mbconv_pallas
    return loaded


def _small(monkeypatch, module):
    for name, value in dict(N=N, C=C, H=H, W=W, BH=BH).items():
        monkeypatch.setattr(module, name, value)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-6)


def _bf16(a):
    """numpy fp32 -> bf16 numpy array (the values both packages see)."""
    return np.asarray(a, np.float32).astype(DT)


def _to_torch(a):
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.bfloat16() if np.asarray(a).dtype == DT else t


def _dw_inputs(rng):
    """x [N,C,H,W] bf16, wdw [C,3,3] fp32, bdw [C] fp32."""
    return (_bf16(rng.normal(size=(N, C, H, W)) * 0.5),
            (rng.normal(size=(C, 3, 3)) * 0.1).astype(np.float32),
            (rng.normal(size=(C,)) * 0.1).astype(np.float32))


def _lanes(wdw, bdw):
    """The TPU scripts' layouts: wdw [3,3,C,1,W] bf16, bdw [C,1,W] fp32."""
    wl = np.broadcast_to(np.transpose(wdw, (1, 2, 0))[:, :, :, None, None], (3, 3, C, 1, W))
    bl = np.broadcast_to(bdw[:, None, None], (C, 1, W))
    return jnp.asarray(_bf16(wl)), jnp.asarray(np.ascontiguousarray(bl))


def _xspec():
    return pl.BlockSpec((1, C, H, W), lambda i: (i, 0, 0, 0), memory_space=VM)


def _call(kernel, args, scratch=()):
    return pl.pallas_call(
        kernel, grid=(N,), in_specs=[_xspec()] + [pl.BlockSpec(memory_space=VM)] * (len(args) - 1),
        out_specs=_xspec(), out_shape=jax.ShapeDtypeStruct((N, C, H, W), DT),
        scratch_shapes=list(scratch), interpret=True)(*args)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4"])
def test_dw3x3_bias_silu_matches_dw_variants(scripts, monkeypatch, rng, variant):
    dwv = scripts["pallas_dw_variants"]
    _small(monkeypatch, dwv)
    x, wdw, bdw = _dw_inputs(rng)
    wl, bl = _lanes(wdw, bdw)
    slab = pltpu.VMEM((C, BH + 2, W + 2), DT)
    args = (jnp.asarray(x), wl, bl)
    if variant in ("v1", "v2"):
        want = _call(functools.partial(dwv.v1_kernel, bh=BH, bf16=variant == "v2"),
                     args, [slab])
    elif variant == "v3":
        want = _call(functools.partial(dwv.v3_kernel, bh=BH), args,
                     [slab, pltpu.VMEM((3, C, BH + 2, W), DT)])
    else:
        band = np.zeros((3, W + 2, W), np.float32)
        for v in range(3):
            band[v, np.arange(W) + v, np.arange(W)] = 1.0
        want = _call(functools.partial(dwv.v4_kernel, bh=BH),
                     args + (jnp.asarray(band, DT),), [slab])
    got = depthwise.dw3x3_bias_silu(_to_torch(x), torch.from_numpy(wdw),
                                    torch.from_numpy(bdw))
    assert got.dtype == torch.bfloat16 and got.shape == (N, C, H, W)
    assert _rel_err(got.float(), want) < 2e-2


def test_dw_rows_silu_matches_dw_only_kernel(scripts, monkeypatch, rng):
    instr = scripts["pallas_mbconv_instr"]
    _small(monkeypatch, instr)
    x, wdw, bdw = _dw_inputs(rng)
    # slab 1 starts at row 8: lo = 7 and tap row 2 would end past row 15,
    # so it reads the last BH rows instead
    assert 7 + 2 + BH > H
    want = _call(instr._dw_only_kernel, (jnp.asarray(x),) + _lanes(wdw, bdw))
    got = depthwise.dw_rows_silu(_to_torch(x), torch.from_numpy(wdw),
                                 torch.from_numpy(bdw), BH)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want) < 2e-2
    # the probe is not a convolution: it differs from the true depthwise
    true_dw = depthwise.dw3x3_bias_silu(_to_torch(x), torch.from_numpy(wdw),
                                        torch.from_numpy(bdw))
    assert _rel_err(got.float(), true_dw.float()) > 5e-2


def test_copy_matches_copy_kernel(scripts, monkeypatch, rng):
    instr = scripts["pallas_mbconv_instr"]
    _small(monkeypatch, instr)
    x = _dw_inputs(rng)[0]
    want = _call(instr._copy_kernel, (jnp.asarray(x),))
    got = copy.copy(_to_torch(x))
    assert torch.equal(got.float(), torch.from_numpy(np.asarray(want, np.float32)))


def _proto_params(rng, cin, mid, cout, se_c):
    """The prototype's parameter dict in its TPU layout, as numpy."""
    def r(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    wdw, bdw = r((3, 3, mid, 1, 1), 0.2), r((mid, 1, 1), 0.1)
    return {"wexp": _bf16(r((mid, cin), 0.2)), "bexp": r((mid, 1), 0.1),
            "wdw": _bf16(np.broadcast_to(wdw, (3, 3, mid, 1, W))),
            "bdw": np.ascontiguousarray(np.broadcast_to(bdw, (mid, 1, W))),
            "se_w1": r((mid, se_c), 0.2), "se_b1": r((se_c,), 0.1),
            "se_w2": r((se_c, mid), 0.2), "se_b2": r((mid,), 0.1),
            "wproj": r((mid, cout), 0.2), "bproj": r((cout, 1), 0.1)}


@pytest.mark.parametrize("expand,mid", [(False, 4), (True, 24)])
def test_mbconv_proto_matches_pallas_interpret(scripts, monkeypatch, rng, expand, mid):
    pro = scripts["pallas_mbconv_proto"]
    monkeypatch.setattr(pro.pl, "pallas_call",
                        functools.partial(pro.pl.pallas_call, interpret=True))
    p = _proto_params(rng, C, mid, C, 2)
    x = _bf16(rng.normal(size=(N, C, H, W)) * 0.5)
    want = pro.mbconv_pallas(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                             bh=BH, expand=expand, residual=True)
    with torch.no_grad():
        got = port_proto.mbconv_proto(_to_torch(x), port_proto.params_from_jax(p),
                                      expand=expand, residual=True)
    assert got.dtype == torch.bfloat16 and got.shape == (N, C, H, W)
    assert _rel_err(got.float(), want) < 3e-2


@pytest.mark.parametrize("expand,mid", [(False, 4), (True, 24)])
def test_library_yardstick_matches_xla_nhwc(scripts, rng, expand, mid):
    pro = scripts["pallas_mbconv_proto"]
    p = _proto_params(rng, C, mid, C, 2)
    xh = _bf16(rng.normal(size=(N, H, W, C)) * 0.5)
    want = pro.mbconv_xla_nhwc(jnp.asarray(xh), {k: jnp.asarray(v) for k, v in p.items()},
                               expand=expand, residual=True)
    got = port_proto.mbconv_nhwc_library(_to_torch(xh), port_proto.params_from_jax(p),
                                         expand=expand, residual=True)
    assert got.shape == (N, H, W, C)
    assert _rel_err(got.float(), want) < 3e-2


def test_make_params_layout_and_seed():
    a = port_proto.make_params(torch.Generator().manual_seed(3), 4, 24, 8, 2)
    b = port_proto.make_params(torch.Generator().manual_seed(3), 4, 24, 8, 2)
    shapes = {"wexp": (24, 4), "bexp": (24,), "wdw": (24, 3, 3), "bdw": (24,),
              "se_w1": (24, 2), "se_b1": (2,), "se_w2": (2, 24), "se_b2": (24,),
              "wproj": (24, 8), "bproj": (8,)}
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert a["wexp"].dtype == a["wdw"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = port_proto.proto_weights(a, expand=False)
    assert w.wexp is None and w.bexp is None


@pytest.mark.parametrize("module", [dw_variants, mbconv_instr, port_proto, mbconv_nchw],
                         ids=["dw_variants", "mbconv_instr", "mbconv_proto", "mbconv_nchw"])
def test_bench_main_raises_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main()


def test_timing_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        microtime.time_op(lambda x: x, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        microtime.device_row(torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        microtime.kernel_row("copy", lambda: torch.zeros(4), lambda: torch.zeros(4), 0.0)


def _wrappers():
    w, b = torch.zeros(4, 3, 3), torch.zeros(4)
    return {"dw3x3_bias_silu": lambda x: depthwise.dw3x3_bias_silu(x, w, b),
            "dw_rows_silu": lambda x: depthwise.dw_rows_silu(x, w, b, 4),
            "copy": copy.copy}


@pytest.mark.parametrize("name", ["dw3x3_bias_silu", "dw_rows_silu", "copy"])
@pytest.mark.parametrize("fault", ["dtype", "fp32", "contiguity", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(name, fault):
    # the kernels take bf16 only, as the TPU kernels do
    x = torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    err = {"dtype": TypeError, "fp32": TypeError, "contiguity": ValueError,
           "device": ValueError}[fault]
    if fault == "dtype":
        x = x.contiguous().half()
    elif fault == "fp32":
        x = x.contiguous().float()
    elif fault == "device":
        x = torch.empty(2, 4, 8, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(err):
        _wrappers()[name](x)


def test_copy_rejects_a_misaligned_view():
    x = torch.zeros(4099, dtype=torch.bfloat16)
    assert torch.equal(copy.copy(x[8:]), x[8:])          # 16 bytes in: aligned
    with pytest.raises(ValueError, match="aligned"):
        copy.copy(x[3:])


def test_dw_rows_silu_needs_bh_to_divide_h():
    x = torch.zeros(1, 4, 12, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divide"):
        depthwise.dw_rows_silu(x, torch.zeros(4, 3, 3), torch.zeros(4), 8)
