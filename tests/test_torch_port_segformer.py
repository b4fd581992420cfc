"""SegFormer in the port (`models/segformer.py`) on the CPU: against the
benchmark's plain reference (`portbench/reference/segformer_b5.py`) and
`transformers`' SegFormer at a small preset in fp32, MiT-B5's parameters and
names on the meta device, the Mix-FFN depthwise kernel's plain version and
its weight cache, the tiled Evaluator, and the spans and counters of a
traced forward.  The kernel itself is held on the card
(`tests/test_torch_port_gpu.py`)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from enhanced_unet_tpu_torch.models import PORT_ONLY, get_model, init_random_weights_
from enhanced_unet_tpu_torch.models import segformer as S
from enhanced_unet_tpu_torch.ops.kernels import depthwise
from enhanced_unet_tpu_torch.utils import profiler
from portbench.reference import segformer_b5 as reference

torch.set_num_threads(2)
# a small preset with every mechanism: four stages, spatial reduction 8, 4
# and 2 and full attention, 1 to 8 heads (head sizes 16, 16, 8, 8)
SMALL = dict(hidden_sizes=(16, 32, 40, 64), depths=(1, 2, 2, 1),
             num_attention_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
             decoder_hidden_size=32)
B5_PARAMETERS = 84_595_651          # transformers' SegformerForSemanticSegmentation, 3 labels
# fp32 against fp32: the same equations summed in other orders (SDPA
# against matmul-softmax-matmul, a GEMM against a 1x1 conv, layer_norm's
# fused reduction), about 1e-6 of the largest logit here
FP32_TOL = 1e-5


def small_port(seed=1):
    model = S.SegFormer(num_classes=3, dtype=torch.float32, **SMALL)
    return init_random_weights_(model, seed).eval()


def small_reference(port):
    ref = reference.SegFormerRef(
        3, SMALL["hidden_sizes"], SMALL["depths"], SMALL["num_attention_heads"],
        SMALL["sr_ratios"], (7, 3, 3, 3), (4, 2, 2, 2), (4, 4, 4, 4),
        SMALL["decoder_hidden_size"])
    ref.load_state_dict(port.state_dict())
    return ref.eval()


def images(n=2, h=64, w=96, seed=3):
    return torch.rand(n, h, w, 3, generator=torch.Generator().manual_seed(seed))


def rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_the_port_matches_the_plain_reference():
    port = small_port()
    ref = small_reference(port)
    x = images()
    with torch.no_grad():
        got, aux = port(x)
        want = ref(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    assert aux == {} and got.dtype == torch.float32 and got.shape == (2, 64, 96, 3)
    assert want.abs().max().item() > 0.1
    assert rel(got, want) <= FP32_TOL


def test_the_port_matches_transformers():
    transformers = pytest.importorskip("transformers")
    port = small_port(seed=4)
    cfg = transformers.SegformerConfig(num_labels=3, **{k: list(v) if isinstance(v, tuple)
                                                        else v for k, v in SMALL.items()})
    hf = transformers.SegformerForSemanticSegmentation(cfg).eval()
    hf.load_state_dict(port.state_dict())          # the same names: copied by name
    x = images(seed=5)
    # transformers' image processor normalises what its model sees; the
    # port's forward normalises its [0, 1] input itself
    processor = transformers.SegformerImageProcessor(do_resize=False, do_rescale=False)
    pixels = processor(images=list(x.numpy()), input_data_format="channels_last",
                       return_tensors="pt").pixel_values
    with torch.no_grad():
        got = port(x)[0].permute(0, 3, 1, 2)
        logits = hf(pixel_values=pixels).logits
    # transformers returns stride-4 logits and resizes them only for its
    # loss, as the port does for every answer
    want = F.interpolate(logits, size=(64, 96), mode="bilinear", align_corners=False)
    assert rel(got, want) <= FP32_TOL


def test_b5_on_the_meta_device_has_the_references_parameters_and_names():
    with torch.device("meta"):
        port = S.SegFormer(num_classes=3, dtype=torch.float32)
        ref = reference.SegFormerRef(3)
    sizes = {n: tuple(t.shape) for n, t in port.state_dict().items()}
    assert sizes == {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    assert sum(p.numel() for p in port.parameters()) == B5_PARAMETERS
    assert "segformer.encoder.block.2.39.attention.self.query.weight" in sizes
    assert sizes["decode_head.linear_fuse.weight"] == (768, 3072, 1, 1)
    assert "segformer.encoder.block.3.0.attention.self.sr.weight" not in sizes   # sr 1


def test_b5_names_are_transformers():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.SegformerConfig(num_labels=3, hidden_sizes=[64, 128, 320, 512],
                                       depths=[3, 6, 40, 3], decoder_hidden_size=768)
    with torch.device("meta"):
        port = S.SegFormer(num_classes=3, dtype=torch.float32)
        hf = transformers.SegformerForSemanticSegmentation(cfg)
    assert ({n: tuple(t.shape) for n, t in port.state_dict().items()}
            == {n: tuple(t.shape) for n, t in hf.state_dict().items()})


def test_get_model_serves_the_port_only_names():
    assert PORT_ONLY == ("segformer_b5",)
    model = get_model("segformer_b5", dtype=torch.float32, device="cpu", **SMALL)
    assert isinstance(model, S.SegFormer) and not model.training
    assert [m.dwconv.dtype for m in model.modules() if isinstance(m, S.MixFFN)] == \
        [torch.float32] * sum(SMALL["depths"])


def test_init_random_weights_draws_the_token_layers():
    model = small_port(seed=7)
    lns = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert all(0.75 <= m.weight.min() and m.weight.max() <= 1.25 for m in lns)
    w = model.segformer.encoder.block[2][0].mlp.dense2.weight          # 160 -> 40
    assert 0.8 < w.std().item() * 160 ** 0.5 < 1.2
    assert torch.equal(small_port(seed=7).state_dict()["decode_head.linear_c.0.proj.weight"],
                       model.state_dict()["decode_head.linear_c.0.proj.weight"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [(2, 24, 9, 13), (1, 40, 3, 2), (3, 8, 17, 1)])
def test_gelu_wrappers_plain_version_is_the_stock_sequence(dtype, n, c, h, w):
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn(n, c, h, w, generator=g).to(dtype)
    weight, bias = torch.randn(c, 1, 3, 3, generator=g) * 0.3, torch.randn(c, generator=g)
    p = depthwise.fold_dw_bias(weight, bias, dtype)
    assert p.w.shape == (3, 3, c) and p.w.dtype == dtype and p.shift.dtype == torch.float32
    got = depthwise.dw3x3_bias_gelu_nhwc(x.contiguous(memory_format=torch.channels_last), p)
    # the stock sequence in fp32 on the weights rounded as the kernel takes them
    want = F.gelu(F.conv2d(x.float(), weight.to(dtype).float(), bias, padding=1, groups=c))
    assert got.dtype == dtype and got.shape == x.shape
    # fp32: summation order; bf16: the one rounding of the output
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    assert rel(got.float(), want) <= tol


def test_gelu_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(1, 8, 5, 5)
    p = depthwise.fold_dw_bias(torch.randn(8, 1, 3, 3), torch.randn(8), torch.float32)
    with pytest.raises(ValueError, match="3x3"):
        depthwise.dw3x3_bias_gelu_nhwc(x, depthwise.DwFolded(torch.randn(5, 5, 8), p.shift))
    with pytest.raises(TypeError):
        depthwise.dw3x3_bias_gelu_nhwc(x.half(), p)
    with pytest.raises(ValueError):
        depthwise.dw3x3_bias_gelu_nhwc(x[:, :4], p)


def test_the_mixffn_fold_is_cached_until_the_weights_change():
    model = small_port()
    dw = model.segformer.encoder.block[0][0].mlp.dwconv
    first = dw.fold()
    assert dw.fold() is first
    model.load_state_dict(small_port(seed=2).state_dict())
    assert dw.fold() is not first
    assert torch.equal(dw.fold().shift, dw.dwconv.bias)


def test_the_compute_dtype_weights_are_cast_once_until_the_weights_change():
    model = S.SegFormer(num_classes=3, dtype=torch.bfloat16, **SMALL)
    init_random_weights_(model, 1).eval()
    query = model.segformer.encoder.block[2][1].attention.self.query
    x = images(1, 64, 64)
    with torch.no_grad():
        first = model(x)[0]
        w, b = query.__dict__["_cast"][1]
        assert w.dtype == b.dtype == torch.bfloat16 and torch.equal(w, query.weight.bfloat16())
        again = model(x)[0]
        assert query.__dict__["_cast"][1][0] is w and torch.equal(first, again)
        query.weight.mul_(2.0)                    # an in-place edit: cast again
        edited = model(x)[0]
        assert torch.equal(query.__dict__["_cast"][1][0], query.weight.bfloat16())
    assert not torch.equal(edited, first)
    # with autograd on, the casts are made on each call and reach the parameters
    model.train()
    model(x)[0].float().sum().backward()
    assert query.weight.grad is not None and query.weight.grad.abs().sum() > 0


def test_train_mode_runs_the_stock_depthwise():
    dw = small_port().segformer.encoder.block[1][1].mlp.dwconv
    x = torch.randn(2, 6, 7, 128, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = dw(x)
    got = dw.train()(x)
    assert got.requires_grad and rel(got.detach(), want) <= 1e-6
    with pytest.raises(RuntimeError, match="no backward"):
        dw.eval()(x)                              # eval mode with grad enabled


def test_a_traced_forward_records_the_spans_and_counters():
    from torch.profiler import ProfilerActivity, profile

    model = small_port()
    x = images(1, 64, 64)
    got = []
    with torch.no_grad():
        for _ in range(2):
            profiler.clear()
            with profile(activities=[ProfilerActivity.CPU]):
                model(x)
            got.append((profiler.counters(), profiler.spans()))
    names = [s["name"] for s in got[0][1]]
    assert names == [f"model.segformer.stage{i}" for i in (1, 2, 3, 4)] + ["model.segformer.head"]
    # one fold a Mix-FFN in the first forward, none after; on the CPU the
    # wrapper runs its plain version, which launches nothing
    assert [c.get("kernels.mixffn_fold", 0) for c, _ in got] == [sum(SMALL["depths"]), 0]
    assert [c["launches.dw3x3_bias_gelu_nhwc"] for c, _ in got] == [0, 0]


def test_the_tiled_evaluator_serves_it():
    from portbench.reference import common
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    port = small_port(seed=9)
    ref = small_reference(port)
    ev = Evaluator(port, "segformer_b5", enable_tta=True, device="cpu", verbose=False,
                   tiled=True, tile=64, overlap=16)
    image = np.random.default_rng(0).random((80, 104, 3)).astype(np.float32)
    masks = ev.predict_semantic_masks_tiled(image[None])
    assert masks.shape == (1, 80, 104) and set(np.unique(masks)) <= {0, 1, 2}
    with torch.inference_mode():
        enhanced = ev._enhance(torch.from_numpy(image))
        got = ev.tiled_probs(enhanced[None])[0]
        want = common.tiled_probs(
            lambda t: common.tta_probs(lambda v: ref(v)[0], t, True),
            enhanced.permute(2, 0, 1), 64, 16, 4)
    assert (got - want.permute(1, 2, 0)).abs().max().item() <= 1e-5
