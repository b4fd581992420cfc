"""The SegFormer cell on the CPU: the reference's FLOPs, the token kind's
weights, its readers' known answers, and runs of the cell at a small size
through the harness (a sound run passes; the control and a swapped tile
fail; a traced run prints the new metrics).

oneDNN's bf16 convolutions on this CPU give wrong sums where the kernel
equals the stride (the spatial reductions' 8x8/8 and 4x4/4 convs), so the
runs here turn oneDNN off (`torch.backends.mkldnn.flags`); the card runs
cuDNN."""

import math

import pytest
import torch

from portbench import calibrate, faults, harness, tokenread
from portbench.counts.tokens import attention_bound_s, dw_gelu_bound_s

CELL = "segformer_tiled_2048"
SMALL = dict(image_size=160, tile=96, overlap=32, pool=2, check_requests=2)
# every mechanism at a small width: four stages, reductions 8, 4, 2, 1
TINY = dict(hidden_sizes=[16, 32, 40, 64], depths=[1, 2, 2, 1], decoder_hidden_size=32)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def small(cell):
    cell.traffic.update(SMALL)
    cell.config["calibration"]["size"] = 96
    cell.config["model_kwargs"].update(TINY)


def cell():
    return harness.Cell(harness.manifest(), CELL)


@pytest.fixture
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_segformer_flops_at_512():
    from portbench.counts.flops import forward_flops

    c = cell()
    flops = forward_flops(lambda: c.reference().build(c.config), [(1, 512, 512)])
    # transformers' B5 with 3 labels under torch.utils.flop_counter: 219.3 GF
    assert 219.0e9 < flops < 219.6e9
    assert forward_flops(lambda: c.reference().build(c.config), [(75, 512, 512)]) == 75 * flops


def test_the_reference_is_b5_at_the_configured_count():
    c = cell()
    with torch.device("meta"):
        model = c.reference().build(c.config)
    assert sum(p.numel() for p in model.parameters()) == c.config["parameters"]


def test_token_weights_cover_every_tensor():
    c = cell()
    small(c)
    kind = c.kind_module()
    state = kind.token_weights(c, SEED, CPU)
    model = c.reference().build(c.config)
    assert {n: t.shape for n, t in state.items()} == {n: t.shape for n, t in
                                                     model.state_dict().items()}
    assert all(torch.isfinite(t.float()).all() for t in state.values())
    ln = state["segformer.encoder.block.2.1.layer_norm_2.weight"]
    assert 0.75 <= ln.min() and ln.max() <= 1.25
    w = state["segformer.encoder.block.2.1.mlp.dense2.weight"]          # 160 -> 40
    assert 0.8 < w.std().item() * math.sqrt(160) < 1.2
    # a bf16 checkpoint's values, held in fp32
    assert all(torch.equal(t, t.to(torch.bfloat16).to(t.dtype)) for t in state.values()
               if t.is_floating_point())
    # the same seed, the same weights
    again = kind.token_weights(c, SEED, CPU)
    assert all(torch.equal(state[n], again[n]) for n in state)


def test_the_first_patch_embedding_is_centred_on_the_calibration_micrographs():
    import numpy as np

    from portbench.micrographs import micrographs
    from portbench.reference import common

    c = cell()
    small(c)
    assert c.config["calibration"]["center_convs"] == ["segformer.encoder.patch_embeddings.0.proj"]
    model = c.reference().build(c.config)
    model.load_state_dict(c.kind_module().calibrated_weights(c, SEED, CPU))
    images, _ = micrographs(2, 96, 96, SEED, CPU, stream="calibration")
    x = torch.from_numpy(np.stack([common.enhance(im) for im in images.numpy()]))
    ref = c.reference()
    x = (x - torch.tensor(ref.MEAN)) / torch.tensor(ref.STD)     # the model's own first step
    with torch.no_grad():
        out = model.segformer.encoder.patch_embeddings[0].proj(x.permute(0, 3, 1, 2))
    assert out.mean(dim=(0, 2, 3)).abs().max() < 1e-4 * out.std()


def test_the_readers_known_answers():
    calls = {"dw_gelu_calls": [(2, 8, 8, 64, 2)] * 3,
             "attention_calls": [(2, 1, 256, 16, 64, 2), (2, 8, 16, 16, 64, 2)],
             "requests": 1}
    kernels = [("void (anonymous namespace)::dw3x3_gelu_nhwc_kernel<unsigned short, 4, 8>",
                0, 2000), ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 3000, 4000),
               ("pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>", 5000, 6000),
               ("void at::native::vectorized_layer_norm_kernel", 7000, 9000)]
    t = harness.TraceView(1e-5, kernels, calls)
    assert tokenread.dw_gelu_roofline(t) == pytest.approx(
        100 * 3 * dw_gelu_bound_s(2, 8, 8, 64) / 2e-6)
    assert tokenread.attention_roofline(t) == pytest.approx(
        100 * (attention_bound_s(2, 1, 256, 16, 64) + attention_bound_s(2, 8, 16, 16, 64)) / 2e-6)
    empty = harness.TraceView(1e-5, kernels[3:], {"requests": 1})
    assert tokenread.dw_gelu_roofline(empty) is None
    assert tokenread.attention_roofline(empty) is None
    spans = [{"name": "serve.request", "id": 0, "parent": None, "root": 0, "device_ms": 9.0},
             {"name": "model.segformer.head", "id": 1, "parent": 0, "root": 0,
              "device_ms": 2.5},
             {"name": "model.segformer.head", "id": 2, "parent": 0, "root": 0,
              "device_ms": 1.5}]
    assert tokenread.head_ms(t, spans) == pytest.approx(4.0)
    assert tokenread.head_ms(t, spans[:1]) is None


def test_the_bounds_at_the_serving_shapes():
    # the Mix-FFN's stage 3 at [75, 32, 32, 1280] bf16: bytes, 0.1174 ms
    assert dw_gelu_bound_s(75, 32, 32, 1280) * 1e3 == pytest.approx(0.1174, abs=1e-4)
    # stage 1's attention on 75 tiles, 16,384 queries over 256 keys: bytes,
    # 0.0954 ms (its 80.5 GFLOP take 0.0814 ms at the bf16 peak)
    assert attention_bound_s(75, 1, 16384, 256, 64) * 1e3 == pytest.approx(0.0954, abs=1e-4)


def test_a_sound_run_is_correct(no_onednn):
    r = harness.run(CELL, SEED, 0.3, False, 0.0, device=CPU, adjust=small)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"tiled_mpix_per_s", "setup_s"}


def test_a_traced_run_prints_the_new_metrics(no_onednn):
    from enhanced_unet_tpu_torch.utils import profiler

    profiler.clear()
    r = harness.run(CELL, SEED + 1, 0.3, True, 0.0, device=CPU, adjust=small)
    m = r["metrics"]
    # on the CPU the kernels do not run (no device trace) but the spans do
    assert "head_ms.segformer" in m and m["head_ms.segformer"]["value"] > 0
    assert "forward_ms.tiled" in m and "dw_gelu_roofline.segformer" not in m


def test_the_control_fails_at_b5s_widths(no_onednn):
    """The reference in the program's place with its convs, linears and
    attention products in fp8, over a limit on three seeds; at B5's widths
    (depths 1-1-2-1): fp8's error grows with the sums' widths, and at the
    tiny preset's it can stay inside the limits set for B5."""
    def wide(cell):
        small(cell)
        cell.config["model_kwargs"].update(depths=[1, 1, 2, 1], hidden_sizes=[64, 128, 320, 512],
                                           decoder_hidden_size=256)

    limits = cell().limits
    for r in calibrate.readings(CELL, [], [1, 2, 3], 0.0, device=CPU, adjust=wide):
        assert any(r[k] > v for k, v in limits.items()), r


def test_a_swapped_tile_fails(no_onednn, monkeypatch):
    faults.swapped_tiles(monkeypatch.setattr)
    r = harness.run(CELL, SEED, 0.3, False, 0.0, device=CPU, adjust=small)
    assert not r["correct"], r["checks"]
