"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: these tests need a CUDA device and skip without one (the
decision is taken inside a fixture, so every pytest worker collects the
same tests).  Run them on the H100 with

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

(`--noconftest`: `tests/conftest.py` sets up JAX, which these tests do not
use).

Tolerances: fp32 kernels within 1e-4 of the reference's max |value| (fp32
summation order); bf16 kernels within 2e-2 of it (the rounding points are
the plain version's, so what remains is a bf16 rounding that a different
fp32 summation order can flip).  TF32 is off for the plain versions.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 40, 72, 6, 64, True),
                                   (1, 37, 45, 70, 5, False),
                                   (2, 64, 64, 128, 64, True)])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    n, h, w, cin, cout, relu = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, h, w, cin, generator=g, device=cuda).to(dtype)
    wt = torch.randn(3, 3, cin, cout, generator=g, device=cuda) / (9 * cin) ** 0.5
    sc = torch.rand(cout, generator=g, device=cuda) + 0.5
    sh = torch.randn(cout, generator=g, device=cuda) * 0.1
    before = conv_fused.LAUNCHES["conv3x3_bn_act"]
    got = conv_fused.fused_conv3x3_bn_relu(x, wt, sc, sh, relu)
    torch.cuda.synchronize()
    assert conv_fused.LAUNCHES["conv3x3_bn_act"] == before + 1
    want = conv_fused.fused_conv3x3_bn_relu_plain(x, wt, sc, sh, relu)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,ratio,cout,residual", [(24, 1, 24, True),
                                                      (48, 1, 24, False),
                                                      (16, 6, 16, True)])
def test_mbconv_kernel_matches_plain(cuda, dtype, cin, ratio, cout, residual):
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    block = MBConvBlock(cin, cout, ratio, 1, 3, fused=True, dtype=dtype)
    init_random_weights_(block, 1).eval().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, cin, 45, 70, generator=g, device=cuda).to(dtype)
    with torch.no_grad():
        p = block.fold()
        before = dict(mbconv.LAUNCHES)
        got = mbconv.mbconv_infer_nchw(x, p, residual=residual)
        torch.cuda.synchronize()
        want = mbconv.mbconv_infer_nchw_plain(x, p, residual=residual)
    assert mbconv.LAUNCHES["mbconv_pass1"] == before["mbconv_pass1"] + 1
    assert mbconv.LAUNCHES["mbconv_pass2"] == before["mbconv_pass2"] + 1
    assert got.dtype == dtype and got.shape == (3, cout, 45, 70)
    assert _rel(got, want) <= _tol(dtype)


def test_kernels_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    x = torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv_fused.fused_conv3x3_bn_relu(x, torch.zeros(3, 3, 4, 4, device=cuda),
                                         torch.ones(4, device=cuda),
                                         torch.zeros(4, device=cuda))


def test_tiny_flagship_on_card_matches_cpu(cuda):
    from enhanced_unet_tpu_torch.models import get_model

    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    gpu = get_model("enhanced_unet", dtype=torch.float32, device=cuda, seed=2,
                    encoder_names=tiny)
    cpu = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=2,
                    encoder_names=tiny)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(3)) - 0.5
    with torch.no_grad():
        want, _ = cpu(x)
        got, _ = gpu(x.to(cuda))
    assert _rel(got.cpu(), want) <= 1e-4
