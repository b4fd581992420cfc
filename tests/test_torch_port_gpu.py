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


# (n, h, w, cin, cout, relu) -> the bf16 kernel the shape reaches (fp32:
# always the CUDA-core kernel).  W not a multiple of the 16-column tile,
# H not one of the tile's rows, a 1-row image, the 128- and 512-pixel
# tiles of the wgmma kernel, Cout above 128 and Cin not a multiple of 64.
_CONV_CASES = [
    ((2, 40, 72, 6, 64, True), "smallc"),
    ((1, 24, 40, 6, 256, True), "smallc"),          # the head's entry layer
    ((1, 1, 50, 3, 64, False), "smallc"),
    ((1, 37, 45, 70, 5, False), "mma"),             # neither takes Cin 70
    ((2, 64, 64, 128, 64, True), "wgmma"),
    ((1, 48, 40, 256, 128, False), "wgmma"),
    ((2, 33, 70, 256, 32, True), "wgmma"),          # ragged W
    ((2, 29, 45, 88, 48, True), "wgmma"),
    ((2, 50, 37, 16, 16, False), "wgmma"),         # 16-channel chunks
    ((2, 40, 45, 32, 16, True), "wgmma"),           # 32-channel chunks
    ((1, 30, 50, 24, 32, False), "wgmma"),          # a ragged 32-channel chunk
    ((1, 20, 33, 8, 8, True), "wgmma"),             # Cout 8 of a 16-channel tile
    ((1, 1, 77, 64, 128, True), "wgmma"),           # a 1-row image
    ((4, 256, 256, 32, 32, True), "wgmma"),         # 512-pixel tiles
    ((2, 24, 24, 688, 256, True), "wgmma"),         # 128-pixel tiles, Cout 256
    # the zoo's shapes, smaller: the UNet decoder's long K (2048 + 1024 at
    # s16, 512 + 256 at s8), SegNet's 512 -> 512, a ResNet block's second
    # conv (no ReLU), BasicPSPNet's 1024 -> 128, the 32 -> 16 head stage
    ((2, 16, 16, 3072, 256, True), "wgmma"),
    ((2, 32, 32, 768, 128, True), "wgmma"),
    ((2, 32, 32, 512, 512, True), "wgmma"),
    ((2, 64, 64, 64, 64, False), "wgmma"),
    ((2, 16, 16, 256, 256, False), "wgmma"),
    ((2, 32, 32, 1024, 128, True), "wgmma"),
    ((2, 128, 128, 32, 16, True), "wgmma"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,variant", _CONV_CASES)
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape, variant):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    n, h, w, cin, cout, relu = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, h, w, cin, generator=g, device=cuda).to(dtype)
    wt = torch.randn(3, 3, cin, cout, generator=g, device=cuda) / (9 * cin) ** 0.5
    sc = torch.rand(cout, generator=g, device=cuda) + 0.5
    sh = torch.randn(cout, generator=g, device=cuda) * 0.1
    if dtype == torch.float32:
        variant = "f32"
    assert conv_fused.variant_for(cin, cout, dtype) == variant
    before = dict(conv_fused.LAUNCHES)
    got = conv_fused.fused_conv3x3_bn_relu(x, wt, sc, sh, relu)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in conv_fused.LAUNCHES.items() if v != before[k]}
    assert moved == {f"conv3x3_bn_act_{variant}": 1}
    want = conv_fused.fused_conv3x3_bn_relu_plain(x, wt, sc, sh, relu)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,ratio,cout,residual", [(24, 1, 24, True),
                                                      (48, 1, 24, False),
                                                      (16, 6, 16, True),
                                                      (20, 6, 24, False)])
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
        # bf16 without expand: the nhwc kernels; bf16 with an expand and
        # channels multiples of 8: nhwc_expand; fp32 or Cin 20: the nchw ones
        variant = mbconv.variant_for(x, p)
        assert variant == ("nchw" if dtype == torch.float32 or cin % 8 else
                           "nhwc" if ratio == 1 else "nhwc_expand")
        before = dict(mbconv.LAUNCHES)
        got = mbconv.mbconv_infer_nchw(x, p, residual=residual)
        torch.cuda.synchronize()
        want = mbconv.mbconv_infer_nchw_plain(x, p, residual=residual)
    prefix = "mbconv_" if variant == "nchw" else f"mbconv_{variant}_"
    moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
    assert moved == {f"{prefix}pass1": 1, f"{prefix}pass2": 1}
    assert got.dtype == dtype and got.shape == (3, cout, 45, 70)
    assert _rel(got, want) <= _tol(dtype)


# (dtype, n, cin, mid, cout, h, w, residual, offset): the `nchw` kernels'
# instantiations (bf16 and fp32, with and without an expand, the 16-byte
# path and, where W is not a multiple of 16 bytes or x starts `offset`
# elements into its storage, the element-wise one), N 1 and 6, ragged maps,
# channel counts that are not multiples of 8, a short last mid chunk, Cout
# over one 64-channel block, an input streamed in 32-channel chunks (Cin >
# 64), stage 3 (128 -> 768 -> 128) and stage 6 (512 -> 3072 -> 512, and its
# first block 304 -> 1824 -> 512), which the kernels once refused
_NCHW_CASES = [
    (torch.bfloat16, 16, 24, 24, 24, 64, 64, True, 0),     # B2's block, 16-byte path
    (torch.bfloat16, 1, 24, 24, 24, 37, 45, True, 0),      # element-wise (W 45)
    (torch.bfloat16, 6, 48, 48, 24, 8, 8, False, 0),
    (torch.bfloat16, 1, 20, 120, 36, 45, 70, False, 0),    # W 70: element-wise
    (torch.bfloat16, 6, 5, 30, 7, 37, 45, False, 0),
    (torch.bfloat16, 1, 40, 240, 40, 32, 128, True, 1),    # a start one element in
    (torch.bfloat16, 6, 128, 768, 128, 32, 32, True, 0),   # stage 3
    (torch.bfloat16, 1, 112, 672, 112, 45, 70, True, 0),
    (torch.bfloat16, 6, 512, 3072, 512, 16, 16, True, 0),  # stage 6
    (torch.bfloat16, 1, 304, 1824, 512, 8, 8, False, 0),
    (torch.bfloat16, 1, 96, 96, 72, 37, 64, False, 0),     # no expand, streamed
    (torch.float32, 6, 48, 48, 24, 64, 64, False, 0),      # stage 0, 16-byte path
    (torch.float32, 1, 24, 24, 24, 37, 45, True, 0),
    (torch.float32, 6, 40, 240, 40, 32, 32, True, 0),
    (torch.float32, 1, 20, 120, 36, 45, 70, False, 0),
    (torch.float32, 6, 5, 30, 7, 8, 8, False, 0),
    (torch.float32, 1, 24, 144, 24, 40, 64, True, 3),      # a start 3 elements in
    (torch.float32, 1, 128, 768, 128, 16, 16, True, 0),
    (torch.float32, 1, 80, 80, 80, 37, 45, True, 0),       # no expand, streamed
]


@pytest.mark.parametrize("dtype,n,cin,mid,cout,h,w,residual,offset", _NCHW_CASES)
def test_mbconv_nchw_kernels_match_plain(cuda, dtype, n, cin, mid, cout, h, w, residual,
                                         offset):
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=cuda).manual_seed(9)
    expand = mid != cin
    p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, cin, mid, cout, 4), expand)
    p = p._replace(**{k: getattr(p, k).to(dtype) for k in ("wexp", "wdw") if getattr(p, k)
                      is not None})
    flat = torch.randn(n * cin * h * w + offset, generator=g, device=cuda).to(dtype)
    x = flat[offset:].view(n, cin, h, w)
    with torch.no_grad():
        before = dict(mbconv.LAUNCHES)
        sums = mbconv.mbconv_pass1(x, p)
        got = mbconv.mbconv_pass2(x, p, mbconv.se_gated_projection(sums, p, h * w, dtype),
                                  residual)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
        want_sums = mbconv.mbconv_pass1_plain(x, p)
        want = mbconv.mbconv_infer_nchw_plain(x, p, residual=residual)
        wpp = mbconv.se_gated_projection(want_sums, p, h * w, dtype)
        got2 = mbconv.mbconv_pass2(x, p, wpp, residual)
        want2 = mbconv.mbconv_pass2_plain(x, p, wpp, residual)
        # the entry takes the same kernels where the shape routes there
        routed = mbconv.variant_for(x, p) == "nchw"
        entry = mbconv.mbconv_infer_nchw(x, p, residual=residual) if routed else got
    assert moved == {"mbconv_pass1": 1, "mbconv_pass2": 1}
    assert (sums - want_sums).abs().max() <= 1e-3 * want_sums.abs().max()
    assert got.dtype == dtype and got.shape == (n, cout, h, w) and got.is_contiguous()
    assert _rel(got, want) <= _tol(dtype)
    assert _rel(got2, want2) <= _tol(dtype)
    assert torch.equal(entry, got)


def test_mbconv_nchw_entry_points_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=cuda).manual_seed(10)
    p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, 24, 72, 24, 4), True)
    x = torch.zeros(1, 24, 8, 8, device=cuda, dtype=torch.bfloat16)
    wpp = torch.zeros(1, 72, 24, device=cuda, dtype=torch.bfloat16)
    before = dict(mbconv.LAUNCHES)
    with pytest.raises(TypeError):
        mbconv.mbconv_pass1(x.half(), p)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_pass2(x.cpu(), p, wpp, True)
    with pytest.raises(ValueError, match="match"):
        mbconv.mbconv_pass1(torch.zeros(1, 16, 8, 8, device=cuda, dtype=torch.bfloat16), p)
    with pytest.raises(ValueError, match="residual"):
        mbconv.mbconv_pass2(x, p._replace(wproj=p.wproj[:, :16], bproj=p.bproj[:16]),
                            wpp[:, :, :16], True)
    with pytest.raises(ValueError, match="gated"):
        mbconv.mbconv_pass2(x, p, wpp[:, :64], True)
    assert mbconv.LAUNCHES == before


# (n, C = mid, Cout, h, w, residual): every C the nhwc kernels take at the
# serving path's (24, 48) and at the limits (8, 64), Cout 8 and 24, 256^2,
# a ragged 37 x 45 and one 8 x 8 tile short of both tile sides
_NHWC_CASES = [
    (6, 48, 24, 256, 256, False), (6, 24, 24, 256, 256, True),
    (1, 48, 24, 37, 45, False), (1, 24, 24, 37, 45, True),
    (1, 8, 8, 8, 8, True), (6, 8, 24, 37, 45, False),
    (1, 64, 8, 8, 8, False), (6, 64, 24, 37, 45, False),
    (1, 24, 8, 256, 256, False), (6, 8, 8, 256, 256, True),
    (1, 64, 24, 8, 8, False), (1, 48, 8, 37, 45, False),
]


@pytest.mark.parametrize("n,c,cout,h,w,residual", _NHWC_CASES)
def test_mbconv_nhwc_kernels_match_plain(cuda, monkeypatch, n, c, cout, h, w, residual):
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    block = MBConvBlock(c, cout, 1, 1, 3, fused=True, dtype=torch.bfloat16)
    init_random_weights_(block, 2).eval().to(cuda)
    assert block.residual == residual
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).bfloat16().permute(0, 3, 1, 2)
    with torch.no_grad():
        p = block.fold()
        assert mbconv.variant_for(x, p) == "nhwc"
        before = dict(mbconv.LAUNCHES)
        sums = mbconv.mbconv_nhwc_pass1(x, p)
        got = mbconv.mbconv_infer_nchw(x, p, residual=residual)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
        want_sums = mbconv.mbconv_pass1_plain(x, p)
        want = mbconv.mbconv_infer_nchw_plain(x, p, residual=residual)
    assert moved == {"mbconv_nhwc_pass1": 2, "mbconv_nhwc_pass2": 1}   # the nchw ones: none
    assert (sums - want_sums).abs().max() <= 1e-3 * want_sums.abs().max()
    assert got.dtype == torch.bfloat16 and got.shape == (n, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= 2e-2
    with torch.no_grad():                 # a plain-contiguous input: same values
        assert torch.equal(mbconv.mbconv_infer_nchw(x.contiguous(), p, residual=residual),
                           got)
        wpp = mbconv.se_gated_projection(want_sums, p, h * w, x.dtype)
        want2 = mbconv.mbconv_pass2_plain(x, p, wpp, residual)
        for rows in (8, 16):              # both tile heights, whichever the rule picks
            monkeypatch.setattr(mbconv, "nhwc_tile_rows", lambda *a, r=rows: r)
            sums = mbconv.mbconv_nhwc_pass1(x, p)
            assert (sums - want_sums).abs().max() <= 1e-3 * want_sums.abs().max()
            assert _rel(mbconv.mbconv_nhwc_pass2(x, p, wpp, residual), want2) <= 2e-2


def test_mbconv_nhwc_entry_points_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    def weights(c):
        blk = MBConvBlock(c, c, 1, 1, 3, fused=True, dtype=torch.bfloat16)
        return init_random_weights_(blk, 3).eval().to(cuda).fold()

    p24, p12 = weights(24), weights(12)
    x = torch.zeros(1, 24, 8, 8, device=cuda, dtype=torch.bfloat16)
    wpp = torch.zeros(1, 24, 24, device=cuda, dtype=torch.bfloat16)
    before = dict(mbconv.LAUNCHES)
    with pytest.raises(TypeError):
        mbconv.mbconv_nhwc_pass1(x.float(), p24)
    with pytest.raises(TypeError):
        mbconv.mbconv_nhwc_pass2(x.float(), p24, wpp, True)
    with pytest.raises(ValueError, match="do not take"):
        mbconv.mbconv_nhwc_pass1(torch.zeros(1, 12, 8, 8, device=cuda,
                                             dtype=torch.bfloat16), p12)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_pass1(x.cpu(), p24)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_pass2(x.cpu(), p24, wpp, True)
    assert mbconv.LAUNCHES == before


# (n, cin, mid, cout, h, w, residual): B5's and B4's stage-1 blocks (40 ->
# 240 -> 40, 32 -> 192 -> 32) at a serving shape and at ragged sizes with
# tiles at every image edge, Cout 32 and 40 with no residual, a short last
# chunk (mid 72 = 64 + 8, K padding of the projection), one chunk (mid 24),
# Cin 8 and 64, and a 1-row image
_EXPAND_CASES = [
    (6, 40, 240, 40, 128, 128, True), (2, 40, 240, 40, 37, 45, True),
    (1, 32, 192, 32, 20, 36, True), (2, 40, 240, 32, 33, 70, False),
    (1, 16, 96, 40, 8, 8, False), (1, 64, 72, 64, 9, 33, True),
    (3, 8, 24, 8, 16, 32, True), (2, 24, 144, 24, 1, 50, True),
]


@pytest.mark.parametrize("n,cin,mid,cout,h,w,residual", _EXPAND_CASES)
def test_mbconv_nhwc_expand_kernels_match_plain(cuda, monkeypatch, n, cin, mid, cout, h, w,
                                                residual):
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=cuda).manual_seed(8)
    p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, cin, mid, cout, 4), True)
    x = torch.randn(n, h, w, cin, generator=g, device=cuda).bfloat16().permute(0, 3, 1, 2)
    with torch.no_grad():
        assert mbconv.variant_for(x, p) == "nhwc_expand"
        before = dict(mbconv.LAUNCHES)
        got = mbconv.mbconv_infer_nchw(x, p, residual=residual)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
        want_sums = mbconv.mbconv_pass1_plain(x, p)
        want = mbconv.mbconv_infer_nchw_plain(x, p, residual=residual)
    assert moved == {"mbconv_nhwc_expand_pass1": 1, "mbconv_nhwc_expand_pass2": 1}
    assert got.dtype == torch.bfloat16 and got.shape == (n, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= 2e-2
    with torch.no_grad():                 # a plain-contiguous input: same values
        assert torch.equal(mbconv.mbconv_infer_nchw(x.contiguous(), p, residual=residual),
                           got)
        wpp = mbconv.se_gated_projection(want_sums, p, h * w, x.dtype)
        want2 = mbconv.mbconv_pass2_plain(x, p, wpp, residual)
        for rows in (8, 16):              # both tile heights, whichever the rule picks
            monkeypatch.setattr(mbconv, "nhwc_tile_rows", lambda *a, r=rows: r)
            sums = mbconv.mbconv_nhwc_expand_pass1(x, p)
            assert (sums - want_sums).abs().max() <= 1e-3 * want_sums.abs().max()
            assert _rel(mbconv.mbconv_nhwc_expand_pass2(x, p, wpp, residual), want2) <= 2e-2


def test_mbconv_nhwc_expand_entry_points_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=cuda).manual_seed(9)

    def weights(cin, mid, cout, expand=True):
        return mbconv_proto.proto_weights(mbconv_proto.make_params(g, cin, mid, cout, 2),
                                          expand)

    p = weights(16, 96, 16)
    x = torch.zeros(1, 16, 8, 8, device=cuda, dtype=torch.bfloat16)
    wpp = torch.zeros(1, 96, 16, device=cuda, dtype=torch.bfloat16)
    before = dict(mbconv.LAUNCHES)
    with pytest.raises(TypeError):
        mbconv.mbconv_nhwc_expand_pass1(x.float(), p)
    with pytest.raises(TypeError):
        mbconv.mbconv_nhwc_expand_pass2(x.float(), p, wpp, True)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_expand_pass1(x.cpu(), p)
    with pytest.raises(ValueError, match="device"):
        mbconv.mbconv_nhwc_expand_pass2(x.cpu(), p, wpp, True)
    for cin, mid, cout, expand in ((12, 72, 16, True), (16, 100, 16, True),
                                   (16, 96, 72, True), (16, 16, 16, False)):
        with pytest.raises(ValueError, match="do not take"):
            mbconv.mbconv_nhwc_expand_pass1(
                torch.zeros(1, cin, 8, 8, device=cuda, dtype=torch.bfloat16),
                weights(cin, mid, cout, expand))
    with pytest.raises(ValueError, match="gated weights"):
        mbconv.mbconv_nhwc_expand_pass2(x, p, wpp[:, :64], True)
    assert mbconv.LAUNCHES == before


@pytest.mark.parametrize("variant,weight", [("nhwc", "wdw"), ("nhwc", "bdw"),
                                            ("nhwc_expand", "wexp"), ("nhwc_expand", "bexp")])
def test_mbconv_nhwc_wrappers_need_aligned_weights(cuda, variant, weight):
    # the `nhwc` kernels read their weights 16 bytes at a time: a weight
    # that starts one element into its storage is refused, not launched
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    expand = variant == "nhwc_expand"
    g = torch.Generator(device=cuda).manual_seed(11)
    p = mbconv_proto.proto_weights(mbconv_proto.make_params(g, 24, 144 if expand else 24, 24, 4),
                                   expand)
    p = p._replace(**{k: getattr(p, k).bfloat16() for k in ("wexp", "wdw")
                      if getattr(p, k) is not None})
    x = torch.zeros(1, 24, 8, 8, device=cuda, dtype=torch.bfloat16)
    w = getattr(p, weight)
    shifted = torch.empty(w.numel() + 1, device=cuda, dtype=w.dtype)[1:].view(w.shape)
    shifted.copy_(w)
    assert mbconv.variant_for(x, p) == variant and shifted.data_ptr() % 16
    pass1 = mbconv.mbconv_nhwc_expand_pass1 if expand else mbconv.mbconv_nhwc_pass1
    pass2 = mbconv.mbconv_nhwc_expand_pass2 if expand else mbconv.mbconv_nhwc_pass2
    wpp = torch.zeros(1, p.wdw.shape[0], 24, device=cuda, dtype=torch.bfloat16)
    bad = p._replace(**{weight: shifted})
    before = dict(mbconv.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pass1(x, bad)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pass2(x, bad, wpp, True)
    assert mbconv.LAUNCHES == before
    with torch.no_grad():                  # the same values, aligned, launch
        assert torch.equal(pass1(x, p), pass1(x, bad._replace(**{weight: w})))


def test_kernels_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    w, ones, zeros = (torch.zeros(3, 3, 16, 8, device=cuda), torch.ones(8, device=cuda),
                      torch.zeros(8, device=cuda))
    before = dict(conv_fused.LAUNCHES)
    with pytest.raises(TypeError):
        conv_fused.fused_conv3x3_bn_relu(
            torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16), w, ones, zeros)
    x = torch.zeros(1, 16, 8, 8, device=cuda, dtype=torch.bfloat16).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        conv_fused.fused_conv3x3_bn_relu(x, w, ones, zeros)
    on_cpu = conv_fused.pack_conv3x3(w.cpu(), ones.cpu(), zeros.cpu(), torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="device"):
        conv_fused.fused_conv3x3_bn_relu_packed(x.contiguous(), on_cpu)
    for_f32 = conv_fused.pack_conv3x3(w, ones, zeros, torch.float32, cuda)
    with pytest.raises(TypeError, match="packed"):
        conv_fused.fused_conv3x3_bn_relu_packed(x.contiguous(), for_f32)
    assert conv_fused.LAUNCHES == before


# The depthwise kernels' paths: W not a multiple of 8 (45, 129, 301: the
# 2-byte path, 301 over two warp runs), W = 256 (one full warp run), W =
# 520 (runs that end mid-row, the edge columns read from the next run), H
# not a multiple of the 16-row strip (37, 33, 70), more than 65,535 planes.
_DW_SHAPES = [(2, 1, 37, 45), (1, 3, 64, 70), (2, 24, 33, 129), (2, 3, 40, 256),
              (1, 2, 70, 520), (1, 2, 40, 301), (1, 70000, 8, 8)]


@pytest.mark.parametrize("shape", _DW_SHAPES)
def test_dw3x3_kernel_matches_plain(cuda, shape):
    from enhanced_unet_tpu_torch.ops.kernels import depthwise

    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda).bfloat16()
    wdw = torch.randn(shape[1], 3, 3, generator=g, device=cuda) * 0.3
    bdw = torch.randn(shape[1], generator=g, device=cuda) * 0.1
    before = depthwise.LAUNCHES["dw3x3_bias_silu"]
    got = depthwise.dw3x3_bias_silu(x, wdw, bdw)
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES["dw3x3_bias_silu"] == before + 1
    want = depthwise.dw3x3_bias_silu_plain(x, wdw, bdw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= 2e-2


# beside _DW_SHAPES' paths: slabs cut into several strips (bh 64, 128),
# bh = H (one slab, every tap row after the first clamped), bh = 1, and
# every case with more than one slab ends in the clamped last slab
@pytest.mark.parametrize("shape,bh", [((2, 1, 40, 45), 8), ((1, 3, 64, 70), 32),
                                      ((2, 24, 96, 130), 32), ((2, 3, 128, 256), 64),
                                      ((1, 2, 96, 520), 32), ((1, 2, 40, 301), 8),
                                      ((1, 3, 48, 64), 48), ((1, 2, 128, 256), 128),
                                      ((2, 2, 6, 40), 1), ((1, 70000, 8, 8), 4)])
def test_dw_rows_kernel_matches_plain(cuda, shape, bh):
    from enhanced_unet_tpu_torch.ops.kernels import depthwise

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=cuda).bfloat16()
    wdw = torch.randn(shape[1], 3, 3, generator=g, device=cuda) * 0.3
    bdw = torch.randn(shape[1], generator=g, device=cuda) * 0.1
    before = depthwise.LAUNCHES["dw_rows_silu"]
    got = depthwise.dw_rows_silu(x, wdw, bdw, bh)
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES["dw_rows_silu"] == before + 1
    want = depthwise.dw_rows_silu_plain(x, wdw, bdw, bh)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("offset", [3, 8])
def test_dw_kernels_take_any_start(cuda, offset):
    # a contiguous view 6 bytes into its storage takes the 2-byte path; 16
    # bytes in, the 16-byte one
    from enhanced_unet_tpu_torch.ops.kernels import depthwise

    shape = (2, 3, 40, 256)
    g = torch.Generator(device=cuda).manual_seed(11)
    flat = torch.randn(2 * 3 * 40 * 256 + offset, generator=g, device=cuda).bfloat16()
    x = flat[offset:].view(shape)
    wdw = torch.randn(3, 3, 3, generator=g, device=cuda) * 0.3
    bdw = torch.randn(3, generator=g, device=cuda) * 0.1
    assert x.is_contiguous()
    before = dict(depthwise.LAUNCHES)
    got = (depthwise.dw3x3_bias_silu(x, wdw, bdw), depthwise.dw_rows_silu(x, wdw, bdw, 8))
    torch.cuda.synchronize()
    # each of the two kernels once, and no other (the dilated kernel's count stays)
    kernels = ("dw3x3_bias_silu", "dw_rows_silu")
    assert depthwise.LAUNCHES == {**before, **{k: before[k] + 1 for k in kernels}}
    assert _rel(got[0], depthwise.dw3x3_bias_silu_plain(x, wdw, bdw)) <= 2e-2
    assert _rel(got[1], depthwise.dw_rows_silu_plain(x, wdw, bdw, 8)) <= 2e-2


@pytest.mark.parametrize("numel,offset", [(16 * 24 * 64 * 64, 0), (8 * 3 + 5, 0),
                                          (1, 0), (4099, 8), (7, 0)])
def test_copy_kernel_is_exact(cuda, numel, offset):
    # offset 8: a view that starts 16 bytes inside its storage; 7 elements:
    # no whole 16-byte vector, the tail alone
    from enhanced_unet_tpu_torch.ops.kernels import copy

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(numel + offset, generator=g, device=cuda).bfloat16()[offset:]
    before = copy.LAUNCHES["copy"]
    got = copy.copy(x)
    torch.cuda.synchronize()
    assert copy.LAUNCHES["copy"] == before + 1
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(got, copy.copy_plain(x))


@pytest.mark.parametrize("numel", [16 * 24 * 64 * 64 + 3, 8 * 3 + 5, 65536 * 5 + 1])
def test_copy_odd_byte_counts_and_misaligned(cuda, numel):
    # odd byte counts: whole 16-byte vectors and a tail
    from enhanced_unet_tpu_torch.ops.kernels import copy

    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(numel, generator=g, device=cuda).bfloat16()
    before = copy.LAUNCHES["copy"]
    got = copy.copy(x)
    torch.cuda.synchronize()
    assert copy.LAUNCHES["copy"] == before + 1
    assert torch.equal(got, x)
    with pytest.raises(ValueError, match="aligned"):      # starts 6 bytes in
        copy.copy(torch.zeros(numel + 8, device=cuda, dtype=torch.bfloat16)[3:])
    assert copy.LAUNCHES["copy"] == before + 1


def test_mbconv_proto_on_card_matches_plain(cuda):
    from enhanced_unet_tpu_torch.benchmarks import mbconv_proto
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    g = torch.Generator(device=cuda).manual_seed(5)
    p = mbconv_proto.make_params(g, 8, 48, 8, 2)
    x = (torch.randn(2, 8, 45, 70, generator=g, device=cuda) * 0.5).bfloat16()
    before = dict(mbconv.LAUNCHES)
    got = mbconv_proto.mbconv_proto(x, p, expand=True, residual=True)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
    assert moved == {"mbconv_nhwc_expand_pass1": 1, "mbconv_nhwc_expand_pass2": 1}
    want = mbconv.mbconv_infer_nchw_plain(x, mbconv_proto.proto_weights(p, True),
                                          residual=True)
    assert _rel(got, want) <= 2e-2


def test_bench_kernels_reject_what_they_do_not_take(cuda):
    from enhanced_unet_tpu_torch.ops.kernels import copy, depthwise

    w, b = torch.zeros(4, 3, 3, device=cuda), torch.zeros(4, device=cuda)
    calls = (lambda x: depthwise.dw3x3_bias_silu(x, w, b),
             lambda x: depthwise.dw_rows_silu(x, w, b, 4), copy.copy)
    bf16 = torch.zeros(2, 4, 8, 8, device=cuda, dtype=torch.bfloat16)
    strided = torch.zeros(2, 8, 8, 4, device=cuda, dtype=torch.bfloat16).permute(0, 3, 1, 2)
    meta = torch.empty(2, 4, 8, 8, device="meta", dtype=torch.bfloat16)
    for call in calls:
        before = (dict(depthwise.LAUNCHES), dict(copy.LAUNCHES))
        for other in (torch.float16, torch.float32):
            with pytest.raises(TypeError):
                call(bf16.to(other))
        with pytest.raises(ValueError, match="contiguous"):
            call(strided)
        with pytest.raises(ValueError, match="device"):
            call(meta)
        assert (dict(depthwise.LAUNCHES), dict(copy.LAUNCHES)) == before
    with pytest.raises(ValueError, match="aligned"):
        copy.copy(torch.zeros(64, device=cuda, dtype=torch.bfloat16)[3:])
    assert copy.LAUNCHES == before[1]


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


def test_tiny_train_step_on_card_matches_cpu(cuda):
    # chip_smoke.py phase 6c's bounds: fp32 loss and running statistics
    # within 1e-4, the fp32 gradient tree within 1e-3, or 3x the CPU's own
    # fp32-to-fp64 distance where that is larger (train-mode BatchNorm at
    # batch 2 makes the gradient noise-limited), the fp64 gradient tree
    # within 1e-4
    import chip_smoke
    from enhanced_unet_tpu_torch.config import get_preset

    cfg = get_preset("enhanced_unet")
    batch = chip_smoke.blob_batch(2, 56, 64, 5)
    run = {(d, dt): chip_smoke.tiny_train_step(cfg, d, dt, batch)
           for d in ("cpu", cuda) for dt in (torch.float32, torch.float64)}
    cpu32, cpu64 = run["cpu", torch.float32], run["cpu", torch.float64]
    card32, card64 = run[cuda, torch.float32], run[cuda, torch.float64]
    assert abs(card32["loss"] - cpu32["loss"]) <= 1e-4 * abs(cpu32["loss"])
    for name, want in cpu32["stats"].items():
        assert (card32["stats"][name] - want).abs().max() <= 1e-4 * want.abs().max(), name
    noise = chip_smoke.tree_rel_l2(cpu32["grads"], cpu64["grads"])
    assert chip_smoke.tree_rel_l2(card32["grads"], cpu32["grads"]) <= max(1e-3, 3 * noise)
    assert chip_smoke.tree_rel_l2(card64["grads"], cpu64["grads"]) <= 1e-4


def _tiny_trained_on_card(cuda):
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg = get_preset("enhanced_unet")
    model = get_model("enhanced_unet", device=cuda, seed=6,
                      encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    state = create_train_state(model, cfg, 4, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.rand(2, 64, 64, 3, generator=g, device=cuda)
    masks = torch.randint(0, 3, (2, 64, 64), generator=g, device=cuda)
    valid = torch.ones(2, 64, 64, dtype=torch.bool, device=cuda)
    valid[:, :, 56:] = False
    state, out = make_train_step(cfg)(state, images, masks, valid, g)
    assert torch.isfinite(out["loss"])
    return cfg, state, images, masks, valid


def test_eval_step_on_card_launches_k1_and_k2(cuda):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.train.trainer import make_eval_step

    cfg, state, images, masks, valid = _tiny_trained_on_card(cuda)
    k1, k2 = sum(mbconv.LAUNCHES.values()), sum(conv_fused.LAUNCHES.values())
    logits, cms = make_eval_step(cfg)(state, images, masks, valid)
    assert sum(mbconv.LAUNCHES.values()) > k1 and sum(conv_fused.LAUNCHES.values()) > k2
    assert torch.isfinite(logits).all()
    assert cms.dtype == torch.int64 and (cms.sum((1, 2)) == 64 * 64).all()


def test_eval_forward_with_grad_raises_on_card(cuda):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

    _, state, images, _, _ = _tiny_trained_on_card(cuda)
    model = state.model.eval()
    before = (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES))
    with pytest.raises(RuntimeError, match="no backward"):
        model(images)
    assert (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES)) == before
    with torch.no_grad():
        logits, _ = model(images)
    assert torch.isfinite(logits).all()


def test_tiled_evaluator_on_card_matches_cpu(cuda):
    # the tiny flagship in fp32, TTA on, tile 64 / overlap 16 over 96 x 128
    # (six tiles): tile probabilities within 1e-4, masks on 99.9% of pixels
    import numpy as np

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    evs = {d: Evaluator(get_model("enhanced_unet", dtype=torch.float32, device=d, seed=2,
                                  encoder_names=tiny), "enhanced_unet", device=d,
                        tiled=True, tile=64, overlap=16) for d in ("cpu", cuda)}
    img = np.random.default_rng(0).random((96, 128, 3)).astype(np.float32)
    enh = torch.from_numpy(img)[None]
    before = sum(mbconv.LAUNCHES.values()), sum(conv_fused.LAUNCHES.values())
    with torch.inference_mode():
        want = evs["cpu"].tiled_probs(enh)
        got = evs[cuda].tiled_probs(enh.to(cuda))
    assert sum(mbconv.LAUNCHES.values()) > before[0]
    assert sum(conv_fused.LAUNCHES.values()) > before[1]
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    masks = {d: ev.predict_semantic_mask(img) for d, ev in evs.items()}
    assert masks[cuda].dtype == np.uint8 and masks[cuda].shape == (96, 128)
    assert np.mean(masks[cuda] == masks["cpu"]) >= 0.999


def test_native_host_ops_match_numpy(cuda):
    import numpy as np

    from enhanced_unet_tpu_torch import native
    from enhanced_unet_tpu_torch.data import rle
    from enhanced_unet_tpu_torch.metrics.instance import _pairwise_iou

    rng = np.random.default_rng(1)
    masks = (rng.random((5, 37, 53)) > rng.random((5, 1, 1))).astype(np.uint8)
    masks[2] = 0
    for m in masks:
        np.testing.assert_array_equal(native.rle_counts(m), rle._mask_to_counts(m))
        assert rle.encode_rle(m, native=True) == rle.encode_rle(m)
    np.testing.assert_array_equal(_pairwise_iou(masks, masks[::-1], native=True),
                                  _pairwise_iou(masks, masks[::-1]))


def test_evaluate_on_card_uses_the_native_host_ops(cuda, monkeypatch):
    import numpy as np

    import chip_smoke
    from enhanced_unet_tpu_torch import native
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.postprocess import semantic_to_instances
    from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS, Evaluator

    calls = {"rle_counts": 0, "pairwise_iou": 0}
    for name in calls:
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _n=name: (
            calls.__setitem__(_n, calls[_n] + 1), _fn(*a))[1])
    batch = chip_smoke.eval_batch(2, 96, 4)
    ev = Evaluator(get_model("enhanced_unet", dtype=torch.float32, device=cuda, seed=2,
                             encoder_names=("efficientnet-tiny", "efficientnet-tiny")),
                   "enhanced_unet", device=cuda, verbose=False)
    out = ev.evaluate([batch])
    assert set(out) == set(_METRIC_KEYS) and all(np.isfinite(v) for v in out.values())
    assert calls["rle_counts"] > 0
    masks = ev.predict_semantic_masks(np.stack([it["image"] for it in batch["batch_items"]]))
    labels = [l for m in masks for l in semantic_to_instances(m)[1]]
    assert out["pred_live_count"] * 2 == sum(1 for l in labels if l == 0)
    assert out["pred_dead_count"] * 2 == sum(1 for l in labels if l == 1)


def test_kernels_refuse_a_batch_beyond_the_grid(cuda):
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

    block = MBConvBlock(8, 8, 1, 1, 3, fused=True).eval().to(cuda)
    p = block.fold()
    x = torch.zeros(65536, 8, 2, 2, device=cuda, dtype=torch.bfloat16)
    before = (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES))
    with pytest.raises(ValueError, match="beyond the kernels' grid"):
        mbconv.mbconv_infer_nchw(x, p, residual=True)
    with pytest.raises(ValueError, match="beyond the kernels' grid"):
        mbconv.mbconv_infer_nchw(x.float(), p, residual=True)
    wt = torch.randn(3, 3, 8, 8, device=cuda)
    ones = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="beyond the kernels' grid"):
        conv_fused.fused_conv3x3_bn_relu(x.permute(0, 2, 3, 1).contiguous(), wt, ones, ones)
    assert (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES)) == before


def _pipeline_batch(cuda):
    """Two seeded 96^2 micrographs with live and dead regions, and the
    augmentation's draws, on the CPU and on the card."""
    import chip_smoke
    from enhanced_unet_tpu_torch.ops.augment import augment_params

    images, masks, _ = chip_smoke.blob_batch(2, 96, 96, 8)
    masks = torch.from_numpy(masks)
    cpu = (torch.floor(torch.from_numpy(images) * 255.0), (masks == 1).to(torch.uint8),
           (masks == 2).to(torch.uint8), masks)
    params = augment_params(torch.Generator().manual_seed(2), 2, 96, 96, "cpu")
    return cpu, params, [t.to(cuda) for t in cpu], {k: v.to(cuda) for k, v in params.items()}


def test_device_pipeline_on_card_matches_cpu(cuda):
    # chip_smoke.py phase 7's bounds: the augmentation on the same input
    # within 3 grey levels and 0.99 of the values equal, the preprocess
    # within 16 levels and 0.9 equal (JAX's jitted run keeps 11 and 0.91
    # from its own op-by-op run), masks equal
    from enhanced_unet_tpu_torch.ops.augment import apply_augment
    from enhanced_unet_tpu_torch.ops.preprocess import cell_specific_preprocess

    cpu, params, card, card_params = _pipeline_batch(cuda)
    pre_cpu = cell_specific_preprocess(*cpu[:3])
    pre = (cell_specific_preprocess(*card[:3]).cpu() - pre_cpu).abs()
    assert pre.max() <= 16 and (pre == 0).float().mean() >= 0.9
    want, want_masks = apply_augment(pre_cpu, cpu[3], params)
    got, got_masks = apply_augment(pre_cpu.to(cuda), card[3], card_params)
    assert torch.equal(got_masks.cpu(), want_masks)
    aug = (got.cpu() - want).abs()
    assert aug.max() <= 3 and (aug == 0).float().mean() >= 0.99


def test_loader_on_card_with_and_without_prefetch(cuda, tmp_path, monkeypatch):
    import chip_smoke
    from enhanced_unet_tpu_torch.data import BatchLoader, CellDataset

    monkeypatch.setattr(chip_smoke, "MICROGRAPH_HW", (200, 272))
    monkeypatch.setattr(chip_smoke, "CELLS", 8)
    chip_smoke.write_micrographs(str(tmp_path), 4, 3)
    ds = CellDataset(str(tmp_path), max_size=128,
                     files=sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".jpg"))
    runs = [list(BatchLoader(ds, 2, (128, 128), train=True, seed=4, prefetch=p, device=cuda))
            for p in (2, 0)]
    for a, b in zip(*runs):
        assert a["images"].device.type == "cuda" and a["images"].shape == (2, 128, 128, 3)
        for key in ("images", "semantic_masks", "valid_mask"):
            assert torch.equal(a[key], b[key]), key


def test_train_model_one_epoch_on_card(cuda, tmp_path, monkeypatch):
    import dataclasses
    import json
    import os

    import chip_smoke
    import numpy as np
    from enhanced_unet_tpu_torch import models
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.train import api

    real = models.get_model
    monkeypatch.setattr(api, "get_model", lambda name, **kw: real(
        name, encoder_names=("efficientnet-tiny", "efficientnet-tiny"), **kw))
    monkeypatch.setattr(chip_smoke, "MICROGRAPH_HW", (200, 272))
    monkeypatch.setattr(chip_smoke, "CELLS", 8)
    data = tmp_path / "data"
    data.mkdir()
    chip_smoke.write_micrographs(str(data), 7, 5)
    cfg = dataclasses.replace(get_preset("enhanced_unet"), num_epochs=1, eval_every_epochs=1)
    k1, k2 = sum(mbconv.LAUNCHES.values()), sum(conv_fused.LAUNCHES.values())
    best = api.train_model("enhanced_unet", data_dir=str(data), max_size=128, cfg=cfg,
                           checkpoint_dir=str(tmp_path / "ck"), log=lambda *a: None)
    assert sum(mbconv.LAUNCHES.values()) > k1 and sum(conv_fused.LAUNCHES.values()) > k2
    last = os.path.join(os.path.dirname(best), "last_model")
    with open(os.path.join(last, "meta.json")) as f:
        history = json.load(f)["history"]
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert len(history["val_miou"]) == 1 and os.path.exists(os.path.join(best, "state.pt"))
    saved = torch.load(os.path.join(last, "state.pt"), map_location="cpu", weights_only=True)
    assert saved["step"] == 2      # 4 train images, batch 2


def _entry_setup(tmp_path, monkeypatch):
    """The tiny flagship behind `train.api.get_model`, and seven small
    seeded micrographs (train 4, val 1, test 2)."""
    import chip_smoke
    from enhanced_unet_tpu_torch import models
    from enhanced_unet_tpu_torch.train import api

    real = models.get_model
    monkeypatch.setattr(api, "get_model", lambda name, **kw: real(
        name, encoder_names=("efficientnet-tiny", "efficientnet-tiny"), **kw))
    monkeypatch.setattr(chip_smoke, "MICROGRAPH_HW", (200, 272))
    monkeypatch.setattr(chip_smoke, "CELLS", 8)
    data = tmp_path / "data"
    data.mkdir()
    chip_smoke.write_micrographs(str(data), 7, 6)
    return api, data


def _launches():
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv

    return sum(mbconv.LAUNCHES.values()), sum(conv_fused.LAUNCHES.values())


def test_evaluate_model_on_card_launches_k1_and_k2(cuda, tmp_path, monkeypatch):
    import json
    import math
    import os

    from enhanced_unet_tpu_torch.train.evaluator import _METRIC_KEYS

    api, data = _entry_setup(tmp_path, monkeypatch)
    before = _launches()
    out = api.evaluate_model("enhanced_unet", str(data), str(tmp_path / "none"),
                             results_dir=str(tmp_path / "results"), max_size=128,
                             generate_visualizations=False, log=lambda *a: None)
    after = _launches()
    assert after[0] > before[0] and after[1] > before[1]
    assert set(out) == set(_METRIC_KEYS) and all(math.isfinite(v) for v in out.values())
    with open(os.path.join(tmp_path, "results", "enhanced_unet",
                           "enhanced_unet_results.json")) as f:
        assert json.load(f) == out


@pytest.mark.parametrize("tiled", [False, True])
def test_predict_model_on_card_launches_k1_and_k2(cuda, tmp_path, monkeypatch, tiled):
    import os

    api, data = _entry_setup(tmp_path, monkeypatch)
    images = tmp_path / "images"
    images.mkdir()
    for name in sorted(os.listdir(data))[:3]:
        if name.endswith(".jpg"):
            os.link(data / name, images / name)
    before = _launches()
    out = api.predict_model("enhanced_unet", str(images), str(tmp_path / "none"),
                            results_dir=str(tmp_path / "results"), max_size=128, tiled=tiled,
                            tile=64, overlap=16, log=lambda *a: None)
    after = _launches()
    assert after[0] > before[0] and after[1] > before[1]
    rows = out["predictions"]
    assert [r["filename"] for r in rows] == sorted(os.listdir(images))
    assert len(os.listdir(out["save_dir"])) == 2 * len(rows) + 1


# the zoo: model -> whether its request launches the small-Cin kernel (a
# 3-channel first 3x3 conv) beside wgmma
_ZOO_SMALLC = {"segnet": True, "unet": False, "unet_basic": True,
               "enhanced_unet_basic": True, "fcn": False, "fcn_basic": True,
               "pspnet": False, "pspnet_basic": True, "linknet": False,
               "linknet_basic": True}


@pytest.mark.parametrize("name", sorted(_ZOO_SMALLC))
def test_zoo_model_served_on_card(cuda, monkeypatch, name):
    """Each zoo model at full width: served in bf16 through an `Evaluator`
    on K2 alone (no K1 launch, no plain version of K2), and in fp32 on the
    card within 1e-4 of the CPU's plain path on the same weights."""
    import numpy as np

    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    def no_plain(*a, **kw):
        raise AssertionError("the plain version of K2 ran on the card")

    monkeypatch.setattr(conv_fused, "fused_conv3x3_bn_relu_plain", no_plain)
    k2, k1 = dict(conv_fused.LAUNCHES), dict(mbconv.LAUNCHES)
    ev = Evaluator(get_model(name, seed=0), name, enable_tta=get_preset(name).enable_tta)
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    masks = ev.predict_semantic_masks(imgs)
    moved = {k: v - k2[k] for k, v in conv_fused.LAUNCHES.items() if v != k2[k]}
    assert masks.shape == (2, 128, 128) and set(np.unique(masks)) <= {0, 1, 2}
    assert set(moved) == ({"conv3x3_bn_act_wgmma", "conv3x3_bn_act_smallc"}
                          if _ZOO_SMALLC[name] else {"conv3x3_bn_act_wgmma"}), moved
    assert mbconv.LAUNCHES == k1
    monkeypatch.undo()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    gpu = get_model(name, dtype=torch.float32, device=cuda, seed=3)
    cpu = get_model(name, dtype=torch.float32, device="cpu", seed=3)
    before = conv_fused.LAUNCHES["conv3x3_bn_act_f32"]
    with torch.no_grad():
        got, _ = gpu(x.to(cuda))
        want, _ = cpu(x)
    assert conv_fused.LAUNCHES["conv3x3_bn_act_f32"] > before
    assert _rel(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_max_pool_with_indices_on_card_takes_the_first_maximum(cuda, dtype):
    from enhanced_unet_tpu_torch.models import blocks

    x = torch.randint(0, 3, (2, 8, 32, 48), generator=torch.Generator().manual_seed(0))
    x = x.to(dtype)
    pooled, idx = blocks.max_pool_with_indices(x.to(cuda))
    want_pooled, want_idx = blocks.max_pool_with_indices(x)
    assert torch.equal(pooled.cpu(), want_pooled) and torch.equal(idx.cpu(), want_idx)
    assert torch.equal(blocks.max_unpool_2x2(pooled, idx).cpu(),
                       blocks.max_unpool_2x2(want_pooled, want_idx))


# ---- spatial partitioning: K1's counted-rows window, K2 on a haloed band ----

@pytest.mark.parametrize("dtype,n,c,h,w,rows", [
    (torch.bfloat16, 2, 48, 66, 70, (1, 33)), (torch.bfloat16, 1, 24, 40, 64, (17, 39)),
    (torch.bfloat16, 2, 8, 20, 33, (0, 20)), (torch.bfloat16, 1, 24, 18, 40, (5, 5)),
    (torch.float32, 2, 48, 66, 70, (1, 33)), (torch.float32, 1, 24, 40, 64, (17, 39)),
    (torch.float32, 1, 16, 20, 33, (0, 20)),
])
def test_mbconv_windowed_pass1_matches_plain(cuda, monkeypatch, dtype, n, c, h, w, rows):
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    block = MBConvBlock(c, c, 1, 1, 3, fused=True, dtype=dtype)
    init_random_weights_(block, 4).eval().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(n, h, w, c, generator=g, device=cuda).to(dtype).permute(0, 3, 1, 2)
    nhwc = dtype == torch.bfloat16
    if not nhwc:
        x = x.contiguous()
    pass1 = mbconv.mbconv_nhwc_pass1 if nhwc else mbconv.mbconv_pass1
    key = "mbconv_nhwc_pass1" if nhwc else "mbconv_pass1"
    with torch.no_grad():
        p = block.fold()
        assert mbconv.variant_for(x, p) == ("nhwc" if nhwc else "nchw")
        want = mbconv.mbconv_pass1_plain(x, p, rows)
        scale = mbconv.mbconv_pass1_plain(x, p).abs().max()
        for th in ((8, 16) if nhwc else (None,)):
            if th is not None:
                monkeypatch.setattr(mbconv, "nhwc_tile_rows", lambda *a, r=th: r)
            before = dict(mbconv.LAUNCHES)
            got = pass1(x, p, rows)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in mbconv.LAUNCHES.items() if v != before[k]}
            assert moved == {key + "_window": 1}
            assert (got - want).abs().max() <= 1e-3 * scale
        # the whole map as the window: the unwindowed launch's sums, bitwise
        assert torch.equal(pass1(x, p, (0, h)), pass1(x, p))


def test_mbconv_window_is_refused_where_the_kernel_takes_none(cuda):
    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.encoders import MBConvBlock
    from enhanced_unet_tpu_torch.ops.kernels import mbconv

    def case(cin, ratio, dtype):
        block = init_random_weights_(MBConvBlock(cin, cin, ratio, 1, 3, fused=True,
                                                 dtype=dtype), 1).eval().to(cuda)
        x = torch.randn(1, 16, 16, cin, device=cuda).to(dtype).permute(0, 3, 1, 2)
        return x, block.fold()

    with torch.no_grad():
        x, p = case(40, 6, torch.bfloat16)                     # nhwc_expand
        with pytest.raises(ValueError, match="no counted-rows window"):
            mbconv.mbconv_infer_nchw(x, p, residual=True, rows=(1, 15))
        x, p = case(40, 6, torch.float32)                      # the tiled nchw pass 1
        with pytest.raises(ValueError, match="no counted-rows window"):
            mbconv.mbconv_pass1(x.contiguous(), p, (1, 15))
        x, p = case(24, 1, torch.bfloat16)
        with pytest.raises(ValueError, match="not inside"):
            mbconv.mbconv_nhwc_pass1(x, p, (3, 17))


@pytest.mark.parametrize("dtype,cin,cout", [(torch.bfloat16, 64, 128),
                                            (torch.bfloat16, 3, 64),
                                            (torch.float32, 32, 48)])
def test_k2_on_haloed_bands_matches_the_unsharded_conv(cuda, dtype, cin, cout):
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(1, 64, 72, cin, generator=g, device=cuda).to(dtype)
    w = torch.randn(3, 3, cin, cout, generator=g, device=cuda) / (9 * cin) ** 0.5
    scale = torch.rand(cout, generator=g, device=cuda) + 0.5
    shift = torch.randn(cout, generator=g, device=cuda) * 0.1
    packed = conv_fused.pack_conv3x3(w, scale, shift, dtype, cuda)
    whole = conv_fused.fused_conv3x3_bn_relu_packed(x, packed)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))      # zeros beyond the image
    bands = [conv_fused.fused_conv3x3_bn_relu_packed(xp[:, r * 16:r * 16 + 18].contiguous(),
                                                     packed)[:, 1:-1] for r in range(4)]
    want = conv_fused.fused_conv3x3_bn_relu_plain(x, w, scale, shift)
    assert _rel(torch.cat(bands, 1), want) <= _tol(dtype)
    assert _rel(whole, want) <= _tol(dtype)


def test_spatial_apply_on_card_at_world_size_1(cuda, tmp_path):
    import torch.distributed as dist

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.parallel import make_mesh
    from enhanced_unet_tpu_torch.parallel.spatial import make_spatial_apply

    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    model = get_model("enhanced_unet", dtype=torch.float32, encoder_names=tiny)
    x = torch.rand(1, 128, 96, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    mesh = make_mesh(1, "space", init_dir=str(tmp_path))
    try:
        with torch.no_grad():
            want = model(x)[0]
        k1, k2 = dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES)
        got = make_spatial_apply(model, mesh)(x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert mbconv.LAUNCHES["mbconv_pass1_window"] > k1["mbconv_pass1_window"]
    assert conv_fused.LAUNCHES["conv3x3_bn_act_f32"] > k2["conv3x3_bn_act_f32"]
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("kind,cin,cout,parts", [
    ("column", 6, 256, 2),          # the fusion head's entry layer: small-Cin kernel
    ("column", 256, 256, 2),
    ("row", 256, 128, 2),           # the fusion head's 256 -> 128, no epilogue
    ("row", 128, 128, 4),
])
def test_conv3x3_on_tensor_parallel_slices_matches_plain(cuda, kind, cin, cout, parts):
    """K2 on a column slice (the BN folded on the slice's channels) and on a
    row slice (scale 1, shift 0, no ReLU) against its plain version; the
    row slices' partial sums, added in fp32, then BN and ReLU, make the
    whole layer's."""
    import torch.nn as nn

    from enhanced_unet_tpu_torch.models import init_random_weights_
    from enhanced_unet_tpu_torch.models.blocks import ConvBNAct, packed_conv3x3
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused

    dt = torch.bfloat16
    layer = init_random_weights_(ConvBNAct(cin, cout, dtype=dt), 4).eval().to(cuda)
    conv, bn = layer[0], layer[1]
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(2, 40, 48, cin, generator=g, device=cuda).to(dt)
    full = cout if kind == "column" else cin
    outs = []
    for r in range(parts):
        lo, hi = r * full // parts, (r + 1) * full // parts
        part = nn.Conv2d(1, 1, 3, padding=1, bias=False).to(cuda)
        w = conv.weight[lo:hi] if kind == "column" else conv.weight[:, lo:hi]
        part.weight = nn.Parameter(w.detach().clone())
        before = dict(conv_fused.LAUNCHES)
        with torch.no_grad():
            if kind == "column":
                packed = packed_conv3x3(part, bn, dt, cuda, (lo, hi))
                y = conv_fused.fused_conv3x3_bn_relu_packed(x, packed, relu=True)
                scale, shift = conv_fused.fold_bn_params(
                    bn.weight[lo:hi], bn.bias[lo:hi], bn.running_mean[lo:hi],
                    bn.running_var[lo:hi], bn.eps)
                want = conv_fused.fused_conv3x3_bn_relu_plain(
                    x, part.weight.permute(2, 3, 1, 0), scale, shift, True)
            else:
                xr = x[..., lo:hi].contiguous()
                packed = packed_conv3x3(part, bn, dt, cuda, epilogue=False)
                y = conv_fused.fused_conv3x3_bn_relu_packed(xr, packed, relu=False)
                ones = torch.ones(cout, device=cuda)
                want = conv_fused.fused_conv3x3_bn_relu_plain(
                    xr, part.weight.permute(2, 3, 1, 0), ones, ones * 0, False)
        torch.cuda.synchronize()
        launched = {k for k, v in conv_fused.LAUNCHES.items() if v != before[k]}
        assert launched == {f"conv3x3_bn_act_{packed.variant}"}
        assert packed.variant == ("smallc" if cin <= 7 else "wgmma")
        assert _rel(y, want) <= _tol(dt)
        outs.append(y)
    with torch.no_grad():
        scale, shift = conv_fused.fold_bn_params(bn.weight, bn.bias, bn.running_mean,
                                                 bn.running_var, bn.eps)
        whole = conv_fused.fused_conv3x3_bn_relu_plain(x, conv.weight.permute(2, 3, 1, 0),
                                                       scale, shift, True)
        if kind == "column":
            got = torch.cat(outs, 3)
        else:
            got = torch.relu(sum(o.float() for o in outs) * scale + shift).to(dt)
    assert _rel(got, whole) <= _tol(dt)


def test_tp_train_step_on_card_at_world_size_1(cuda, tmp_path):
    """`make_tp_train_step` on a 1 x 1 grid (NCCL) against `make_train_step`
    on the same weights and generator seed: the tiny flagship with dropout
    and stochastic depth on, its weights split at `min_channels` 16, no K1
    or K2 launch (train mode takes the stock path).  fp32: the loss within
    1e-4 (cuDNN's BatchNorm and the mode's sum in another order); float64:
    the loss within 1e-6 (the models cast their logits to fp32) and the
    gradient tree within 1e-5 (relative L2; fp32 gradients of train-mode
    BatchNorm at batch 2 are noise-limited)."""
    import torch.distributed as dist

    import chip_smoke
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.parallel import make_mesh_2d, make_tp_train_step, shard_params_tp
    from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

    cfg = get_preset("enhanced_unet")
    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    g = torch.Generator(device=cuda).manual_seed(3)
    images = torch.rand(2, 64, 64, 3, generator=g, device=cuda)
    masks = torch.randint(0, 3, (2, 64, 64), generator=g, device=cuda)
    valid = torch.ones(2, 64, 64, dtype=torch.bool, device=cuda)
    valid[1, :, 48:] = False
    out = {}
    mesh = make_mesh_2d(1, 1, init_dir=str(tmp_path))
    try:
        for dtype in (torch.float32, torch.float64):
            for path in ("plain", "tp"):
                model = get_model("enhanced_unet", dtype=dtype, device=cuda, seed=4,
                                  encoder_names=tiny).to(dtype)
                if path == "tp":
                    shard_params_tp(model, mesh, 16)
                state = create_train_state(model, cfg, 4, device=cuda)
                step = make_tp_train_step(cfg, mesh) if path == "tp" else make_train_step(cfg)
                before = (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES))
                _, metrics = step(state, images.to(dtype), masks, valid,
                                  torch.Generator(device=cuda).manual_seed(5))
                torch.cuda.synchronize()
                assert (dict(mbconv.LAUNCHES), dict(conv_fused.LAUNCHES)) == before
                out[dtype, path] = (float(metrics["loss"]),
                                    {n: p.grad.double().cpu()
                                     for n, p in model.named_parameters() if p.grad is not None})
    finally:
        dist.destroy_process_group()
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-6)):
        want = out[dtype, "plain"][0]
        assert abs(out[dtype, "tp"][0] - want) <= tol * abs(want), dtype
    wide = torch.float64
    assert chip_smoke.tree_rel_l2(out[wide, "tp"][1], out[wide, "plain"][1]) <= 1e-5


def test_evaluator_mesh_on_card_at_world_size_1(cuda, tmp_path):
    """`Evaluator(mesh=make_mesh(1))` (NCCL) on the tiny flagship in fp32,
    tiled (tile 64, overlap 16, nine tiles padded to the chunk of 8's
    multiple): the host-stitched probabilities equal the Evaluator's
    without the mesh within 1e-5 and the masks on every pixel; K1 and K2
    launched, no plain version."""
    import numpy as np
    import torch.distributed as dist

    import chip_smoke
    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.ops.kernels import conv_fused, mbconv
    from enhanced_unet_tpu_torch.parallel import make_mesh
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator

    tiny = ("efficientnet-tiny", "efficientnet-tiny")
    model = get_model("enhanced_unet", dtype=torch.float32, device=cuda, seed=2,
                      encoder_names=tiny)
    img = np.random.default_rng(1).random((152, 144, 3)).astype(np.float32)
    mesh = make_mesh(1, init_dir=str(tmp_path))
    try:
        evs = {m is not None: Evaluator(model, "enhanced_unet", tiled=True, tile=64,
                                        overlap=16, mesh=m) for m in (None, mesh)}
        plain, restore = chip_smoke.count_plain()
        try:
            before = sum(mbconv.LAUNCHES.values()), sum(conv_fused.LAUNCHES.values())
            got = evs[True].predict_probs_tiled(img)
            mask = evs[True].predict_semantic_mask(img)
            torch.cuda.synchronize()
            launched = (sum(mbconv.LAUNCHES.values()) > before[0],
                        sum(conv_fused.LAUNCHES.values()) > before[1])
        finally:
            restore()
        want = evs[False].predict_probs_tiled(img)
        want_mask = evs[False].predict_semantic_mask(img)
    finally:
        dist.destroy_process_group()
    assert launched == (True, True) and not any(plain.values())
    assert np.abs(got - want).max() <= 1e-5
    assert mask.dtype == np.uint8 and np.array_equal(mask, want_mask)


def test_spans_time_the_device_their_work_runs_on(cuda):
    # CUDA is initialised: a CPU span still gives its host interval, a span
    # on the card its events' time, and a child inherits its parent's card
    from torch.profiler import ProfilerActivity, profile

    from enhanced_unet_tpu_torch.utils import profiler

    torch.ones(1, device=cuda)
    rec = profiler.Recorder()
    cycles = 200_000_000                 # ~0.1 s at the H100's clock
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("cpu", device="cpu"):
            torch.ones(64).sum()
        with rec.span("none"):
            pass
        with rec.span("card", device=cuda):
            with rec.span("sleep"):
                torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    cpu, none, card, sleep = rec.spans()
    for s in (cpu, none):
        assert s["device_ms"] == (s["end_ns"] - s["start_ns"]) / 1e6
    host_ms = (sleep["end_ns"] - sleep["start_ns"]) / 1e6
    assert sleep["device_ms"] > max(20.0, 4 * host_ms)
    assert card["device_ms"] >= sleep["device_ms"]


def test_a_traced_request_after_a_weight_swap_rebuilds_and_launches(cuda):
    # the operator's check after `update_state`: the first traced request
    # packs and folds every cached operand once and launches K1 and K2 (the
    # tiny flagship in fp32: K2's CUDA-core kernel, K1's nchw kernels)
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    from enhanced_unet_tpu_torch.utils import profiler

    model = get_model("enhanced_unet", dtype=torch.float32, device=cuda, seed=2,
                      encoder_names=("efficientnet-tiny", "efficientnet-tiny"))
    ev = Evaluator(model, "enhanced_unet", enable_tta=False, device=cuda, verbose=False,
                   tiled=True, tile=64, overlap=16)
    img = np.random.default_rng(0).random((1, 96, 128, 3)).astype(np.float32)
    ev.predict_semantic_masks_tiled(img)
    packs = sum("_packed_conv3x3" in m.__dict__ for m in model.modules())
    folds = sum("_folded" in m.__dict__ for m in model.modules())
    ev.update_state({k: v + 0.01 if v.is_floating_point() else v
                     for k, v in model.state_dict().items()})
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ev.predict_semantic_masks_tiled(img)
    got = profiler.counters()
    assert packs > 0 and folds > 0
    assert (got["kernels.k2_pack"], got["kernels.k1_fold"]) == (packs, folds)
    assert got["launches.conv3x3_bn_act_f32"] > 0
    assert sum(v for k, v in got.items() if k.startswith("launches.mbconv")) > 0
    (root,) = [s for s in profiler.spans() if s["parent"] is None]
    forwards = [s for s in profiler.spans() if s["name"] == "model.forward"]
    assert 0 < sum(f["device_ms"] for f in forwards) <= root["device_ms"]


def _dw_dilated_case(cuda, dtype, n, c, hw, k, seed, d=2):
    from enhanced_unet_tpu_torch.ops.kernels.depthwise import DwFolded

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, c, hw, hw + 1, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, k, c, generator=g, device=cuda) * 0.2).to(dtype)
    return x, DwFolded(w, torch.randn(c, generator=g, device=cuda) * 0.1)


def _dw_dilated_check(x, p, d=2):
    from enhanced_unet_tpu_torch.ops.kernels import depthwise

    before = depthwise.LAUNCHES["dw_dilated_bn_silu_nhwc"]
    got = depthwise.dw_dilated_bn_silu_nhwc(x, p, d)
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES["dw_dilated_bn_silu_nhwc"] == before + 1
    want = depthwise.dw_dilated_bn_silu_nhwc_plain(x, p, d)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= _tol(x.dtype)


# the serving widths of B4's dilated stages (960 and 1632 at k5, 1632 and
# 2688 at k3) on the stride-16 maps of a tiled request (32², 24², 40²)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [32, 24, 40])
@pytest.mark.parametrize("c,k", [(960, 5), (1632, 5), (1632, 3), (2688, 3)])
def test_dw_dilated_kernel_matches_plain_at_the_serving_widths(cuda, dtype, hw, c, k):
    x, p = _dw_dilated_case(cuda, dtype, 2, c, hw, k, seed=c + hw + k)
    _dw_dilated_check(x.contiguous(memory_format=torch.channels_last), p)


# an odd width (the element-wise path), a width a multiple of 8 but not of
# the 64-channel group, maps smaller than the halo (3², 5²), one wider than
# a band (100 columns), dilation 1 and 4, and an NCHW input (copied first)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,hw,k,d,layout", [
    (3, 13, 9, 5, 2, "cl"), (2, 1001, 12, 3, 2, "cl"), (2, 200, 3, 5, 2, "cl"),
    (1, 72, 5, 3, 2, "cl"), (1, 64, 100, 5, 2, "cl"), (2, 48, 11, 3, 1, "cl"),
    (1, 40, 20, 5, 4, "cl"), (2, 96, 10, 5, 2, "nchw")])
def test_dw_dilated_kernel_takes_odd_shapes(cuda, dtype, n, c, hw, k, d, layout):
    x, p = _dw_dilated_case(cuda, dtype, n, c, hw, k, seed=c * 7 + hw)
    if layout == "cl":
        x = x.contiguous(memory_format=torch.channels_last)
    _dw_dilated_check(x, p, d)


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 3), (torch.bfloat16, 8),
                                          (torch.float32, 1)])
def test_dw_dilated_kernel_takes_any_start(cuda, dtype, offset):
    # a channels_last view a few elements into its storage: the element-wise
    # path where the start is not 16-byte aligned (bf16 3, fp32 1), the
    # 16-byte one where it is (bf16 8)
    x, p = _dw_dilated_case(cuda, dtype, 2, 64, 12, 5, seed=offset)
    flat = torch.empty(x.numel() + offset, device=cuda, dtype=dtype)
    view = flat[offset:].view(2, 12, 13, 64).permute(0, 3, 1, 2)
    view.copy_(x)
    assert view.is_contiguous(memory_format=torch.channels_last)
    _dw_dilated_check(view, p)


def test_a_tiled_request_launches_the_dilated_kernel_30_times(cuda):
    # the B5/B4 flagship serving a tiled request with TTA: three forwards of
    # the DeepLab encoder, ten dilated blocks each; after a weight swap the
    # first request folds each block's weights once, the next none
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    from enhanced_unet_tpu_torch.utils import profiler

    model = get_model("enhanced_unet", device=cuda, seed=2)
    ev = Evaluator(model, "enhanced_unet", enable_tta=True, device=cuda, verbose=False,
                   tiled=True, tile=256, overlap=32)
    img = np.random.default_rng(0).random((1, 384, 400, 3)).astype(np.float32)
    ev.predict_semantic_masks_tiled(img)
    ev.update_state({k: v + 0.01 if v.is_floating_point() else v
                     for k, v in model.state_dict().items()})
    got = []
    for _ in range(2):
        profiler.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            ev.predict_semantic_masks_tiled(img)
        got.append(profiler.counters())
    assert [c["launches.dw_dilated_bn_silu_nhwc"] for c in got] == [30, 30]
    assert [c.get("kernels.dw_fold", 0) for c in got] == [10, 0]


def _gelu_check(x, p):
    from enhanced_unet_tpu_torch.ops.kernels import depthwise

    before = depthwise.LAUNCHES["dw3x3_bias_gelu_nhwc"]
    got = depthwise.dw3x3_bias_gelu_nhwc(x, p)
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES["dw3x3_bias_gelu_nhwc"] == before + 1
    want = depthwise.dw3x3_bias_gelu_nhwc_plain(x, p)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= _tol(x.dtype)


def _gelu_case(cuda, dtype, n, c, h, w, seed):
    from enhanced_unet_tpu_torch.ops.kernels.depthwise import fold_dw_bias

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g, device=cuda).to(dtype)
    p = fold_dw_bias(torch.randn(c, 1, 3, 3, generator=g, device=cuda) * 0.3,
                     torch.randn(c, generator=g, device=cuda) * 0.3, dtype)
    return x, p


# SegFormer-B5's Mix-FFN widths on its stage maps (512^2 tiles: 128^2 to
# 16^2; 384^2 and 640^2 tiles: 12^2 to 160^2), odd widths and heights
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,h,w", [(256, 128, 128), (256, 160, 160), (512, 48, 48),
                                   (1280, 40, 40), (1280, 24, 24), (2048, 12, 12),
                                   (2048, 16, 16), (512, 33, 70)])
def test_mixffn_gelu_kernel_matches_plain_at_the_serving_widths(cuda, dtype, c, h, w):
    x, p = _gelu_case(cuda, dtype, 2, c, h, w, seed=c + h + w)
    _gelu_check(x.contiguous(memory_format=torch.channels_last), p)


# an odd channel count (the element-wise path), one-pixel maps and rows, a
# map wider than a band of columns, an NCHW input (copied first), and a
# start that is not 16-byte aligned
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,h,w,layout,offset", [
    (3, 13, 9, 11, "cl", 0), (1, 64, 1, 1, "cl", 0), (2, 40, 1, 97, "cl", 0),
    (1, 16, 100, 3, "cl", 0), (2, 96, 10, 70, "nchw", 0), (2, 64, 12, 13, "cl", 3)])
def test_mixffn_gelu_kernel_takes_odd_shapes(cuda, dtype, n, c, h, w, layout, offset):
    x, p = _gelu_case(cuda, dtype, n, c, h, w, seed=c * 7 + h)
    if offset:
        flat = torch.empty(x.numel() + offset, device=cuda, dtype=dtype)
        view = flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
        view.copy_(x)
        x = view
    elif layout == "cl":
        x = x.contiguous(memory_format=torch.channels_last)
    _gelu_check(x, p)


def test_a_tiled_segformer_request_launches_the_gelu_kernel_156_times(cuda):
    # SegFormer-B5 serving a tiled request with TTA: three forwards of 52
    # Mix-FFN blocks; after a weight swap the first request lays out each
    # block's depthwise weights once, the next none
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from enhanced_unet_tpu_torch.models import get_model
    from enhanced_unet_tpu_torch.train.evaluator import Evaluator
    from enhanced_unet_tpu_torch.utils import profiler

    model = get_model("segformer_b5", device=cuda, seed=2)
    ev = Evaluator(model, "segformer_b5", enable_tta=True, device=cuda, verbose=False,
                   tiled=True, tile=256, overlap=32)
    img = np.random.default_rng(0).random((1, 384, 400, 3)).astype(np.float32)
    ev.predict_semantic_masks_tiled(img)
    ev.update_state({k: v + 0.01 if v.is_floating_point() else v
                     for k, v in model.state_dict().items()})
    got = []
    for _ in range(2):
        profiler.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            ev.predict_semantic_masks_tiled(img)
        got.append((profiler.counters(), profiler.spans()))
    assert [c["launches.dw3x3_bias_gelu_nhwc"] for c, _ in got] == [156, 156]
    assert [c.get("kernels.mixffn_fold", 0) for c, _ in got] == [52, 0]
    names = {s["name"] for s in got[1][1]}
    assert {f"model.segformer.stage{i}" for i in (1, 2, 3, 4)} | {"model.segformer.head"} <= names
