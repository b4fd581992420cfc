// Fused MBConv inference block (EfficientNet unit) on NCHW memory, two
// passes, every shape: the `nchw` kernels, redesigned for Hopper.
//
// Replaces enhanced_unet_tpu/ops/pallas/mbconv.py::mbconv_infer_nchw
// (_pass1_kernel :144, launched at :208; _pass2_kernel :162, launched at
// :233) for every block that csrc/mbconv_nhwc.cu and mbconv_nhwc_expand.cu
// do not take (fp32, and bf16 blocks wider than 64 channels or with channel
// counts that are not multiples of 8), and B2's two passes
// (benchmarks/pallas_mbconv_instr.py :89, :99).  Weights arrive folded (BN0
// into the expand, BN1 into the depthwise, BN2 into the projection bias; the
// SE gate is folded into per-image projection weights between the passes).
//
//   pass 1: [expand 1x1 + bias, SiLU, cast T ->] depthwise 3x3 + bias, SiLU
//           (fp32) -> one partial channel sum per (image, tile, channel)
//   pass 2: recompute the same, cast T -> 1x1 projection with the image's
//           gated weights [mid, Cout] (fp32 sums) + bias [+ residual x]
//           -> cast T
//
// What bounds it on the H100: bytes where there is no expand (B2's bf16
// [16,24,256,256]: about 24 operations per byte in pass 1, 40 in pass 2,
// against a bf16 ridge of about 295), operations where there is one
// (fp32 [6,40,128,128] mid 240: 2 * 40 * 240 expand + 2 * 240 * 40
// projection multiply-adds a pixel, above the fp32 ridge of 20 operations
// per byte of the CUDA cores).
//
// The design.  Pass 1 without an expand is a depthwise and a sum over x
// itself: a row-streaming kernel (below, `mbconv_pass1_stream_kernel`).
// Every other pass is one tiled kernel: a block takes one image and a tile
// of P = 256 output pixels in whole NCHW row segments, 256 threads: 8 rows
// x 32 columns (fp32: 128-byte rows; bf16 maps up to 32 wide: 64-byte rows)
// or, for wider bf16 maps, 4 x 64 (128-byte rows).
// - Tiles copied 16 bytes at a time: the block keeps each input channel's
//   haloed tile (TH + 2 rows) as a shared-memory plane whose rows hold the
//   interior 16-byte aligned, filled by 16-byte `cp.async` copies, with the
//   +-1 columns beside them (4-byte copies of the neighbouring pair or
//   element); zero-filled outside the image, the depthwise's padding.
//   Planes are an odd number of 16-byte units apart (ldmatrix rows and
//   8-lane row reads hit distinct banks).
// - Channels in chunks, so shared memory is bounded by the tile: mid is
//   taken 32 channels at a time; an input of up to 64 channels stays
//   resident (one copy group per 32 channels, so a block without an expand
//   starts its first chunk while the second is in flight), a wider one is
//   streamed 32 channels at a time through two buffers, the next chunk in
//   flight while this one computes (`cp.async.wait_group 1`).  Cout is taken
//   64 channels a block (32 where Cout <= 32), as a grid dimension: each
//   Cout block recomputes the expand and the depthwise of its pixels (a
//   tile's accumulators fit in registers, and the wide stages' small maps
//   need the blocks).  Pass 1 splits mid across blocks instead where the
//   tiles alone would not fill the card (its sums are per channel).
// - The expand is a GEMM with pixels as N: E[32 mid][haloed positions] =
//   Wexp[32][Cin chunk] . X[Cin chunk][positions].  bf16: `mma.sync
//   .m16n8k16`, A (the chunk's weights, staged [mid][k]) by `ldmatrix`, B
//   (the NCHW planes, pixels contiguous) by `ldmatrix.trans`; fp32: 8 x 4
//   register tiles of FMAs from `float4` reads.  Epilogue: bias, SiLU, zero
//   outside the image, cast to T, into a plane of the same layout.
// - The depthwise from shared memory: a thread takes one channel, 16 bytes
//   of columns and 4 (8 in fp32) output rows, the 9 taps and bias in
//   registers, each input row read once (a 16-byte vector and its two
//   neighbours) and added into the three output rows it touches; the SiLU
//   on ex2/rcp.approx.  Pass 1 sums the fp32 SiLU output in registers, then
//   over the 8 lanes of a channel by shuffles, one partial sum a channel.
// - The projection is a GEMM: O[CT Cout][256 px] += Wg[CT][32] . Y[32][256]
//   over the mid chunks, Y the T-rounded SiLU output.  bf16: `mma.sync`, A
//   (the gated weights, transposed as they are staged) by `ldmatrix`, B by
//   `ldmatrix.trans`; fp32: register tiles (CT / 8 channels x 8 pixels).
//   The accumulators stay in registers across the chunks.  At the end the
//   bias, the residual (from the resident input planes, or from x where the
//   input is streamed) and the cast are applied on the way out as 16-byte
//   row stores: fp32 straight from the accumulators (4 pixels a thread),
//   bf16 through an fp32 staging area in shared memory (8 pixels a thread).
// What holds it back (PERF.md has the times): without an expand, the
// phases of a tile (copy, depthwise, projection, stores) follow each other
// behind barriers, and two blocks an SM (128 registers a thread) hide
// little of their latency; a tighter register cap spills and is slower
// (benchmarks/mbconv_nchw.py --sweep).  With an expand, the CUDA cores'
// depthwise and SiLUs, and for Cout above 64 the recomputation by each Cout
// block (8x at stage 6's 512 channels).
// fp32 runs in full fp32 on the CUDA cores (no TF32).  Where W is not a
// multiple of 16 bytes or x does not start 16-byte aligned, an element-wise
// instantiation of the same kernel runs (scalar copies and stores).
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include "mbconv_common.cuh"
#include "row_stream.cuh"

namespace {

using namespace mbconv;

constexpr int NT = 256;          // threads per block
constexpr int MC = 32;           // mid channels per chunk
constexpr int KC = 32;           // input channels per streamed chunk
constexpr int RESIDENT = 64;     // inputs of up to this many channels stay resident
constexpr int P = 256;           // output pixels per tile
// bf16 pass 2's fp32 output staging rows: 8 banks apart, so a half warp's
// float2 stores hit distinct banks
constexpr int LDO = P + 8;

// Blocks an SM that the register cap of pass 2's kernels without an expand
// leaves room for (those with an expand: one).  bf16 maps up to
// NARROW_W wide take tiles of 32 columns x 8 rows (64-byte row segments, 10
// haloed rows copied for 8), wider ones 64 x 4 (128-byte segments, 6 rows
// for 4); fp32 always 32 x 8.  benchmarks/mbconv_nchw.py --sweep builds
// other values (-DMBCONV_P2_BLOCKS=.., -DMBCONV_NARROW_W=..).
#ifndef MBCONV_P2_BLOCKS
#define MBCONV_P2_BLOCKS 2
#endif
#ifndef MBCONV_NARROW_W
#define MBCONV_NARROW_W 32
#endif
constexpr int P2_BLOCKS = MBCONV_P2_BLOCKS;
constexpr int NARROW_W = MBCONV_NARROW_W;
// Phases of the tiled kernel left out, for benchmarks/mbconv_nchw.py
// --ablate only (-DMBCONV_SKIP=..; the results are then wrong): the input
// copies, pass 2's depthwise, its projection GEMM, its epilogue and stores.
#ifndef MBCONV_SKIP
#define MBCONV_SKIP 0
#endif
enum Skip { SKIP_COPIES = 1, SKIP_DEPTHWISE = 2, SKIP_GEMM = 4, SKIP_STORES = 8 };
__host__ __device__ constexpr bool skips(int phase) { return (MBCONV_SKIP & phase) != 0; }

// The element type's constants.
template <bool BF16>
struct Geo;

template <>
struct Geo<true> {
  using T = uint16_t;
  static constexpr int VW = 8;               // elements per 16 bytes
  static constexpr int A = 8;                // interior offset in a plane row
  static constexpr int POS = 480;            // positions of a plane (haloed rows x RS)
  static constexpr int PLANE = POS + 8;      // 976 bytes: 61 16-byte units
  static constexpr int LDY = P + 8;          // Y rows: 33 units
  static constexpr int LDW = KC + 8;         // expand weights [mid][k]: 5 units
  static constexpr int WB = MC * LDW;
};

template <>
struct Geo<false> {
  using T = float;
  static constexpr int VW = 4;
  static constexpr int A = 4;
  static constexpr int POS = 400;
  static constexpr int PLANE = POS + 4;      // 1616 bytes: 101 units
  static constexpr int LDY = P;
  static constexpr int LDW = MC + 4;         // expand weights [k][mid]
  static constexpr int WB = KC * LDW;
};

// A tile of P pixels, TW columns wide.
template <bool BF16, int TWD>
struct Tile {
  static constexpr int TW = TWD, TH = P / TW;
  static constexpr int RS = TW + 2 * Geo<BF16>::A;   // plane row stride
  static constexpr int ROWS = TH + 2;                // haloed rows
  static constexpr int VPR = TW / Geo<BF16>::VW;     // 16-byte runs a row
  static constexpr int RT = TH * VPR * MC / NT;      // output rows a depthwise thread
  static_assert(ROWS * RS == Geo<BF16>::POS && TH % RT == 0, "the tile fills the plane");
};

template <bool BF16>
int tile_w(int W) {
  return BF16 && W > NARROW_W ? 64 : 32;
}

// The staged projection weights of a block of CT output channels: bf16
// [co][m] (rows of 5 16-byte units), fp32 [m][co].
template <bool BF16, int CT>
struct PGeo {
  static constexpr int LDA = BF16 ? MC + 8 : CT + 4;
  static constexpr int AS = BF16 ? CT * LDA : MC * LDA;
};

static_assert(KC == MC, "without an expand, a streamed input chunk is a mid chunk");

// Planes of the input kept in shared memory: all of it up to RESIDENT
// channels (rounded up to the bf16 expand's k16 steps), else two chunks.
__host__ __device__ constexpr int input_planes(int Cin, bool expand) {
  return Cin > RESIDENT ? 2 * KC : expand ? (Cin + 15) / 16 * 16 : Cin;
}

// Offsets (elements of T) of the block's shared-memory regions: the input
// planes, the expanded planes, Y, the staged expand and projection weights;
// and (bytes) bf16 pass 2's fp32 output staging after all of them (so no
// warp's staging waits for the others' projection).
template <bool BF16, int CT>
struct Layout {
  int es, ys, wb, as, os, bytes;
  __host__ __device__ Layout(int Cin, bool expand, int pass) {
    using G = Geo<BF16>;
    constexpr int ES = (int)sizeof(typename G::T);
    es = input_planes(Cin, expand) * G::PLANE;
    ys = es + (expand ? MC * G::PLANE : 0);
    wb = ys + (pass == 2 ? MC * G::LDY : 0);
    as = wb + (expand ? G::WB : 0);
    bytes = (as + (pass == 2 ? PGeo<BF16, CT>::AS : 0)) * ES;
    os = bytes;
    if (BF16 && pass == 2) bytes += CT * LDO * 4;
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float to_f(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Planes [0, nplanes) at dst <- channels k0.. of image n's haloed tile
// (zeros outside the image and for channels >= Cin).  VEC: 16-byte copies
// of the interior and 4-byte copies of the edge pair (bf16) or element
// (fp32) beside it, in flight until the caller's wait; else scalar loads
// and stores.
template <bool BF16, int TWD, bool VEC>
__device__ __forceinline__ void load_planes(const typename Geo<BF16>::T* __restrict__ x,
                                            typename Geo<BF16>::T* dst, int k0, int nplanes,
                                            int Cin, int H, int W, int n, int h0, int w0) {
  using G = Geo<BF16>;
  using K = Tile<BF16, TWD>;
  using T = typename G::T;
  constexpr int VPR = K::VPR;
  if constexpr (VEC) {
    const uint32_t base = smem_u32(dst);
    for (int i = threadIdx.x; i < nplanes * K::ROWS * VPR; i += NT) {
      const int v = i % VPR, rest = i / VPR;
      const int r = rest % K::ROWS, j = rest / K::ROWS;
      const int c = k0 + j, hh = h0 + r - 1, ww = w0 + v * G::VW;
      const bool ok = c < Cin && hh >= 0 && hh < H && ww < W;
      const T* src = ok ? x + (((size_t)n * Cin + c) * H + hh) * W + ww : x;
      cp_async16(base + (j * G::PLANE + r * K::RS + G::A + v * G::VW) * sizeof(T), src,
                 ok ? 16 : 0);
    }
    // the column left of the tile and the one right of it: bf16 the pair
    // (w0 - 2, w0 - 1) and (w0 + TW, w0 + TW + 1), fp32 the element
    constexpr int EL = BF16 ? 2 : 1;
    for (int i = threadIdx.x; i < nplanes * K::ROWS * 2; i += NT) {
      const int side = i & 1, rest = i >> 1;
      const int r = rest % K::ROWS, j = rest / K::ROWS;
      const int c = k0 + j, hh = h0 + r - 1;
      const int ww = side ? w0 + K::TW : w0 - EL;
      const bool ok = c < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const T* src = ok ? x + (((size_t)n * Cin + c) * H + hh) * W + ww : x;
      const int col = side ? G::A + K::TW : G::A - EL;
      cp_async4(base + (j * G::PLANE + r * K::RS + col) * sizeof(T), src, ok ? 4 : 0);
    }
  } else {
    constexpr int COLS = K::TW + 2;
    for (int i = threadIdx.x; i < nplanes * K::ROWS * COLS; i += NT) {
      const int q = i % COLS, rest = i / COLS;
      const int r = rest % K::ROWS, j = rest / K::ROWS;
      const int c = k0 + j, hh = h0 + r - 1, ww = w0 + q - 1;
      const bool ok = c < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W;
      dst[j * G::PLANE + r * K::RS + G::A - 1 + q] =
          ok ? x[(((size_t)n * Cin + c) * H + hh) * W + ww] : T(0);
    }
  }
}

// The staged expand weights of step (c0, k0), width mid channels and kw
// input channels, four a thread: bf16 wb[m][k], fp32 wb[k][m]; zeros past
// them.
template <bool BF16>
struct WexpRegs {
  typename Geo<BF16>::T v[MC * KC / NT];

  __device__ __forceinline__ void fetch(const typename Geo<BF16>::T* __restrict__ wexp,
                                        int Cin, int c0, int width, int k0, int kw) {
#pragma unroll
    for (int q = 0; q < MC * KC / NT; ++q) {
      const int e = threadIdx.x + NT * q;
      const int m = BF16 ? e / KC : e % MC, k = BF16 ? e % KC : e / MC;
      v[q] = m < width && k < kw ? wexp[(size_t)(c0 + m) * Cin + k0 + k]
                                 : typename Geo<BF16>::T(0);
    }
  }

  __device__ __forceinline__ void store(typename Geo<BF16>::T* wb) const {
    using G = Geo<BF16>;
#pragma unroll
    for (int q = 0; q < MC * KC / NT; ++q) {
      const int e = threadIdx.x + NT * q;
      if (BF16)
        wb[(e / KC) * G::LDW + e % KC] = v[q];
      else
        wb[(e / MC) * G::LDW + e % MC] = v[q];
    }
  }
};

// The image's gated projection weights of chunk c0 (width channels) and
// output channels co0..co0+ctw, CT / 8 a thread: bf16 as[co][m], fp32
// as[m][co]; zeros past them.
template <bool BF16, int CT>
struct WprojRegs {
  typename Geo<BF16>::T v[CT * MC / NT];

  __device__ __forceinline__ void fetch(const typename Geo<BF16>::T* __restrict__ wn, int Cout,
                                        int c0, int width, int co0, int ctw) {
#pragma unroll
    for (int q = 0; q < CT * MC / NT; ++q) {
      const int e = threadIdx.x + NT * q;
      const int co = e % CT, m = e / CT;
      v[q] = m < width && co < ctw ? wn[(size_t)(c0 + m) * Cout + co0 + co]
                                   : typename Geo<BF16>::T(0);
    }
  }

  __device__ __forceinline__ void store(typename Geo<BF16>::T* as) const {
    constexpr int LDA = PGeo<BF16, CT>::LDA;
#pragma unroll
    for (int q = 0; q < CT * MC / NT; ++q) {
      const int e = threadIdx.x + NT * q;
      const int co = e % CT, m = e / CT;
      if (BF16)
        as[co * LDA + m] = v[q];
      else
        as[m * LDA + co] = v[q];
    }
  }
};

// bf16 expand accumulators: warp w takes m16 tile w & 1 and the n8 tiles
// (w >> 1) + 4 j of the 60 covering a plane's 480 positions.
constexpr int EJ_BF16 = Geo<true>::POS / 8 / 4;      // 15
// fp32: items tid + 256 j (j < 2) of 4 (8 mid) x 100 (4 positions).
constexpr int EITEMS_F32 = (MC / 8) * (Geo<false>::POS / 4);   // 400

template <bool BF16, int TWD>
struct ExpandAcc;

template <int TWD>
struct ExpandAcc<true, TWD> {
  float acc[EJ_BF16][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < EJ_BF16; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }

  // acc += wb[:, 0:kw] . planes[0:kw] (kw rounded up to 16: zero rows)
  __device__ __forceinline__ void gemm(const uint16_t* planes, const uint16_t* wb, int kw) {
    using G = Geo<true>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mt = warp & 1;
    for (int ks = 0; ks * 16 < kw; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(wb + (mt * 16 + (lane & 15)) * G::LDW + ks * 16 + (lane >> 4) * 8));
      const uint16_t* brow = planes + (ks * 16 + (lane & 15)) * G::PLANE;
#pragma unroll
      for (int j = 0; j < EJ_BF16; ++j) {
        uint32_t b[2];
        ldsm_x2_trans(b, smem_u32(brow + ((warp >> 1) + 4 * j) * 8));
        mma_bf16(acc[j], a, b);
      }
    }
  }

  // es[m][pos] <- bf16(SiLU(acc + bexp)), 0 outside the image
  __device__ __forceinline__ void finish(uint16_t* es, const float* __restrict__ bexp, int c0,
                                         int width, int h0, int w0, int H, int W) {
    using G = Geo<true>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, mt = warp & 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      const float bias = m < width ? bexp[c0 + m] : 0.f;
#pragma unroll
      for (int j = 0; j < EJ_BF16; ++j) {
        const int pos = ((warp >> 1) + 4 * j) * 8 + 2 * t;
        const int r = pos / Tile<true, TWD>::RS, q = pos - r * Tile<true, TWD>::RS;
        const int hh = h0 + r - 1, ww = w0 + q - G::A;
        const bool row = hh >= 0 && hh < H;
        const float v0 = row && ww >= 0 && ww < W ? silu(acc[j][2 * half] + bias) : 0.f;
        const float v1 = row && ww + 1 >= 0 && ww + 1 < W ? silu(acc[j][2 * half + 1] + bias)
                                                          : 0.f;
        *reinterpret_cast<uint32_t*>(es + m * G::PLANE + pos) = pack2(v0, v1);
      }
    }
  }
};

template <int TWD>
struct ExpandAcc<false, TWD> {
  float acc[2][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][i][k] = 0.f;
  }

  __device__ __forceinline__ void gemm(const float* planes, const float* wb, int kw) {
    using G = Geo<false>;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int it = threadIdx.x + NT * j;
      if (it >= EITEMS_F32) continue;
      const int mg = it & 3, pb = it >> 2;
      const float* wa = wb + mg * 8;
      const float* xb = planes + pb * 4;
#pragma unroll 4
      for (int k = 0; k < kw; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wa + k * G::LDW);
        const float4 w1 = *reinterpret_cast<const float4*>(wa + k * G::LDW + 4);
        const float4 xv = *reinterpret_cast<const float4*>(xb + k * G::PLANE);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][i][e] = fmaf(wv[i], xs[e], acc[j][i][e]);
      }
    }
  }

  __device__ __forceinline__ void finish(float* es, const float* __restrict__ bexp, int c0,
                                         int width, int h0, int w0, int H, int W) {
    using G = Geo<false>;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int it = threadIdx.x + NT * j;
      if (it >= EITEMS_F32) continue;
      const int mg = it & 3, pb = it >> 2;
      const int pos = pb * 4;
      const int r = pos / Tile<false, TWD>::RS, q = pos - r * Tile<false, TWD>::RS;
      const int hh = h0 + r - 1, ww = w0 + q - G::A;
      const bool row = hh >= 0 && hh < H;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = mg * 8 + i;
        const float bias = m < width ? bexp[c0 + m] : 0.f;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = row && ww + e >= 0 && ww + e < W ? silu(acc[j][i][e] + bias) : 0.f;
        *reinterpret_cast<float4*>(es + m * G::PLANE + pos) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
};

// Projection accumulators O[CT co][256 px].  bf16: warp w takes pixels
// [32 w, 32 w + 32) (4 n8 tiles) of all CT / 16 m16 tiles; fp32: thread
// (cg = tid / 32, pg = tid % 32) takes CT / 8 output channels from
// cg * CT / 8 and pixels 4 pg.. and 128 + 4 pg..
template <bool BF16, int CT>
struct ProjAcc;

template <int CT>
struct ProjAcc<true, CT> {
  static constexpr int MT = CT / 16;
  float acc[MT][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }

  __device__ __forceinline__ void gemm(const uint16_t* as, const uint16_t* ys, int width,
                                       int ctw) {
    using G = Geo<true>;
    constexpr int LDA = PGeo<true, CT>::LDA;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int ks = 0; ks < MC / 16; ++ks) {
      if (ks * 16 >= width) break;
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_u32(ys + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * G::LDY +
                                  warp * 32 + h * 16 + (lane >> 4) * 8));
        b[2 * h][0] = r[0], b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2], b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt * 16 >= ctw) break;
        uint32_t a[4];
        ldsm_x4(a, smem_u32(as + (mt * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }

  // os[co][p] <- the accumulators, fp32
  __device__ __forceinline__ void stage(float* os) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int co = mt * 16 + g + 8 * half, p = warp * 32 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(os + co * LDO + p) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
  }
};

template <int CT>
struct ProjAcc<false, CT> {
  static constexpr int CO = CT / 8;
  float acc[CO][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < CO; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  }

  __device__ __forceinline__ void gemm(const float* as, const float* ys, int width, int ctw) {
    using G = Geo<false>;
    constexpr int LDA = PGeo<false, CT>::LDA;
    const int cg = threadIdx.x >> 5, pg = threadIdx.x & 31;
    if (cg * CO >= ctw) return;
#pragma unroll 4
    for (int k = 0; k < width; ++k) {
      float av[CO];
#pragma unroll
      for (int q = 0; q < CO / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(as + k * LDA + cg * CO + 4 * q);
        av[4 * q] = a.x, av[4 * q + 1] = a.y, av[4 * q + 2] = a.z, av[4 * q + 3] = a.w;
      }
      const float4 y0 = *reinterpret_cast<const float4*>(ys + k * G::LDY + pg * 4);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + k * G::LDY + P / 2 + pg * 4);
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < CO; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], yv[e], acc[i][e]);
    }
  }

  // put(co, p, v): output channel co of the block, pixels p..p + 3
  template <typename Put>
  __device__ __forceinline__ void store(Put&& put) const {
    const int cg = threadIdx.x >> 5, pg = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < CO; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v[4] = {acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                            acc[i][4 * half + 3]};
        put(cg * CO + i, half * (P / 2) + pg * 4, v);
      }
  }
};

// One plane row's 16-byte column run j0.. and its two neighbours, in fp32.
template <bool BF16>
__device__ __forceinline__ void read_run(const typename Geo<BF16>::T* row, int j0,
                                         float (&f)[Geo<BF16>::VW + 2]) {
  using G = Geo<BF16>;
  const typename G::T* p = row + G::A + j0;
  f[0] = to_f(p[-1]);
  f[G::VW + 1] = to_f(p[G::VW]);
  if constexpr (BF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[1 + 2 * k] = lo_f(w4[k]);
      f[2 + 2 * k] = hi_f(w4[k]);
    }
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[1] = v.x, f[2] = v.y, f[3] = v.z, f[4] = v.w;
  }
}

// Depthwise 3x3 + bias + SiLU (fp32) of one channel's plane from row
// `plane` on, the thread's column run j0..j0+VW down RT output rows: each
// input row is read once and added into the up to three output rows it
// touches; fin(o, v) takes output row o when its last input row is in.
template <bool BF16, int TWD, typename Fin>
__device__ __forceinline__ void depthwise(const typename Geo<BF16>::T* plane, const float (&k)[9],
                                          float bias, int j0, Fin&& fin) {
  using G = Geo<BF16>;
  using K = Tile<BF16, TWD>;
  constexpr int VW = G::VW;
  float acc[3][VW];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[s][e] = bias;
#pragma unroll
  for (int i = 0; i < K::RT + 2; ++i) {
    float f[VW + 2];
    read_run<BF16>(plane + i * K::RS, j0, f);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int o = i - u;
      if (o < 0 || o >= K::RT) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          acc[o % 3][e] = fmaf(k[u * 3 + dx], f[e + dx], acc[o % 3][e]);
    }
    if (i >= 2) {
      const int o = i - 2;
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        v[e] = silu(acc[o % 3][e]);
        acc[o % 3][e] = bias;
      }
      fin(o, v);
    }
  }
}

// One block: one image (blockIdx.z), one tile (blockIdx.x), and (blockIdx.y)
// in pass 2 one block of CT output channels, in pass 1 the mid chunks
// [y * mcpb, y * mcpb + mcpb): small maps give too few tiles to fill the
// card, and pass 1's sums are per channel, so mid is split across blocks.
template <bool BF16, int TWD, bool EXPAND, int PASS, bool VEC, int CT>
__global__ void __launch_bounds__(NT, EXPAND ? 1 : P2_BLOCKS)
mbconv_nchw_kernel(const typename Geo<BF16>::T* __restrict__ x,
                   const typename Geo<BF16>::T* __restrict__ wexp,
                   const float* __restrict__ bexp, const typename Geo<BF16>::T* __restrict__ wdw,
                   const float* __restrict__ bdw, const typename Geo<BF16>::T* __restrict__ wpp,
                   const float* __restrict__ bproj, typename Geo<BF16>::T* __restrict__ out,
                   float* __restrict__ partial, int Cin, int mid, int Cout, int H, int W,
                   int residual, int tiles_w, int mcpb) {
  using G = Geo<BF16>;
  using K = Tile<BF16, TWD>;
  using T = typename G::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<BF16, CT> L(Cin, EXPAND, PASS);
  T* xs = reinterpret_cast<T*>(smem);
  T* es = xs + L.es;
  T* ys = xs + L.ys;
  T* wb = xs + L.wb;
  T* as = xs + L.as;
  const int tile = blockIdx.x, n = blockIdx.z;
  const int h0 = (tile / tiles_w) * K::TH, w0 = (tile % tiles_w) * K::TW;
  const int co0 = PASS == 2 ? blockIdx.y * CT : 0, ctw = min(CT, Cout - co0);
  const int nxc = (Cin + KC - 1) / KC;
  const int mc0 = PASS == 1 ? blockIdx.y * mcpb : 0;
  const int nmc = PASS == 1 ? min((mid + MC - 1) / MC, mc0 + mcpb) : (mid + MC - 1) / MC;
  const bool stream = Cin > RESIDENT;
  const int steps = EXPAND ? nmc * nxc : nmc;   // steps [mc0 * nxc, steps) (expand)
  // the X chunk of step s: channels k0.. into half s & 1 (streamed)
  auto load_step = [&](int s) {
    const int k0 = (EXPAND ? s % nxc : s) * KC;
    const int planes = EXPAND ? (min(KC, Cin - k0) + 15) / 16 * 16 : min(KC, Cin - k0);
    load_planes<BF16, TWD, VEC>(x, xs + (s & 1) * KC * G::PLANE, k0, planes, Cin, H, W, n, h0, w0);
    commit();
  };
  int s = EXPAND ? mc0 * nxc : mc0;
  if (stream) {
    load_step(s);
  } else {                                // resident: a copy group per 32 channels
    const int xpl = input_planes(Cin, EXPAND);
    for (int k0 = 0; k0 < xpl; k0 += KC) {
      if (!skips(SKIP_COPIES))
        load_planes<BF16, TWD, VEC>(x, xs + k0 * G::PLANE, k0, min(KC, xpl - k0), Cin, H, W, n,
                                    h0, w0);
      commit();
    }
  }
  // the depthwise thread's channel, 16-byte column run and rows [r0, r0 + RT)
  const int ch = threadIdx.x >> 3, j0 = (threadIdx.x & 7) % K::VPR * G::VW;
  const int r0 = (threadIdx.x & 7) / K::VPR * K::RT;
  const T* wn = wpp + (size_t)n * mid * Cout;
  ProjAcc<BF16, CT> pacc;
  if constexpr (PASS == 2) pacc.zero();
  WexpRegs<BF16> wreg;
  if constexpr (EXPAND) wreg.fetch(wexp, Cin, mc0 * MC, min(MC, mid - mc0 * MC), 0, min(KC, Cin));
  for (int mc = mc0; mc < nmc; ++mc) {
    const int c0 = mc * MC, width = min(MC, mid - c0);
    WprojRegs<BF16, CT> preg;
    if constexpr (PASS == 2) preg.fetch(wn, Cout, c0, width, co0, ctw);
    // the depthwise weights of channel c0 + ch, in flight over the waits
    const bool active = ch < width;
    float k9[9], kb = 0.f;
    if (active) {
#pragma unroll
      for (int t = 0; t < 9; ++t) k9[t] = to_f(wdw[(size_t)(c0 + ch) * 9 + t]);
      kb = bdw[c0 + ch];
    }
    const T* dsrc;
    if constexpr (EXPAND) {
      ExpandAcc<BF16, TWD> eacc;
      eacc.zero();
      for (int kc = 0; kc < nxc; ++kc, ++s) {
        wreg.store(wb);
        if (stream && s + 1 < steps) {
          load_step(s + 1);
          wait_group<1>();
        } else {
          wait_group<0>();
        }
        __syncthreads();
        if (s + 1 < steps) {
          const int mn = (s + 1) / nxc, kn = (s + 1) % nxc;
          wreg.fetch(wexp, Cin, mn * MC, min(MC, mid - mn * MC), kn * KC,
                     min(KC, Cin - kn * KC));
        }
        const T* planes = stream ? xs + (s & 1) * KC * G::PLANE : xs + kc * KC * G::PLANE;
        eacc.gemm(planes, wb, min(KC, Cin - kc * KC));
        __syncthreads();
      }
      eacc.finish(es, bexp, c0, width, h0, w0, H, W);
      dsrc = es;
    } else {
      if (stream) {
        if (mc + 1 < nmc) {
          load_step(mc + 1);
          wait_group<1>();
        } else {
          wait_group<0>();
        }
        dsrc = xs + (mc & 1) * KC * G::PLANE;
      } else {
        if (mc == mc0 && nxc == 2)
          wait_group<1>();
        else
          wait_group<0>();
        dsrc = xs + c0 * G::PLANE;
      }
    }
    __syncthreads();

    // the depthwise of channel c0 + ch, columns j0..
    if constexpr (PASS == 1) {
      float sum = 0.f;
      if (active) {
        const int rows = H - h0 - r0, cols = W - w0 - j0;
        depthwise<BF16, TWD>(dsrc + ch * G::PLANE + r0 * K::RS, k9, kb, j0,
                        [&](int o, const float (&v)[Geo<BF16>::VW]) {
          if (o < rows) {
#pragma unroll
            for (int e = 0; e < G::VW; ++e)
              if (e < cols) sum += v[e];
          }
        });
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (active && (threadIdx.x & 7) == 0)
        partial[((size_t)n * gridDim.x + tile) * mid + c0 + ch] = sum;
      __syncthreads();
    } else {
      T* yrow = ys + ch * G::LDY + r0 * K::TW + j0;
      if (active && !skips(SKIP_DEPTHWISE)) {
        depthwise<BF16, TWD>(dsrc + ch * G::PLANE + r0 * K::RS, k9, kb, j0,
                        [&](int o, const float (&v)[Geo<BF16>::VW]) {
          if constexpr (BF16)
            *reinterpret_cast<uint4*>(yrow + o * K::TW) = make_uint4(
                pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
          else
            *reinterpret_cast<float4*>(yrow + o * K::TW) = make_float4(v[0], v[1], v[2], v[3]);
        });
      } else {                       // zero K rows of a short last chunk
#pragma unroll
        for (int o = 0; o < K::RT; ++o) {
          if constexpr (BF16)
            *reinterpret_cast<uint4*>(yrow + o * K::TW) = make_uint4(0, 0, 0, 0);
          else
            *reinterpret_cast<float4*>(yrow + o * K::TW) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      preg.store(as);
      __syncthreads();
      if (!skips(SKIP_GEMM)) pacc.gemm(as, ys, width, ctw);
      if (mc + 1 < nmc) __syncthreads();   // the next chunk rewrites ys and as
    }
  }

  if constexpr (PASS == 2 && !skips(SKIP_STORES)) {
    // bias [+ residual: from the resident input planes, else from x] and
    // one cast on the way out, 16-byte row stores: fp32 straight from the
    // accumulators (4 pixels of a row a thread), bf16 through shared memory
    // in fp32 (8 pixels of a row a thread); element-wise stores where the
    // rows are not 16-byte runs
    auto finish = [&](int co, int r, int c, const float* v) {
      const int hh = h0 + r, ww = w0 + c;
      if (co >= ctw || hh >= H || ww >= W) return;
      float o[G::VW];
      const float bias = bproj[co0 + co];
#pragma unroll
      for (int e = 0; e < G::VW; ++e) o[e] = v[e] + bias;
      const T* xr = stream ? x + (((size_t)n * Cin + co0 + co) * H + hh) * W + ww
                           : xs + (co0 + co) * G::PLANE + (r + 1) * K::RS + G::A + c;
      T* dst = out + (((size_t)n * Cout + co0 + co) * H + hh) * W + ww;
      if constexpr (VEC) {               // a whole run inside the image, aligned
        if (residual) {
          if constexpr (BF16) {
            const uint4 xv = *reinterpret_cast<const uint4*>(xr);
            const uint32_t w4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              o[2 * q] += lo_f(w4[q]);
              o[2 * q + 1] += hi_f(w4[q]);
            }
          } else {
            const float4 xv = *reinterpret_cast<const float4*>(xr);
            o[0] += xv.x, o[1] += xv.y, o[2] += xv.z, o[3] += xv.w;
          }
        }
        if constexpr (BF16)
          *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                                                      pack2(o[4], o[5]), pack2(o[6], o[7]));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < G::VW; ++e)
          if (ww + e < W) dst[e] = from_f<T>(residual ? o[e] + to_f(xr[e]) : o[e]);
      }
    };
    if constexpr (BF16) {
      float* os = reinterpret_cast<float*>(smem + L.os);
      pacc.stage(os);
      __syncthreads();
      constexpr int VPR = K::VPR;
      for (int i = threadIdx.x; i < ctw * K::TH * VPR; i += NT) {
        const int v = i % VPR, rest = i / VPR, r = rest % K::TH, co = rest / K::TH;
        finish(co, r, v * G::VW, os + co * LDO + r * K::TW + v * G::VW);
      }
    } else {
      pacc.store([&](int co, int p, const float (&v)[4]) {
        finish(co, p / K::TW, p % K::TW, v);
      });
    }
  }
}

// ---- pass 1 without an expand: a row-streaming kernel ---------------------
// The depthwise reads x itself, so the block's staged tile buys nothing:
// csrc/row_stream.cuh's loop (csrc/depthwise.cu's), with a sum in place of
// the store.  A warp takes a work item (plane, strip of SH output rows, run
// of 32 lanes x 16 bytes of columns) and sums the fp32 SiLU output of its
// columns inside the image, in the rows of the counted window (a band's own
// rows of a haloed band under spatial partitioning); then the warp's sum goes to
// partial[n][strip, run][c] by shuffles in a fixed order.  Element-wise
// loads where W is not a multiple of 16 bytes or x starts misaligned.
constexpr int SH = 16;               // output rows a strip
constexpr int SPF = 8;               // rows in flight a warp
constexpr int SWPB = NT / 32;        // warps (work items in flight) a block
constexpr int MAX_BLOCKS = 1 << 30;

template <bool BF16>
constexpr int RUN = rowstream::Lane<typename Geo<BF16>::T>::RUN;   // columns a warp run

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(NT)
mbconv_pass1_stream_kernel(const typename Geo<BF16>::T* __restrict__ x,
                           const typename Geo<BF16>::T* __restrict__ wdw,
                           const float* __restrict__ bdw, float* __restrict__ partial,
                           long long items, int C, int H, int W, int runs, int strips,
                           int row_lo, int row_hi) {
  using T = typename Geo<BF16>::T;
  using Row = rowstream::Row<T>;
  constexpr int VW = Geo<BF16>::VW;
  __shared__ uint4 stages[VEC ? SWPB * SPF * 32 : 1];
  const int lane = threadIdx.x & 31;
  uint4* stage = stages + (VEC ? (threadIdx.x / 32) * SPF * 32 + lane : 0);
  for (long long item = (long long)blockIdx.x * SWPB + threadIdx.x / 32; item < items;
       item += (long long)gridDim.x * SWPB) {
    const int run = (int)(item % runs);
    const long long rest = item / runs;
    const int strip = (int)(rest % strips);
    const long long plane = rest / strips;
    const int c = (int)(plane % C);
    float k[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = to_f(wdw[(size_t)c * 9 + j]);
    const float bias = bdw[c];
    const int h0 = strip * SH, run0 = run * RUN<BF16>;
    const int cols = W - run0 - lane * VW;    // the lane's columns inside the image
    float sum = 0.f;
    rowstream::stream_strip<T, SPF, VEC, true>(
        x + (size_t)plane * H * W, min(SH, H - h0), h0 - 1, H, W, run0, lane, stage,
        [&](int r, const Row& ra, const Row& rb, const Row& rc) {
          if (h0 + r < row_lo || h0 + r >= row_hi) return;   // a row not counted
          float acc[VW];
#pragma unroll
          for (int j = 0; j < VW; ++j) acc[j] = bias;
          rowstream::taps3(ra, k[0], k[1], k[2], acc);
          rowstream::taps3(rb, k[3], k[4], k[5], acc);
          rowstream::taps3(rc, k[6], k[7], k[8], acc);
#pragma unroll
          for (int j = 0; j < VW; ++j)
            if (j < cols) sum += silu(acc[j]);
        });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(rowstream::FULL, sum, off);
    const long long n = plane / C;
    if (lane == 0) partial[((size_t)n * strips * runs + (size_t)strip * runs + run) * C + c] = sum;
  }
}

template <bool BF16>
int stream_tiles(int H, int W) {
  return ((H + SH - 1) / SH) * ((W + RUN<BF16> - 1) / RUN<BF16>);
}

template <bool BF16>
int launch_pass1_stream(const void* x, const void* wdw, const void* bdw, void* partial, int N,
                        int C, int H, int W, int row_lo, int row_hi, cudaStream_t s) {
  using T = typename Geo<BF16>::T;
  const bool vec = W % Geo<BF16>::VW == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int runs = (W + RUN<BF16> - 1) / RUN<BF16>, strips = (H + SH - 1) / SH;
  const long long items = (long long)N * C * strips * runs;
  const long long want = (items + SWPB - 1) / SWPB;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  auto kernel = vec ? mbconv_pass1_stream_kernel<BF16, true>
                    : mbconv_pass1_stream_kernel<BF16, false>;
  kernel<<<blocks, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(wdw),
                               static_cast<const float*>(bdw), static_cast<float*>(partial),
                               items, C, H, W, runs, strips, row_lo, row_hi);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int TWD>
int tiles_w_of(int W) {
  return (W + TWD - 1) / TWD;
}

template <bool BF16, int TWD>
int tiles_of(int H, int W) {
  return ((H + Tile<BF16, TWD>::TH - 1) / Tile<BF16, TWD>::TH) * tiles_w_of<BF16, TWD>(W);
}

// The tiled kernels' tiles of an H x W map.
template <bool BF16>
int tiles_of(int H, int W) {
  if constexpr (BF16)
    if (tile_w<BF16>(W) == 64) return tiles_of<BF16, 64>(H, W);
  return tiles_of<BF16, 32>(H, W);
}

template <bool BF16, int TWD, bool EXPAND, int PASS, bool VEC, int CT>
int launch(const void* x, const void* wexp, const void* bexp, const void* wdw, const void* bdw,
           const void* wpp, const void* bproj, void* out, void* partial, int N, int Cin,
           int mid, int Cout, int H, int W, int residual, cudaStream_t s) {
  using T = typename Geo<BF16>::T;
  const Layout<BF16, CT> L(Cin, EXPAND, PASS);
  auto kernel = mbconv_nchw_kernel<BF16, TWD, EXPAND, PASS, VEC, CT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 1: mid split into as many groups of chunks as bring the grid to
  // two blocks an SM
  const int tiles = tiles_of<BF16, TWD>(H, W), nmc = (mid + MC - 1) / MC;
  int groups = 1;
  if (PASS == 1) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    const long long blocks = (long long)tiles * N;
    groups = (int)min((long long)nmc, max(1LL, (2LL * sms + blocks - 1) / blocks));
  }
  const int mcpb = (nmc + groups - 1) / groups;
  const dim3 grid(tiles, PASS == 2 ? (Cout + CT - 1) / CT : (nmc + mcpb - 1) / mcpb, N);
  kernel<<<grid, NT, L.bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wexp), static_cast<const float*>(bexp),
      static_cast<const T*>(wdw), static_cast<const float*>(bdw), static_cast<const T*>(wpp),
      static_cast<const float*>(bproj), static_cast<T*>(out), static_cast<float*>(partial),
      Cin, mid, Cout, H, W, residual, tiles_w_of<BF16, TWD>(W), mcpb);
  return static_cast<int>(cudaGetLastError());
}

#define MBCONV_ARGS \
  x, wexp, bexp, wdw, bdw, wpp, bproj, out, partial, N, Cin, mid, Cout, H, W, residual, s
#define MBCONV_PARAMS                                                                        \
  const void *x, const void *wexp, const void *bexp, const void *wdw, const void *bdw,       \
      const void *wpp, const void *bproj, void *out, void *partial, int N, int Cin, int mid, \
      int Cout, int H, int W, int residual, cudaStream_t s

template <bool BF16, bool EXPAND, int PASS, int CT>
int launch_vec(bool vec, MBCONV_PARAMS) {
  if constexpr (BF16)
    if (tile_w<BF16>(W) == 64)
      return vec ? launch<BF16, 64, EXPAND, PASS, true, CT>(MBCONV_ARGS)
                 : launch<BF16, 64, EXPAND, PASS, false, CT>(MBCONV_ARGS);
  return vec ? launch<BF16, 32, EXPAND, PASS, true, CT>(MBCONV_ARGS)
             : launch<BF16, 32, EXPAND, PASS, false, CT>(MBCONV_ARGS);
}

template <bool BF16, bool EXPAND>
int launch_ct(bool vec, MBCONV_PARAMS) {
  return Cout <= 32 ? launch_vec<BF16, EXPAND, 2, 32>(vec, MBCONV_ARGS)
                    : launch_vec<BF16, EXPAND, 2, 64>(vec, MBCONV_ARGS);
}

// The instantiation for the shape: 16-byte copies where W is a multiple of
// 16 bytes and x (and out) start 16-byte aligned, else element-wise; pass 2
// in blocks of 32 output channels where Cout <= 32, else 64.
template <bool BF16, int PASS>
int dispatch(MBCONV_PARAMS) {
  if (N < 1 || N > 65535 || Cin < 1 || mid < 1 || H < 1 || W < 1 ||
      (PASS == 2 && Cout < 1) || (!wexp && mid != Cin) || (residual && Cout != Cin))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = W % Geo<BF16>::VW == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if constexpr (PASS == 1)        // with an expand (mbconv_pass1 streams the rest)
    return launch_vec<BF16, true, 1, 32>(vec, MBCONV_ARGS);
  else
    return wexp ? launch_ct<BF16, true>(vec, MBCONV_ARGS)
                : launch_ct<BF16, false>(vec, MBCONV_ARGS);
}
#undef MBCONV_PARAMS
#undef MBCONV_ARGS

}  // namespace

// Tiles of an H x W map: the middle axis of pass 1's partial sums (the
// row-streaming kernel's strips and runs where there is no expand).
extern "C" int mbconv_nchw_tiles(int H, int W, int expand, int is_bf16) {
  if (!expand) return is_bf16 ? stream_tiles<true>(H, W) : stream_tiles<false>(H, W);
  return is_bf16 ? tiles_of<true>(H, W) : tiles_of<false>(H, W);
}

// x [N,Cin,H,W]; wexp [mid,Cin] or NULL (no expand: mid == Cin); bexp [mid]
// fp32; wdw [mid,3,3]; bdw [mid] fp32; partial [N, tiles, mid] fp32 with
// tiles = mbconv_nchw_tiles(H, W, wexp != NULL, is_bf16).  T is bf16 when
// is_bf16, else fp32.  Only output rows [row_lo, row_hi) are summed
// (0 <= row_lo <= row_hi <= H): any window without an expand (the
// row-streaming kernel), only 0, H with one (the tiled kernel).
extern "C" int mbconv_pass1(const void* x, const void* wexp, const void* bexp,
                            const void* wdw, const void* bdw, void* partial, int N, int Cin,
                            int mid, int H, int W, int row_lo, int row_hi, int is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_lo < 0 || row_lo > row_hi || row_hi > H || (wexp && (row_lo != 0 || row_hi != H)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!wexp) {
    if (N < 1 || Cin < 1 || H < 1 || W < 1 || mid != Cin)
      return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16
               ? launch_pass1_stream<true>(x, wdw, bdw, partial, N, Cin, H, W, row_lo, row_hi, s)
               : launch_pass1_stream<false>(x, wdw, bdw, partial, N, Cin, H, W, row_lo, row_hi,
                                            s);
  }
  if (is_bf16)
    return dispatch<true, 1>(x, wexp, bexp, wdw, bdw, nullptr, nullptr, nullptr, partial, N,
                             Cin, mid, 0, H, W, 0, s);
  return dispatch<false, 1>(x, wexp, bexp, wdw, bdw, nullptr, nullptr, nullptr, partial, N,
                            Cin, mid, 0, H, W, 0, s);
}

// wpp [N,mid,Cout] (per-image SE-gated projection); bproj [Cout] fp32;
// out [N,Cout,H,W].  residual adds x (needs Cin == Cout).
extern "C" int mbconv_pass2(const void* x, const void* wexp, const void* bexp,
                            const void* wdw, const void* bdw, const void* wpp,
                            const void* bproj, void* out, int N, int Cin, int mid, int Cout,
                            int H, int W, int residual, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true, 2>(x, wexp, bexp, wdw, bdw, wpp, bproj, out, nullptr, N, Cin, mid,
                             Cout, H, W, residual, s);
  return dispatch<false, 2>(x, wexp, bexp, wdw, bdw, wpp, bproj, out, nullptr, N, Cin, mid,
                            Cout, H, W, residual, s);
}
