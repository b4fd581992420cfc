// Depthwise 3x3 kernels on NCHW tensors, bias and SiLU fused: row-streaming
// kernels for Hopper.
//
// dw3x3_bias_silu replaces the Pallas kernels of
// benchmarks/pallas_dw_variants.py::main (v1_kernel, v3_kernel, v4_kernel;
// v2 runs v1's program).  The four TPU variants differ only in how they
// shift the taps into place on the TPU's lanes; each computes
//   out = bf16(SiLU(depthwise 3x3 SAME, zero-padded, of x + fp32 bias)).
// Here the nine products and their sum are fp32 (the TPU kernels round the
// products and partial sums to bf16).
//
// dw_rows_silu replaces _dw_only_kernel of
// benchmarks/pallas_mbconv_instr.py::main, a probe that is deliberately not
// a true convolution.  For output row h in row slab s = h / bh, h0 = s*bh,
// lo = max(h0 - 1, 0), tap row u reads input row lo + u + (h - h0), or
// H - bh + (h - h0) when lo + u + bh > H; the three v taps of a row read the
// same column (no column shift).  out = bf16(SiLU(sum_u sum_v x[row_u] *
// w[u][v] + bias)), fp32 sums.
//
// What bounds them on the H100: bytes.  Each does about 23 operations per
// element on 4 bytes moved in bf16 (x read once, the output written once),
// against the card's bf16 ridge of about 295 operations per byte: at
// [16,24,256,256] 100.7 MB, 30 us at 3.35 TB/s.  The design streams rows
// (the loop is csrc/row_stream.cuh's, shared with csrc/mbconv.cu):
// - One warp takes one run of 256 columns (32 lanes x 8 consecutive
//   columns) of one channel plane down a strip of SH output rows.  A lane
//   moves its 8 columns of a row as one 16-byte vector in and one out, so a
//   warp instruction moves 512 contiguous bytes.
// - The lane keeps a window of three input rows in registers as fp32 (8
//   values each, plus the two column neighbours for dw3x3) and slides it
//   down one row per output row: each input row of the strip is read from
//   device memory once, plus two halo rows a strip.
// - The +-1 column neighbours come from the adjacent lanes by
//   __shfl_up_sync / __shfl_down_sync.  The run's two end lanes read one
//   value each from device memory (the neighbouring run's edge), or take
//   zero at the image's edge.
// - Bytes in flight: each warp keeps the next PF rows in flight in a ring of
//   16-byte-a-lane stages in shared memory, filled by cp.async (one commit
//   group a row, zero-filled outside the image) and read back by the lane
//   that copied it (no barrier), so the rows in flight cost no registers
//   (but dw3x3's edge values) and arrive under the arithmetic: PF x 512
//   bytes a warp.  (Held in registers instead, the rows in flight would
//   compete with the window for a thread's registers.)  The row loop is
//   unrolled over lcm(3, PF) rows, so the window and the ring rotate by
//   renaming, not by moves.
// - 16 rows a strip, 256 threads a block, 8 rows in flight: the fastest
//   of the settings that benchmarks/dw_sweep.py times at [16,24,256,256]
//   (4 rows in flight tie for dw3x3).  There dw3x3 runs two 256-thread
//   blocks an SM (its registers), 2,112 resident warps on 132 SMs:
//   16-row strips make 6,144 work items, 32-row strips 3,072 (about 1.5
//   waves) and 64-row strips 1,536 (a part-filled wave), so longer strips
//   lose more to the tail than they save in halo rows (16-row strips read
//   12.5% more input rows, 6% more bytes).
// - The SiLU on the fast path: ex2.approx and rcp.approx (denormals flushed,
//   below bf16's resolution of the output).
// - dw_rows_silu runs the same loop.  Within a slab the probe's three tap
//   rows advance one row per output row, and they always lie among the
//   three consecutive rows lo + (h - h0) + {0, 1, 2}: so a strip (cut
//   inside one slab) slides the same window, and the taps that read the
//   same window row (all three v taps, and the tap rows the clamp sends to
//   one row) have their weights summed in fp32 once per strip: three FMAs
//   an output.  The slab edges read exactly the probe's rows.
// Sums run on CUDA cores; tensor cores and TMA are not used.  Rows whose
// width is not a multiple of 8, or tensors whose start is not 16-byte
// aligned, take the same loop with 2-byte loads and stores and the rows in
// flight in registers (a second instantiation, chosen by shape and
// alignment alone).  Work items (plane, strip, run) are spread over a
// one-dimensional grid, looped where there are more than the grid holds,
// so any number of planes is taken.
// bf16 only, as the TPU kernels.  Plain C interface (no PyTorch headers),
// loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_stream.cuh"

namespace {

constexpr int NT = 256;             // threads per block
constexpr int WPB = NT / 32;        // warps (work items in flight) per block
constexpr int SH = 16;              // output rows per strip
constexpr int PF = 8;               // rows in flight ahead of the arithmetic
constexpr int MAX_BLOCKS = 1 << 30;

using bf16 = __nv_bfloat16;
using rowstream::Row;
using Lane = rowstream::Lane<uint16_t>;
constexpr int VEC = Lane::VW;       // columns per lane: one 16-byte vector
constexpr int RUN = Lane::RUN;      // columns per warp run

// One output row of the lane's 8 columns from the window rows a, b, c,
// SiLU, one cast to bf16, stored at op (the output row).
template <bool kRows, bool kVec>
__device__ __forceinline__ void emit(const Row<uint16_t>& a, const Row<uint16_t>& b,
                                     const Row<uint16_t>& c, const float (&k)[9], float bias,
                                     bf16* __restrict__ op, int col, int W) {
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = bias;
  if (kRows) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[j] = fmaf(a.v[j], k[0], acc[j]);
      acc[j] = fmaf(b.v[j], k[1], acc[j]);
      acc[j] = fmaf(c.v[j], k[2], acc[j]);
    }
  } else {
    rowstream::taps3(a, k[0], k[1], k[2], acc);
    rowstream::taps3(b, k[3], k[4], k[5], acc);
    rowstream::taps3(c, k[6], k[7], k[8], acc);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = mbconv::silu(acc[j]);
  if (kVec) {
    if (col < W)
      __stcs(reinterpret_cast<uint4*>(op + col),
             make_uint4(mbconv::pack2(acc[0], acc[1]), mbconv::pack2(acc[2], acc[3]),
                        mbconv::pack2(acc[4], acc[5]), mbconv::pack2(acc[6], acc[7])));
  } else {
#pragma unroll
    for (int k2 = 0; k2 < VEC; ++k2)
      if (col + k2 < W) op[col + k2] = __float2bfloat16_rn(acc[k2]);
  }
}

// grid: blocks of WPB warps, one work item (plane, strip, run) a warp,
// looped past the grid.  dw3x3: strips of SH rows over the whole plane.
// dw_rows (kRows): each slab of bh rows cut into strips of SH rows.
// kVec: each warp's ring of PF row stages in shared memory.
template <bool kRows, bool kVec>
__global__ void __launch_bounds__(NT)
dw_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ out, long long items,
                 int C, int H, int W, int bh, int runs, int strips, int slab_strips) {
  __shared__ uint4 stages[kVec ? WPB * PF * 32 : 1];
  const int lane = threadIdx.x & 31;
  uint4* stage = stages + (kVec ? (threadIdx.x / 32) * PF * 32 + lane : 0);
  for (long long item = (long long)blockIdx.x * WPB + threadIdx.x / 32; item < items;
       item += (long long)gridDim.x * WPB) {
    const int run = (int)(item % runs);
    const long long rest = item / runs;
    const int strip = (int)(rest % strips);
    const long long plane = rest / strips;
    const int c = (int)(plane % C);
    float k[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = __bfloat162float(w[(size_t)c * 9 + j]);
    const float bias = b[c];
    int h0, rows, ws;
    if (kRows) {
      // the probe's tap rows in slab s: base_u = lo + u, or H - bh where
      // lo + u + bh > H; each is lo + d_u with d_u in {0, 1, 2}, a row of the
      // window that starts at lo + (h - s*bh)
      const int s = strip / slab_strips;
      const int s0 = s * bh;
      h0 = s0 + (strip % slab_strips) * SH;
      rows = min(SH, s0 + bh - h0);
      const int lo = s0 > 0 ? s0 - 1 : 0;
      ws = lo + (h0 - s0);
      float kr[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int d = (lo + u + bh <= H ? lo + u : H - bh) - lo;
        const float ku = k[3 * u] + k[3 * u + 1] + k[3 * u + 2];
        kr[0] += d == 0 ? ku : 0.f;
        kr[1] += d == 1 ? ku : 0.f;
        kr[2] += d == 2 ? ku : 0.f;
      }
      k[0] = kr[0];
      k[1] = kr[1];
      k[2] = kr[2];
    } else {
      h0 = strip * SH;
      rows = min(SH, H - h0);
      ws = h0 - 1;
    }
    const size_t base = (size_t)plane * H * W;
    const int run0 = run * RUN, col = run0 + lane * VEC;
    bf16* op = out + base + (size_t)h0 * W;
    rowstream::stream_strip<uint16_t, PF, kVec, !kRows>(
        reinterpret_cast<const uint16_t*>(x) + base, rows, ws, H, W, run0, lane, stage,
        [&](int r, const Row<uint16_t>& ra, const Row<uint16_t>& rb, const Row<uint16_t>& rc) {
          emit<kRows, kVec>(ra, rb, rc, k, bias, op + (size_t)r * W, col, W);
        });
  }
}

template <bool kRows>
int launch(const void* x, const void* w, const void* b, void* out, int N, int C, int H,
           int W, int bh, void* stream) {
  const bool vec = W % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int runs = (W + RUN - 1) / RUN;
  const int slab_strips = kRows ? (bh + SH - 1) / SH : 1;
  const int strips = kRows ? (H / bh) * slab_strips : (H + SH - 1) / SH;
  const long long items = (long long)N * C * strips * runs;
  const long long want = (items + WPB - 1) / WPB;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  auto kernel = vec ? dw_stream_kernel<kRows, true> : dw_stream_kernel<kRows, false>;
  kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), items, C, H, W, bh, runs,
      strips, slab_strips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [N,C,H,W] bf16; w [C,3,3] bf16; b [C] fp32.  N*C and H*W must fit
// in an int.
extern "C" int dw3x3_bias_silu(const void* x, const void* w, const void* b,
                               void* out, int N, int C, int H, int W, void* stream) {
  return launch<false>(x, w, b, out, N, C, H, W, 1, stream);
}

// As dw3x3_bias_silu, with the row map of the probe; bh divides H.
extern "C" int dw_rows_silu(const void* x, const void* w, const void* b,
                            void* out, int N, int C, int H, int W, int bh,
                            void* stream) {
  return launch<true>(x, w, b, out, N, C, H, W, bh, stream);
}

// ---------------------------------------------------------------------------
// dw_dilated_bn_silu_nhwc: out = SiLU(depthwise k x k (k 3 or 5), stride 1,
// dilation d, zero padding d * (k / 2), of x with BN folded into the weights,
// + fp32 shift), one cast, on NHWC memory (channels_last tensors).  It serves
// the eval-mode dilated MBConv blocks of an EfficientNet at output stride 16
// (the DeepLab encoder's stages 5-6), where cuDNN's grouped direct kernel ran
// about 50 times off the bytes bound below, between NHWC<->NCHW transforms.
// It replaces no Pallas kernel: the JAX package leaves these convs to XLA.
//
// What bounds it on the H100: bytes.  k5 does 50 operations an element on 4
// bytes moved in bf16 (x read once, the output written once), against the
// card's fp32 CUDA-core ridge of about 20 operations a byte: at a tiled
// request's 30 launches 8.77 GB, 2.62 ms at 3.35 TB/s.  The design keeps
// every input element to one read from device memory and every output
// element to one write:
// - A block takes one image, a group of GROUP_BYTES of channels (32 bf16 or
//   16 fp32) and a band of BH output rows by BW columns (the whole width of
//   the serving maps, 24-40).  It copies its input rows plus a halo of
//   d * (k / 2) rows and columns into shared memory by 16-byte cp.async, the
//   copies outside the image zero-filled: so the padding costs no device
//   memory, and a map smaller than its halo (3 x 3 at d 2, k 5) works.  The
//   band height fills a shared-memory budget (SMEM), balanced over the map.
//   Bands are the fastest grid index, so the bands of one channel group run
//   together and their shared halo rows come from L2.
// - Its weights, [k, k, C] in the compute dtype, are widened to fp32 in
//   shared memory once a block; the shift is fp32.
// - A thread takes V = 4 channels (8 bytes of bf16, 16 of fp32) of a run of
//   TR outputs of one row that lie d columns apart: with dilation d the taps
//   of such a run read every d-th column, so its k column taps of a tap row
//   share TR + k - 1 loads from shared memory (reused from registers), not
//   TR * k.  Neighbouring threads take neighbouring channels, so a
//   half-warp's loads are 128 contiguous bytes of shared memory (no bank
//   conflict) and the stores coalesce.  TR (4, 5, 6 or 8) is picked by the
//   host from the band's width (run_cost).
// - fp32 sums on CUDA cores; the epilogue adds the shift, takes the fast
//   SiLU and casts once.
// A block loads, waits and then computes, so the load of one block hides
// behind the arithmetic of others: the three constants are set for three
// blocks an SM (at most 85 registers a thread, 72 KB of shared memory each).
// With 8 bf16 channels a thread, k5 needed 138 registers (one block an SM)
// and a request's 30 launches took 7.31 ms; with 4, 5.59 ms (2.14 times the
// bound on an H100), the fastest of seven settings of the three constants
// (group bytes 32-128, 48-96 KB, 2-4 blocks an SM).
// Channel counts that are not a multiple of 16 bytes and tensors that do
// not start 16-byte aligned take the same tiles with element-wise copies and
// V = 1 (a second instantiation, chosen by shape and alignment alone).
//
// dw3x3_bias_gelu_nhwc runs the same body at k 3, dilation 1, with the
// conv's bias as the shift and exact-erf GELU as the epilogue: SegFormer's
// Mix-FFN depthwise (models/segformer.py), at 4x the block's width (256 to
// 2048 channels) on maps of 12 to 160 columns.  Its kernel has a name of
// its own (dw3x3_gelu_nhwc_kernel), so a trace tells the two apart; the
// SiLU instances are the same code as before the epilogue became a
// template parameter.
namespace {

constexpr int DD_NT = 256;          // threads a block
constexpr int GROUP_BYTES = 64;     // bytes of channels a block takes at a pixel
constexpr int SMEM = 72 * 1024;     // a block's budget of shared memory
constexpr int MIN_BLOCKS = 3;       // blocks an SM the registers must allow

__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ void narrow(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }

// V values of T at p as fp32 (one 8- or 16-byte load where V > 1).
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&f)[V]) {
  if constexpr (V > 1) {
    constexpr int WORDS = V * (int)sizeof(T) / 4;
    uint32_t q[WORDS];
    if constexpr (WORDS == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      q[0] = u.x, q[1] = u.y, q[2] = u.z, q[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      q[0] = u.x, q[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[2 * i] = mbconv::lo_f(q[i]);
        f[2 * i + 1] = mbconv::hi_f(q[i]);
      } else {
        f[i] = __uint_as_float(q[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = widen(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&f)[V]) {
  if constexpr (V > 1 && sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(mbconv::pack2(f[0], f[1]), mbconv::pack2(f[2], f[3]));
  } else if constexpr (V > 1) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                              __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) narrow(p + i, f[i]);
  }
}

// The epilogues, applied to the sum plus the shift before the one cast.
struct Silu {                       // the dilated MBConv blocks' (fast SiLU)
  static __device__ __forceinline__ float apply(float v) { return mbconv::silu(v); }
};
struct GeluErf {                    // the Mix-FFN's exact-erf GELU
  static __device__ __forceinline__ float apply(float v) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  }
};

// grid: x the (row band, column band) pairs, bands fastest; y the channel
// groups; z the images.  Shared memory: the fp32 weights [k * k][GC], then
// the tile [TH][TWS][GC] of T.  T: uint16_t (bf16 bits) or float; V 4 or 1.
// Epi: the epilogue.  The body of both kernels below, which differ only in
// it (and in their names, which a trace reads).
template <typename T, int K, int V, int TR, typename Epi>
__device__ __forceinline__ void dw_nhwc_body(const T* __restrict__ x, const T* __restrict__ w,
                                             const float* __restrict__ shift,
                                             T* __restrict__ out, int H, int W, int C, int d,
                                             int BH, int BW, int col_bands, int runs,
                                             int TWS) {
  constexpr int GC = GROUP_BYTES / (int)sizeof(T);  // channels a block
  constexpr int GT = GC / V;                        // threads a pixel
  static_assert(V == 4 || V == 1, "4 channels a thread, or 1 on the element-wise path");
  extern __shared__ uint4 dd_smem[];
  float* ws = reinterpret_cast<float*>(dd_smem);
  T* tile = reinterpret_cast<T*>(ws + K * K * GC);
  const int pad = d * (K / 2);
  const int TH = BH + 2 * pad;
  const int h0 = (blockIdx.x / col_bands) * BH, w0 = (blockIdx.x % col_bands) * BW;
  const int c0 = blockIdx.y * GC;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const T* xn = x + img;

  for (int i = threadIdx.x; i < K * K * GC; i += DD_NT) {
    const int tap = i / GC, c = c0 + i % GC;
    ws[i] = c < C ? widen(w[(size_t)tap * C + c]) : 0.f;
  }
  // the tile: image rows h0 - pad ..., columns w0 - pad ..., zero outside
  if constexpr (V > 1) {
    constexpr int LV = 16 / (int)sizeof(T);         // channels a 16-byte copy
    constexpr int LT = GC / LV;                     // copies a pixel
    const int total = TH * TWS * LT;
    for (int i = threadIdx.x; i < total; i += DD_NT) {
      const int t = i % LT, pix = i / LT;
      const int gy = h0 - pad + pix / TWS, gx = w0 - pad + pix % TWS, c = c0 + t * LV;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      const T* src = in ? xn + ((size_t)gy * W + gx) * C + c : x;
      mbconv::cp_async16(mbconv::smem_u32(tile + (size_t)pix * GC + t * LV), src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    const int total = TH * TWS * GC;
    for (int i = threadIdx.x; i < total; i += DD_NT) {
      const int cc = i % GC, pix = i / GC;
      const int gy = h0 - pad + pix / TWS, gx = w0 - pad + pix % TWS, c = c0 + cc;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      tile[i] = in ? xn[((size_t)gy * W + gx) * C + c] : T(0);
    }
  }
  __syncthreads();

  // item: (band row, parity r, run q, channel vector t), t fastest; outputs
  // at band columns r + d * (q * TR + j), j < TR; input m of a tap row at
  // tile column r + d * (q * TR + m), m < TR + K - 1 (< TWS by the host)
  const int items = BH * d * runs * GT;
  for (int it = threadIdx.x; it < items; it += DD_NT) {
    const int t = it % GT;
    int rest = it / GT;
    const int q = rest % runs;
    rest /= runs;
    const int r = rest % d, yb = rest / d;
    const int xb0 = r + d * q * TR, c = c0 + t * V;
    if (h0 + yb >= H || xb0 >= BW || w0 + xb0 >= W || c >= C) continue;
    float acc[TR][V];
#pragma unroll
    for (int j = 0; j < TR; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      float wk[K][V];
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const float* src = ws + (ky * K + kx) * GC + t * V;
        if constexpr (V == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(src);
          wk[kx][0] = v4.x, wk[kx][1] = v4.y, wk[kx][2] = v4.z, wk[kx][3] = v4.w;
        } else {
          wk[kx][0] = src[0];
        }
      }
      const T* row = tile + ((size_t)(yb + ky * d) * TWS + r + d * q * TR) * GC + t * V;
#pragma unroll
      for (int m = 0; m < TR + K - 1; ++m) {
        float v[V];
        load_f<T, V>(row + (size_t)m * d * GC, v);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const int j = m - kx;
          if (j >= 0 && j < TR) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[j][i] = fmaf(v[i], wk[kx][i], acc[j][i]);
          }
        }
      }
    }
    float sh[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sh[i] = shift[c + i];
    T* op = out + img + ((size_t)(h0 + yb) * W + w0 + xb0) * C + c;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      if (xb0 + d * j >= BW || w0 + xb0 + d * j >= W) break;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = Epi::apply(acc[j][i] + sh[i]);
      store_f<T, V>(op + (size_t)j * d * C, o);
    }
  }
}

// The dilated MBConv blocks: k 3 or 5, any dilation, SiLU.
template <typename T, int K, int V, int TR>
__global__ void __launch_bounds__(DD_NT, MIN_BLOCKS)
dw_dilated_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ shift, T* __restrict__ out, int H, int W,
                       int C, int d, int BH, int BW, int col_bands, int runs, int TWS) {
  dw_nhwc_body<T, K, V, TR, Silu>(x, w, shift, out, H, W, C, d, BH, BW, col_bands, runs, TWS);
}

// The Mix-FFN's depthwise: k 3, dilation 1, the conv's bias as the shift,
// exact-erf GELU.
template <typename T, int V, int TR>
__global__ void __launch_bounds__(DD_NT, MIN_BLOCKS)
dw3x3_gelu_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ shift, T* __restrict__ out, int H, int W,
                       int C, int d, int BH, int BW, int col_bands, int runs, int TWS) {
  dw_nhwc_body<T, 3, V, TR, GeluErf>(x, w, shift, out, H, W, C, d, BH, BW, col_bands, runs,
                                     TWS);
}

// Instructions a channel vector of a band row costs at run length tr: the
// runs, each of k tap rows of tr + k - 1 loads (each widened) and tr * k
// FMAs a channel, plus its k weight loads.
long long run_cost(int p, int tr, int k, int v) {
  const long long runs = (p + tr - 1) / tr;
  return runs * ((long long)(tr + k - 1) * (1 + v) + k * ((v + 3) / 4) + (long long)tr * k * v);
}

// A launch's geometry: band width bw, run length tr, runs a parity, the
// tile's width tws and its rows bh (0 where a band of one row does not fit).
struct Plan {
  int bw, tr, runs, tws, bh;
};

Plan plan(int H, int W, int k, int d, int v, int elem_bytes, bool vec) {
  const int gc = GROUP_BYTES / elem_bytes;
  const int pad = d * (k / 2);
  // the serving maps (24-40 columns) take their whole width, wider maps
  // bands of 32 columns, fewer where the tile would not fit
  Plan pl{W <= 48 ? W : 32, 4, 0, 0, 0};
  for (;; pl.bw = (pl.bw + 1) / 2) {
    const int p = (pl.bw + d - 1) / d;
    pl.tr = 4;
    const int lengths[] = {8, 6, 5};
    if (vec)
      for (int tr : lengths)
        if (run_cost(p, tr, k, v) < run_cost(p, pl.tr, k, v)) pl.tr = tr;
    pl.runs = (p + pl.tr - 1) / pl.tr;
    pl.tws = d * (pl.runs * pl.tr + k - 1);
    const long long wbytes = (long long)k * k * gc * 4;
    const long long fit = (SMEM - wbytes) / ((long long)pl.tws * GROUP_BYTES) - 2 * pad;
    if (fit >= 1) {
      const int bands = (int)((H + fit - 1) / fit);
      pl.bh = (H + bands - 1) / bands;
      return pl;
    }
    if (pl.bw == 1) return pl;
  }
}

template <typename T, int K, int V, int TR, typename Epi>
int launch_dd(const void* x, const void* w, const void* shift, void* out, int N, int H,
              int W, int C, int d, const Plan& pl, void* stream) {
  constexpr int GC = GROUP_BYTES / (int)sizeof(T);
  const int pad = d * (K / 2);
  const size_t smem = (size_t)K * K * GC * sizeof(float) +
                      (size_t)(pl.bh + 2 * pad) * pl.tws * GROUP_BYTES;
  const int col_bands = (W + pl.bw - 1) / pl.bw;
  const int bands = (H + pl.bh - 1) / pl.bh;
  auto kernel = dw_dilated_nhwc_kernel<T, K, V, TR>;
  if constexpr (std::is_same<Epi, GeluErf>::value) kernel = dw3x3_gelu_nhwc_kernel<T, V, TR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((long long)bands * col_bands), (unsigned)((C + GC - 1) / GC),
                  (unsigned)N);
  kernel<<<grid, DD_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(shift),
      static_cast<T*>(out), H, W, C, d, pl.bh, pl.bw, col_bands, pl.runs, pl.tws);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, typename Epi = Silu>
int dispatch_dd(const void* x, const void* w, const void* shift, void* out, int N, int H,
                int W, int C, int d, void* stream) {
  constexpr int VV = 4;                      // channels a thread on the vector path
  const bool vec = C % (16 / (int)sizeof(T)) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const Plan pl = plan(H, W, K, d, vec ? VV : 1, (int)sizeof(T), vec);
  if (pl.bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!vec) return launch_dd<T, K, 1, 4, Epi>(x, w, shift, out, N, H, W, C, d, pl, stream);
  switch (pl.tr) {
    case 4: return launch_dd<T, K, VV, 4, Epi>(x, w, shift, out, N, H, W, C, d, pl, stream);
    case 5: return launch_dd<T, K, VV, 5, Epi>(x, w, shift, out, N, H, W, C, d, pl, stream);
    case 6: return launch_dd<T, K, VV, 6, Epi>(x, w, shift, out, N, H, W, C, d, pl, stream);
    default: return launch_dd<T, K, VV, 8, Epi>(x, w, shift, out, N, H, W, C, d, pl, stream);
  }
}

}  // namespace

// x, out [N,H,W,C] (NHWC memory); w [k,k,C] in x's dtype (BN folded);
// shift [C] fp32.  k 3 or 5, d >= 1, fp32 1 for float tensors, 0 for bf16.
// N at most 65,535.
extern "C" int dw_dilated_bn_silu_nhwc(const void* x, const void* w, const void* shift,
                                       void* out, int N, int H, int W, int C, int k, int d,
                                       int fp32, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || d < 1 || (k != 3 && k != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fp32)
    return k == 3 ? dispatch_dd<float, 3>(x, w, shift, out, N, H, W, C, d, stream)
                  : dispatch_dd<float, 5>(x, w, shift, out, N, H, W, C, d, stream);
  return k == 3 ? dispatch_dd<uint16_t, 3>(x, w, shift, out, N, H, W, C, d, stream)
                : dispatch_dd<uint16_t, 5>(x, w, shift, out, N, H, W, C, d, stream);
}

// out = GELU(depthwise 3x3, stride 1, zero padding 1, of x + fp32 shift (the
// conv's bias)), exact erf, one cast: the Mix-FFN's depthwise on the same
// tiles as dw_dilated_bn_silu_nhwc at dilation 1.  x, out [N,H,W,C] (NHWC
// memory); w [3,3,C] in x's dtype; shift [C] fp32; fp32 as above.
extern "C" int dw3x3_bias_gelu_nhwc(const void* x, const void* w, const void* shift,
                                    void* out, int N, int H, int W, int C, int fp32,
                                    void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fp32) return dispatch_dd<float, 3, GeluErf>(x, w, shift, out, N, H, W, C, 1, stream);
  return dispatch_dd<uint16_t, 3, GeluErf>(x, w, shift, out, N, H, W, C, 1, stream);
}
