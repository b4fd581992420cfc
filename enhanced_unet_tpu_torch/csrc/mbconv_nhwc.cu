// Fused MBConv inference block for the serving path's shapes: bf16, no
// expand, NHWC storage (the memory of a channels_last NCHW tensor), two
// passes.
//
// Replaces enhanced_unet_tpu/ops/pallas/mbconv.py::mbconv_infer_nchw
// (_pass1_kernel :144, launched at :208; _pass2_kernel :162, launched at
// :233) for the blocks with expand ratio 1 (EfficientNet stage 0): mid = Cin
// a multiple of 8 up to 64, Cout a multiple of 8 up to 64, any N, H, W.
// csrc/mbconv.cu keeps every other shape (expand blocks, fp32).
//
//   pass 1: depthwise 3x3 + bias, SiLU (fp32) -> per-(image, tile) channel
//           sums, reduced inside the block in a fixed order (no atomics)
//   pass 2: the same, cast to bf16 -> 1x1 projection with the image's
//           SE-gated weights [mid, Cout] (bf16, fp32 sums on mma.sync)
//           + bias [+ residual x] -> one cast to bf16
//
// What bounds it: bytes.  At [6,48,256,256] -> 24 the block does about
// 18*48 (depthwise) + 5*48 (bias, SiLU) + 2*48*24 (projection) = 3,400
// operations per pixel against the 96 + 48 bytes that pass 2 must move per
// pixel: about 24 operations per byte, far below the H100's bf16 ridge of
// about 295.  Pass 1 must read x once (37.7 MB there, 11.3 us at 3.35 TB/s),
// pass 2 read x and write the output (56.6 MB, 16.9 us).  The tensor cores
// are there only to take the projection off the CUDA cores: its K is 24 or
// 48 and N is 24, one or three k16 steps and three n8 tiles per 16 pixels.
// `mma.sync.m16n8k16` fits such small tiles from any warp; `wgmma` would want
// 64-row tiles fed from swizzled shared memory, a warpgroup's worth of
// pixels, and buys nothing where bytes bound the kernel.
//
// One block takes one image and a tile of TH x TW output pixels, TW = 32 and
// TH = 16 or 8 (two or one chunks of 8 rows; the wrapper takes 8 where the
// grid fills the card in fewer waves of rows, e.g. mid 24 at 256^2 or the
// small TTA views), with 4 * C threads: one thread per (16-byte channel
// group, tile column).
// What the design does about the faults of the first csrc/mbconv.cu:
// - Integer division by runtime sizes on every element: the tile geometry and
//   C are compile-time (one instantiation per C), the thread's (group,
//   column) is fixed once, and the loops over rows and taps are unrolled.
// - 2-byte NCHW loads: the haloed tile (TH + 2 x 34 pixels x all C channels) is
//   filled with 16-byte `cp.async` copies of whole NHWC row runs, zero-filled
//   outside the image; consecutive threads copy consecutive 16 bytes.
// - The projection on CUDA cores with two shared-memory loads per FMA: it
//   runs on `mma.sync` (A by `ldmatrix` from the bf16 SiLU output, B the
//   image's gated weights, both in padded shared-memory rows).
// - Tiles of at most 8 x 32 pixels (the halo read 1.33x): 16 x 32 pixels,
//   the halo read 1.20x (from L2: neighbouring tiles share halo rows),
//   wherever the grid fills the card as well as with 8 rows.
// - A warp shuffle per (channel, 32 pixels): each thread owns 8 consecutive
//   channels of one column and runs down its rows in chunks of 8,
//   reading each input vector from shared memory 3 times (once per column
//   tap) and adding it into the three output rows it touches; it keeps its
//   9 x 8 weights and its pass-1 sums in registers; the sums are reduced
//   once per block into partial[n][c][tile], which the wrapper sums over
//   its last axis.
// Pass 2 projects each chunk of the tile as soon as it is done, so the SiLU
// output staged for the tensor cores is 256 pixels.  At C = 48 and TH = 16
// a block holds 65 KB (pass 1) or 95 KB (pass 2) of shared memory and the
// register cap (`BLOCKS`) leaves room for two blocks per SM.
// What holds it back (PERF.md has the times against the bounds): the
// instruction issue, not the bytes.  Per pixel and channel the depthwise
// takes 9 FMAs, about 4 bf16-to-fp32 conversions, the SiLU's ex2 and rcp on
// the special-function unit and its adds, and 12 warps per SM hide little
// of their latency.  In development runs, loading the halo in row groups
// that the depthwise waits for one by one, dropping the block barriers
// around the projection, and storing the projection straight from its
// fragments did not change the time; interleaving the two halves, or caps
// for more blocks per SM, spilled registers and ran slower.
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include "mbconv_common.cuh"

namespace {

using namespace mbconv;

constexpr int TW = 32;                          // output columns per tile
constexpr int HW = TW + 2;                      // haloed columns
constexpr int CHUNK = 8;                        // rows per depthwise (and projection) chunk
constexpr int MTILES = CHUNK * TW / 16;         // m16 tiles per chunk
constexpr int MAX_COUT = 64;

template <int C>
struct Geo {
  static constexpr int CG = C / 8;              // 16-byte channel groups
  static constexpr int NT = TW * CG;            // threads: one per (group, column)
  static constexpr int KP = (C + 15) / 16 * 16; // projection K, zero-padded
  static constexpr int LD = KP + 8;             // A and B rows in halves (odd 16-byte count)
  // blocks per SM that the register cap (`__launch_bounds__`) leaves room
  // for: about 12 warps (a lower cap spills the 72 weights)
  static constexpr int BLOCKS = CG >= 7 ? 1 : 12 / CG;
};

// The haloed tile of TH output rows (8 or 16: one or two chunks), halves.
template <int C, int TH>
constexpr int HALO = (TH + 2) * HW * C;

// xs[r][c][:] <- x[n, h0 + r - 1, w0 + c - 1, :] by 16-byte cp.async copies,
// zeros outside the image (the depthwise's padding); waited for by
// `halo_wait`.
template <int C, int TH>
__device__ __forceinline__ void load_halo(const uint16_t* __restrict__ x, uint16_t* xs,
                                          int H, int W, int n, int h0, int w0) {
  constexpr int CG = Geo<C>::CG, ROW = HW * CG;
  const uint32_t base = smem_u32(xs);
  for (int i = threadIdx.x; i < (TH + 2) * ROW; i += Geo<C>::NT) {
    const int r = i / ROW, rem = i - r * ROW;   // compile-time divisors
    const int c = rem / CG, g = rem - c * CG;
    const int hh = h0 + r - 1, ww = w0 + c - 1;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const uint16_t* src = in ? x + (((size_t)n * H + hh) * W + ww) * C + g * 8 : x;
    cp_async16(base + i * 16, src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for the thread's copies, then for every thread's.
__device__ __forceinline__ void halo_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Depthwise 3x3 + bias + SiLU (fp32) of the thread's 8 channels down tile
// column `col`, output rows [R0, R0 + CHUNK): each haloed input row is read
// once per column tap and added into the up to three output rows it
// touches; `fin(o, v)` takes output row o as soon as its last input row is
// in.
template <int C, int R0, typename Fin>
__device__ __forceinline__ void depthwise_rows(const uint16_t* xs, const float (&w)[9][8],
                                               const float (&b)[8], int col, int cg,
                                               Fin&& fin) {
  float acc[3][8];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[s][k] = b[k];
#pragma unroll
  for (int i = 0; i < CHUNK + 2; ++i) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(xs + ((R0 + i) * HW + col + dx) * C + cg * 8);
      const float f[8] = {lo_f(v.x), hi_f(v.x), lo_f(v.y), hi_f(v.y),
                          lo_f(v.z), hi_f(v.z), lo_f(v.w), hi_f(v.w)};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int o = i - u;
        if (o < 0 || o >= CHUNK) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[o % 3][k] = fmaf(w[u * 3 + dx][k], f[k], acc[o % 3][k]);
      }
    }
    if (i >= 2) {
      const int o = i - 2;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = silu(acc[o % 3][k]);
        acc[o % 3][k] = b[k];
      }
      fin(R0 + o, v);
    }
  }
}

template <int C, int TH>
__global__ void __launch_bounds__(Geo<C>::NT, Geo<C>::BLOCKS)
mbconv_nhwc_pass1_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wdw,
                         const float* __restrict__ bdw, float* __restrict__ partial,
                         int H, int W, int row_lo, int row_hi) {
  using G = Geo<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  float* red = reinterpret_cast<float*>(xs + HALO<C, TH>);   // [TW][C]
  const int n = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  load_halo<C, TH>(x, xs, H, W, n, h0, w0);
  const int cg = threadIdx.x % G::CG, col = threadIdx.x / G::CG;
  float w[9][8], b[8];
  load_dw(wdw, bdw, cg * 8, w, b);

  const bool col_in = w0 + col < W;
  // the tile rows counted: output rows [row_lo, row_hi) of the image (the
  // whole image by default; a band's own rows of a haloed band)
  const int lo = row_lo - h0, hi = row_hi - h0;
  float sum[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = 0.f;
  auto add = [&](int o, const float (&v)[8]) {
    if (col_in && o >= lo && o < hi) {
#pragma unroll
      for (int k = 0; k < 8; ++k) sum[k] += v[k];
    }
  };
  halo_wait();
  depthwise_rows<C, 0>(xs, w, b, col, cg, add);
  if constexpr (TH > CHUNK) depthwise_rows<C, CHUNK>(xs, w, b, col, cg, add);
  float* r = red + col * C + cg * 8;
  *reinterpret_cast<float4*>(r) = make_float4(sum[0], sum[1], sum[2], sum[3]);
  *reinterpret_cast<float4*>(r + 4) = make_float4(sum[4], sum[5], sum[6], sum[7]);
  __syncthreads();
  // 4 * C threads: a quarter of the columns per thread, then the quarters,
  // each in a fixed order (the halo's memory holds the quarters)
  float* quarter = reinterpret_cast<float*>(xs);
  {
    const int c = threadIdx.x % C, q = threadIdx.x / C;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TW / 4; ++k) s += red[(q * (TW / 4) + k) * C + c];
    quarter[q * C + c] = s;
  }
  __syncthreads();
  if (threadIdx.x < C) {       // partial[n][c][tile]: the wrapper sums the last axis
    const float* qs = quarter + threadIdx.x;
    const int tiles = gridDim.y * gridDim.x, tile = blockIdx.y * gridDim.x + blockIdx.x;
    partial[((size_t)n * C + threadIdx.x) * tiles + tile] =
        ((qs[0] + qs[C]) + qs[2 * C]) + qs[3 * C];
  }
}

// Project one chunk of CHUNK tile rows starting at tile row r0: the warp
// takes m16 tiles warp, warp + CG, ...; each is staged in the warp's `st`
// [16][Cout] and written as 16-byte vectors of the NHWC output row.
template <int C>
__device__ __forceinline__ void project_chunk(const uint16_t* as, const uint16_t* bs,
                                              uint16_t* st, const uint16_t* xs,
                                              const float* __restrict__ bproj,
                                              uint16_t* __restrict__ out, int n, int H,
                                              int W, int Cout, int residual, int r0,
                                              int h0, int w0) {
  using G = Geo<C>;
  constexpr int NJ = MAX_COUT / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int co8 = Cout >> 3;
  float bias[NJ][2];                       // the lane's output channels' bias
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < co8) {
      bias[j][0] = bproj[j * 8 + 2 * t];
      bias[j][1] = bproj[j * 8 + 2 * t + 1];
    }
  for (int mt = warp; mt < MTILES; mt += G::CG) {
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::KP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(as + (mt * 16 + (lane & 15)) * G::LD + ks * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < co8) {
          const uint16_t* q = bs + (j * 8 + g) * G::LD + ks * 16 + 2 * t;
          const uint32_t bf[2] = {ld32(q), ld32(q + 8)};
          mma_bf16(acc[j], a, bf);
        }
      }
    }
    const int r = r0 + (mt >> 1);          // tile row
    const int c0 = (mt & 1) * 16;          // tile column of the m-tile's first pixel
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < co8) {
        const int co = j * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = g + 8 * half;
          float v0 = acc[j][2 * half] + bias[j][0], v1 = acc[j][2 * half + 1] + bias[j][1];
          if (residual) {   // Cout == C: the input at the tile's centre
            const uint32_t xr = ld32(xs + ((r + 1) * HW + c0 + px + 1) * C + co);
            v0 += lo_f(xr);
            v1 += hi_f(xr);
          }
          *reinterpret_cast<uint32_t*>(st + px * Cout + co) = pack2(v0, v1);
        }
      }
    }
    __syncwarp();
    const int hh = h0 + r, ww = w0 + c0;
    const int valid = min(16, W - ww);     // the m-tile's pixels inside the image
    if (hh < H && valid > 0) {
      uint16_t* dst = out + (((size_t)n * H + hh) * W + ww) * Cout;
      for (int j = lane; j < valid * co8; j += 32)
        *reinterpret_cast<uint4*>(dst + j * 8) = *reinterpret_cast<const uint4*>(st + j * 8);
    }
    __syncwarp();
  }
}

template <int C, int TH>
__global__ void __launch_bounds__(Geo<C>::NT, Geo<C>::BLOCKS)
mbconv_nhwc_pass2_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wdw,
                         const float* __restrict__ bdw, const uint16_t* __restrict__ wpp,
                         const float* __restrict__ bproj, uint16_t* __restrict__ out,
                         int H, int W, int Cout, int residual) {
  using G = Geo<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* as = xs + HALO<C, TH>;             // [CHUNK * TW][LD] bf16 SiLU output
  uint16_t* bs = as + CHUNK * TW * G::LD;      // [Cout][LD] gated weights, k-contiguous
  uint16_t* st = bs + Cout * G::LD + (threadIdx.x >> 5) * 16 * Cout;   // [16][Cout]
  const int n = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  load_halo<C, TH>(x, xs, H, W, n, h0, w0);
  const uint16_t* wn = wpp + (size_t)n * C * Cout;
  for (int i = threadIdx.x; i < Cout * G::KP; i += G::NT) {
    const int co = i / G::KP, k = i - co * G::KP;
    bs[co * G::LD + k] = k < C ? wn[k * Cout + co] : uint16_t(0);
  }
  const int cg = threadIdx.x % G::CG, col = threadIdx.x / G::CG;
  float w[9][8], b[8];
  load_dw(wdw, bdw, cg * 8, w, b);

  auto stage = [&](int o, const float (&v)[8]) {
    uint16_t* a = as + ((o % CHUNK) * TW + col) * G::LD + cg * 8;
    *reinterpret_cast<uint4*>(a) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
    if (G::KP != C && cg == G::CG - 1)       // zero K padding
      *reinterpret_cast<uint4*>(a + 8) = make_uint4(0, 0, 0, 0);
  };
  halo_wait();
  depthwise_rows<C, 0>(xs, w, b, col, cg, stage);
  __syncthreads();
  project_chunk<C>(as, bs, st, xs, bproj, out, n, H, W, Cout, residual, 0, h0, w0);
  if constexpr (TH > CHUNK) {
    __syncthreads();                       // every warp is done with `as`
    depthwise_rows<C, CHUNK>(xs, w, b, col, cg, stage);
    __syncthreads();
    project_chunk<C>(as, bs, st, xs, bproj, out, n, H, W, Cout, residual, CHUNK, h0, w0);
  }
}

template <int C, int TH>
constexpr int pass1_smem() {
  return HALO<C, TH> * 2 + TW * C * 4;
}

template <int C, int TH>
int pass2_smem(int Cout) {
  using G = Geo<C>;
  return (HALO<C, TH> + CHUNK * TW * G::LD + Cout * G::LD + G::CG * 16 * Cout) * 2;
}

// The kernel's dynamic shared memory allowed, then its resident blocks per
// SM (`blocks` not null) or its launch on `grid`.
template <typename K>
int prepare_or_launch(K kernel, int smem, int* blocks, int nt) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && blocks)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, nt, smem);
  return static_cast<int>(e);
}

template <int C, int TH>
int launch_pass1(const void* x, const void* wdw, const void* bdw, void* partial, int N,
                 int H, int W, int row_lo, int row_hi, int* blocks, cudaStream_t s) {
  using G = Geo<C>;
  const int smem = pass1_smem<C, TH>();
  const int e = prepare_or_launch(mbconv_nhwc_pass1_kernel<C, TH>, smem, blocks, G::NT);
  if (e != 0 || blocks) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  mbconv_nhwc_pass1_kernel<C, TH><<<grid, G::NT, smem, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wdw),
      static_cast<const float*>(bdw), static_cast<float*>(partial), H, W, row_lo, row_hi);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int TH>
int launch_pass2(const void* x, const void* wdw, const void* bdw, const void* wpp,
                 const void* bproj, void* out, int N, int Cout, int H, int W, int residual,
                 int* blocks, cudaStream_t s) {
  using G = Geo<C>;
  const int smem = pass2_smem<C, TH>(Cout);
  const int e = prepare_or_launch(mbconv_nhwc_pass2_kernel<C, TH>, smem, blocks, G::NT);
  if (e != 0 || blocks) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  mbconv_nhwc_pass2_kernel<C, TH><<<grid, G::NT, smem, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wdw),
      static_cast<const float*>(bdw), static_cast<const uint16_t*>(wpp),
      static_cast<const float*>(bproj), static_cast<uint16_t*>(out), H, W, Cout, residual);
  return static_cast<int>(cudaGetLastError());
}

#define MBCONV_NHWC_CHANNELS(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)

}  // namespace

// x [N,H,W,C] bf16; wdw [C,3,3] bf16; bdw [C] fp32 (all 16-byte aligned);
// partial [N, C, ceil(H/TH) * ceil(W/32)] fp32.  C a multiple of 8, <= 64;
// TH (tile rows) 8 or 16.  Only output rows [row_lo, row_hi) are summed
// (0 <= row_lo <= row_hi <= H; 0, H: every row).  With `blocks` not null,
// nothing is launched: *blocks <- the blocks of that kernel one SM holds.
extern "C" int mbconv_nhwc_pass1(const void* x, const void* wdw, const void* bdw,
                                 void* partial, int N, int C, int H, int W, int TH,
                                 int row_lo, int row_hi, int* blocks, void* stream) {
  if (!blocks && (row_lo < 0 || row_lo > row_hi || row_hi > H))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C * 100 + TH) {
#define CASE(c)                                                                 \
  case c * 100 + 8:                                                             \
    return launch_pass1<c, 8>(x, wdw, bdw, partial, N, H, W, row_lo, row_hi, blocks, s); \
  case c * 100 + 16:                                                                     \
    return launch_pass1<c, 16>(x, wdw, bdw, partial, N, H, W, row_lo, row_hi, blocks, s);
    MBCONV_NHWC_CHANNELS(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// wpp [N,C,Cout] bf16 (per-image SE-gated projection); bproj [Cout] fp32;
// out [N,H,W,Cout] bf16.  Cout a multiple of 8, <= 64; residual adds x
// (needs Cout == C); TH and `blocks` as for pass 1.
extern "C" int mbconv_nhwc_pass2(const void* x, const void* wdw, const void* bdw,
                                 const void* wpp, const void* bproj, void* out, int N, int C,
                                 int Cout, int H, int W, int residual, int TH, int* blocks,
                                 void* stream) {
  if (Cout % 8 != 0 || Cout < 8 || Cout > MAX_COUT || (residual && Cout != C))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C * 100 + TH) {
#define CASE(c)                                                                      \
  case c * 100 + 8:                                                                  \
    return launch_pass2<c, 8>(x, wdw, bdw, wpp, bproj, out, N, Cout, H, W, residual, \
                              blocks, s);                                            \
  case c * 100 + 16:                                                                 \
    return launch_pass2<c, 16>(x, wdw, bdw, wpp, bproj, out, N, Cout, H, W, residual, \
                               blocks, s);
    MBCONV_NHWC_CHANNELS(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
