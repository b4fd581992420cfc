// Fused MBConv inference block for the expand blocks: bf16, a 1x1 expand in
// front, NHWC storage (the memory of a channels_last NCHW tensor), two
// passes.
//
// Replaces enhanced_unet_tpu/ops/pallas/mbconv.py::mbconv_infer_nchw
// (_pass1_kernel :144, launched at :208; _pass2_kernel :162, launched at
// :233, with _expand_rows :116 and _dw_silu :126) for the blocks with an
// expand: Cin and Cout multiples of 8 up to 64, mid a multiple of 8 of any
// size, any N, H, W (EfficientNet's stride-1 3x3 blocks of stage 1: Cin 40,
// mid 240 in B5; Cin 32, mid 192 in B4).  csrc/mbconv_nhwc.cu keeps the
// blocks without an expand, csrc/mbconv.cu every other shape and fp32.
//
//   pass 1: per chunk of 64 mid channels: 1x1 expand + bias, SiLU, cast to
//           bf16 -> depthwise 3x3 + bias, SiLU (fp32) -> per-(image, tile)
//           channel sums, reduced inside the block in a fixed order
//   pass 2: the same per chunk, cast to bf16 -> 1x1 projection with the
//           image's SE-gated weights [mid, Cout] (bf16, fp32 sums on
//           mma.sync), accumulated over the chunks in registers
//           + bias [+ residual x] -> one cast to bf16
//
// What bounds it: at [6,40,128,128] mid 240 -> 40 the block moves 80 + 80
// bytes per pixel in pass 2 and does about 2*40*240 (expand) + 23*240
// (depthwise, SiLUs) + 2*240*40 (projection) = 44,000 operations per pixel:
// about 270 per byte, near the H100's bf16 ridge of about 295, so bytes and
// operations bound it about equally, and the operations only where the two
// GEMMs run on the tensor cores.  The depthwise and the two SiLUs (about
// 2 x 240 per pixel, on CUDA cores) are what is left.
//
// One block takes one image and a tile of TH x 32 output pixels (TH = 16 or
// 8), 256 threads.  What the design does about the faults of the first
// csrc/mbconv.cu:
// - The expand on CUDA cores with a device-memory weight load and integer
//   divisions per FMA: it is a GEMM on `mma.sync.m16n8k16`: M the haloed
//   pixels of 8 output rows (10 x 34 = 340, 22 m16 tiles), K = Cin padded
//   to a multiple of 16 (zeros in A and B), N a chunk of 64 mid channels;
//   A by `ldmatrix` from the haloed input tile, B the chunk's expand
//   weights staged in shared memory, both in rows padded to an odd number
//   of 16-byte units.  Its epilogue adds the bias, takes the SiLU, zeroes
//   the halo outside the image (the depthwise pads the expanded tensor, and
//   SiLU(bias) is not 0) and casts to bf16.
// - The whole mid x halo tile in shared memory, capping the tile at 8 rows
//   and one block per SM: mid is taken in chunks of 64, so shared memory
//   grows with the chunk and not with mid; the expand and the depthwise run
//   over 8 output rows at a time (the expand recomputes 2 of 10 haloed
//   rows, 1.25x).
// - 2-byte NCHW loads: the haloed input tile (TH + 2 x 34 pixels x Cin) is
//   filled with 16-byte `cp.async` copies of NHWC pixels, zero-filled
//   outside the image.
// - One warp per channel with shuffles: the depthwise is csrc/mbconv_nhwc.cu's
//   loop, each thread 8 channels of one tile column with its 9 x 8 weights
//   (one 144-byte run of wdw) in registers.
// - Pass 2's projection runs on `mma.sync` per chunk (K = the chunk) into
//   [256 pixels, Cout] fp32 accumulators in registers (2 m16 tiles x Cout/8
//   n8 tiles a warp), so the mid-channel tensor never leaves shared memory.
// Pass 1's sums: one partial per (image, channel, tile), each reduced over
// the tile in a fixed order; the wrapper sums the tiles (no atomics).
// What holds it back (PERF.md has the times against the bounds): registers
// and the CUDA cores.  Pass 2 takes up to 255 registers a thread (64
// projection accumulators, 72 depthwise weights) and about 135 KB of shared
// memory, so one block of 8 warps an SM; both passes issue about 2 SiLUs,
// 9 FMAs and 5 conversions per pixel and mid channel on the CUDA cores,
// against which the two GEMMs on the tensor cores are small.
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include "mbconv_common.cuh"

namespace {

using namespace mbconv;

constexpr int NT = 256;                         // threads per block
constexpr int TW = 32;                          // output columns per tile
constexpr int HW = TW + 2;                      // haloed columns
constexpr int CHUNK = 8;                        // output rows per expand/depthwise step
constexpr int EROWS = CHUNK + 2;                // haloed rows of a step
constexpr int EPIX = EROWS * HW;                // expanded pixels of a step (340)
constexpr int EMT = (EPIX + 15) / 16;           // their m16 tiles (22)
constexpr int MC = 64;                          // mid channels per chunk
constexpr int LDE = MC + 8;                     // expanded / staged rows in halves
constexpr int PMT = CHUNK * TW / 16;            // projection m16 tiles of a step (16)
constexpr int WARPS = NT / 32;
constexpr int MAX_COUT = 64;
static_assert(NT == TW * (MC / 8), "one thread per (8-channel group, tile column)");
static_assert(PMT == 2 * WARPS, "two projection m-tiles a warp");

template <int CIN>
struct Geo {
  static constexpr int CG = CIN / 8;            // 16-byte channel groups of x
  static constexpr int KP = (CIN + 15) / 16 * 16;   // expand K, zero-padded
  static constexpr int LDX = KP + 8;            // x and expand-weight rows in halves
};

// Rows of the haloed input tile, padded for the expand's last m16 tile.
template <int TH>
constexpr int XROWS = ((TH + 2) * HW + 15) / 16 * 16;

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// xs[r * HW + c][0:CIN] <- x[n, h0 + r - 1, w0 + c - 1, :] by 16-byte
// cp.async copies, zeros outside the image; the K padding [CIN, KP) of
// every row is zeroed (garbage times a zero weight could be NaN).
template <int CIN, int TH>
__device__ __forceinline__ void load_x(const uint16_t* __restrict__ x, uint16_t* xs, int H,
                                       int W, int n, int h0, int w0) {
  using G = Geo<CIN>;
  constexpr int ROW = HW * G::CG;
  const uint32_t base = smem_u32(xs);
  for (int i = threadIdx.x; i < (TH + 2) * ROW; i += NT) {
    const int r = i / ROW, rem = i - r * ROW;   // compile-time divisors
    const int c = rem / G::CG, g = rem - c * G::CG;
    const int hh = h0 + r - 1, ww = w0 + c - 1;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const uint16_t* src = in ? x + (((size_t)n * H + hh) * W + ww) * CIN + g * 8 : x;
    cp_async16(base + ((r * HW + c) * G::LDX + g * 8) * 2, src, in ? 16 : 0);
  }
  if constexpr (G::KP != CIN)
    for (int p = threadIdx.x; p < XROWS<TH>; p += NT)
      *reinterpret_cast<uint4*>(xs + p * G::LDX + CIN) = make_uint4(0, 0, 0, 0);
}

// bse[j][0:KP] <- wexp[c0 + j, :] (zero K padding) for the chunk's `width`
// channels starting at c0, by cp.async; waited for with the caller's wait.
template <int CIN>
__device__ __forceinline__ void stage_wexp(const uint16_t* __restrict__ wexp, uint16_t* bse,
                                           int c0, int width) {
  using G = Geo<CIN>;
  constexpr int KG = G::KP / 8;
  for (int i = threadIdx.x; i < width * KG; i += NT) {
    const int j = i / KG, k = i - j * KG;
    uint16_t* dst = bse + j * G::LDX + k * 8;
    if (k < G::CG)
      cp_async16(smem_u32(dst), wexp + (size_t)(c0 + j) * CIN + k * 8, 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// es[p][0:width] <- bf16(SiLU(x[p] . wexp[chunk] + bexp[chunk])) for the
// EPIX haloed pixels p of the step whose first haloed row is tile row r0,
// zero outside the image; the warp takes m16 tiles warp, warp + 8, ...
template <int CIN>
__device__ __forceinline__ void expand_step(const uint16_t* xs, const uint16_t* bse,
                                            uint16_t* es, const float* __restrict__ bexp,
                                            int c0, int width, int r0, int h0, int w0, int H,
                                            int W) {
  using G = Geo<CIN>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nj = width >> 3;
  float bias[MC / 8][2];
#pragma unroll
  for (int j = 0; j < MC / 8; ++j)
    if (j < nj) {
      bias[j][0] = bexp[c0 + j * 8 + 2 * t];
      bias[j][1] = bexp[c0 + j * 8 + 2 * t + 1];
    }
  const uint16_t* xa = xs + (r0 * HW + (lane & 15)) * G::LDX + (lane >> 4) * 8;
  for (int mt = warp; mt < EMT; mt += WARPS) {
    float acc[MC / 8][4];
#pragma unroll
    for (int j = 0; j < MC / 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::KP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(xa + mt * 16 * G::LDX + ks * 16));
#pragma unroll
      for (int j = 0; j < MC / 8; ++j)
        if (j < nj) {
          const uint16_t* q = bse + (j * 8 + g) * G::LDX + ks * 16 + 2 * t;
          const uint32_t b[2] = {ld32(q), ld32(q + 8)};
          mma_bf16(acc[j], a, b);
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mt * 16 + g + 8 * half;
      if (p >= EPIX) continue;
      const int r = p / HW, c = p - r * HW;
      const int hh = h0 + r0 + r - 1, ww = w0 + c - 1;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
#pragma unroll
      for (int j = 0; j < MC / 8; ++j)
        if (j < nj) {
          const float v0 = in ? silu(acc[j][2 * half] + bias[j][0]) : 0.f;
          const float v1 = in ? silu(acc[j][2 * half + 1] + bias[j][1]) : 0.f;
          *reinterpret_cast<uint32_t*>(es + p * LDE + j * 8 + 2 * t) = pack2(v0, v1);
        }
    }
  }
}

// Depthwise 3x3 + bias + SiLU (fp32) of the thread's 8 channels (group cg
// of the chunk) down tile column `col`, the CHUNK output rows of a step
// from its EROWS expanded rows: each input row is read once per column tap
// and added into the up to three output rows it touches; `fin(o, v)` takes
// output row o as soon as its last input row is in.
template <typename Fin>
__device__ __forceinline__ void depthwise_step(const uint16_t* es, const float (&w)[9][8],
                                               const float (&b)[8], int col, int cg,
                                               Fin&& fin) {
  float acc[3][8];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[s][k] = b[k];
#pragma unroll
  for (int i = 0; i < EROWS; ++i) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const uint4 v = *reinterpret_cast<const uint4*>(es + (i * HW + col + dx) * LDE + cg * 8);
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
      fin(o, v);
    }
  }
}

// Pass 1 is capped at 128 registers a thread, so two blocks (16 warps) share
// an SM where shared memory allows (8-row tiles): a few hundred bytes of
// spills, and faster than one block of 255 registers at stage 1's shapes.
constexpr int PASS1_BLOCKS = 2;

template <int CIN, int TH>
__global__ void __launch_bounds__(NT, PASS1_BLOCKS)
mbconv_nhwc_expand_pass1_kernel(const uint16_t* __restrict__ x,
                                const uint16_t* __restrict__ wexp,
                                const float* __restrict__ bexp,
                                const uint16_t* __restrict__ wdw,
                                const float* __restrict__ bdw, float* __restrict__ partial,
                                int H, int W, int mid) {
  using G = Geo<CIN>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* es = xs + XROWS<TH> * G::LDX;            // [EPIX][LDE]
  uint16_t* bse = es + EPIX * LDE;                   // [MC][LDX]
  float* red = reinterpret_cast<float*>(bse + MC * G::LDX);   // [TW][MC]
  const int n = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  load_x<CIN, TH>(x, xs, H, W, n, h0, w0);
  const int cg = threadIdx.x % (MC / 8), col = threadIdx.x / (MC / 8);
  const bool col_in = w0 + col < W;
  const int rows = H - h0;                           // output rows inside the image
  const int tiles = gridDim.y * gridDim.x, tile = blockIdx.y * gridDim.x + blockIdx.x;

  for (int c0 = 0; c0 < mid; c0 += MC) {
    const int width = min(MC, mid - c0);
    const bool active = cg * 8 < width;
    stage_wexp<CIN>(wexp, bse, c0, width);
    cp_async_wait_all();
    __syncthreads();
    float sum[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < TH; r0 += CHUNK) {
      expand_step<CIN>(xs, bse, es, bexp, c0, width, r0, h0, w0, H, W);
      __syncthreads();
      float w[9][8], b[8];      // loaded here: not live across the expand
      if (active) load_dw(wdw, bdw, c0 + cg * 8, w, b);
      if (active)
        depthwise_step(es, w, b, col, cg, [&](int o, const float (&v)[8]) {
          if (col_in && r0 + o < rows) {
#pragma unroll
            for (int k = 0; k < 8; ++k) sum[k] += v[k];
          }
        });
      __syncthreads();
    }
    float* r = red + col * MC + cg * 8;
    *reinterpret_cast<float4*>(r) = make_float4(sum[0], sum[1], sum[2], sum[3]);
    *reinterpret_cast<float4*>(r + 4) = make_float4(sum[4], sum[5], sum[6], sum[7]);
    __syncthreads();
    // NT = 4 * MC threads: a quarter of the columns each, then the quarters,
    // each in a fixed order (the expanded tile's memory holds the quarters)
    float* quarter = reinterpret_cast<float*>(es);
    {
      const int c = threadIdx.x % MC, q = threadIdx.x / MC;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < TW / 4; ++k) s += red[(q * (TW / 4) + k) * MC + c];
      quarter[q * MC + c] = s;
    }
    __syncthreads();
    if (threadIdx.x < width) {     // partial[n][c][tile]: the wrapper sums the last axis
      const float* qs = quarter + threadIdx.x;
      partial[((size_t)n * mid + c0 + threadIdx.x) * tiles + tile] =
          ((qs[0] + qs[MC]) + qs[2 * MC]) + qs[3 * MC];
    }
  }
}

template <int CIN, int TH>
__global__ void __launch_bounds__(NT, 1)
mbconv_nhwc_expand_pass2_kernel(const uint16_t* __restrict__ x,
                                const uint16_t* __restrict__ wexp,
                                const float* __restrict__ bexp,
                                const uint16_t* __restrict__ wdw,
                                const float* __restrict__ bdw,
                                const uint16_t* __restrict__ wpp,
                                const float* __restrict__ bproj, uint16_t* __restrict__ out,
                                int H, int W, int mid, int Cout, int residual) {
  using G = Geo<CIN>;
  constexpr int NJ = MAX_COUT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* es = xs + XROWS<TH> * G::LDX;            // [EPIX][LDE]
  uint16_t* bse = es + EPIX * LDE;                   // [MC][LDX]
  uint16_t* as = bse + MC * G::LDX;                  // [CHUNK * TW][LDE] bf16 SiLU output
  uint16_t* bsp = as + CHUNK * TW * LDE;             // [Cout][LDE] gated weights, k-contiguous
  const int n = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  load_x<CIN, TH>(x, xs, H, W, n, h0, w0);
  const uint16_t* wn = wpp + (size_t)n * mid * Cout;
  const int cg = threadIdx.x % (MC / 8), col = threadIdx.x / (MC / 8);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int co8 = Cout >> 3;

#pragma unroll 1
  for (int r0 = 0; r0 < TH; r0 += CHUNK) {
    float acc[2][NJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < mid; c0 += MC) {
      const int width = min(MC, mid - c0);
      const int kp = (width + 15) & ~15;             // projection K of the chunk
      const bool active = cg * 8 < width;
      stage_wexp<CIN>(wexp, bse, c0, width);
      cp_async_wait_all();
      __syncthreads();               // every warp is done with the last chunk's as and bsp
      expand_step<CIN>(xs, bse, es, bexp, c0, width, r0, h0, w0, H, W);
      for (int i = threadIdx.x; i < Cout * kp; i += NT) {
        const int co = i / kp, k = i - co * kp;
        bsp[co * LDE + k] = k < width ? wn[(size_t)(c0 + k) * Cout + co] : uint16_t(0);
      }
      float w[9][8], b[8];
      if (active) load_dw(wdw, bdw, c0 + cg * 8, w, b);
      __syncthreads();
      uint16_t* a_col = as + col * LDE + cg * 8;
      if (active) {
        depthwise_step(es, w, b, col, cg, [&](int o, const float (&v)[8]) {
          *reinterpret_cast<uint4*>(a_col + o * TW * LDE) = make_uint4(
              pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
        });
      } else {                       // zero K padding of a short last chunk
#pragma unroll
        for (int o = 0; o < CHUNK; ++o)
          *reinterpret_cast<uint4*>(a_col + o * TW * LDE) = make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = warp + WARPS * i;
#pragma unroll
        for (int ks = 0; ks < MC / 16; ++ks) {
          if (ks * 16 >= kp) break;
          uint32_t a[4];
          ldsm_x4(a, smem_u32(as + (mt * 16 + (lane & 15)) * LDE + ks * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (j < co8) {
              const uint16_t* q = bsp + (j * 8 + g) * LDE + ks * 16 + 2 * t;
              const uint32_t bf[2] = {ld32(q), ld32(q + 8)};
              mma_bf16(acc[i][j], a, bf);
            }
        }
      }
    }
    __syncthreads();                 // every warp is done reading as
    // epilogue: bias [+ residual], one cast; each m16 tile staged in as
    // [16][Cout] and written as 16-byte vectors of the NHWC output row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = warp + WARPS * i;
      uint16_t* st = as + mt * 16 * Cout;
      const int r = r0 + (mt >> 1);          // tile row
      const int c0 = (mt & 1) * 16;          // tile column of the m-tile's first pixel
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < co8) {
          const int co = j * 8 + 2 * t;
          const float b0 = bproj[co], b1 = bproj[co + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int px = g + 8 * half;
            float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
            if (residual) {   // Cout == CIN: the input at the tile's centre
              const uint32_t xr = ld32(xs + ((r + 1) * HW + c0 + px + 1) * G::LDX + co);
              v0 += lo_f(xr);
              v1 += hi_f(xr);
            }
            *reinterpret_cast<uint32_t*>(st + px * Cout + co) = pack2(v0, v1);
          }
        }
      __syncwarp();
      const int hh = h0 + r, ww = w0 + c0;
      const int valid = min(16, W - ww);     // the m-tile's pixels inside the image
      if (hh < H && valid > 0) {
        uint16_t* dst = out + (((size_t)n * H + hh) * W + ww) * Cout;
        for (int k = lane; k < valid * co8; k += 32)
          *reinterpret_cast<uint4*>(dst + k * 8) = *reinterpret_cast<const uint4*>(st + k * 8);
      }
      __syncwarp();
    }
  }
}

template <int CIN, int TH>
constexpr int pass1_smem() {
  return (XROWS<TH> * Geo<CIN>::LDX + EPIX * LDE + MC * Geo<CIN>::LDX) * 2 + TW * MC * 4;
}

template <int CIN, int TH>
int pass2_smem(int Cout) {
  return (XROWS<TH> * Geo<CIN>::LDX + EPIX * LDE + MC * Geo<CIN>::LDX + CHUNK * TW * LDE +
          Cout * LDE) * 2;
}

// The kernel's dynamic shared memory allowed, then its resident blocks per
// SM (`blocks` not null).
template <typename K>
int prepare(K kernel, int smem, int* blocks) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && blocks)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NT, smem);
  return static_cast<int>(e);
}

template <int CIN, int TH>
int launch_pass1(const void* x, const void* wexp, const void* bexp, const void* wdw,
                 const void* bdw, void* partial, int N, int mid, int H, int W, int* blocks,
                 cudaStream_t s) {
  const int smem = pass1_smem<CIN, TH>();
  const int e = prepare(mbconv_nhwc_expand_pass1_kernel<CIN, TH>, smem, blocks);
  if (e != 0 || blocks) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  mbconv_nhwc_expand_pass1_kernel<CIN, TH><<<grid, NT, smem, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wexp),
      static_cast<const float*>(bexp), static_cast<const uint16_t*>(wdw),
      static_cast<const float*>(bdw), static_cast<float*>(partial), H, W, mid);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, int TH>
int launch_pass2(const void* x, const void* wexp, const void* bexp, const void* wdw,
                 const void* bdw, const void* wpp, const void* bproj, void* out, int N,
                 int mid, int Cout, int H, int W, int residual, int* blocks, cudaStream_t s) {
  const int smem = pass2_smem<CIN, TH>(Cout);
  const int e = prepare(mbconv_nhwc_expand_pass2_kernel<CIN, TH>, smem, blocks);
  if (e != 0 || blocks) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  mbconv_nhwc_expand_pass2_kernel<CIN, TH><<<grid, NT, smem, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wexp),
      static_cast<const float*>(bexp), static_cast<const uint16_t*>(wdw),
      static_cast<const float*>(bdw), static_cast<const uint16_t*>(wpp),
      static_cast<const float*>(bproj), static_cast<uint16_t*>(out), H, W, mid, Cout,
      residual);
  return static_cast<int>(cudaGetLastError());
}

#define MBCONV_EXPAND_CIN(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)

bool bad_mid(int mid) { return mid < 8 || mid % 8 != 0; }

}  // namespace

// x [N,H,W,Cin] bf16; wexp [mid,Cin] bf16; bexp [mid] fp32; wdw [mid,3,3]
// bf16; bdw [mid] fp32 (all 16-byte aligned); partial [N, mid,
// ceil(H/TH) * ceil(W/32)] fp32.  Cin a multiple of 8, <= 64; mid a
// multiple of 8; TH (tile rows) 8 or 16.  With `blocks` not null, nothing
// is launched: *blocks <- the blocks of that kernel one SM holds.
extern "C" int mbconv_nhwc_expand_pass1(const void* x, const void* wexp, const void* bexp,
                                        const void* wdw, const void* bdw, void* partial,
                                        int N, int Cin, int mid, int H, int W, int TH,
                                        int* blocks, void* stream) {
  if (!blocks && bad_mid(mid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cin * 100 + TH) {
#define CASE(c)                                                                          \
  case c * 100 + 8:                                                                      \
    return launch_pass1<c, 8>(x, wexp, bexp, wdw, bdw, partial, N, mid, H, W, blocks, s); \
  case c * 100 + 16:                                                                     \
    return launch_pass1<c, 16>(x, wexp, bexp, wdw, bdw, partial, N, mid, H, W, blocks, s);
    MBCONV_EXPAND_CIN(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// wpp [N,mid,Cout] bf16 (per-image SE-gated projection); bproj [Cout] fp32;
// out [N,H,W,Cout] bf16.  Cout a multiple of 8, <= 64; residual adds x
// (needs Cout == Cin); the rest as for pass 1.
extern "C" int mbconv_nhwc_expand_pass2(const void* x, const void* wexp, const void* bexp,
                                        const void* wdw, const void* bdw, const void* wpp,
                                        const void* bproj, void* out, int N, int Cin,
                                        int mid, int Cout, int H, int W, int residual, int TH,
                                        int* blocks, void* stream) {
  if (Cout % 8 != 0 || Cout < 8 || Cout > MAX_COUT || (residual && Cout != Cin) ||
      (!blocks && bad_mid(mid)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cin * 100 + TH) {
#define CASE(c)                                                                          \
  case c * 100 + 8:                                                                      \
    return launch_pass2<c, 8>(x, wexp, bexp, wdw, bdw, wpp, bproj, out, N, mid, Cout, H, \
                              W, residual, blocks, s);                                   \
  case c * 100 + 16:                                                                     \
    return launch_pass2<c, 16>(x, wexp, bexp, wdw, bdw, wpp, bproj, out, N, mid, Cout,   \
                               H, W, residual, blocks, s);
    MBCONV_EXPAND_CIN(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
