// Depthwise 3x3 kernels on NCHW tensors, bias and SiLU fused.
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
// element on 4 bytes moved in bf16, against the card's bf16 ridge of about
// 295 operations per byte.  dw3x3_bias_silu stages one haloed tile of one
// channel plane (TH+2 rows of TW+2 values, fp32) in shared memory, so device
// memory sees each input value about once; each thread then sums its nine
// taps from shared memory for TH*TW/NT pixels of one column.  dw_rows_silu
// has the same tiles and reads its three rows straight from device memory:
// they are whole rows of the same columns, so a warp's loads are
// contiguous, and the rows that neighbouring output rows share are served
// from the caches.  Both keep a plane's nine weights in registers.  Sums
// run on CUDA cores; tensor cores, TMA and wgmma are not used.
// bf16 only, as the TPU kernels.  Plain C interface (no PyTorch headers),
// loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int TW = 64;              // tile width
constexpr int TH = 32;              // tile height
constexpr int RPT = TH * TW / NT;   // output rows per thread (8)
constexpr int MAX_PLANES = 65535;   // gridDim.y limit; blocks loop over more

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 from_f(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }

// grid (tiles of TH x TW, planes N*C (looped past MAX_PLANES)), NT threads.
__global__ void __launch_bounds__(NT)
dw3x3_bias_silu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ b, bf16* __restrict__ out,
                       int planes, int C, int H, int W) {
  __shared__ float tile[(TH + 2) * (TW + 2)];
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int col = threadIdx.x % TW;
  const int r0 = (threadIdx.x / TW) * RPT;
  for (int pl = blockIdx.y; pl < planes; pl += gridDim.y) {
    const int c = pl % C;
    const bf16* xp = x + (size_t)pl * H * W;
    bf16* op = out + (size_t)pl * H * W;
    __syncthreads();   // the previous plane's reads of `tile` are done
    for (int i = threadIdx.x; i < (TH + 2) * (TW + 2); i += NT) {
      const int hh = h0 + i / (TW + 2) - 1;
      const int ww = w0 + i % (TW + 2) - 1;
      tile[i] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                    ? to_f(xp[(size_t)hh * W + ww]) : 0.f;
    }
    float k[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = to_f(w[c * 9 + j]);
    const float bias = b[c];
    __syncthreads();
    const int ww = w0 + col;
    if (ww >= W) continue;
#pragma unroll
    for (int r = r0; r < r0 + RPT; ++r) {
      const int hh = h0 + r;
      if (hh >= H) break;
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          acc = fmaf(k[u * 3 + v], tile[(r + u) * (TW + 2) + col + v], acc);
      op[(size_t)hh * W + ww] = from_f(silu(acc + bias));
    }
  }
}

// grid (tiles of TH x TW, planes (looped past MAX_PLANES)), NT threads; a
// thread keeps the plane's weights in registers and writes RPT pixels of
// one column.
__global__ void __launch_bounds__(NT)
dw_rows_silu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ b, bf16* __restrict__ out,
                    int planes, int C, int H, int W, int bh) {
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int ww = (blockIdx.x % tiles_w) * TW + threadIdx.x % TW;
  const int r0 = h0 + (threadIdx.x / TW) * RPT;
  if (ww >= W) return;
  for (int pl = blockIdx.y; pl < planes; pl += gridDim.y) {
    const int c = pl % C;
    const bf16* xp = x + (size_t)pl * H * W + ww;
    bf16* op = out + (size_t)pl * H * W + ww;
    float k[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = to_f(w[c * 9 + j]);
    const float bias = b[c];
#pragma unroll
    for (int hh = r0; hh < r0 + RPT; ++hh) {
      if (hh >= H) break;
      const int s0 = (hh / bh) * bh;          // first row of the slab
      const int lo = s0 > 0 ? s0 - 1 : 0;
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int row = (lo + u + bh <= H ? lo + u : H - bh) + (hh - s0);
        const float xv = to_f(xp[(size_t)row * W]);
#pragma unroll
        for (int v = 0; v < 3; ++v) acc = fmaf(xv, k[u * 3 + v], acc);
      }
      op[(size_t)hh * W] = from_f(silu(acc + bias));
    }
  }
}

dim3 tile_grid(int planes, int H, int W) {
  return dim3(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
              planes < MAX_PLANES ? planes : MAX_PLANES);
}

}  // namespace

// x, out [N,C,H,W] bf16; w [C,3,3] bf16; b [C] fp32.  N*C and H*W must fit
// in an int.
extern "C" int dw3x3_bias_silu(const void* x, const void* w, const void* b,
                               void* out, int N, int C, int H, int W, void* stream) {
  dw3x3_bias_silu_kernel<<<tile_grid(N * C, H, W), NT, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), N * C, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// As dw3x3_bias_silu, with the row map of the probe; bh divides H.
extern "C" int dw_rows_silu(const void* x, const void* w, const void* b,
                            void* out, int N, int C, int H, int W, int bh,
                            void* stream) {
  dw_rows_silu_kernel<<<tile_grid(N * C, H, W), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), N * C, C, H, W, bh);
  return static_cast<int>(cudaGetLastError());
}
