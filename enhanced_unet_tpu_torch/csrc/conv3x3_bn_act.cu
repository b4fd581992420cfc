// Fused 3x3 SAME stride-1 convolution + folded BatchNorm + optional ReLU,
// NHWC activations, as an implicit GEMM.
//
// Replaces enhanced_unet_tpu/ops/pallas/conv_fused.py::fused_conv3x3_bn_relu.
// out[n,h,w,co] = act(sum_{dy,dx,ci} x[n,h+dy-1,w+dx-1,ci] * w[co,dy,dx,ci]
//                     * scale[co] + shift[co]), zero padding, fp32 sums,
// cast to the input type.  Weights arrive as [Cout][3][3][Cin] (OHWI), so
// the reduction dimension is contiguous for both operands.
//
// Both kernels compute a tile of TH x TW output pixels by a block of output
// channels.  For each chunk of input channels a block stages ONE haloed
// input tile ((TH+2) x (TW+2) pixels) and the chunk's nine tap weights in
// shared memory, and all nine taps read from that tile: no shifted copies
// of the input exist in device memory.  Any H, W, Cin and Cout are taken;
// edges and ragged channel chunks are masked with zeros.
//
// - bf16: tensor cores, `mma.sync.m16n8k16` with bf16 operands and fp32
//   accumulators.  One m16 tile is one output row of the 16-pixel-wide
//   tile, so an A fragment of tap (dy, dx) is read straight from the haloed
//   tile at a shifted pixel.  Shared-memory rows are padded to 24 halves so
//   the fragment loads are free of bank conflicts.
// - fp32: CUDA cores in fp32 (the tensor cores would round the operands to
//   TF32); each thread keeps 8 pixels x 4 channels of sums in registers.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;      // output rows per block
constexpr int TW = 16;     // output columns per block
constexpr int NT = 256;    // threads per block
constexpr int HALO = (TH + 2) * (TW + 2);

__device__ __forceinline__ float epilogue(float acc, float sc, float sh, int relu) {
  // y * scale + shift rounded as two operations, as the plain version does
  const float v = __fadd_rn(__fmul_rn(acc, sc), sh);
  return relu ? fmaxf(v, 0.f) : v;
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int BN = 64;       // output channels per block
constexpr int CK = 16;       // input channels per chunk (one k16 step per tap)
constexpr int LD = CK + 8;   // padded shared-memory row, in halves

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 consecutive channels [c, c+8) of a row that holds `len` channels, as
// raw bf16 bits; zeros past the end.  `vec`: 16-byte loads are aligned.
__device__ __forceinline__ uint4 load8(const uint16_t* row, int c, int len, int vec) {
  if (vec && c + 8 <= len) return *reinterpret_cast<const uint4*>(row + c);
  union { uint4 u; uint16_t h[8]; } v;
#pragma unroll
  for (int k = 0; k < 8; ++k) v.h[k] = c + k < len ? row[c + k] : uint16_t(0);
  return v.u;
}

__global__ void __launch_bounds__(NT)
conv3x3_bn_act_bf16_kernel(const uint16_t* __restrict__ x,
                           const uint16_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int Cin, int Cout, int relu, int tiles_w, int vec) {
  __shared__ __align__(16) uint16_t xs[HALO * LD];      // [pixel][ci]
  __shared__ __align__(16) uint16_t ws[9 * BN * LD];    // [tap][co][ci]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const int wm = warp >> 1;                // output rows 2*wm and 2*wm + 1
  const int wn = warp & 1;                 // output channels wn*32 .. wn*32 + 31
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const uint16_t* xn = x + (size_t)n * H * W * Cin;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int i = tid; i < HALO * 2; i += NT) {
      const int grp = i & 1, p = i >> 1;
      const int hh = h0 + p / (TW + 2) - 1;
      const int ww = w0 + p % (TW + 2) - 1;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = load8(xn + ((size_t)hh * W + ww) * Cin, c0 + grp * 8, Cin, vec);
      *reinterpret_cast<uint4*>(&xs[p * LD + grp * 8]) = v;
    }
    for (int i = tid; i < BN * 9 * 2; i += NT) {
      const int grp = i & 1, r = i >> 1;   // r = co * 9 + tap
      const int tap = r % 9, co = r / 9;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (co0 + co < Cout)
        v = load8(w + ((size_t)(co0 + co) * 9 + tap) * Cin, c0 + grp * 8, Cin, vec);
      *reinterpret_cast<uint4*>(&ws[(tap * BN + co) * LD + grp * 8]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // fragment rows g and g + 8 are output columns g and g + 8
        const uint16_t* p0 = &xs[((2 * wm + mt + dy) * (TW + 2) + g + dx) * LD + 2 * t];
        const uint16_t* p1 = p0 + 8 * LD;
        a[mt][0] = ld32(p0);
        a[mt][1] = ld32(p1);
        a[mt][2] = ld32(p0 + 8);
        a[mt][3] = ld32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* q = &ws[(tap * BN + wn * 32 + nt * 8 + g) * LD + 2 * t];
        b[nt][0] = ld32(q);
        b[nt][1] = ld32(q + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int hh = h0 + 2 * wm + mt;
    if (hh >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ww = w0 + g + 8 * half;
      if (ww >= W) continue;
      __nv_bfloat16* o = out + ((size_t)n * H * W + (size_t)hh * W + ww) * Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int oc = co0 + wn * 32 + nt * 8 + 2 * t + j;
          if (oc < Cout)
            o[oc] = __float2bfloat16_rn(
                epilogue(acc[mt][nt][2 * half + j], scale[oc], shift[oc], relu));
        }
    }
  }
}

// ---- fp32 on the CUDA cores -----------------------------------------------

constexpr int CO_T = 64;   // output channels per block
constexpr int CK32 = 8;    // input channels per chunk

__global__ void __launch_bounds__(NT)
conv3x3_bn_act_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift, float* __restrict__ out,
                          int H, int W, int Cin, int Cout, int relu, int tiles_w) {
  __shared__ float xs[HALO * CK32];        // [row][col][ci]
  __shared__ float ws[9 * CK32 * CO_T];    // [tap][ci][co]

  const int tid = threadIdx.x;
  const int tx = tid % 16;               // channel lane: co = co0 + tx + 16k
  const int ty = tid / 16;               // output column inside the tile
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const float* xn = x + (size_t)n * H * W * Cin;

  float acc[TH][4];
#pragma unroll
  for (int j = 0; j < TH; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK32) {
    for (int i = tid; i < HALO * CK32; i += NT) {
      const int ci = i % CK32;
      const int pix = i / CK32;
      const int hh = h0 + pix / (TW + 2) - 1;
      const int ww = w0 + pix % (TW + 2) - 1;
      const int cc = c0 + ci;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < Cin)
        v = xn[((size_t)hh * W + ww) * Cin + cc];
      xs[i] = v;
    }
    for (int i = tid; i < 9 * CK32 * CO_T; i += NT) {
      const int co = i % CO_T;
      const int r = i / CO_T;
      const int ci = r % CK32;
      const int tap = r / CK32;
      const int cc = c0 + ci;
      const int oc = co0 + co;
      float v = 0.f;
      if (cc < Cin && oc < Cout) v = w[((size_t)oc * 9 + tap) * Cin + cc];
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ci = 0; ci < CK32; ++ci) {
        float wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) wv[k] = ws[(tap * CK32 + ci) * CO_T + tx + 16 * k];
#pragma unroll
        for (int j = 0; j < TH; ++j) {
          const float xv = xs[((j + dy) * (TW + 2) + ty + dx) * CK32 + ci];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(xv, wv[k], acc[j][k]);
        }
      }
    }
    __syncthreads();
  }

  const int ww = w0 + ty;
  if (ww >= W) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int oc = co0 + tx + 16 * k;
    if (oc >= Cout) continue;
#pragma unroll
    for (int j = 0; j < TH; ++j) {
      const int hh = h0 + j;
      if (hh >= H) break;
      out[(((size_t)n * H + hh) * W + ww) * Cout + oc] =
          epilogue(acc[j][k], scale[oc], shift[oc], relu);
    }
  }
}

}  // namespace

// x [N,H,W,Cin], w [Cout,3,3,Cin] (both bf16 when is_bf16, else fp32),
// scale/shift [Cout] fp32, out [N,H,W,Cout] of x's type.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int conv3x3_bn_act(const void* x, const void* w, const void* scale,
                              const void* shift, void* out, int N, int H,
                              int W, int Cin, int Cout, int relu, int is_bf16,
                              void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (is_bf16) {
    const int vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid(tiles_w * tiles_h, (Cout + BN - 1) / BN, N);
    conv3x3_bn_act_bf16_kernel<<<grid, NT, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), sc, sh,
        static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, relu, tiles_w, vec);
  } else {
    const dim3 grid(tiles_w * tiles_h, (Cout + CO_T - 1) / CO_T, N);
    conv3x3_bn_act_f32_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, sh,
        static_cast<float*>(out), H, W, Cin, Cout, relu, tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}
