// Device helpers shared by K1's sources (csrc/mbconv.cu, mbconv_nhwc.cu,
// mbconv_nhwc_expand.cu): shared-memory addresses, 16-byte cp.async copies,
// ldmatrix and mma.sync on bf16, bf16 pairs, the fast SiLU and the
// depthwise weights of 8 channels.  build.py hashes this header into the
// name of every library whose source includes it, so an edit rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mbconv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, the last 16 - bytes of
// them zero (bytes = 0: a zero fill that reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A (16 x 16, row) * B (16 x 8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v * sigmoid(v) = v / (1 + 2^(-v log2 e)), one ex2 and one rcp on the
// special-function unit (relative error about 2^-22 each); where the power
// overflows (v < -88) the reciprocal is 0.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

// Channels c0..c0+7 (c0 a multiple of 8): 9 taps of weights (one 144-byte
// run of wdw [mid][9] bf16, 16-byte aligned) and the bias (bdw fp32,
// 16-byte aligned), in fp32.
__device__ __forceinline__ void load_dw(const uint16_t* __restrict__ wdw,
                                        const float* __restrict__ bdw, int c0,
                                        float (&w)[9][8], float (&b)[8]) {
  const uint4* src = reinterpret_cast<const uint4*>(wdw + c0 * 9);
  uint32_t words[36];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const uint4 v = src[q];
    words[4 * q] = v.x;
    words[4 * q + 1] = v.y;
    words[4 * q + 2] = v.z;
    words[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int i = k * 9 + t;
      w[t][k] = (i & 1) ? hi_f(words[i >> 1]) : lo_f(words[i >> 1]);
    }
  const float4 b0 = *reinterpret_cast<const float4*>(bdw + c0);
  const float4 b1 = *reinterpret_cast<const float4*>(bdw + c0 + 4);
  b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
  b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
}

}  // namespace mbconv
