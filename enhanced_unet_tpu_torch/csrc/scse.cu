// scSE (concurrent spatial and channel squeeze-excitation, smp's
// SCSEModule) over a list of channel parts of one channels_last map, in
// three launches: the UNet++ decoder's attention blocks
// (models/enhanced_unet.py NestedBlock).
//
// A part is a bf16 or fp32 [N, C_i, H, W] tensor on NHWC memory, or, for
// part 0 alone, a [N, C_0, H/2, W/2] one read through a nearest 2x
// upsample.  The block computes, for x the channel concatenation of the
// parts (never formed),
//   s   = bf16(mean over H, W of x)                          [N, C]
//   z   = relu(bf16(bf16(W1 s) + b1))                        [N, C/16]
//   g_c = bf16(sigmoid(bf16(bf16(W2 z) + b2)))               [N, C]
//   t   = bf16(bf16(sum_c ws_c x_c) + bs)  (fp32 sum)        [N, H, W]
//   out = bf16(bf16(x * g_c) + bf16(x * bf16(sigmoid(t))))   [N, C, H, W]
// with the JAX package's rounding points (enhanced_unet_tpu/models/blocks.py
// SCSEBlock in bf16: each conv's output and its bias add in bf16, the
// sigmoids and the products in bf16).  In fp32 nothing is rounded: every
// bf16(.) above is the identity, the sums are fp32 as in bf16.  The output
// is one channels_last [N, C, H, W] tensor in the parts' dtype, which the
// next 3x3 conv (K2) reads in place.
//
// It replaces no Pallas kernel.  Its counterpart in the JAX package is
// models/packed_blocks.py PackedSCSEMulti, which XLA compiles into one
// global-mean reduction, one sSE conv and one gating pass over the parts.
// It was added because the stock sequence it replaces (nearest upsample,
// torch.cat of the node's parts, then the mean, the C->1 1x1 conv and three
// element-wise passes) reads a node's input about six times and writes it
// three times plus the concatenation and the upsample: 131 ms of a tiled
// 2048^2 request with TTA on an H100, 12.8 times the function's bound below
// (this kernel: 20.8 ms, 2.0 times; 1.4 times its own design's).
//
// What bounds it on the H100: bytes.  Per element it does about 7
// operations on 6 bytes moved (x read twice, the output written once),
// against the card's fp32 CUDA-core ridge of about 20 operations a byte.
// The function's least traffic is one read of the parts (the upsampled
// part at its half size) and one write of the output; this design reads
// the parts twice, once for the means and once to apply the gates, since
// the gates need every pixel's sum first:
// - scse_sums_kernel: per block one row band of one part of one image;
//   neighbouring threads take neighbouring vectors of 8 channels of a
//   pixel (16 bytes in bf16, 32 in fp32) and the lanes of a vector stride
//   over the band's pixels, four loads in flight a thread.  Each block
//   writes its channels' fp32 sums to its own row of partial [N, chunks,
//   C]: no atomics, so the result does not vary from run to run.  The upsampled part is summed over its source:
//   its mean is the upsampled map's.
// - scse_gate_kernel: one block an image adds the partial sums in a fixed
//   order and runs the cSE's two 1x1 convs, the ReLU and the sigmoid.
// - scse_apply_kernel: a group of G lanes takes one pixel, each lane K
//   8-channel vectors (G a power of two, G * K >= C / 8, picked by the
//   host for the fewest idle lanes), read from their parts where they lie
//   (the upsampled part at (y / 2, x / 2), whose four readers sit in the
//   same or the next row of one block and hit in the caches).  The lanes
//   sum the sSE's dot product and exchange it by butterfly shuffles (fp32
//   addition commutes, so every lane holds the same sum), then write the
//   pixel's output once.  Each lane keeps its vectors' gates and sSE weights
//   in registers for the whole block.
// Offsets into the maps are 64-bit: a 75-tile batch's widest input holds
// 1.26 * 10^9 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads a block, all three kernels
constexpr int MAX_PARTS = 8;
constexpr int MAX_PART_C = 8 * NT;  // a sums block covers a part's vectors once

struct Parts {
  const void* ptr[MAX_PARTS];       // bf16 or fp32, NHWC memory, 16-byte aligned
  int c[MAX_PARTS];                 // channels, multiples of 8
  int coff[MAX_PARTS];              // first channel in the concatenation
  int n;                            // parts
  int up;                           // 1: part 0 is read through a nearest 2x upsample
};

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float bf(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint16_t bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)bits(lo) | ((uint32_t)bits(hi) << 16);
}

__device__ __forceinline__ uint4 ld16(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void widen8(const uint4& q, float (&f)[8]) {
  f[0] = lo_f(q.x), f[1] = hi_f(q.x), f[2] = lo_f(q.y), f[3] = hi_f(q.y);
  f[4] = lo_f(q.z), f[5] = hi_f(q.z), f[6] = lo_f(q.w), f[7] = hi_f(q.w);
}

// The element type E: uint16_t holds bf16 bits, float is fp32.  A vector is
// 8 channels, one 16-byte load in bf16 and two in fp32.
template <typename E>
struct Vec8 {
  uint4 q[sizeof(E) / 2];
  __device__ __forceinline__ void load(const E* p) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(E) / 2); ++i) q[i] = ld16(h + 8 * i);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(E) / 2); ++i) q[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const {
    if constexpr (sizeof(E) == 2) {
      widen8(q[0], f);
    } else {
      f[0] = __uint_as_float(q[0].x), f[1] = __uint_as_float(q[0].y);
      f[2] = __uint_as_float(q[0].z), f[3] = __uint_as_float(q[0].w);
      f[4] = __uint_as_float(q[1].x), f[5] = __uint_as_float(q[1].y);
      f[6] = __uint_as_float(q[1].z), f[7] = __uint_as_float(q[1].w);
    }
  }
};

template <typename E>
__device__ __forceinline__ void store8(E* p, const float (&y)[8]) {
  if constexpr (sizeof(E) == 2) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]),
                                              pack2(y[4], y[5]), pack2(y[6], y[7]));
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

// a rounding point: to bf16 and back in bf16, none in fp32
template <typename E>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(E) == 2) return bf16r(v);
  else return v;
}
template <typename E>
__device__ __forceinline__ float ld1(const E* p) {
  if constexpr (sizeof(E) == 2) return bf(*p);
  else return *p;
}
template <typename E>
__device__ __forceinline__ E st1(float v) {
  if constexpr (sizeof(E) == 2) return bits(v);
  else return v;
}
// sigmoid in fp32 (PyTorch's 1 / (1 + exp(-v))), then a rounding point
template <typename E>
__device__ __forceinline__ float sigmoid_r(float v) { return rnd<E>(1.f / (1.f + expf(-v))); }

// grid: x the row bands (chunk), y the parts, z the images.  A band is R
// rows of the output map (R even), R / 2 rows of the upsampled part's
// source.  partial[n][chunk][coff + c]: the sum of channel c over the band.
template <typename E>
__global__ void __launch_bounds__(NT) scse_sums_kernel(const Parts P, float* __restrict__ partial,
                                                       int H, int W, int C, int R, int chunks) {
  __shared__ __align__(16) float red[NT * 8];
  const int chunk = blockIdx.x, part = blockIdx.y, n = blockIdx.z;
  const bool up = P.up && part == 0;
  const int hp = up ? H / 2 : H, wp = up ? W / 2 : W, rp = up ? R / 2 : R;
  const int r0 = chunk * rp;
  const int rows = min(rp, hp - r0);
  const int cp = P.c[part], V = cp / 8, L = NT / V;
  const int t = threadIdx.x, v = t % V, lane = t / V;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < L && rows > 0) {
    const E* base = static_cast<const E*>(P.ptr[part]) + ((size_t)n * hp + r0) * wp * cp + 8 * v;
    const int npix = rows * wp;
    int p = lane;
    for (; p + 3 * L < npix; p += 4 * L) {
      Vec8<E> q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u].load(base + (size_t)(p + u * L) * cp);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float f[8];
        q[u].widen(f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += f[e];
      }
    }
    for (; p < npix; p += L) {
      float f[8];
      Vec8<E> q;
      q.load(base + (size_t)p * cp);
      q.widen(f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
  }
  // red[t * 8 + e]: thread t's sum of channel 8 v + e; lane l's vector v
  // lies at t = l * V + v, so channel c of lane l is red[l * cp + c]
  reinterpret_cast<float4*>(red)[2 * t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(red)[2 * t + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  float* out = partial + ((size_t)n * chunks + chunk) * C + P.coff[part];
  for (int c = t; c < cp; c += NT) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += red[l * cp + c];
    out[c] = s;
  }
}

// grid: one block an image.  gates[n][c] = g_c above; the means from the
// partial sums (the upsampled part's channels over its source's H/2 x W/2
// pixels).  Where C < NT, S = NT / C slices of the threads each add every
// S-th band of a channel, and the slices' sums are added in their order.
// Dynamic shared memory: s [C], z [mid] and the slices' sums [S][C], fp32.
template <typename E>
__global__ void __launch_bounds__(NT) scse_gate_kernel(
    const Parts P, const float* __restrict__ partial, int chunks, int C, int HW,
    const E* __restrict__ w1, const E* __restrict__ b1, const E* __restrict__ w2,
    const E* __restrict__ b2, int mid, E* __restrict__ gates) {
  extern __shared__ float sm[];
  float* s = sm;
  float* z = sm + C;
  float* sl = z + mid;
  const int n = blockIdx.x, t = threadIdx.x;
  const int S = C < NT ? NT / C : 1;
  const float* rows = partial + (size_t)n * chunks * C;
  for (int c = t % C, k0 = t / C; k0 < S && c < C; c += S == 1 ? NT : C) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = k0; k < chunks; k += S) acc += rows[(size_t)k * C + c];
    sl[k0 * C + c] = acc;
  }
  __syncthreads();
  const int c_up = P.up ? P.c[0] : 0;
  // PyTorch's mean: the fp32 sum times the reciprocal of the count
  const float inv = 1.f / (float)HW, inv_up = 1.f / (float)(HW / 4);
  for (int c = t; c < C; c += NT) {
    float acc = sl[c];
    for (int k0 = 1; k0 < S; ++k0) acc += sl[k0 * C + c];
    s[c] = rnd<E>(acc * (c < c_up ? inv_up : inv));
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < mid; j += NT / 32) {
    const E* row = w1 + (size_t)j * C;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc += ld1(row + c) * s[c];
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) z[j] = fmaxf(rnd<E>(rnd<E>(acc) + ld1(b1 + j)), 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const E* row = w2 + (size_t)c * mid;
    float acc = 0.f;
    for (int j = 0; j < mid; ++j) acc += ld1(row + j) * z[j];
    gates[(size_t)n * C + c] = st1<E>(sigmoid_r<E>(rnd<E>(rnd<E>(acc) + ld1(b2 + c))));
  }
}

// grid: x the runs of PB pixels of an image, y the images.  A group of G
// lanes a pixel, K vectors a lane (vector j = g + G * i of the pixel's
// C / 8), U pixels a group in flight (two where a lane holds few vectors).
template <typename E, int K>
__global__ void __launch_bounds__(NT, 2) scse_apply_kernel(
    const Parts P, const E* __restrict__ gates, const E* __restrict__ ws,
    const E* __restrict__ bs, E* __restrict__ out, int H, int W, int C, int G, int PB) {
  constexpr int U = K <= 2 ? 2 : 1;
  const int n = blockIdx.y, HW = H * W;
  const int p0 = blockIdx.x * PB, pend = min(p0 + PB, HW);
  const int g = threadIdx.x % G, grp = threadIdx.x / G, groups = NT / G;
  const int V = C / 8, h2 = H / 2, w2 = W / 2;
  const E* base[K];
  int cp[K];
  bool ok[K], upv[K];
  Vec8<E> gc[K], wv[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = g + G * i;
    ok[i] = j < V;
    int part = 0;
    while (ok[i] && part + 1 < P.n && P.coff[part + 1] <= 8 * j) ++part;
    upv[i] = P.up && part == 0;
    cp[i] = P.c[part];
    base[i] = static_cast<const E*>(P.ptr[part]) + (8 * j - P.coff[part]);
    gc[i].clear();
    wv[i].clear();
    if (ok[i]) {
      gc[i].load(gates + (size_t)n * C + 8 * j);
      wv[i].load(ws + 8 * j);
    }
  }
  const float b = ld1(bs);
  // every lane of a warp runs every step (the shuffles need them all); a
  // lane past the run's end loads and stores nothing
  for (int p1 = p0; p1 < pend; p1 += U * groups) {
    Vec8<E> d[U][K];
    size_t q[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p1 + u * groups + grp;
      live[u] = p < pend;
      const int y = p / W, x = p - y * W;
      q[u] = (size_t)n * HW + p;
      const size_t qs = ((size_t)n * h2 + (y >> 1)) * w2 + (x >> 1);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        d[u][i].clear();
        if (live[u] && ok[i]) d[u][i].load(base[i] + (upv[i] ? qs : q[u]) * cp[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float f[8], w[8];
        d[u][i].widen(f);
        wv[i].widen(w);
#pragma unroll
        for (int e = 0; e < 8; ++e) t = fmaf(f[e], w[e], t);
      }
      for (int o = G / 2; o; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      const float gt = sigmoid_r<E>(rnd<E>(rnd<E>(t) + b));
      if (!live[u]) continue;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (!ok[i]) continue;
        float f[8], c[8], y[8];
        d[u][i].widen(f);
        gc[i].widen(c);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = rnd<E>(f[e] * c[e]) + rnd<E>(f[e] * gt);
        store8(out + q[u] * C + 8 * (g + G * i), y);
      }
    }
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }


template <typename E>
int launch(const Parts& P, int N, int H, int W, int C, const void* w1, const void* b1,
           const void* w2, const void* b2, int mid, const void* ws, const void* bs,
           float* partial, int R, int chunks, void* gates, int G, int K, int PB, void* out,
           cudaStream_t s) {
  scse_sums_kernel<E><<<dim3((unsigned)chunks, (unsigned)P.n, (unsigned)N), NT, 0, s>>>(
      P, partial, H, W, C, R, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)(2 * C + mid + NT) * sizeof(float);
  auto* gp = static_cast<E*>(gates);
  scse_gate_kernel<E><<<(unsigned)N, NT, smem, s>>>(
      P, partial, chunks, C, H * W, static_cast<const E*>(w1), static_cast<const E*>(b1),
      static_cast<const E*>(w2), static_cast<const E*>(b2), mid, gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((H * W + PB - 1) / PB), (unsigned)N);
  const auto* wsp = static_cast<const E*>(ws);
  const auto* bsp = static_cast<const E*>(bs);
  auto* op = static_cast<E*>(out);
  switch (K) {
    case 1: scse_apply_kernel<E, 1><<<grid, NT, 0, s>>>(P, gp, wsp, bsp, op, H, W, C, G, PB); break;
    case 2: scse_apply_kernel<E, 2><<<grid, NT, 0, s>>>(P, gp, wsp, bsp, op, H, W, C, G, PB); break;
    case 3: scse_apply_kernel<E, 3><<<grid, NT, 0, s>>>(P, gp, wsp, bsp, op, H, W, C, G, PB); break;
    default: scse_apply_kernel<E, 4><<<grid, NT, 0, s>>>(P, gp, wsp, bsp, op, H, W, C, G, PB);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scSE of the channel concatenation of `nparts` parts (ptrs[i], chans[i]
// channels, NHWC, bf16 where esize is 2 and fp32 where it is 4; part 0
// [N, H/2, W/2, C_0] when up, the others [N, H, W, C_i]) into out
// [N, H, W, C] (NHWC in the parts' dtype, C the sum of chans).  w1 [mid, C],
// b1 [mid], w2 [C, mid], b2 [C], ws [C], bs [1]: in the parts' dtype.
// Scratch: partial [N, chunks, C] fp32 with chunks = ceil(H / R), R even;
// gates [N, C] in the parts' dtype.  The apply pass takes G lanes (a power
// of two up to 32) and K vectors (1-4) a pixel, with G * K >= C / 8, over
// runs of PB pixels.  Returns a CUDA error code (cudaErrorInvalidValue for
// what the kernels do not take).
extern "C" int scse_parts(const void* const* ptrs, const int* chans, int nparts, int up,
                          int esize, int N, int H, int W, const void* w1, const void* b1,
                          const void* w2, const void* b2, int mid, const void* ws,
                          const void* bs, void* partial, int R, int chunks, void* gates, int G,
                          int K, int PB, void* out, void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || (esize != 2 && esize != 4) || N < 1 || N > 65535 ||
      H < 1 || W < 1 || (long long)H * W >= (1LL << 31) || R < 2 || R % 2 ||
      chunks != (H + R - 1) / R || PB < 1 || K < 1 || K > 4 || G < 1 || G > 32 ||
      (G & (G - 1)) || mid < 1 || (up && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Parts P{};
  P.n = nparts;
  P.up = up ? 1 : 0;
  int C = 0;
  for (int i = 0; i < nparts; ++i) {
    if (chans[i] < 8 || chans[i] % 8 || chans[i] > MAX_PART_C || !aligned(ptrs[i]))
      return static_cast<int>(cudaErrorInvalidValue);
    P.ptr[i] = ptrs[i];
    P.c[i] = chans[i];
    P.coff[i] = C;
    C += chans[i];
  }
  if (G * K * 8 < C || !aligned(out) || !aligned(gates) || !aligned(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(partial);
  return esize == 2
             ? launch<uint16_t>(P, N, H, W, C, w1, b1, w2, b2, mid, ws, bs, pp, R, chunks,
                                gates, G, K, PB, out, s)
             : launch<float>(P, N, H, W, C, w1, b1, w2, b2, mid, ws, bs, pp, R, chunks,
                             gates, G, K, PB, out, s);
}
