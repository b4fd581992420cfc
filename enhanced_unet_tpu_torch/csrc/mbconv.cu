// Fused MBConv inference block (EfficientNet unit), NCHW, two passes.
//
// Replaces enhanced_unet_tpu/ops/pallas/mbconv.py::mbconv_infer_nchw
// (_pass1_kernel, _pass2_kernel).  Weights arrive folded (BN0 into the
// expand, BN1 into the depthwise, BN2 into the projection bias; the SE gate
// is folded into per-image projection weights between the passes).
//
//   pass 1: [expand 1x1 + bias, SiLU, cast T ->] depthwise 3x3 + bias, SiLU
//           (fp32) -> per-(image, tile) channel sums, reduced inside the
//           block in a fixed order (no atomics)
//   pass 2: recompute the same, cast T -> 1x1 projection with the gated
//           weights [mid, Cout] of the image (fp32 sums) + bias
//           [+ residual x] -> cast T
//
// One block handles one image and a tile of TH x 32 pixels.  It stages the
// haloed input tile of all Cin channels in shared memory, expands it there
// (halo included, zeros outside the image: the depthwise pads its own
// input), runs the depthwise from shared memory and, in pass 2, keeps the
// T-rounded depthwise output of all mid channels in shared memory for the
// projection.  The mid-channel tensor never reaches device memory.  Any H and
// W are taken.  TH is chosen by the caller so that the shared memory fits.
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;     // tile width (one warp of pixels per tile row)
constexpr int NT = 256;    // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }

struct Tile {
  int n, h0, w0, th, halo, pixels;
};

__device__ __forceinline__ Tile tile_of(int th, int W) {
  const int tiles_w = (W + TW - 1) / TW;
  Tile t;
  t.n = blockIdx.y;
  t.h0 = (blockIdx.x / tiles_w) * th;
  t.w0 = (blockIdx.x % tiles_w) * TW;
  t.th = th;
  t.halo = (th + 2) * (TW + 2);
  t.pixels = th * TW;
  return t;
}

// xs[c][row][col] <- x[n, c, h0+row-1, w0+col-1], zero outside the image.
template <typename T>
__device__ void load_halo(const T* __restrict__ x, T* xs, int C, int H, int W,
                          const Tile& t) {
  const T* xn = x + (size_t)t.n * C * H * W;
  for (int i = threadIdx.x; i < C * t.halo; i += NT) {
    const int c = i / t.halo;
    const int r = i % t.halo;
    const int hh = t.h0 + r / (TW + 2) - 1;
    const int ww = t.w0 + r % (TW + 2) - 1;
    T v = from_f<T>(0.f);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = xn[((size_t)c * H + hh) * W + ww];
    xs[i] = v;
  }
}

// es[m][r] <- T(silu(sum_c wexp[m,c] xs[c][r] + bexp[m])) inside the image,
// 0 outside (the depthwise's zero padding).
template <typename T>
__device__ void expand_halo(const T* xs, T* es, const T* __restrict__ wexp,
                            const float* __restrict__ bexp, int Cin, int mid,
                            int H, int W, const Tile& t) {
  for (int i = threadIdx.x; i < mid * t.halo; i += NT) {
    const int m = i / t.halo;
    const int r = i % t.halo;
    const int hh = t.h0 + r / (TW + 2) - 1;
    const int ww = t.w0 + r % (TW + 2) - 1;
    float v = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
      float acc = 0.f;
      for (int c = 0; c < Cin; ++c)
        acc = fmaf(to_f(wexp[m * Cin + c]), to_f(xs[c * t.halo + r]), acc);
      v = silu(acc + bexp[m]);
    }
    es[i] = from_f<T>(v);
  }
}

// fp32 SiLU(depthwise 3x3 + bias) of channel m at tile pixel p.
template <typename T>
__device__ __forceinline__ float dw_silu(const T* src, const T* __restrict__ wdw,
                                         const float* __restrict__ bdw, int m,
                                         int p, const Tile& t) {
  const int prow = p / TW;
  const int pcol = p % TW;
  const T* s = src + (size_t)m * t.halo;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int v = 0; v < 3; ++v)
      acc = fmaf(to_f(wdw[m * 9 + u * 3 + v]), to_f(s[(prow + u) * (TW + 2) + pcol + v]), acc);
  return silu(acc + bdw[m]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
mbconv_pass1_kernel(const T* __restrict__ x, const T* __restrict__ wexp,
                    const float* __restrict__ bexp, const T* __restrict__ wdw,
                    const float* __restrict__ bdw, float* __restrict__ partial,
                    int Cin, int mid, int H, int W, int th) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(th, W);
  const bool expand = wexp != nullptr;
  T* xs = reinterpret_cast<T*>(smem);
  T* es = xs + (size_t)Cin * t.halo;
  float* red = reinterpret_cast<float*>(es + (expand ? (size_t)mid * t.halo : 0));
  const int chunks = t.pixels / 32;   // warps of pixels per channel

  load_halo(x, xs, Cin, H, W, t);
  __syncthreads();
  if (expand) {
    expand_halo(xs, es, wexp, bexp, Cin, mid, H, W, t);
    __syncthreads();
  }
  const T* src = expand ? es : xs;
  const int lane = threadIdx.x % 32;
  // i = m * pixels + p: the 32 lanes of a warp share one channel m
  for (int base = threadIdx.x - lane; base < mid * t.pixels; base += NT) {
    const int i = base + lane;
    const int m = i / t.pixels;
    const int p = i % t.pixels;
    const bool inside = t.h0 + p / TW < H && t.w0 + p % TW < W;
    float v = inside ? dw_silu(src, wdw, bdw, m, p, t) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[m * chunks + p / 32] = v;
  }
  __syncthreads();
  const size_t tile_idx = (size_t)t.n * gridDim.x + blockIdx.x;
  for (int m = threadIdx.x; m < mid; m += NT) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += red[m * chunks + k];
    partial[tile_idx * mid + m] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mbconv_pass2_kernel(const T* __restrict__ x, const T* __restrict__ wexp,
                    const float* __restrict__ bexp, const T* __restrict__ wdw,
                    const float* __restrict__ bdw, const T* __restrict__ wpp,
                    const float* __restrict__ bproj, T* __restrict__ out,
                    int Cin, int mid, int Cout, int H, int W, int th,
                    int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(th, W);
  const bool expand = wexp != nullptr;
  T* xs = reinterpret_cast<T*>(smem);
  T* es = xs + (size_t)Cin * t.halo;
  T* ys = es + (expand ? (size_t)mid * t.halo : 0);
  T* wps = ys + (size_t)mid * t.pixels;

  load_halo(x, xs, Cin, H, W, t);
  const T* wn = wpp + (size_t)t.n * mid * Cout;
  for (int i = threadIdx.x; i < mid * Cout; i += NT) wps[i] = wn[i];
  __syncthreads();
  if (expand) {
    expand_halo(xs, es, wexp, bexp, Cin, mid, H, W, t);
    __syncthreads();
  }
  const T* src = expand ? es : xs;
  for (int i = threadIdx.x; i < mid * t.pixels; i += NT) {
    const int m = i / t.pixels;
    const int p = i % t.pixels;
    ys[i] = from_f<T>(dw_silu(src, wdw, bdw, m, p, t));
  }
  __syncthreads();
  T* on = out + (size_t)t.n * Cout * H * W;
  for (int i = threadIdx.x; i < Cout * t.pixels; i += NT) {
    const int co = i / t.pixels;
    const int p = i % t.pixels;
    const int hh = t.h0 + p / TW;
    const int ww = t.w0 + p % TW;
    if (hh >= H || ww >= W) continue;
    float acc = 0.f;
    for (int m = 0; m < mid; ++m)
      acc = fmaf(to_f(wps[m * Cout + co]), to_f(ys[m * t.pixels + p]), acc);
    acc = acc + bproj[co];
    if (residual)
      acc = acc + to_f(xs[(size_t)co * t.halo + (p / TW + 1) * (TW + 2) + p % TW + 1]);
    on[((size_t)co * H + hh) * W + ww] = from_f<T>(acc);
  }
}

size_t pass1_smem(int Cin, int mid, int th, int expand, int elt) {
  const size_t halo = (size_t)(th + 2) * (TW + 2);
  return Cin * halo * elt + (expand ? mid * halo * elt : 0) +
         (size_t)mid * (th * TW / 32) * sizeof(float);
}

size_t pass2_smem(int Cin, int mid, int Cout, int th, int expand, int elt) {
  const size_t halo = (size_t)(th + 2) * (TW + 2);
  return Cin * halo * elt + (expand ? mid * halo * elt : 0) +
         (size_t)mid * th * TW * elt + (size_t)mid * Cout * elt;
}

template <typename T>
int launch_pass1(const void* x, const void* wexp, const void* bexp,
                 const void* wdw, const void* bdw, void* partial, int N,
                 int Cin, int mid, int H, int W, int th, cudaStream_t s) {
  const size_t smem = pass1_smem(Cin, mid, th, wexp != nullptr, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      mbconv_pass1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((H + th - 1) / th) * ((W + TW - 1) / TW), N);
  mbconv_pass1_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wexp),
      static_cast<const float*>(bexp), static_cast<const T*>(wdw),
      static_cast<const float*>(bdw), static_cast<float*>(partial), Cin, mid,
      H, W, th);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pass2(const void* x, const void* wexp, const void* bexp,
                 const void* wdw, const void* bdw, const void* wpp,
                 const void* bproj, void* out, int N, int Cin, int mid,
                 int Cout, int H, int W, int th, int residual, cudaStream_t s) {
  const size_t smem = pass2_smem(Cin, mid, Cout, th, wexp != nullptr, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      mbconv_pass2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((H + th - 1) / th) * ((W + TW - 1) / TW), N);
  mbconv_pass2_kernel<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wexp),
      static_cast<const float*>(bexp), static_cast<const T*>(wdw),
      static_cast<const float*>(bdw), static_cast<const T*>(wpp),
      static_cast<const float*>(bproj), static_cast<T*>(out), Cin, mid, Cout,
      H, W, th, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N,Cin,H,W]; wexp [mid,Cin] or NULL (no expand); bexp [mid] fp32;
// wdw [mid,3,3]; bdw [mid] fp32; partial [N, tiles, mid] fp32 with
// tiles = ceil(H/th) * ceil(W/32).  T is bf16 when is_bf16, else fp32.
extern "C" int mbconv_pass1(const void* x, const void* wexp, const void* bexp,
                            const void* wdw, const void* bdw, void* partial,
                            int N, int Cin, int mid, int H, int W, int th,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_pass1<__nv_bfloat16>(x, wexp, bexp, wdw, bdw, partial, N, Cin,
                                       mid, H, W, th, s);
  return launch_pass1<float>(x, wexp, bexp, wdw, bdw, partial, N, Cin, mid, H,
                             W, th, s);
}

// wpp [N,mid,Cout] (per-image SE-gated projection); bproj [Cout] fp32;
// out [N,Cout,H,W].  residual adds x (needs Cin == Cout).
extern "C" int mbconv_pass2(const void* x, const void* wexp, const void* bexp,
                            const void* wdw, const void* bdw, const void* wpp,
                            const void* bproj, void* out, int N, int Cin,
                            int mid, int Cout, int H, int W, int th,
                            int residual, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_pass2<__nv_bfloat16>(x, wexp, bexp, wdw, bdw, wpp, bproj, out,
                                       N, Cin, mid, Cout, H, W, th, residual, s);
  return launch_pass2<float>(x, wexp, bexp, wdw, bdw, wpp, bproj, out, N, Cin,
                             mid, Cout, H, W, th, residual, s);
}

// Shared-memory bytes of the larger of the two passes at tile height th.
extern "C" long long mbconv_smem_bytes(int Cin, int mid, int Cout, int th,
                                       int expand, int is_bf16) {
  const int elt = is_bf16 ? 2 : 4;
  const size_t a = pass1_smem(Cin, mid, th, expand, elt);
  const size_t b = pass2_smem(Cin, mid, Cout, th, expand, elt);
  return static_cast<long long>(a > b ? a : b);
}
