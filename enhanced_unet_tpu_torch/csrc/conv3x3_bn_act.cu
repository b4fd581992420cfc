// Fused 3x3 SAME stride-1 convolution + folded BatchNorm + optional ReLU,
// NHWC activations, as an implicit GEMM (pixels x Cout, K = 9 * Cin).
//
// Replaces enhanced_unet_tpu/ops/pallas/conv_fused.py::fused_conv3x3_bn_relu.
// out[n,h,w,co] = act(sum_{dy,dx,ci} x[n,h+dy-1,w+dx-1,ci] * w[co,dy,dx,ci]
//                     * scale[co] + shift[co]), zero padding, fp32 sums,
// `y * scale + shift` rounded as two operations, cast to the input type.
// Weights arrive as [Cout][3][3][Cin] (OHWI): K-contiguous, as x is.
//
// What bounds each layer on the H100.  The serving path's wide layers
// (fusion head 256->128 and 128->64, the decoders' 136..688-channel
// inputs) do hundreds of FLOPs per byte they must move, above the card's
// bf16 ridge of about 295: only the tensor cores at their full rate, i.e.
// `wgmma`, approach their bound.  An implicit GEMM then lives or dies by
// what it reads per output pixel: from L2, 9 * Cin * N_tile * 2 / M_tile
// bytes of weights plus the haloed input tile; from shared memory, the B
// operand that every wgmma re-reads (1/32 byte per multiply-add) plus the
// A fragments.  The entry layer (Cin 6 -> 256) does about 53 FLOPs per
// byte and is bound by the bytes of its 256-channel output; the narrow
// decoder layers (16..48 channels) by their bytes too.
//
// Four kernels, chosen by shape alone (`ops/kernels/conv_fused.py`):
//
// - wgmma (bf16, Cin % 8 == 0, Cout % 8 == 0): persistent and warp-
//   specialised.  One producer thread issues TMA copies; two consumer
//   warpgroups run `wgmma.mma_async` m64nNk16 with A (activations) from
//   registers and B (weights) from swizzled shared memory.  A tile is
//   8*MT x 16 output pixels (MT = 1, 2 or 4: 128, 256 or 512 pixels, the
//   weights read from L2 once per tile) by N = all of Cout up to 128 (the
//   input read once, not Cout/64 times); `wgmma_tile` picks MT and the
//   channel chunk KC (16, 32 or 64) from the shape.  K runs as (chunk,
//   tap) stages.  The haloed input chunk ((8*MT+2) x 18 pixels x KC
//   channels) arrives by one 4-D TMA box at (h0-1, w0-1): out-of-range
//   rows, columns and channels are filled with zeros, which is the SAME
//   padding and the ragged-Cin mask for free; it is double-buffered, and
//   the producer runs ahead into the next tile.  Each stage's weights
//   ([N][KC] of one tap) arrive by TMA into a ring of STAGES buffers
//   tracked by mbarriers.  A shifted tap starts at an arbitrary pixel,
//   which no shared-memory A descriptor expresses, so each warp loads its
//   A fragments with `ldmatrix` at per-row addresses shifted by the tap
//   (one m16 = 16 pixels of one output row); a warp's MT rows are
//   consecutive, so the three taps of one column share all but one row of
//   fragments.  Each warp applies scale/shift/ReLU in registers, stages
//   its bf16 rows in shared memory and writes them with TMA stores, which
//   clip what lies outside the image and Cout.
// - smallc (bf16, Cin <= 7, Cout % 8 == 0; the fusion head's 6 -> 256
//   entry layer): a tile is 64 pixels of one image row; its three haloed
//   input rows are read coalesced into shared memory, the 3x3xCin patch is
//   packed into one K of 64 (54 used at Cin 6), and the 64 pixels take four
//   k16 steps for every 64 output channels (`wgmma` m64n64k16, weights
//   [Cout][64] resident in shared memory for a persistent CTA).  Each 64 x
//   64 output box is staged and written by a TMA store.  Its goal is the
//   output's byte bound.
// - mma (bf16, every other shape, e.g. Cin 70): `mma.sync.m16n8k16`,
//   synchronous loads, a 128-pixel x 64-channel tile.
// - f32: CUDA cores in fp32 (the tensor cores would round fp32 operands to
//   TF32); each thread keeps 8 pixels x 4 channels of sums in registers.
//
// Plain C interface (no PyTorch headers), loaded with ctypes.  The TMA
// tensor maps are encoded on the host by `cuTensorMapEncodeTiled`, found
// through `cudaGetDriverEntryPoint` (no -lcuda), and passed to the kernels
// as `__grid_constant__` parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float epilogue(float acc, float sc, float sh, int relu) {
  // y * scale + shift rounded as two operations, as the plain version does
  const float v = __fadd_rn(__fmul_rn(acc, sc), sh);
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- Hopper primitives: mbarrier, TMA, ldmatrix, wgmma --------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spins until the phase of parity `parity` has completed; a wait of more
// than about 2^32 cycles (seconds) traps, so a broken pipeline fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (!start) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// waits until at most N bulk store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// wgmma B descriptor of a K-major [rows][ROW bytes] bf16 tile, ROW = 128,
// 64 or 32 bytes swizzled over ROW bytes as TMA writes it, 1024-byte
// aligned: SBO = 8 rows between 8-row groups (LBO is unused for a swizzled
// K-major operand), layout 1, 2, 3 for the 128-, 64-, 32-byte swizzle.
// Adding 2 advances K by 16.
template <int ROW = 128>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t layout = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * ROW >> 4) << 32) | (layout << 62);
}

// the 16-byte chunk `chunk` of line `line` of a tile with ROW-byte lines,
// as TMA's ROW-byte swizzle places it: address bits [4, 4 + log2(ROW/16))
// XOR bits [7, ...) of a 1024-byte aligned tile
template <int ROW>
__device__ __forceinline__ uint32_t swizzled(int line, int chunk) {
  return line * ROW + ((chunk ^ ((line * ROW >> 7) & (ROW / 16 - 1))) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulators across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x N] += A[64 x 16] (registers, the mma.m16n8k16 A fragment of each
// warp's 16 rows) * B[16 x N] (shared memory, descriptor), fp32 sums
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc);

template <> __device__ __forceinline__ void
wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <> __device__ __forceinline__ void
wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <> __device__ __forceinline__ void
wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <> __device__ __forceinline__ void
wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <> __device__ __forceinline__ void
wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// ---- bf16 on wgmma: warp-specialised, TMA ring ----------------------------

constexpr int STAGES = 4;       // weight ring depth, one (chunk, tap) per stage
constexpr int TW = 16;          // output columns per tile: one m16 per output row
constexpr int WG_THREADS = 384; // two consumer warpgroups, then the producer's

constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }

// KC input channels per chunk (16, 32 or 64): one line of ROW = 2 * KC
// bytes per pixel, swizzled over ROW bytes
template <int BN, int MT, int KC>
struct WgTile {
  static constexpr int ROW = 2 * KC;
  static constexpr int KK = KC / 16;                 // k16 steps per stage
  static constexpr int TH = 8 * MT;                  // 2 warpgroups x MT m64 x 4 rows
  static constexpr int HALO = (TH + 2) * (TW + 2);   // haloed pixels per chunk
  static constexpr int X_BYTES = HALO * ROW;
  static constexpr int X_STRIDE = align1k(X_BYTES);
  static constexpr int W_BYTES = BN * ROW;
  static constexpr int W_STRIDE = align1k(W_BYTES);
  // output staging: per consumer warp two buffers of one m16 (16 pixels),
  // each one 64-channel TMA store box or two, [16 px][128 B] swizzled
  static constexpr int SLABS = (BN + 63) / 64;
  static constexpr int STG_BUF = SLABS * 16 * 128;
  static constexpr int STG_OFF = 2 * X_STRIDE + STAGES * W_STRIDE;
  static constexpr int BAR_OFF = STG_OFF + 8 * 2 * STG_BUF;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "shared memory");
};

// Persistent: CTA b takes tiles b, b + gridDim.x, ...  A tile is (image n,
// TH x 16 output pixels at (h0, w0), BN output channels at co0); the
// producer runs ahead into the next tile while the consumers finish one.
template <int BN, int MT, int KC>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                            const __grid_constant__ CUtensorMap tmap_w,
                            const __grid_constant__ CUtensorMap tmap_out,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            int H, int Cin, int Cout, int relu, int tiles_w,
                            int tiles_h, int tiles_c, int tiles) {
  using T = WgTile<BN, MT, KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t xs = smem_u32(smem);            // [2][X_STRIDE]: haloed input chunks
  const uint32_t ws = xs + 2 * T::X_STRIDE;      // [STAGES][W_STRIDE]: weight ring
  const uint32_t bars = xs + T::BAR_OFF;
  // barriers: full_w[s], empty_w[s], full_x[b], empty_x[b]
  auto full_w = [&](int s) { return bars + 8 * s; };
  auto empty_w = [&](int s) { return bars + 8 * (STAGES + s); };
  auto full_x = [&](int b) { return bars + 8 * (2 * STAGES + b); };
  auto empty_x = [&](int b) { return bars + 8 * (2 * STAGES + 2 + b); };
  // tile -> (n, h0, w0, co0), channel slice fastest: neighbouring CTAs
  // share their weights and input halos in L2
  auto origin = [&](int tile, int& n, int& h0, int& w0, int& co0) {
    co0 = (tile % tiles_c) * BN;
    tile /= tiles_c;
    w0 = (tile % tiles_w) * TW;
    tile /= tiles_w;
    h0 = (tile % tiles_h) * T::TH;
    n = tile / tiles_h;
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nchunks = (Cin + KC - 1) / KC;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 2);      // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(full_x(b), 1);
      mbar_init(empty_x(b), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one thread keeps the TMA copies in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int step = 0, xc = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int n, h0, w0, co0;
        origin(tile, n, h0, w0, co0);
        for (int c = 0; c < nchunks; ++c, ++xc) {
          const int xb = xc & 1;
          mbar_wait(empty_x(xb), ((xc >> 1) & 1) ^ 1);
          mbar_expect_tx(full_x(xb), T::X_BYTES);
          tma_load_4d(xs + xb * T::X_STRIDE, &tmap_x, full_x(xb), c * KC, w0 - 1, h0 - 1, n);
          for (int i = 0; i < 9; ++i, ++step) {   // taps column by column: dx, then dy
            const int s = step % STAGES;
            mbar_wait(empty_w(s), ((step / STAGES) & 1) ^ 1);
            mbar_expect_tx(full_w(s), T::W_BYTES);
            tma_load_3d(ws + s * T::W_STRIDE, &tmap_w, full_w(s), c * KC, (i % 3) * 3 + i / 3,
                        co0);
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: ldmatrix A, wgmma against the ring ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wq = warp & 3;
    const bool leader = wq == 0 && lane == 0;
    // ldmatrix.x4 rows: lanes 0-7 / 8-15 pixels 0-7 / 8-15 at k 0-7, lanes
    // 16-31 the same pixels at k 8-15: the A fragment of an m16 k16 tile
    const int px = (lane & 7) + (lane & 8);
    const int khi = lane >> 4;
    const int g = lane >> 2, t = lane & 3;
    uint8_t* stg = smem + T::STG_OFF + warp * 2 * T::STG_BUF;   // this warp's
    int step = 0, xc = 0, stores = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int n, h0, w0, co0;
      origin(tile, n, h0, w0, co0);
      float acc[MT][BN / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;

      for (int c = 0; c < nchunks; ++c, ++xc) {
        const int xb = xc & 1;
        mbar_wait(full_x(xb), (xc >> 1) & 1);
        const uint32_t xbase = xs + xb * T::X_STRIDE;
        // this warp's MT output rows are consecutive, so the three taps of
        // one column (dy = 0, 1, 2) share all but one haloed row: a ring of
        // MT rows of A fragments, one new row per tap
        uint32_t a[MT][T::KK][4];
        auto load_row = [&](uint32_t (&r)[T::KK][4], int hrow, int dx) {
          const int line = (wg * 4 * MT + wq * MT + hrow) * (TW + 2) + px + dx;
#pragma unroll
          for (int kk = 0; kk < T::KK; ++kk)
            ldsm_x4(r[kk], xbase + swizzled<T::ROW>(line, 2 * kk + khi));
        };
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) load_row(a[mt], mt, dx);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy, ++step) {
            if (dy > 0) load_row(a[(MT - 1 + dy) % MT], MT - 1 + dy, dx);
            const int s = step % STAGES;
            mbar_wait(full_w(s), (step / STAGES) & 1);
            const uint64_t desc = b_desc<T::ROW>(ws + s * T::W_STRIDE);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) reg_fence(acc[mt]);
            wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int kk = 0; kk < T::KK; ++kk)
                wgmma<BN>(acc[mt], a[(mt + dy) % MT][kk], desc + 2 * kk);
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) reg_fence(acc[mt]);
            if (leader) mbar_arrive(empty_w(s));
          }
        }
        if (leader) mbar_arrive(empty_x(xb));
      }

      // ---- epilogue, each warp alone, one output row (m16) at a time:
      // scale/shift/ReLU, bf16 into a staging buffer, TMA store (rows,
      // columns and channels out of range are clipped) ----
#pragma unroll
      for (int mt = 0; mt < MT; ++mt, ++stores) {
        uint8_t* sb = stg + (stores & 1) * T::STG_BUF;
        if (lane == 0) bulk_wait_read<1>();   // the store of two rows ago has read sb
        __syncwarp();
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int oc = co0 + 8 * j + 2 * t;
          const float sc0 = oc < Cout ? scale[oc] : 0.f, sc1 = oc < Cout ? scale[oc + 1] : 0.f;
          const float sh0 = oc < Cout ? shift[oc] : 0.f, sh1 = oc < Cout ? shift[oc + 1] : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = g + 8 * half;
            *reinterpret_cast<uint32_t*>(sb + (j / 8) * 2048 + p * 128 +
                                         (((j & 7) ^ (p & 7)) << 4) + t * 4) =
                pack_bf16x2(epilogue(acc[mt][4 * j + 2 * half], sc0, sh0, relu),
                            epilogue(acc[mt][4 * j + 2 * half + 1], sc1, sh1, relu));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // TMA reads sb
        __syncwarp();
        if (lane == 0) {
          const int hh = h0 + wg * 4 * MT + wq * MT + mt;
#pragma unroll
          for (int slab = 0; slab < T::SLABS; ++slab)
            if (co0 + 64 * slab < Cout)
              tma_store_4d(&tmap_out, smem_u32(sb + slab * 2048), co0 + 64 * slab, w0, hh, n);
          bulk_commit();
        }
      }
    }
    if (lane == 0) bulk_wait_all();   // the last stores are done before the CTA exits
  }
}

// ---- bf16 small Cin: the 3x3xCin patch packed into one K of 64 ------------

constexpr int SC_K = 64;        // packed K: 9 * Cin <= 64
constexpr int SC_NB = 64;       // output channels per wgmma pass and per store box
constexpr int SC_PX = 64;       // pixels per tile (one m64), in one image row
constexpr int SC_THREADS = 128;
constexpr int SC_CTAS_PER_SM = 3;
constexpr int SC_IN = 3 * (SC_PX + 2) * 7;   // a tile's three haloed input rows, Cin <= 7
constexpr int SC_LOADS = (SC_IN + SC_THREADS - 1) / SC_THREADS;

// weights [cout_pad][64], the patch [64 px][64] and two staging buffers
// [64 px][64 ch] (128-byte rows, 128-byte swizzle), then scale/shift
// [cout_pad] fp32 and the input rows
int smallc_smem(int cout_pad) {
  return (cout_pad + 3 * SC_PX) * SC_K * 2 + cout_pad * 8 + SC_IN * 2 + 1024;
}

__global__ void __launch_bounds__(SC_THREADS)
conv3x3_bn_act_smallc_kernel(const __grid_constant__ CUtensorMap tmap_out,
                             const uint16_t* __restrict__ x, const uint4* __restrict__ wk,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift, int N, int H, int W, int Cin,
                             int Cout, int cout_pad, int relu) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int16_t kofs[SC_K];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wsm = smem;                           // [cout_pad][64] swizzled
  uint8_t* patch = wsm + cout_pad * SC_K * 2;    // [64 px][64 k] swizzled
  uint8_t* stg = patch + SC_PX * SC_K * 2;       // [2][64 px][64 ch] swizzled
  float* scs = reinterpret_cast<float*>(stg + 2 * SC_PX * 128);   // [cout_pad]
  float* shs = scs + cout_pad;                                    // [cout_pad]
  uint16_t* xin = reinterpret_cast<uint16_t*>(shs + cout_pad);    // [3][(64+2)*Cin]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_len = (SC_PX + 2) * Cin;   // values in one haloed input row
  if (tid < SC_K) {   // patch column k reads input row dy, pixel line + dx, channel ci
    const int tap = tid / Cin, ci = tid - tap * Cin;
    kofs[tid] = tid < 9 * Cin ? (tap / 3) * row_len + (tap % 3) * Cin + ci : -1;
  }
  for (int i = tid; i < cout_pad * 8; i += SC_THREADS) {
    const int row = i >> 3, ch = i & 7;
    *reinterpret_cast<uint4*>(wsm + row * 128 + ((ch ^ (row & 7)) << 4)) = wk[i];
  }
  for (int i = tid; i < cout_pad; i += SC_THREADS) {
    scs[i] = i < Cout ? scale[i] : 0.f;
    shs[i] = i < Cout ? shift[i] : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads wsm
  __syncthreads();

  // a tile is 64 pixels of one image row; the input it reads is three
  // haloed rows of (64 + 2) * Cin contiguous values each, loaded coalesced
  const int tiles_w = (W + SC_PX - 1) / SC_PX;
  const int ntiles = tiles_w * H * N;
  // this thread's loads: value e = tid + i * SC_THREADS of the three rows,
  // row r, pixel offset xo from w0 - 1, offset off in the row
  int lr[SC_LOADS], lxo[SC_LOADS], loff[SC_LOADS];
#pragma unroll
  for (int i = 0; i < SC_LOADS; ++i) {
    const int e = tid + i * SC_THREADS;
    lr[i] = e < 3 * row_len ? e / row_len : 3;   // 3: no value
    loff[i] = e - lr[i] * row_len;
    lxo[i] = loff[i] / Cin;
  }
  auto fetch = [&](int tile, uint32_t (&v)[SC_LOADS]) {
    const int w0 = (tile % tiles_w) * SC_PX, nh = tile / tiles_w, h = nh % H;
#pragma unroll
    for (int i = 0; i < SC_LOADS; ++i) {
      const int y = h + lr[i] - 1, xx = w0 - 1 + lxo[i];
      v[i] = lr[i] < 3 && y >= 0 && y < H && xx >= 0 && xx < W
                 ? x[((size_t)(nh + lr[i] - 1) * W + w0 - 1) * Cin + loff[i]] : 0u;
    }
  };
  const int line = tid & 63, kpart = tid >> 6;   // patch builder: pixel, k half
  const int g = lane >> 2, t = lane & 3;
  uint32_t v[SC_LOADS];
  if (blockIdx.x < ntiles) fetch(blockIdx.x, v);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int w0 = (tile % tiles_w) * SC_PX, nh = tile / tiles_w;
#pragma unroll
    for (int i = 0; i < SC_LOADS; ++i)
      if (lr[i] < 3) xin[tid + i * SC_THREADS] = v[i];
    __syncthreads();
    // the next tile's loads fly while this tile is multiplied and stored
    if (tile + (int)gridDim.x < ntiles) fetch(tile + gridDim.x, v);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int k = kpart * 32 + kc * 8 + e;
        const int o0 = kofs[k], o1 = kofs[k + 1];
        const uint32_t lo = o0 >= 0 ? xin[line * Cin + o0] : 0u;
        const uint32_t hi = o1 >= 0 ? xin[line * Cin + o1] : 0u;
        q[e / 2] = lo | (hi << 16);
      }
      const int chunk = kpart * 4 + kc;
      *reinterpret_cast<uint4*>(patch + line * 128 + ((chunk ^ (line & 7)) << 4)) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
    uint32_t a[4][4];
    {
      const int row = warp * 16 + (lane & 7) + (lane & 8);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(a[kk], smem_u32(patch) + row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4));
    }
    for (int nb = 0; nb < cout_pad; nb += SC_NB, buf ^= 1) {
      float acc[SC_NB / 2];
#pragma unroll
      for (int i = 0; i < SC_NB / 2; ++i) acc[i] = 0.f;
      const uint64_t desc = b_desc(smem_u32(wsm) + nb * 128);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma<SC_NB>(acc, a[kk], desc + 2 * kk);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      // the store that last read this staging buffer (two boxes ago) is done
      if (tid == 0) bulk_wait_read<1>();
      __syncthreads();
      uint8_t* sb = stg + buf * SC_PX * 128;
#pragma unroll
      for (int j = 0; j < SC_NB / 8; ++j) {
        const int oc = nb + 8 * j + 2 * t;
        const float sc0 = scs[oc], sc1 = scs[oc + 1], sh0 = shs[oc], sh1 = shs[oc + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = warp * 16 + g + 8 * half;
          *reinterpret_cast<uint32_t*>(sb + p * 128 + ((j ^ (p & 7)) << 4) + t * 4) =
              pack_bf16x2(epilogue(acc[4 * j + 2 * half], sc0, sh0, relu),
                          epilogue(acc[4 * j + 2 * half + 1], sc1, sh1, relu));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // TMA reads sb
      __syncthreads();
      if (tid == 0) {   // pixels past W and channels past Cout are clipped
        tma_store_3d(&tmap_out, smem_u32(sb), nb, w0, nh);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ---- bf16 on mma.sync: every other shape -----------------------------------

constexpr int TH = 8;      // output rows per block
constexpr int NT = 256;    // threads per block
constexpr int HALO = (TH + 2) * (TW + 2);
constexpr int MMA_BN = 64;       // output channels per block
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
conv3x3_bn_act_mma_kernel(const uint16_t* __restrict__ x,
                           const uint16_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int Cin, int Cout, int relu, int tiles_w, int vec) {
  __shared__ __align__(16) uint16_t xs[HALO * LD];      // [pixel][ci]
  __shared__ __align__(16) uint16_t ws[9 * MMA_BN * LD];    // [tap][co][ci]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const int wm = warp >> 1;                // output rows 2*wm and 2*wm + 1
  const int wn = warp & 1;                 // output channels wn*32 .. wn*32 + 31
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * MMA_BN;
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
    for (int i = tid; i < MMA_BN * 9 * 2; i += NT) {
      const int grp = i & 1, r = i >> 1;   // r = co * 9 + tap
      const int tap = r % 9, co = r / 9;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (co0 + co < Cout)
        v = load8(w + ((size_t)(co0 + co) * 9 + tap) * Cin, c0 + grp * 8, Cin, vec);
      *reinterpret_cast<uint4*>(&ws[(tap * MMA_BN + co) * LD + grp * 8]) = v;
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
        const uint16_t* q = &ws[(tap * MMA_BN + wn * 32 + nt * 8 + g) * LD + 2 * t];
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

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 map whose inner box of `box[0]` channels (32, 64 or 128 bytes) is
// swizzled over its own width; zero fill out of range
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapL2promotion l2) {
  EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box[0] == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box[0] == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                  dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int num_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The wgmma kernel's tile: N = `*bn` output channels (all of Cout up to
// 128), 8 * `*mt` x 16 output pixels, `*kc` input channels per chunk.
// Pixel tile: 512 for N <= 48 (half the weight traffic per pixel; at N =
// 64 its 128 accumulators and 4 rows of A fragments do not fit the
// registers and ptxas serialises the wgmmas) where that still gives two
// tiles per SM, else 256, else 128 where fewer tiles than SMs would leave
// SMs idle.  Chunk: 16 or 32 channels where Cin is no more (and N <= 32),
// so a narrow layer does not stream and multiply 64-channel chunks of zeros.
void wgmma_tile(int N, int H, int W, int Cin, int Cout, int sms, int* bn, int* mt, int* kc) {
  *bn = Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 48 ? 48 : Cout <= 64 ? 64 : 128;
  const long long cols = (long long)((W + TW - 1) / TW) * N * ((Cout + *bn - 1) / *bn);
  auto tiles = [&](int m) { return cols * ((H + 8 * m - 1) / (8 * m)); };
  *mt = *bn <= 48 && tiles(4) >= 2 * sms ? 4 : tiles(2) >= sms ? 2 : 1;
  *kc = *bn <= 32 && Cin <= 16 ? 16 : *bn <= 32 && Cin <= 32 ? 32 : 64;
}

template <int BN, int MT, int KC>
int launch_wgmma(const void* x, const void* w, const float* sc, const float* sh,
                 void* out, int N, int H, int W, int Cin, int Cout, int relu, int sms,
                 cudaStream_t s) {
  using T = WgTile<BN, MT, KC>;
  const cuuint64_t c = Cin;
  const cuuint64_t xdims[4] = {c, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {c * 2, c * 2 * W, c * 2 * W * H};
  const cuuint32_t xbox[4] = {KC, TW + 2, T::TH + 2, 1};
  const cuuint64_t wdims[3] = {c, 9, (cuuint64_t)Cout};
  const cuuint64_t wstrides[2] = {c * 2, c * 2 * 9};
  const cuuint32_t wbox[3] = {KC, 1, BN};
  const cuuint64_t o = Cout;
  const cuuint64_t odims[4] = {o, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t ostrides[3] = {o * 2, o * 2 * W, o * 2 * W * H};
  const cuuint32_t obox[4] = {64, TW, 1, 1};
  CUtensorMap tx, tw, to;
  if (!encode(&tx, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode(&tw, w, 3, wdims, wstrides, wbox, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode(&to, out, 4, odims, ostrides, obox, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_bn_act_wgmma_kernel<BN, MT, KC>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + T::TH - 1) / T::TH;
  const int tiles_c = (Cout + BN - 1) / BN;
  const int tiles = tiles_w * tiles_h * tiles_c * N;
  kernel<<<tiles < sms ? tiles : sms, WG_THREADS, T::SMEM, s>>>(
      tx, tw, to, sc, sh, H, Cin, Cout, relu, tiles_w, tiles_h, tiles_c, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The wgmma kernel's tile for a shape on this card: N = `*bn` output
// channels, 8 * `*mt` x 16 output pixels, `*kc` input channels per chunk
// (see `wgmma_tile`).  Returns a cudaError_t.
int conv3x3_bn_act_wgmma_tile(int N, int H, int W, int Cin, int Cout, int* bn, int* mt,
                              int* kc) {
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  wgmma_tile(N, H, W, Cin, Cout, sms, bn, mt, kc);
  return 0;
}

// x [N,H,W,Cin] bf16 with Cin % 8 == 0 and 16-byte aligned, w [Cout,3,3,Cin]
// bf16, Cout % 8 == 0; scale/shift [Cout] fp32; out [N,H,W,Cout] bf16.
// Returns the cudaError_t of the launch (0 on success).
int conv3x3_bn_act_wgmma(const void* x, const void* w, const void* scale,
                         const void* shift, void* out, int N, int H, int W, int Cin,
                         int Cout, int relu, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int bn, mt, kc;
  wgmma_tile(N, H, W, Cin, Cout, sms, &bn, &mt, &kc);
#define CONV_WGMMA(B, M, K) \
  if (bn == B && mt == M && kc == K) \
  return launch_wgmma<B, M, K>(x, w, sc, sh, out, N, H, W, Cin, Cout, relu, sms, s)
#define CONV_WGMMA_KC(B, M) CONV_WGMMA(B, M, 16); CONV_WGMMA(B, M, 32); CONV_WGMMA(B, M, 64)
  CONV_WGMMA_KC(16, 4); CONV_WGMMA_KC(16, 2); CONV_WGMMA_KC(16, 1);
  CONV_WGMMA_KC(32, 4); CONV_WGMMA_KC(32, 2); CONV_WGMMA_KC(32, 1);
  CONV_WGMMA(48, 4, 64); CONV_WGMMA(48, 2, 64); CONV_WGMMA(48, 1, 64);
  CONV_WGMMA(64, 2, 64); CONV_WGMMA(64, 1, 64);
  CONV_WGMMA(128, 2, 64); CONV_WGMMA(128, 1, 64);
#undef CONV_WGMMA_KC
#undef CONV_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [N,H,W,Cin] bf16 with Cin <= 7; wk [cout_pad][64] bf16, the weights
// with K = (3*dy + dx) * Cin + ci, zero past 9 * Cin and Cout, cout_pad a
// multiple of 64; Cout % 8 == 0; scale/shift [Cout] fp32; out bf16,
// 16-byte aligned.
int conv3x3_bn_act_smallc(const void* x, const void* wk, const void* scale,
                          const void* shift, void* out, int N, int H, int W, int Cin,
                          int Cout, int cout_pad, int relu, void* stream) {
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cuuint64_t odims[3] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)N * H};
  const cuuint64_t ostrides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cout * 2 * W};
  const cuuint32_t obox[3] = {SC_NB, SC_PX, 1};
  CUtensorMap to;
  if (!encode(&to, out, 3, odims, ostrides, obox, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smallc_smem(cout_pad);
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_bn_act_smallc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (W + SC_PX - 1) / SC_PX * H * N;
  const int grid = tiles < sms * SC_CTAS_PER_SM ? tiles : sms * SC_CTAS_PER_SM;
  conv3x3_bn_act_smallc_kernel<<<grid, SC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      to, static_cast<const uint16_t*>(x), static_cast<const uint4*>(wk),
      static_cast<const float*>(scale), static_cast<const float*>(shift), N, H, W, Cin,
      Cout, cout_pad, relu);
  return static_cast<int>(cudaGetLastError());
}

// x [N,H,W,Cin] bf16, w [Cout,3,3,Cin] bf16, any Cin and Cout.
int conv3x3_bn_act_mma(const void* x, const void* w, const void* scale,
                       const void* shift, void* out, int N, int H, int W, int Cin,
                       int Cout, int relu, void* stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(tiles_w * tiles_h, (Cout + MMA_BN - 1) / MMA_BN, N);
  conv3x3_bn_act_mma_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, relu, tiles_w, vec);
  return static_cast<int>(cudaGetLastError());
}

// x [N,H,W,Cin] fp32, w [Cout,3,3,Cin] fp32, any Cin and Cout.
int conv3x3_bn_act_f32(const void* x, const void* w, const void* scale, const void* shift,
                       void* out, int N, int H, int W, int Cin, int Cout, int relu,
                       void* stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (Cout + CO_T - 1) / CO_T, N);
  conv3x3_bn_act_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), H, W, Cin, Cout, relu, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
