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
// [16,24,256,256] 100.7 MB, 30 us at 3.35 TB/s.  The design streams rows:
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

namespace {

constexpr int NT = 256;             // threads per block
constexpr int WPB = NT / 32;        // warps (work items in flight) per block
constexpr int VEC = 8;              // columns per lane: one 16-byte vector
constexpr int RUN = 32 * VEC;       // columns per warp run
constexpr int SH = 16;              // output rows per strip
constexpr int PF = 8;               // rows in flight ahead of the arithmetic
constexpr int MAX_BLOCKS = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// One input row as a lane loaded it: its 8 columns (bf16 pairs) and, for
// the run's end lanes, the neighbouring run's edge column (dw3x3 only).
struct Raw {
  uint4 q;
  unsigned int e;
};

// One window row in fp32: the lane's 8 columns and, for dw3x3, the columns
// left and right of them.
struct Row {
  float v[VEC];
  float l, r;
};

__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&p);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool row_in(int row, int last, int H) {
  return row >= 0 && row < H && row <= last;
}

// The run's edge column of row `row` for the end lanes (dw3x3), else 0.
template <bool kHalo>
__device__ __forceinline__ unsigned int load_edge(const bf16* __restrict__ xp, int row,
                                                  int last, int H, int W, int edge_col) {
  if (!kHalo || !row_in(row, last, H) || edge_col < 0 || edge_col >= W) return 0u;
  return __ldg(reinterpret_cast<const unsigned short*>(xp + (size_t)row * W) + edge_col);
}

// Row `row` of the plane at xp into registers, zero outside [0, H) and past
// `last` (the strip's last input row).  kVec: one 16-byte load a lane
// (W % 8 == 0, 16-byte aligned rows); else eight 2-byte loads.  Columns
// past W are zero.
template <bool kVec, bool kHalo>
__device__ __forceinline__ Raw load_row(const bf16* __restrict__ xp, int row, int last,
                                        int H, int W, int col, int edge_col) {
  Raw t;
  t.q = make_uint4(0u, 0u, 0u, 0u);
  t.e = load_edge<kHalo>(xp, row, last, H, W, edge_col);
  if (!row_in(row, last, H)) return t;
  const bf16* rp = xp + (size_t)row * W;
  if (kVec) {
    if (col < W) t.q = __ldg(reinterpret_cast<const uint4*>(rp + col));
  } else {
    const unsigned short* rs = reinterpret_cast<const unsigned short*>(rp);
    unsigned int h[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) h[k] = col + k < W ? __ldg(rs + col + k) : 0u;
    t.q = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                     h[6] | h[7] << 16);
  }
  return t;
}

// Put row `row` in flight into ring slot t (kVec: its 16 bytes by cp.async
// into the lane's shared-memory stage `slot`, zero-filled where load_row
// gives zero, one commit group a row; else into registers).
template <bool kVec, bool kHalo>
__device__ __forceinline__ void fetch(Raw& t, uint4* slot, const bf16* __restrict__ xp,
                                      int row, int last, int H, int W, int col,
                                      int edge_col) {
  if constexpr (kVec) {
    const bool ok = row_in(row, last, H) && col < W;
    const bf16* src = ok ? xp + (size_t)row * W + col : xp;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(slot)), "l"(src), "r"(ok ? 16 : 0) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    t.e = load_edge<kHalo>(xp, row, last, H, W, edge_col);
  } else {
    t = load_row<false, kHalo>(xp, row, last, H, W, col, edge_col);
  }
}

// The oldest row in flight, in ring slot t: kVec waits for its commit group
// (PF - 1 younger ones stay in flight) and reads the lane's 16 bytes back.
template <bool kVec>
__device__ __forceinline__ void take(Raw& t, const uint4* slot) {
  if constexpr (kVec) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PF - 1) : "memory");
    t.q = *slot;
  }
}

// bf16 pairs to fp32, and for dw3x3 the neighbour columns from the adjacent
// lanes (the run's end lanes take the edge value they loaded).
template <bool kHalo>
__device__ __forceinline__ void unpack(const Raw& t, Row& o, int lane) {
  const unsigned int w4[4] = {t.q.x, t.q.y, t.q.z, t.q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o.v[2 * k] = __uint_as_float(w4[k] << 16);
    o.v[2 * k + 1] = __uint_as_float(w4[k] & 0xffff0000u);
  }
  if (kHalo) {
    const float up = __shfl_up_sync(FULL, o.v[VEC - 1], 1);
    const float down = __shfl_down_sync(FULL, o.v[0], 1);
    const float e = __uint_as_float(t.e << 16);
    o.l = lane == 0 ? e : up;
    o.r = lane == 31 ? e : down;
  }
}

// acc += the three column taps k0..k2 of one window row (dw3x3).
__device__ __forceinline__ void taps3(const Row& x, float k0, float k1, float k2,
                                      float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float left = j == 0 ? x.l : x.v[j - 1];
    const float right = j == VEC - 1 ? x.r : x.v[j + 1];
    acc[j] = fmaf(left, k0, acc[j]);
    acc[j] = fmaf(x.v[j], k1, acc[j]);
    acc[j] = fmaf(right, k2, acc[j]);
  }
}

// One output row of the lane's 8 columns from the window rows a, b, c,
// SiLU, one cast to bf16, stored at op (the output row).
template <bool kRows, bool kVec>
__device__ __forceinline__ void emit(const Row& a, const Row& b, const Row& c,
                                     const float (&k)[9], float bias,
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
    taps3(a, k[0], k[1], k[2], acc);
    taps3(b, k[3], k[4], k[5], acc);
    taps3(c, k[6], k[7], k[8], acc);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = silu(acc[j]);
  if (kVec) {
    if (col < W)
      __stcs(reinterpret_cast<uint4*>(op + col),
             make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                        pack2(acc[4], acc[5]), pack2(acc[6], acc[7])));
  } else {
#pragma unroll
    for (int k2 = 0; k2 < VEC; ++k2)
      if (col + k2 < W) op[col + k2] = __float2bfloat16_rn(acc[k2]);
  }
}

// Output rows [h0, h0 + rows) of one run of one plane; window row i of
// output row h0 + r is input row ws + r + i.  `stage`: the lane's slot 0 of
// its warp's ring in shared memory (slot i at stage + 32 i; kVec only).
template <bool kRows, bool kVec>
__device__ __forceinline__ void stream_strip(const bf16* __restrict__ xp,
                                             bf16* __restrict__ op, const float (&k)[9],
                                             float bias, int h0, int rows, int ws, int H,
                                             int W, int run0, int lane, uint4* stage) {
  constexpr bool kHalo = !kRows;
  constexpr int U = PF % 3 == 0 ? PF : 3 * PF;   // lcm(3, PF)
  const int col = run0 + lane * VEC;
  const int edge_col = lane == 0 ? run0 - 1 : lane == 31 ? run0 + RUN : -1;
  const int last = ws + rows + 1;
  Row win[3];
  Raw ring[PF];
  {
    const Raw t0 = load_row<kVec, kHalo>(xp, ws, last, H, W, col, edge_col);
    const Raw t1 = load_row<kVec, kHalo>(xp, ws + 1, last, H, W, col, edge_col);
#pragma unroll
    for (int i = 0; i < PF; ++i)
      fetch<kVec, kHalo>(ring[i], stage + 32 * i, xp, ws + 2 + i, last, H, W, col, edge_col);
    unpack<kHalo>(t0, win[0], lane);
    unpack<kHalo>(t1, win[1], lane);
  }
  for (int r0 = 0; r0 < rows; r0 += U) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = r0 + i;
      if (r < rows) {
        Raw& t = ring[i % PF];
        uint4* slot = stage + 32 * (i % PF);
        take<kVec>(t, slot);
        unpack<kHalo>(t, win[(i + 2) % 3], lane);
        fetch<kVec, kHalo>(t, slot, xp, ws + r + 2 + PF, last, H, W, col, edge_col);
        emit<kRows, kVec>(win[i % 3], win[(i + 1) % 3], win[(i + 2) % 3], k, bias,
                          op + (size_t)(h0 + r) * W, col, W);
      }
    }
  }
  if constexpr (kVec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
    stream_strip<kRows, kVec>(x + base, out + base, k, bias, h0, rows, ws, H, W,
                              run * RUN, lane, stage);
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
