// The row-streaming loop of the NCHW depthwise 3x3 kernels, shared by
// csrc/depthwise.cu (dw3x3_bias_silu, dw_rows_silu) and csrc/mbconv.cu (pass
// 1 without an expand).  csrc/depthwise.cu's header comment gives the
// design; in short:
// - a warp takes one run of 32 lanes x 16 bytes of columns of one plane
//   down a strip of output rows; a lane moves its columns of a row as one
//   16-byte vector (8 bf16 or 4 fp32 values);
// - the lane keeps a window of three input rows in registers as fp32 and
//   slides it down one row per output row, each input row read once;
// - the +-1 column neighbours (kHalo) come from the adjacent lanes by
//   shuffles, the run's end lanes loading the neighbouring run's edge;
// - the next PF rows are in flight by cp.async in a ring of 16-byte-a-lane
//   stages in shared memory, read back by the lane that copied them;
// - kVec false (W not a multiple of 16 bytes, or a misaligned start): the
//   same loop with element-wise loads and the rows in flight in registers.
// What an output row becomes is the caller's: `emit(r, a, b, c)` gets
// output row r of the strip and its three window rows.
// T is the storage type: uint16_t (bf16 bits) or float.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mbconv_common.cuh"

namespace rowstream {

constexpr unsigned FULL = 0xffffffffu;

// Columns a lane (one 16-byte vector) and a warp run.
template <typename T>
struct Lane {
  static constexpr int VW = 16 / (int)sizeof(T);
  static constexpr int RUN = 32 * VW;
};

// One input row as a lane loaded it: its 16 bytes and, for the run's end
// lanes, the neighbouring run's edge column (its bits; kHalo only).
struct Raw {
  uint4 q;
  uint32_t e;
};

// One window row in fp32: the lane's columns and, for kHalo, the columns
// left and right of them.
template <typename T>
struct Row {
  float v[Lane<T>::VW];
  float l, r;
};

__device__ __forceinline__ bool row_in(int row, int last, int H) {
  return row >= 0 && row < H && row <= last;
}

template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
  if constexpr (sizeof(T) == 2)
    return v;
  else
    return __float_as_uint(v);
}

template <typename T>
__device__ __forceinline__ float value(uint32_t b) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(b << 16);
  else
    return __uint_as_float(b);
}

// The run's edge column of row `row` for the end lanes (kHalo), else 0.
template <typename T, bool kHalo>
__device__ __forceinline__ uint32_t load_edge(const T* __restrict__ xp, int row, int last, int H,
                                              int W, int edge_col) {
  if (!kHalo || !row_in(row, last, H) || edge_col < 0 || edge_col >= W) return 0u;
  return bits<T>(__ldg(xp + (size_t)row * W + edge_col));
}

// Row `row` of the plane at xp into registers, zero outside [0, H), past
// `last` (the strip's last input row) and past W.  kVec: one 16-byte load a
// lane; else element-wise.
template <typename T, bool kVec, bool kHalo>
__device__ __forceinline__ Raw load_row(const T* __restrict__ xp, int row, int last, int H,
                                        int W, int col, int edge_col) {
  constexpr int VW = Lane<T>::VW;
  Raw t;
  t.q = make_uint4(0u, 0u, 0u, 0u);
  t.e = load_edge<T, kHalo>(xp, row, last, H, W, edge_col);
  if (!row_in(row, last, H)) return t;
  const T* rp = xp + (size_t)row * W;
  if constexpr (kVec) {
    if (col < W) t.q = __ldg(reinterpret_cast<const uint4*>(rp + col));
  } else {
    union {
      T h[VW];
      uint4 q;
    } u;
#pragma unroll
    for (int k = 0; k < VW; ++k) u.h[k] = col + k < W ? __ldg(rp + col + k) : T(0);
    t.q = u.q;
  }
  return t;
}

// Put row `row` in flight into ring slot t (kVec: its 16 bytes by cp.async
// into the lane's shared-memory stage `slot`, zero-filled where load_row
// gives zero, one commit group a row; else into registers).
template <typename T, bool kVec, bool kHalo>
__device__ __forceinline__ void fetch(Raw& t, uint4* slot, const T* __restrict__ xp, int row,
                                      int last, int H, int W, int col, int edge_col) {
  if constexpr (kVec) {
    const bool ok = row_in(row, last, H) && col < W;
    mbconv::cp_async16(mbconv::smem_u32(slot), ok ? xp + (size_t)row * W + col : xp,
                       ok ? 16 : 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    t.e = load_edge<T, kHalo>(xp, row, last, H, W, edge_col);
  } else {
    t = load_row<T, false, kHalo>(xp, row, last, H, W, col, edge_col);
  }
}

// The oldest row in flight, in ring slot t: kVec waits for its commit group
// (PF - 1 younger ones stay in flight) and reads the lane's 16 bytes back.
template <int PF, bool kVec>
__device__ __forceinline__ void take(Raw& t, const uint4* slot) {
  if constexpr (kVec) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PF - 1) : "memory");
    t.q = *slot;
  }
}

// The lane's values in fp32 and, for kHalo, the neighbour columns from the
// adjacent lanes (the run's end lanes take the edge value they loaded).
template <typename T, bool kHalo>
__device__ __forceinline__ void unpack(const Raw& t, Row<T>& o, int lane) {
  constexpr int VW = Lane<T>::VW;
  const uint32_t w4[4] = {t.q.x, t.q.y, t.q.z, t.q.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o.v[2 * k] = mbconv::lo_f(w4[k]);
      o.v[2 * k + 1] = mbconv::hi_f(w4[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o.v[k] = __uint_as_float(w4[k]);
  }
  if constexpr (kHalo) {
    const float up = __shfl_up_sync(FULL, o.v[VW - 1], 1);
    const float down = __shfl_down_sync(FULL, o.v[0], 1);
    const float e = value<T>(t.e);
    o.l = lane == 0 ? e : up;
    o.r = lane == 31 ? e : down;
  }
}

// acc += the three column taps k0..k2 of one window row (kHalo).
template <typename T>
__device__ __forceinline__ void taps3(const Row<T>& x, float k0, float k1, float k2,
                                      float (&acc)[Lane<T>::VW]) {
  constexpr int VW = Lane<T>::VW;
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    const float left = j == 0 ? x.l : x.v[j - 1];
    const float right = j == VW - 1 ? x.r : x.v[j + 1];
    acc[j] = fmaf(left, k0, acc[j]);
    acc[j] = fmaf(x.v[j], k1, acc[j]);
    acc[j] = fmaf(right, k2, acc[j]);
  }
}

// Output rows [0, rows) of a strip of one run (columns run0..) of the plane
// at xp; window row i of output row r is input row ws + r + i.  `stage`:
// the lane's slot 0 of its warp's ring of PF stages in shared memory (slot i
// at stage + 32 i; kVec only).  The row loop is unrolled over lcm(3, PF)
// rows, so the window and the ring rotate by renaming, not by moves.
template <typename T, int PF, bool kVec, bool kHalo, typename Emit>
__device__ __forceinline__ void stream_strip(const T* __restrict__ xp, int rows, int ws, int H,
                                             int W, int run0, int lane, uint4* stage,
                                             Emit&& emit) {
  constexpr int U = PF % 3 == 0 ? PF : 3 * PF;
  const int col = run0 + lane * Lane<T>::VW;
  const int edge_col = lane == 0 ? run0 - 1 : lane == 31 ? run0 + Lane<T>::RUN : -1;
  const int last = ws + rows + 1;
  Row<T> win[3];
  Raw ring[PF];
  {
    const Raw t0 = load_row<T, kVec, kHalo>(xp, ws, last, H, W, col, edge_col);
    const Raw t1 = load_row<T, kVec, kHalo>(xp, ws + 1, last, H, W, col, edge_col);
#pragma unroll
    for (int i = 0; i < PF; ++i)
      fetch<T, kVec, kHalo>(ring[i], stage + 32 * i, xp, ws + 2 + i, last, H, W, col, edge_col);
    unpack<T, kHalo>(t0, win[0], lane);
    unpack<T, kHalo>(t1, win[1], lane);
  }
  for (int r0 = 0; r0 < rows; r0 += U) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = r0 + i;
      if (r < rows) {
        Raw& t = ring[i % PF];
        uint4* slot = stage + 32 * (i % PF);
        take<PF, kVec>(t, slot);
        unpack<T, kHalo>(t, win[(i + 2) % 3], lane);
        fetch<T, kVec, kHalo>(t, slot, xp, ws + r + 2 + PF, last, H, W, col, edge_col);
        emit(r, win[i % 3], win[(i + 1) % 3], win[(i + 2) % 3]);
      }
    }
  }
  if constexpr (kVec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace rowstream
