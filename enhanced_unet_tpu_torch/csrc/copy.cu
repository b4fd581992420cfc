// Identity copy of a tensor's bytes: the device-memory floor of the MBConv
// benches.
//
// Replaces the Pallas copy kernels of
// benchmarks/pallas_mbconv_instr.py::main (_copy_kernel, copy_g._k), which
// copy an [N,C,H,W] block into the output block and measure the TPU's DMA
// floor.  Their grid size is only the TPU's block size; the function is the
// identity.
//
// What bounds it on the H100: bytes, and nothing else (no arithmetic).  The
// design reads and writes 16 bytes a thread (uint4), neighbouring threads on
// neighbouring addresses.  Each block copies UNROLL x NT vectors, every
// thread issuing its UNROLL loads before its first store, over a grid that
// covers the buffer once (the shape of PyTorch's own elementwise kernels).
// The bytes past the last whole 16-byte vector (fewer than 16) are copied
// one a thread by the first block.  Both pointers must be 16-byte aligned.
// Plain C interface (no PyTorch headers), loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int UNROLL = 4;           // 16-byte loads in flight per thread

__global__ void __launch_bounds__(NT)
copy_kernel(const uint4* __restrict__ src4, uint4* __restrict__ dst4,
            size_t nvec, const unsigned char* __restrict__ src,
            unsigned char* __restrict__ dst, size_t nbytes) {
  const size_t base = (size_t)blockIdx.x * NT * UNROLL + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    if (base + k * NT < nvec) v[k] = src4[base + k * NT];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k)
    if (base + k * NT < nvec) dst4[base + k * NT] = v[k];
  const size_t tail = nvec * 16 + threadIdx.x;
  if (blockIdx.x == 0 && tail < nbytes) dst[tail] = src[tail];
}

}  // namespace

// dst[0:nbytes] <- src[0:nbytes] on `stream`.  The buffers must not overlap
// and must both be 16-byte aligned (else cudaErrorMisalignedAddress).
extern "C" int copy_bytes(const void* src, void* dst, long long nbytes,
                          void* stream) {
  if (nbytes <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t n = static_cast<size_t>(nbytes);
  const size_t nvec = n / 16;
  const size_t blocks = nvec == 0 ? 1 : (nvec + NT * UNROLL - 1) / (NT * UNROLL);
  copy_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec,
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}
