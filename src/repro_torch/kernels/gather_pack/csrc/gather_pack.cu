// Restructuring kernel (paper §5.1) for Hopper (sm_90a): pack token rows of
// a flat pool into the padded (docs, T, D) tiles MaxSim consumes.
//
// Replaces: src/repro/kernels/gather_pack/gather_pack.py:gather_pack_pallas
// (body _kernel).  out[k, t, :] = pool[idx[k, t], :] where idx[k, t] >= 0,
// and zeros where idx[k, t] < 0 (padding).
// pool (R, D) with 1-, 2- or 4-byte elements (fp16, fp32, int8 rows all come
// through), idx (K, T) int32 with -1 = pad  ->  out (K, T, D) in pool's type.
//
// What bounds it on the H100: bytes. It is a pure indexed copy with no
// arithmetic: each output row is written once, each valid row is read once
// from the pool and each index once, so the least time is those bytes over
// 3.35 TB/s (about 5 us at the rerank's shape of K=1000, T=180, D=32 fp16).
//
// What the design does about it:
//  * The kernel never looks at the element type. A row is row_bytes opaque
//    bytes, moved in units of 16, 8, 4, 2 or 1 bytes: the widest unit that
//    divides the row's byte count and both base pointers' alignment, so
//    fp16 rows of D=32 (64 bytes) move as four 16-byte int4 loads and
//    stores, and a 40-byte row (D=20 fp16) as five 8-byte ones.
//  * One thread moves one unit, and consecutive threads move consecutive
//    units of the output: stores are fully coalesced, and the threads of a
//    row read one contiguous pool row. A grid-stride loop covers K*T rows.
//  * A pad row (idx < 0) is written as zeros and never reads the pool. The
//    TPU kernel walks one doc's T rows in a sequential fori_loop and masks
//    the padding with a multiply; here every row is independent.
// The wrapper guarantees -1 <= idx < R; rows are addressed in 64 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 resident blocks on each of 132 SMs

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_pack_kernel(const U* __restrict__ pool, const int* __restrict__ idx,
                   U* __restrict__ out, long long n_units,
                   int units_per_row) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       u < n_units; u += stride) {
    const long long row = u / units_per_row;
    const int c = static_cast<int>(u - row * units_per_row);
    const int src = idx[row];
    U v = U();   // value-initialised: all-zero bytes
    if (src >= 0) v = pool[static_cast<long long>(src) * units_per_row + c];
    out[u] = v;
  }
}

template <typename U>
cudaError_t launch(const void* pool, const int* idx, void* out,
                   long long rows, int row_bytes, cudaStream_t stream) {
  const int per_row = row_bytes / static_cast<int>(sizeof(U));
  const long long n_units = rows * per_row;
  const long long want = (n_units + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  gather_pack_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(pool), idx, static_cast<U*>(out), n_units,
      per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Width in bytes of the unit a launch would move (reported by the wrapper).
int gather_pack_unit_bytes(const void* pool, const void* out, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if ((a & 15) == 0) return 16;
  if ((a & 7) == 0) return 8;
  if ((a & 3) == 0) return 4;
  if ((a & 1) == 0) return 2;
  return 1;
}

// Returns cudaGetLastError() after the launch (0 = launched). K * T == 0
// or row_bytes == 0 launches nothing.
int gather_pack_launch(const void* pool, const void* idx, void* out, int K,
                       int T, int row_bytes, void* stream) {
  const long long rows = static_cast<long long>(K) * T;
  if (rows <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  cudaError_t e;
  switch (gather_pack_unit_bytes(pool, out, row_bytes)) {
    case 16: e = launch<uint4>(pool, ix, out, rows, row_bytes, s); break;
    case 8: e = launch<uint2>(pool, ix, out, rows, row_bytes, s); break;
    case 4: e = launch<uint32_t>(pool, ix, out, rows, row_bytes, s); break;
    case 2: e = launch<uint16_t>(pool, ix, out, rows, row_bytes, s); break;
    default: e = launch<uint8_t>(pool, ix, out, rows, row_bytes, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
