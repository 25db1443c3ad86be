// Batched FDE inner products for Hopper (sm_90a): scores = Q . Docs^T.
//
// Replaces: src/repro/kernels/fdescan/fdescan.py:fdescan_pallas.
// q (B, D) fp32, docs (N, D) fp16 (the resident FDE table) or fp32
//   ->  out (B, N) fp32.
// This is the brute-force candidate scan of the fde and cascade backends;
// the caller takes a stable top-k of each row.
//
// What bounds it on the H100: at the query path's shape (B = 64 queries,
// N = 1,000,000 docs, D = 256) the table is 512 MB of fp16 and the output
// 256 MB of fp32, about 0.23 ms at 3.35 TB/s; the product is 2*B*N*D =
// 32.8 GFLOP, about 0.49 ms at the card's 67 TFLOP/s of fp32 outside the
// tensor cores. So fp32 operations bound it, if each table row is read
// from device memory once.
//
// What the design does about it: a shared-memory tiled product, the
// structure of ivf_scan.cu with a half-precision doc operand. Each
// 256-thread block computes a 64 x 64 output tile: all 64 queries of a
// batch against 64 docs, so every table row is read from device memory
// once per batch of up to 64 queries. 32-wide slices of D are staged for
// both operands through shared memory (the fp16 tile widened to fp32 as it
// is loaded; rows padded to 33 floats so the inner loop is free of bank
// conflicts), and each thread accumulates a 4 x 4 register tile in fp32 FMA
// (no TF32), the sum over D taken in order. Edges are bounds-checked, so
// the output is exactly (B, N) with no padding, which equals what the TPU
// kernel returns after its [:B, :N] slice. Tensor cores (wgmma on the fp16
// table) and TMA are later work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;   // query rows per tile
constexpr int kBN = 64;   // doc columns per tile
constexpr int kBK = 32;   // depth slice staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename DocT>
__global__ void __launch_bounds__(kThreads)
fdescan_kernel(const float* __restrict__ q, const DocT* __restrict__ docs,
               float* __restrict__ out, int B, int N, int D) {
  __shared__ float qs[kBM][kBK + 1];
  __shared__ float cs[kBN][kBK + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: cols tx + 16 * j
  const int ty = tid / 16;   // row group: rows ty + 16 * r
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, col = e % kBK;
      const int gm = m0 + r, gd = d0 + col;
      qs[r][col] = (gm < B && gd < D) ? q[static_cast<size_t>(gm) * D + gd]
                                      : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, col = e % kBK;
      const int gn = n0 + r, gd = d0 + col;
      cs[r][col] = (gn < N && gd < D)
                       ? widen(docs[static_cast<size_t>(gn) * D + gd])
                       : 0.f;
    }
    __syncthreads();
    const int kk_end = min(kBK, D - d0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[ty + 16 * r][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cs[tx + 16 * j][kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[r][j];
    }
  }
}

template <typename DocT>
cudaError_t launch(const float* q, const DocT* docs, float* out, int B, int N,
                   int D, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  fdescan_kernel<DocT><<<grid, kThreads, 0, stream>>>(q, docs, out, B, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int fdescan_launch(const void* q, const void* docs, void* out, int B, int N,
                   int D, int docs_fp16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  cudaError_t e =
      docs_fp16 ? launch(qf, static_cast<const __half*>(docs), of, B, N, D, s)
                : launch(qf, static_cast<const float*>(docs), of, B, N, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
