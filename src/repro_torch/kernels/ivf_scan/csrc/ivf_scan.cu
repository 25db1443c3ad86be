// IVF centroid scoring for Hopper (sm_90a): scores = Q . C^T.
//
// Replaces: src/repro/kernels/ivf_scan/ivf_scan.py:ivf_scan_pallas.
// q (B, D) fp32, centroids (N, D) fp32 -> out (B, N) fp32. This is the score
// matrix behind probe_cells; the caller takes a stable top-k of each row.
//
// What bounds it on the H100: at the query path's shape (B=64 queries,
// N~3,700 cells, D=128) each centroid byte read feeds 2*B/4 = 32 fp32
// operations, a little above the card's ~20 fp32 operations per byte of
// memory bandwidth, so the fp32 (non-tensor-core) rate bounds it; either
// bound is about a microsecond, so in practice launch and tail effects
// dominate.
//
// What the design does about it: a classic shared-memory tiled product.
// Each 256-thread block computes a 32 x 64 output tile, staging 32-wide
// slices of D for both operands through shared memory with coalesced loads
// (rows padded to 33 floats so the inner loop is free of bank conflicts).
// Each thread accumulates a 2 x 4 register tile in fp32 FMA (no TF32), the
// sum taken over D in order. Edges are bounds-checked in the kernel, so the
// output is exactly (B, N): there are no pad columns to mask, which equals
// what the TPU kernel returns after its [:B, :N] slice. wgmma/TMA is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;   // query rows per tile
constexpr int kBN = 64;   // centroid columns per tile
constexpr int kBK = 32;   // depth slice staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ c,
                float* __restrict__ out, int B, int N, int D) {
  __shared__ float qs[kBM][kBK + 1];
  __shared__ float cs[kBN][kBK + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // column group: cols tx + 16 * j
  const int ty = tid / 16;   // row pair: rows 2 * ty + r
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
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
      cs[r][col] = (gn < N && gd < D) ? c[static_cast<size_t>(gn) * D + gd]
                                      : 0.f;
    }
    __syncthreads();
    const int kk_end = min(kBK, D - d0);
    for (int kk = 0; kk < kk_end; ++kk) {
      const float a0 = qs[2 * ty][kk];
      const float a1 = qs[2 * ty + 1][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = cs[tx + 16 * j][kk];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = m0 + 2 * ty + r;
    if (gm >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[r][j];
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ivf_scan_launch(const void* q, const void* centroids, void* out, int B,
                    int N, int D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  ivf_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(centroids),
      static_cast<float*>(out), B, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
