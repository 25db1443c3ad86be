// MaxSim late-interaction scoring (paper eq. 1) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/maxsim/maxsim.py:maxsim_pallas (body _kernel).
// For each doc k:  out[k] = sum_i qmask[i] * max_{t < lens[k]} q[i] . docs[k, t]
// q (Lq, D) fp32, qmask (Lq,) fp32, docs (K, T, D) fp32 or fp16,
// lens (K,) int32  ->  out (K,) fp32.
//
// What bounds it on the H100: bytes. At the rerank's shape (Lq=24, D=32,
// mean doc length ~60 of T=180) each doc token read from device memory
// (128 B in fp32) feeds 2*Lq*D / 128 = 12 fp32 operations per byte, well
// under the card's ~20 fp32 operations per byte of memory bandwidth, so
// the least time is the valid token rows over 3.35 TB/s.
//
// What the design does about it:
//  * Tokens at or past lens[k] are never read. The TPU kernel multiplies the
//    whole padded (T, D) tile and masks the padding to -1e30; here the
//    padding is skipped, which moves about a third of the padded bytes and
//    gives the same result (a masked position can never win the max).
//  * One block per doc. The query and its mask sit in shared memory (3 KB at
//    the rerank's shape). The doc's valid rows are staged through shared
//    memory with 16-byte coalesced loads (8-byte loads of fp16 pairs are
//    converted on the way in), in passes of kThreads tokens.
//  * Each thread owns one doc token of the pass and computes its dot product
//    with every query token in fp32 FMA (no TF32, no tensor cores). The
//    staged rows use a row stride of D + 1 floats, so the 32 threads of a
//    warp read 32 different banks while the query row is a broadcast.
//  * The max over doc tokens is a warp shuffle reduction, carried across
//    warps and passes in shared memory; the running max starts at -1e30, not
//    -inf, so a zero-length doc scores -1e30 times the number of unmasked
//    query tokens, exactly as the TPU kernel does.
// A wgmma/TMA version is later work; this one is simple and right.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy n = rows * D contiguous fp32 values to dst with row stride D + 1.
__device__ __forceinline__ void stage(const float* __restrict__ src, int n,
                                      int D, float* __restrict__ dst) {
  if ((D & 3) == 0 && aligned16(src)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int v = threadIdx.x; v < n / 4; v += kThreads) {
      const float4 x = s4[v];
      const int e = v * 4;
      const int t = e / D;
      float* p = dst + e + t;  // t * (D + 1) + (e - t * D)
      p[0] = x.x;
      p[1] = x.y;
      p[2] = x.z;
      p[3] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e + e / D] = src[e];
  }
}

// fp16 variant: 16-byte loads of eight halves, converted to fp32.
__device__ __forceinline__ void stage(const __half* __restrict__ src, int n,
                                      int D, float* __restrict__ dst) {
  if ((D & 7) == 0 && aligned16(src)) {
    const uint4* s8 = reinterpret_cast<const uint4*>(src);
    for (int v = threadIdx.x; v < n / 8; v += kThreads) {
      const uint4 raw = s8[v];
      const __half2* h = reinterpret_cast<const __half2*>(&raw);
      const int e = v * 8;
      const int t = e / D;
      float* p = dst + e + t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __half22float2(h[j]);
        p[2 * j] = f.x;
        p[2 * j + 1] = f.y;
      }
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      dst[e + e / D] = __half2float(src[e]);
  }
}

template <typename DocT>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
              const DocT* __restrict__ docs, const int* __restrict__ lens,
              float* __restrict__ out, int T, int D, int Lq) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // Lq * D
  float* d_s = q_s + Lq * D;                  // kThreads * (D + 1)
  float* run = d_s + kThreads * (D + 1);      // kWarps * Lq running maxima

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < Lq * D; e += kThreads) q_s[e] = q[e];
  for (int e = tid; e < kWarps * Lq; e += kThreads) run[e] = kNeg;

  const int len = max(0, min(lens[k], T));
  const DocT* doc = docs + static_cast<size_t>(k) * T * D;
  const float* row = d_s + tid * (D + 1);

  for (int t0 = 0; t0 < len; t0 += kThreads) {
    const int nt = min(kThreads, len - t0);
    __syncthreads();  // the previous pass is done with d_s
    stage(doc + static_cast<size_t>(t0) * D, nt * D, D, d_s);
    __syncthreads();
    const bool valid = tid < nt;
    for (int i = 0; i < Lq; ++i) {
      float s = kNeg;
      if (valid) {
        const float* qi = q_s + i * D;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qi[d], row[d], acc);
        s = acc;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) run[warp * Lq + i] = fmaxf(run[warp * Lq + i], s);
    }
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < Lq; ++i) {
      float m = run[i];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, run[w * Lq + i]);
      total += m * qmask[i];
    }
    out[k] = total;
  }
}

template <typename DocT>
cudaError_t launch(const float* q, const float* qmask, const DocT* docs,
                   const int* lens, float* out, int K, int T, int D, int Lq,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(Lq) * D +
                                       static_cast<size_t>(kThreads) * (D + 1) +
                                       static_cast<size_t>(kWarps) * Lq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        maxsim_kernel<DocT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  maxsim_kernel<DocT><<<K, kThreads, smem, stream>>>(q, qmask, docs, lens,
                                                     out, T, D, Lq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes (the wrapper checks it first).
size_t maxsim_smem_bytes(int D, int Lq) {
  return sizeof(float) * (static_cast<size_t>(Lq) * D +
                          static_cast<size_t>(kThreads) * (D + 1) +
                          static_cast<size_t>(kWarps) * Lq);
}

// Returns cudaGetLastError() after the launch (0 = launched).
int maxsim_launch(const void* q, const void* qmask, const void* docs,
                  const void* lens, void* out, int K, int T, int D, int Lq,
                  int docs_fp16, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(qmask);
  const int* lf = static_cast<const int*>(lens);
  float* of = static_cast<float*>(out);
  cudaError_t e =
      docs_fp16 ? launch(qf, mf, static_cast<const __half*>(docs), lf, of, K,
                         T, D, Lq, s)
                : launch(qf, mf, static_cast<const float*>(docs), lf, of, K,
                         T, D, Lq, s);
  return static_cast<int>(e);
}

}  // extern "C"
