// Packed-bit asymmetric MaxSim (Nardini et al. 2024) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bitsim/bitsim.py:bitsim_pallas (body _kernel).
// For each doc k:
//   out[k] = sum_i qmask[i] * max_{t < lens[k]} q[i] . sign(docs[k, t])
// where sign(docs[k, t])[d] = +1 if bit (d % 32) of lane d / 32 is set,
// else -1 (little-endian, as core/quantize.binary_pack packs it).
// q (Lq, D) fp32, qmask (Lq,) fp32, packed (K, T, W) 32-bit lanes with
// 32 * W >= D, lens (K,) int32  ->  out (K,) fp32.
//
// What bounds it on the H100: operations. A doc token is W lanes of 4 bytes
// (W = 1 at the bit filter's D = 32) and feeds 2 * Lq * D fp32 operations
// (1,536 at Lq = 24), about 384 operations per byte read, far above the
// card's ~20 fp32 operations per byte of memory bandwidth. At the filter's
// shape (1,000 candidates, ~57,600 valid tokens) the bound is about a
// microsecond, so the launch itself decides the time.
//
// What the design does about it (the shape of maxsim.cu):
//  * Tokens at or past lens[k] are never read. The TPU kernel unpacks the
//    whole padded (T, W) tile and masks the padding to -1e30; here the
//    padding is skipped, with the same result.
//  * One block per doc. The query and its mask sit in shared memory. In
//    passes of kThreads tokens, each thread unpacks the W lanes of its own
//    token with shifts into a row of +-1.0f in shared memory (row stride
//    D + 1, so the 32 threads of a warp touch 32 different banks).
//  * Each thread takes the dot of its token with every query row in fp32
//    FMA. The max over tokens is a warp shuffle reduction, carried across
//    warps and passes in shared memory; the running max starts at -1e30,
//    so a zero-length doc scores -1e30 times the number of unmasked query
//    tokens, exactly as the TPU kernel does.
// A version that scores with popcounts, or on tensor cores, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
bitsim_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
              const uint32_t* __restrict__ packed,
              const int* __restrict__ lens, float* __restrict__ out, int T,
              int W, int D, int Lq) {
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
  const uint32_t* doc = packed + static_cast<size_t>(k) * T * W;
  float* row = d_s + tid * (D + 1);

  for (int t0 = 0; t0 < len; t0 += kThreads) {
    const int t = t0 + tid;
    const bool valid = t < len;
    __syncthreads();  // q_s and run are set; the previous pass is done
    if (valid) {
      const uint32_t* tok = doc + static_cast<size_t>(t) * W;
      for (int w = 0; w * 32 < D; ++w) {
        const uint32_t bits = tok[w];
        const int n = min(32, D - w * 32);
        for (int b = 0; b < n; ++b)
          row[w * 32 + b] = ((bits >> b) & 1u) ? 1.f : -1.f;
      }
    }
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

size_t smem_bytes(int D, int Lq) {
  return sizeof(float) * (static_cast<size_t>(Lq) * D +
                          static_cast<size_t>(kThreads) * (D + 1) +
                          static_cast<size_t>(kWarps) * Lq);
}

}  // namespace

extern "C" {

// Shared memory a launch needs, in bytes (the wrapper checks it first).
size_t bitsim_smem_bytes(int D, int Lq) { return smem_bytes(D, Lq); }

// Returns cudaGetLastError() after the launch (0 = launched).
int bitsim_launch(const void* q, const void* qmask, const void* packed,
                  const void* lens, void* out, int K, int T, int W, int D,
                  int Lq, void* stream) {
  if (K <= 0) return 0;
  const size_t smem = smem_bytes(D, Lq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bitsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bitsim_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qmask),
      static_cast<const uint32_t*>(packed), static_cast<const int*>(lens),
      static_cast<float*>(out), T, W, D, Lq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
