// MaxSim late-interaction scoring (paper eq. 1) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/maxsim/maxsim.py:maxsim_pallas (body _kernel).
// For each doc k:  out[k] = sum_i qmask[i] * max_{t < lens[k]} q[i] . docs[k, t]
// q (Lq, D) fp32, qmask (Lq,) fp32, docs (K, T, D) fp32 or fp16,
// lens (K,) int32  ->  out (K,) fp32.
//
// What bounds it on the H100: bytes. At the rerank's shape (Lq=24, D=32,
// mean doc length ~60 of T=180, fp16 tiles) each valid doc token is 64
// bytes and feeds 2 * 2*Lq*D = 3,072 tensor-core operations (q in two fp16
// parts, below): 48 per byte, far under the ~295 the card does per byte of
// memory bandwidth. The least time is the valid token rows over 3.35 TB/s.
//
// Two kernels; maxsim_launch picks one from the dtype and shape before it
// launches (maxsim_kernel_for), never after a failure:
//
// * maxsim_mma, the main path's case: fp16 docs, D of 16, 32 or 64, Lq of
//   1 to 32, T up to 1,024, 16-byte aligned docs.
//   - Products on the tensor cores: mma.sync m16n8k16, f32 += f16 * f16.
//     M is 16 doc tokens, N is 8 query tokens (4 n-tiles hold Lq <= 32,
//     the ones past Lq skipped), K is D in 16-deep steps. Only the 16-row
//     tiles below lens[k] are read and multiplied: a doc wastes at most 15
//     rows, where wgmma's 64-row tiles would pad a 65-token doc to 128.
//   - q in two fp16 parts under a power-of-two scale, unscaled after the
//     max (../../csrc/mma_common.cuh, which bitsim.cu shares).
//   - A block of 16 warps takes 1, 2, 4 or 8 consecutive docs: as few as
//     still give every SM a block at this K (fewer tiles a warp, a shorter
//     chain of latencies), 8 from K = 8 x 132 on. The docs' 16-row tiles
//     ("items") are dealt to the warps in turn; all of a warp's first 3
//     items are in flight (16-byte cp.async into a ring of 4 tiles a warp,
//     rows padded by 16 bytes so that ldmatrix reads 8 rows from 8 bank
//     groups) before the block splits q, and the next one is fetched while
//     one is multiplied. q is read once a block: split into shared memory,
//     then each warp holds its B fragments (hi and lo) in registers, 32 of
//     them at D = 32.
//   - Rows at or past lens[k] are set to -1e30 before the max. An item's
//     max over its 16 rows is taken within the fragment, then across the 8
//     row groups by shuffles, and goes to shared memory (one value a query
//     token), not through atomics. Then warp d of the block finishes doc
//     d: lane i takes the max over the doc's items and weighs it by
//     qmask[i], and a fixed tree of shuffles sums the lanes, so a second
//     call gives the same bits. A zero-length doc gives the sum of -1e30 *
//     qmask, as the TPU kernel does.
// * maxsim_simt, every other case (fp32 docs, another D, Lq above 32,
//   longer docs, unaligned docs): the SIMT kernel of the first port. One
//   64-thread block per doc; q in shared memory; the doc's valid rows staged
//   with 16-byte loads; each thread owns one doc token and computes its dot
//   products in fp32 FMA; the max over tokens is a warp shuffle reduction
//   carried in shared memory. Rows at or past lens[k] are never read.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_common.cuh"

namespace {

constexpr float kNeg = -1e30f;

// --------------------------------------------------------------------------
// SIMT kernel (fp32 docs, other shapes)
// --------------------------------------------------------------------------

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

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
maxsim_simt(const float* __restrict__ q, const float* __restrict__ qmask,
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

size_t simt_smem_bytes(int D, int Lq) {
  return sizeof(float) * (static_cast<size_t>(Lq) * D +
                          static_cast<size_t>(kThreads) * (D + 1) +
                          static_cast<size_t>(kWarps) * Lq);
}

template <typename DocT>
cudaError_t launch_simt(const float* q, const float* qmask, const DocT* docs,
                        const int* lens, float* out, int K, int T, int D,
                        int Lq, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(D, Lq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        maxsim_simt<DocT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  maxsim_simt<DocT><<<K, kThreads, smem, stream>>>(q, qmask, docs, lens,
                                                   out, T, D, Lq);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// Tensor-core kernel (fp16 docs)
// --------------------------------------------------------------------------

using mma_common::kLoScale;
using mma_common::kMaxDocs;
using mma_common::kMaxLq;
using mma_common::kMmaThreads;
using mma_common::kMmaWarps;
using mma_common::kNT;
using mma_common::mma_16816;

constexpr int kSlots = 4;              // 16-row tiles a warp has in flight
// doc tokens (T) the kernel takes: a warp's items fit its 32 lanes
constexpr int kMaxT = 16 * 32 * kMmaWarps / kMaxDocs;

// Staged doc row pitch in bytes: 16 bytes of padding put the 8 rows an
// ldmatrix phase reads in 8 different 16-byte bank groups. q's rows are
// padded the same way (D + 8 halves) for the B fragments' loads.
__host__ __device__ constexpr int row_pitch(int D) { return 2 * D + 16; }

__host__ __device__ constexpr int mma_smem_bytes(int D, int T, int docs) {
  return kMmaWarps * kSlots * 16 * row_pitch(D)   // doc tiles
         + 2 * kMaxLq * row_pitch(D)              // q hi and lo, fp16
         + 2 * kMaxLq * 4                         // unscale and qmask
         + docs * ((T + 15) / 16) * kMaxLq * 4;   // each item's maxima
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

template <int KS, int kDocs>   // D = 16 * KS; kDocs docs a block
__global__ void __launch_bounds__(kMmaThreads)
maxsim_mma(const float* __restrict__ q, const float* __restrict__ qmask,
           const __half* __restrict__ docs, const int* __restrict__ lens,
           float* __restrict__ out, int K, int T, int Lq) {
  constexpr int D = 16 * KS;
  constexpr int kPitch = row_pitch(D);
  constexpr int kPieces = D / 8;       // 16-byte pieces a doc row
  constexpr int kTile = 16 * kPitch;   // one staged 16-row tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* q_hi = smem_raw + kMmaWarps * kSlots * kTile;
  uint8_t* q_lo = q_hi + kMaxLq * kPitch;
  float* unscale = reinterpret_cast<float*>(q_lo + kMaxLq * kPitch);
  float* qm = unscale + kMaxLq;
  float* partial = qm + kMaxLq;        // [item][query token] maxima

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;             // the fragment's row group
  const int t = lane & 3;              // the thread in the group
  const int k0 = blockIdx.x * kDocs;
  const int ntl = (Lq + 7) / 8;        // n-tiles holding a query token

  // 1. This warp's share of q (query tokens warp, warp + 16; D columns by
  //    lane) and of qmask, loaded before anything waits.
  constexpr int kRows = kMaxLq / kMmaWarps;
  constexpr int kPerLane = (D + 31) / 32;
  float qv[kRows][kPerLane], mv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + kMmaWarps * r;
    mv[r] = i < Lq ? qmask[i] : 0.f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      qv[r][u] = i < Lq && d < D ? q[i * D + d] : 0.f;
    }
  }

  // 2. The block's docs k0 .. k0 + kDocs - 1 in 16-row tiles ("items", in
  //    doc order); warp w takes items w, w + 16, ... Lane d < kDocs holds
  //    doc d's length and its first item; the others read them by
  //    shuffles.
  int len_l = 0;
  if (lane < kDocs && k0 + lane < K) len_l = max(0, min(lens[k0 + lane], T));
  int first_l = (len_l + 15) / 16;     // inclusive scan of the item counts
#pragma unroll
  for (int off = 1; off < kDocs; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, first_l, off);
    if (lane >= off) first_l += v;
  }
  const int items = __shfl_sync(0xffffffffu, first_l, kDocs - 1);
  first_l -= (len_l + 15) / 16;        // exclusive
  auto doc_first = [&](int d) {
    return __shfl_sync(0xffffffffu, first_l, d);
  };
  // Lane n describes the warp's item n (item warp + 16n): its doc, its
  // first row and the rows left in the doc from there.
  const int my_item = warp + kMmaWarps * lane;
  int item_doc = 0;
#pragma unroll
  for (int e = 1; e < kDocs; ++e) item_doc += doc_first(e) <= my_item;
  const int item_row0 = 16 * (my_item - doc_first(item_doc));
  const int item_rows =
      __shfl_sync(0xffffffffu, len_l, item_doc) - item_row0;
  const uint32_t tiles = smem_u32(smem_raw) + warp * kSlots * kTile;
  // The rows of the warp's item n that lie below its doc's length into
  // slot s.
  auto stage = [&](int n, int s) {
    const int d = __shfl_sync(0xffffffffu, item_doc, n);
    const int r0 = __shfl_sync(0xffffffffu, item_row0, n);
    const int rows = min(16, __shfl_sync(0xffffffffu, item_rows, n));
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        docs + (static_cast<size_t>(k0 + d) * T + r0) * D);
    for (int e = lane; e < rows * kPieces; e += 32)
      cp_async16(tiles + s * kTile + (e / kPieces) * kPitch +
                     (e % kPieces) * 16,
                 src + 16 * e);
  };
  const int my_items = (items - warp + kMmaWarps - 1) / kMmaWarps;
#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) {
    if (s < my_items) stage(s, s);
    cp_async_commit();
  }

  // 3. Each query token's power-of-two scale (from the exponent of its
  //    largest |q|, clamped to the normal range), then hi and lo.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + kMmaWarps * r;
    float mx = 0.f;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) mx = fmaxf(mx, fabsf(qv[r][u]));
    float inv;
    const float scale = mma_common::warp_pow2_scale(mx, inv);
    if (lane == 0) {
      unscale[i] = inv;
      qm[i] = mv[r];
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d >= D) break;
      mma_common::split_hi_lo(qv[r][u] * scale,
                              reinterpret_cast<__half*>(q_hi + i * kPitch)[d],
                              reinterpret_cast<__half*>(q_lo + i * kPitch)[d]);
    }
  }
  __syncthreads();

  // 4. B fragments (query tokens 8j + g, D columns 16s + 2t, +1, +8, +9),
  //    hi and lo, in registers for the rest of the block.
  uint32_t bh[kNT][KS][2], bl[kNT][KS][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (8 * j + g) * kPitch + 2 * (16 * s + 2 * t + 8 * h);
        bh[j][s][h] = *reinterpret_cast<const uint32_t*>(q_hi + at);
        bl[j][s][h] = *reinterpret_cast<const uint32_t*>(q_lo + at);
      }

  // 5. The warp's items: the next tiles' copies are in flight while this
  //    one is multiplied. Each item's maxima over its rows, one a query
  //    token, go to shared memory: partial[item][query token].
  for (int n = 0; n < my_items; ++n) {
    if (n + kSlots - 1 < my_items)
      stage(n + kSlots - 1, (n + kSlots - 1) % kSlots);
    cp_async_commit();
    cp_async_wait<kSlots - 1>();       // item n's copies have landed
    __syncwarp();
    const int it = warp + kMmaWarps * n;
    const int rows = __shfl_sync(0xffffffffu, item_rows, n);
    const uint32_t tile = tiles + (n % kSlots) * kTile;
    uint32_t a[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s)
      ldmatrix_x4(a[s], tile + (lane & 15) * kPitch +
                            (16 * s + 8 * (lane >> 4)) * 2);
    const bool v0 = g < rows, v1 = g + 8 < rows;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= ntl) break;
      float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        mma_16816(hi, a[s], bh[j][s]);
        mma_16816(lo, a[s], bl[j][s]);
      }
      // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8; the max over
      // the 16 rows, then over the 8 row groups
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = v0 ? fmaf(lo[c], 1.f / kLoScale, hi[c]) : kNeg;
        const float y =
            v1 ? fmaf(lo[c + 2], 1.f / kLoScale, hi[c + 2]) : kNeg;
        float m = fmaxf(x, y);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0) partial[it * kMaxLq + 8 * j + 2 * t + c] = m;
      }
    }
    __syncwarp();                      // the slot is free for a copy
  }
  cp_async_wait<0>();
  __syncthreads();

  // 6. Warp w finishes doc k0 + w: lane i takes query token i's maximum
  //    over the doc's items and weighs it by its mask; a fixed tree of
  //    shuffles sums them, so a second call gives the same bits. A
  //    zero-length doc gives sum(-1e30 * qmask).
  const int k = k0 + warp;
  const int f = doc_first(warp);
  const int nf = warp + 1 < kDocs ? doc_first(warp + 1) : items;
  if (warp >= kDocs || k >= K) return;
  float part = 0.f;
  if (lane < Lq) {
    float mx = kNeg;
    for (int it = f; it < nf; ++it)
      mx = fmaxf(mx, partial[it * kMaxLq + lane]);
    part = (nf == f ? kNeg : mx * unscale[lane]) * qm[lane];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) out[k] = part;
}

template <int KS, int kDocs>
cudaError_t launch_mma_docs(const float* q, const float* qmask,
                            const __half* docs, const int* lens, float* out,
                            int K, int T, int Lq, cudaStream_t stream) {
  static bool smem_set = false;       // once: the largest T it takes
  const cudaError_t e = mma_common::allow_smem(
      maxsim_mma<KS, kDocs>, mma_smem_bytes(16 * KS, kMaxT, kDocs),
      smem_set);
  if (e != cudaSuccess) return e;
  maxsim_mma<KS, kDocs>
      <<<(K + kDocs - 1) / kDocs, kMmaThreads,
         mma_smem_bytes(16 * KS, T, kDocs), stream>>>(q, qmask, docs, lens,
                                                      out, K, T, Lq);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_mma(const float* q, const float* qmask, const __half* docs,
                       const int* lens, float* out, int K, int T, int Lq,
                       cudaStream_t s) {
  return mma_common::launch_docs_per_block(K, [&](auto docs_a_block) {
    return launch_mma_docs<KS, decltype(docs_a_block)::value>(
        q, qmask, docs, lens, out, K, T, Lq, s);
  });
}

}  // namespace

extern "C" {

// Docs a block of the tensor-core kernel takes for K docs (1, 2, 4 or 8,
// from K and the SM count: mma_common::docs_per_block).
int maxsim_mma_docs_per_block(int K) {
  return mma_common::docs_per_block(K);
}

// 1 if maxsim_launch takes the tensor-core kernel for these inputs, 0 if
// the SIMT one.
int maxsim_kernel_for(const void* docs, int D, int Lq, int T,
                      int docs_fp16) {
  return docs_fp16 && (D == 16 || D == 32 || D == 64) && Lq >= 1 &&
         Lq <= kMaxLq && T <= kMaxT &&
         reinterpret_cast<uintptr_t>(docs) % 16 == 0;
}

// Shared memory a SIMT launch needs, in bytes (the wrapper checks it first;
// the tensor-core kernel's own need is set at its first launch).
size_t maxsim_smem_bytes(int D, int Lq) { return simt_smem_bytes(D, Lq); }

// Returns cudaGetLastError() after the launch (0 = launched).
int maxsim_launch(const void* q, const void* qmask, const void* docs,
                  const void* lens, void* out, int K, int T, int D, int Lq,
                  int docs_fp16, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(qmask);
  const int* lf = static_cast<const int*>(lens);
  const __half* dh = static_cast<const __half*>(docs);
  float* of = static_cast<float*>(out);
  cudaError_t e;
  if (maxsim_kernel_for(docs, D, Lq, T, docs_fp16)) {
    if (D == 16)
      e = launch_mma<1>(qf, mf, dh, lf, of, K, T, Lq, s);
    else if (D == 32)
      e = launch_mma<2>(qf, mf, dh, lf, of, K, T, Lq, s);
    else
      e = launch_mma<4>(qf, mf, dh, lf, of, K, T, Lq, s);
  } else if (docs_fp16) {
    e = launch_simt(qf, mf, dh, lf, of, K, T, D, Lq, s);
  } else {
    e = launch_simt(qf, mf, static_cast<const float*>(docs), lf, of, K, T, D,
                    Lq, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
