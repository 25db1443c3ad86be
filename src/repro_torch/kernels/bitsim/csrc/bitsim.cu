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
// What bounds it on the H100: at the bit filter's shape (1,000 candidates,
// ~57,600 valid tokens of W = 1 lane at D = 32, Lq = 24) the bytes (~0.24
// MB) and the tensor cores' products (~0.18 GFLOP) each take well under a
// microsecond, so the chain of latencies of one launch decides the time.
//
// Two kernels; bitsim_launch picks one from the shape before it launches
// (bitsim_kernel_for), never after a failure:
//
// * bitsim_mma, the bit filter's case: Lq of 1 to 32, D up to 64, T up to
//   1,024.
//   - Products on the tensor cores: mma.sync m16n8k16, f32 += f16 * f16.
//     M is 16 doc tokens, N is 8 query tokens (4 n-tiles hold Lq <= 32,
//     the ones past Lq skipped), K is the dims in 16-deep steps with zero
//     q columns past D, so a pad bit multiplies a zero (D = 32: 2 steps;
//     D = 40: 3; a lane word takes 2, or 1 when it is the last of several
//     and holds at most 8 dims, so never fewer than 2 in all).
//   - The A fragments are built in registers from the lane words: no
//     shared memory, no ldmatrix. The order of k within an mma is free as
//     long as A and B agree, so each A register holds bits p and p + 16 of
//     a word: one shift puts them on the two halves' sign bits, one
//     logical op makes fp16 +-1 of them (0xBC00, -1, with a set bit
//     clearing the sign).
//   - A block of 16 warps takes 1, 2, 4 or 8 consecutive docs: as few as
//     still give every SM a block at this K (mma_common::docs_per_block,
//     as maxsim.cu chooses).
//     The docs' 16-row tiles ("items") are dealt to the warps in turn, so
//     a long doc's tiles run side by side. Every lane holds the block's
//     lengths, so an item's doc and rows take compares, not shuffles (a
//     shuffle is one warp a cycle for the whole SM). Lane (g, c) loads the
//     words of rows g and g + 8 of an item itself, for 8 items at once (2
//     at two words a token), none at or past lens[k].
//   - q in two fp16 parts under a power-of-two scale, unscaled after the
//     max, as maxsim.cu splits it (../../csrc/mma_common.cuh). Signs are
//     exact in fp16, so every product is exact. q is read once a block,
//     with coalesced loads, and split into the B fragments' places in
//     shared memory; each warp then holds them in registers.
//   - Rows at or past lens[k] are set to -1e30 before the max. An item's
//     max over its 16 rows is taken within the fragment, then across the 8
//     row groups by a reduce-scatter of 7 shuffles (not 3 for each of the
//     8 values a lane holds), and goes to shared memory (one value a query
//     token, one store a lane), not through atomics. Then warp d of the
//     block finishes doc d: lane i takes the max over the doc's items,
//     unscales it and weighs it by qmask[i], and a fixed tree of shuffles
//     sums the lanes, so a second call gives the same bits. A zero-length
//     doc gives the sum of -1e30 * qmask, as the TPU kernel does. Lengths
//     above T count as T, negative ones as 0.
// * bitsim_simt, every other case (Lq above 32, D above 64, longer docs):
//   the SIMT kernel of the first port. One 64-thread block per doc; q in
//   shared memory; each thread unpacks its own token into a row of +-1.0f
//   in shared memory and takes its dot with every query row in fp32 FMA;
//   the max over tokens is a warp shuffle reduction carried in shared
//   memory. Tokens at or past lens[k] are never read.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_common.cuh"

namespace {

constexpr float kNeg = -1e30f;

// --------------------------------------------------------------------------
// SIMT kernel (other shapes)
// --------------------------------------------------------------------------

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bitsim_simt(const float* __restrict__ q, const float* __restrict__ qmask,
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

size_t simt_smem_bytes(int D, int Lq) {
  return sizeof(float) * (static_cast<size_t>(Lq) * D +
                          static_cast<size_t>(kThreads) * (D + 1) +
                          static_cast<size_t>(kWarps) * Lq);
}

// --------------------------------------------------------------------------
// Tensor-core kernel
// --------------------------------------------------------------------------

using mma_common::kLoScale;
using mma_common::kMaxDocs;
using mma_common::kMaxLq;
using mma_common::kMmaThreads;
using mma_common::kMmaWarps;
using mma_common::kNT;
using mma_common::mma_16816;

constexpr int kMaxD = 64;
// doc tokens (T) the kernel takes: the items' maxima of 8 such docs fill
// 64 KB of shared memory
constexpr int kMaxT = 1024;

// 16-deep k-steps for D dims: two for each full lane word, one for a last
// word of at most 8 dims after others (its bits 0..7; see the fragment
// order below). At least 2: D <= 8 takes both steps of its one word, the
// second against zero q columns, so no instance runs a single step.
__host__ __device__ constexpr int mma_steps(int D) {
  const int full = (D + 31) / 32 - 1;  // lane words before the last
  return full == 0 ? 2 : 2 * full + (D - 32 * full <= 8 ? 1 : 2);
}

__host__ __device__ constexpr int mma_smem_bytes(int KS, int T, int docs) {
  return kNT * KS * 32 * 16                       // B fragments, hi and lo
         + 2 * kMaxLq * 4                         // unscale and qmask
         + docs * ((T + 15) / 16) * kMaxLq * 4;   // each item's maxima
}

// A lane word's bits b and b + 16 as two fp16 +-1 (bit b in the low half):
// shifted left by 15 - b they sit on the halves' sign bits; -1 is 0xBC00,
// and a set bit clears the sign.
__device__ __forceinline__ uint32_t signs2(uint32_t word, int shift) {
  return 0xBC00BC00u ^ ((word << shift) & 0x80008000u);
}

// The fragment order. Bit b of lane word u is dim 32u + b. It goes to step
// s = 2u + ((b >> 3) & 1), thread c = b & 3 of each row group, register
// r = (b >> 2) & 1 (a0/a1 and b0 for 0; a2/a3 and b1 for 1) and half
// b >> 4. So k = 2c + 8r + (b >> 4) of its step: each k once. Register r
// of thread c holds bits p and p + 16, p = 8 (s & 1) + 4r + c.
template <int KS, int kDocs>   // KS = mma_steps(D), 2 to 4; kDocs docs a block
__global__ void __launch_bounds__(kMmaThreads)
bitsim_mma(const float* __restrict__ q, const float* __restrict__ qmask,
           const uint32_t* __restrict__ packed, const int* __restrict__ lens,
           float* __restrict__ out, int K, int T, int W, int D, int Lq) {
  constexpr int NW = (KS + 1) / 2;     // lane words a token feeds
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint4* frag = reinterpret_cast<uint4*>(smem_raw);   // [j][s][lane]
  float* unscale = reinterpret_cast<float*>(frag + kNT * KS * 32);
  float* qm = unscale + kMaxLq;
  float* partial = qm + kMaxLq;        // [item][query token] maxima

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;             // the fragment's row group
  const int c = lane & 3;              // the thread in the group
  const int k0 = blockIdx.x * kDocs;
  const int ntl = (Lq + 7) / 8;        // n-tiles holding a query token

  // 1. Loads with no dependence: this warp's share of q (query tokens warp,
  //    warp + 16; lane word u's bit lane is dim 32u + lane) and qmask;
  //    lane d < kDocs the length of doc k0 + d.
  constexpr int kRows = kMaxLq / kMmaWarps;
  float qv[kRows][NW], mv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + kMmaWarps * r;
    mv[r] = i < Lq ? __ldg(qmask + i) : 0.f;
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const int d = 32 * u + lane;
      qv[r][u] = i < Lq && d < D ? __ldg(q + i * D + d) : 0.f;
    }
  }
  //    The block's docs k0 .. k0 + kDocs - 1 come in 16-row tiles
  //    ("items", in doc order); warp w takes items w, w + 16, ... Every
  //    lane holds each doc's length (kDocs shuffles) and first item, so an
  //    item's doc and rows take a few compares and no shuffle.
  int lenv[kDocs], firstv[kDocs], key[kDocs];
  int items = 0;
  const int len_l = lane < kDocs && k0 + lane < K
                        ? max(0, min(__ldg(lens + k0 + lane), T)) : 0;
#pragma unroll
  for (int d = 0; d < kDocs; ++d) {
    lenv[d] = __shfl_sync(0xffffffffu, len_l, d);
    firstv[d] = items;
    key[d] = items << 16 | lenv[d] << 4 | d;   // first item, length, doc
    items += (lenv[d] + 15) / 16;
  }
  const int my_items = (items - warp + kMmaWarps - 1) / kMmaWarps;

  // 2. The lane words of rows g and g + 8 of a round of kRound items (none
  //    at or past the doc's length), and each item's rows below it.
  constexpr int kRound = 8 / (NW * NW);   // 2 at two words: registers
  uint32_t x[kRound][2][NW];
  int rows_r[kRound];
  auto load = [&](int n0) {
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      if (n0 + e >= my_items) break;   // the same in every lane
      const int it = warp + kMmaWarps * (n0 + e);
      int at = key[0];                 // the last doc starting at or before
#pragma unroll
      for (int e2 = 1; e2 < kDocs; ++e2) at = firstv[e2] <= it ? key[e2] : at;
      const int r0 = 16 * (it - (at >> 16));
      const int rows = ((at >> 4) & 0xfff) - r0;
      rows_r[e] = rows;
      const uint32_t* row =
          packed + (static_cast<size_t>(k0 + (at & 15)) * T + r0 + g) * W;
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        x[e][0][u] = g < rows ? __ldg(row + u) : 0u;
        x[e][1][u] = g + 8 < rows ? __ldg(row + 8 * W + u) : 0u;
      }
    }
  };
  load(0);

  // 3. Each query token's power-of-two scale (from the exponent of its
  //    largest |q|, clamped to the normal range), then hi and lo into the
  //    B fragments' places in shared memory: {b0, b1} hi, then lo, a uint4
  //    for each (n-tile, step, lane). Rows past Lq and dims past D are 0.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + kMmaWarps * r;
    float mx = 0.f;
#pragma unroll
    for (int u = 0; u < NW; ++u) mx = fmaxf(mx, fabsf(qv[r][u]));
    float inv;
    const float scale = mma_common::warp_pow2_scale(mx, inv);
    if (lane == 0) {
      unscale[i] = inv;
      qm[i] = mv[r];
    }
#pragma unroll
    for (int u = 0; u < NW; ++u) {
      const int s = 2 * u + ((lane >> 3) & 1);
      if (s >= KS) continue;           // bits 8..15, 24..31 of a short word
      __half* at = reinterpret_cast<__half*>(
          frag + ((i >> 3) * KS + s) * 32 + 4 * (i & 7) + (lane & 3));
      const int slot = 2 * ((lane >> 2) & 1) + (lane >> 4);
      mma_common::split_hi_lo(qv[r][u] * scale, at[slot], at[4 + slot]);
    }
  }
  __syncthreads();

  // 4. B fragments (query tokens 8j + g), hi and lo, in registers for the
  //    rest of the block.
  uint32_t bh[kNT][KS][2], bl[kNT][KS][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint4 f = frag[(j * KS + s) * 32 + lane];
      bh[j][s][0] = f.x;
      bh[j][s][1] = f.y;
      bl[j][s][0] = f.z;
      bl[j][s][1] = f.w;
    }

  // 5. The warp's items. An item's max over its 16 rows is taken within
  //    the fragment (rows g, g + 8), then across the 8 row groups by a
  //    reduce-scatter of 7 shuffles: lane (g, c) ends with the max of
  //    column 2c + (g & 1) of n-tile g >> 1, and writes it to shared
  //    memory, partial[item][query token].
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  for (int n0 = 0; n0 < my_items; n0 += kRound) {
    if (n0 > 0) load(n0);
#pragma unroll
    for (int e = 0; e < kRound; ++e) {
      const int n = n0 + e;
      if (n >= my_items) break;        // the same in every lane
      uint32_t a[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int p = 8 * (s & 1) + c;     // register 0: bits p, p + 16
        a[s][0] = signs2(x[e][0][s / 2], 15 - p);
        a[s][1] = signs2(x[e][1][s / 2], 15 - p);
        a[s][2] = signs2(x[e][0][s / 2], 11 - p);
        a[s][3] = signs2(x[e][1][s / 2], 11 - p);
      }
      const bool v0 = g < rows_r[e], v1 = g + 8 < rows_r[e];
      float v[2 * kNT];                // column 2c + t of n-tile j at 2j + t
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        v[2 * j] = v[2 * j + 1] = kNeg;
        if (j >= ntl) continue;
        float hi[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          mma_16816(hi, a[s], bh[j][s]);
          mma_16816(lo, a[s], bl[j][s]);
        }
        // c0, c1: row g, columns 2c, 2c+1; c2, c3: row g + 8
#pragma unroll
        for (int t = 0; t < 2; ++t)
          v[2 * j + t] =
              fmaxf(v0 ? fmaf(lo[t], 1.f / kLoScale, hi[t]) : kNeg,
                    v1 ? fmaf(lo[t + 2], 1.f / kLoScale, hi[t + 2]) : kNeg);
      }
      float w4[4], w2[2];
#pragma unroll
      for (int m = 0; m < 4; ++m)      // keep 4 (g & 4 ? 4..7 : 0..3)
        w4[m] = fmaxf(b4 ? v[m + 4] : v[m],
                      __shfl_xor_sync(0xffffffffu, b4 ? v[m] : v[m + 4], 16));
#pragma unroll
      for (int m = 0; m < 2; ++m)      // then 2, then 1: index g
        w2[m] = fmaxf(b3 ? w4[m + 2] : w4[m],
                      __shfl_xor_sync(0xffffffffu, b3 ? w4[m] : w4[m + 2], 8));
      const float w1 = fmaxf(b2 ? w2[1] : w2[0],
                             __shfl_xor_sync(0xffffffffu, b2 ? w2[0] : w2[1],
                                             4));
      const int it = warp + kMmaWarps * n;
      partial[it * kMaxLq + 8 * (g >> 1) + 2 * c + (g & 1)] = w1;
    }
  }
  __syncthreads();

  // 6. Warp w finishes doc k0 + w: lane i takes query token i's maximum
  //    over the doc's items, unscales it and weighs it by its mask; a fixed
  //    tree of shuffles sums them, so a second call gives the same bits. A
  //    zero-length doc gives sum(-1e30 * qmask).
  const int k = k0 + warp;
  if (warp >= kDocs || k >= K) return;
  int f = 0, nf = 0;
#pragma unroll
  for (int d = 0; d < kDocs; ++d)
    if (d == warp) {
      f = firstv[d];
      nf = f + (lenv[d] + 15) / 16;
    }
  float part = 0.f;
  if (lane < Lq) {
    float mx[4] = {kNeg, kNeg, kNeg, kNeg};
    int it = f;
    for (; it + 4 <= nf; it += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        mx[u] = fmaxf(mx[u], partial[(it + u) * kMaxLq + lane]);
    for (; it < nf; ++it) mx[0] = fmaxf(mx[0], partial[it * kMaxLq + lane]);
    const float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    part = (nf == f ? kNeg : m * unscale[lane]) * qm[lane];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) out[k] = part;
}

template <int KS, int kDocs>
cudaError_t launch_mma_docs(const float* q, const float* qmask,
                            const uint32_t* packed, const int* lens,
                            float* out, int K, int T, int W, int D, int Lq,
                            cudaStream_t stream) {
  static bool smem_set = false;       // once: the largest T it takes
  const cudaError_t e = mma_common::allow_smem(
      bitsim_mma<KS, kDocs>, mma_smem_bytes(KS, kMaxT, kDocs), smem_set);
  if (e != cudaSuccess) return e;
  bitsim_mma<KS, kDocs>
      <<<(K + kDocs - 1) / kDocs, kMmaThreads,
         mma_smem_bytes(KS, T, kDocs), stream>>>(q, qmask, packed, lens, out,
                                                 K, T, W, D, Lq);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_mma(const float* q, const float* qmask,
                       const uint32_t* packed, const int* lens, float* out,
                       int K, int T, int W, int D, int Lq, cudaStream_t s) {
  return mma_common::launch_docs_per_block(K, [&](auto docs_a_block) {
    return launch_mma_docs<KS, decltype(docs_a_block)::value>(
        q, qmask, packed, lens, out, K, T, W, D, Lq, s);
  });
}

}  // namespace

extern "C" {

// Docs a block of the tensor-core kernel takes for K docs (1, 2, 4 or 8,
// from K and the SM count: mma_common::docs_per_block).
int bitsim_mma_docs_per_block(int K) {
  return mma_common::docs_per_block(K);
}

// 1 if bitsim_launch takes the tensor-core kernel for these shapes, 0 if
// the SIMT one.
int bitsim_kernel_for(int D, int Lq, int T) {
  return D >= 1 && D <= kMaxD && Lq >= 1 && Lq <= kMaxLq && T <= kMaxT;
}

// Shared memory a SIMT launch needs, in bytes (the wrapper checks it first;
// the tensor-core kernel's own need is set at its first launch).
size_t bitsim_smem_bytes(int D, int Lq) { return simt_smem_bytes(D, Lq); }

// Returns cudaGetLastError() after the launch (0 = launched).
int bitsim_launch(const void* q, const void* qmask, const void* packed,
                  const void* lens, void* out, int K, int T, int W, int D,
                  int Lq, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(qmask);
  const uint32_t* pf = static_cast<const uint32_t*>(packed);
  const int* lf = static_cast<const int*>(lens);
  float* of = static_cast<float*>(out);
  cudaError_t e;
  if (bitsim_kernel_for(D, Lq, T)) {
    switch (mma_steps(D)) {
      case 2:
        e = launch_mma<2>(qf, mf, pf, lf, of, K, T, W, D, Lq, s);
        break;
      case 3:
        e = launch_mma<3>(qf, mf, pf, lf, of, K, T, W, D, Lq, s);
        break;
      default:
        e = launch_mma<4>(qf, mf, pf, lf, of, K, T, W, D, Lq, s);
    }
    return static_cast<int>(e);
  }
  const size_t smem = simt_smem_bytes(D, Lq);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(bitsim_simt,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bitsim_simt<<<K, kThreads, smem, s>>>(qf, mf, pf, lf, of, T, W, D, Lq);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
