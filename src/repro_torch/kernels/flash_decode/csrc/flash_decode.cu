// Single-token GQA decode attention over a KV cache (flash-decoding) for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py:flash_decode_pallas
// (body _kernel). It computes the function of flash_decode_ref:
//   out[b, kv, g] = sum_s softmax_s(q[b, kv, g] . k[b, s, kv] * Dh^-1/2) v[b, s, kv]
// over the slots s < lengths[b] (a length above S counts as S; a length of 0
// or less weights all S slots equally, the mean of v, as the oracle's -1e30
// mask does). q (B, KV, G, Dh), k/v (B, S, KV, Dh), out (B, KV, G, Dh), all
// fp32, bf16 or fp16 alike; lengths (B,) int32. Scores, p and the PV sums
// are fp32; only the output is rounded, to q's dtype.
//
// What bounds it on the H100: bytes. Each valid (b, kv, slot) row of k and
// of v is read once, 2 * Dh * elt bytes, and feeds 4 * G * Dh fp32
// operations: G operations per byte in bf16 (3 on the SmolLM-135M decode
// path), far under the card's ~20 fp32 operations per byte of memory
// bandwidth. The least time is those bytes over 3.35 TB/s (the path's first
// step, B=8, KV=3, Dh=64, 4097 slots, bf16: 25.2 MB, ~7.5 us).
//
// What the design does about it:
//  * The TPU kernel walks the cache in sequential chunk steps of one grid
//    cell per (b, kv), carrying (m, l, acc) in scratch. Here blocks run in
//    parallel, so the slots are split (flash-decoding): grid (n_splits,
//    KV * g_tiles, B); each block streams its slice of one (b, kv) cache
//    once and writes a partial (m, l, acc[Dh]) per query head; a second
//    launch rescales and sums the partials into the output. At B*KV = 24
//    (b, kv) pairs the wrapper picks ~4 blocks per SM in all.
//  * The G query heads of a KV head share every k/v read: a block holds up
//    to GT (4 or 8, a template bound; G itself is a runtime count, larger G
//    is tiled over blockIdx.y) heads' running states in registers.
//  * Each lane loads 16 bytes of a row (8 bf16/fp16 or 4 fp32 values);
//    Dh / 8 (or / 4) neighbouring lanes cover one row, reading neighbouring
//    addresses. The row's dot products are reduced across those lanes with
//    shuffles; each lane group keeps its own online softmax, and the lane
//    groups are merged by shuffles within the warp, then across the warps
//    through shared memory.
//  * A split wholly past lengths[b] reads nothing and writes an empty
//    partial (m = -inf, l = 0, acc = 0), which the combine gives no weight.
//  * p and the PV sums stay fp32 (the TPU kernel rounds the unnormalised p
//    to v's dtype; the step is memory-bound here, so fp32 costs nothing).
// cp.async/TMA rings and a persistent grid are later work; this is simple
// and right.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16 bytes of T widened to fp32, and one fp32 value rounded to T.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  __device__ static float store(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

template <>
struct Elt<__half> {
  static constexpr int kVec = 8;
  __device__ static void load(const __half* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
  __device__ static __half store(float x) { return __float2half(x); }
};

// Weight of a running state with max m inside a merge whose max is M.
__device__ __forceinline__ float rescale(float m, float M) {
  return M == -INFINITY ? 0.f : expf(m - M);
}

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int S, int KV, int G,
                   int split, int n_splits, float scale) {
  constexpr int VEC = Elt<T>::kVec;
  constexpr int LPR = DH / VEC;        // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows a warp covers per step
  constexpr int RPB = kThreads / LPR;  // rows the block covers per step
  static_assert(LPR >= 1 && LPR <= 32 && (32 % LPR) == 0, "Dh / vector");
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][DH];

  const int sp = blockIdx.x;
  const int g_tiles = (G + GT - 1) / GT;
  const int kv = blockIdx.y / g_tiles;
  const int g0 = (blockIdx.y % g_tiles) * GT;
  const int ng = min(GT, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = (lane % LPR) * VEC;  // this lane's first column of a row

  const int len = lengths[b];
  const bool uniform = len <= 0;       // no valid slot: all S weigh equally
  const int n = uniform ? S : min(len, S);
  const int lo = sp * split;
  const int hi = min(lo + split, n);

  float qf[GT][VEC];
  const T* qb = q + (static_cast<size_t>(b) * KV + kv) * G * DH +
                static_cast<size_t>(g0) * DH + col;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      Elt<T>::load(qb + static_cast<size_t>(g) * DH, qf[g]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qf[g][j] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KV) * DH;
  const size_t head = (static_cast<size_t>(b) * S * KV + kv) * DH + col;
  const T* kb = k + head;
  const T* vb = v + head;
  // The loop bound is the same for every lane of a warp, so the shuffles
  // below always see the whole warp; a lane group past hi only idles.
  for (int base = lo + warp * RPW; base < hi; base += RPB) {
    const int s = base + lane / LPR;
    const bool live = s < hi;
    float kf[VEC], vf[VEC];
    if (live) {
      Elt<T>::load(vb + s * row_stride, vf);
      if (!uniform) Elt<T>::load(kb + s * row_stride, kf);
    }
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float d = 0.f;
      if (live && !uniform) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) d = fmaf(qf[g][j], kf[j], d);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[g] = d * scale;
    }
    if (!live) continue;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) break;
      const float x = sc[g];
      if (x > m[g]) {                  // new max: rescale, this row's p = 1
        const float c = expf(m[g] - x);
        l[g] = fmaf(l[g], c, 1.f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(acc[g][j], c, vf[j]);
        m[g] = x;
      } else {
        const float p = expf(x - m[g]);
        l[g] += p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
      }
    }
  }

  // merge the lane groups of the warp (lanes with the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float a = rescale(m[g], M);
      const float c = rescale(mo, M);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + ao * c;
      }
      m[g] = M;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sm_acc[warp][g][col + j] = acc[g][j];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and write this split's partial of each head
  for (int e = tid; e < ng * DH; e += kThreads) {
    const int g = e / DH;
    const int d = e % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w][g], M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    const size_t row =
        ((static_cast<size_t>(b) * KV + kv) * G + g0 + g) * n_splits + sp;
    part_acc[row * DH + d] = A;
    if (d == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

// One block per (b, kv, g) output row, one thread per column.
template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     T* __restrict__ out, int n_splits,
                                     int DH) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  const float* pa = part_acc + row * n_splits * DH;
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, pm[i]);
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float c = rescale(pm[i], M);
      L += pl[i] * c;
      A += pa[static_cast<size_t>(i) * DH + d] * c;
    }
    out[row * DH + d] = Elt<T>::store(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int DH, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* part_m, float* part_l,
                   float* part_acc, void* out, int B, int S, int KV, int G,
                   int split, int n_splits, float scale, cudaStream_t stream) {
  const int g_tiles = (G + GT - 1) / GT;
  const dim3 grid(n_splits, KV * g_tiles, B);
  flash_decode_split<T, DH, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_m, part_l, part_acc, S, KV, G,
      split, n_splits, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_combine<T><<<B * KV * G, DH, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_splits, DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* lengths, float* pm, float* pl, float* pa,
                     void* out, int B, int S, int KV, int G, int split,
                     int n_splits, float scale, cudaStream_t stream) {
  return G <= 4 ? launch<T, DH, 4>(q, k, v, lengths, pm, pl, pa, out, B, S,
                                   KV, G, split, n_splits, scale, stream)
                : launch<T, DH, 8>(q, k, v, lengths, pm, pl, pa, out, B, S,
                                   KV, G, split, n_splits, scale, stream);
}

template <typename T>
cudaError_t launch_dh(int Dh, const void* q, const void* k, const void* v,
                      const int* lengths, float* pm, float* pl, float* pa,
                      void* out, int B, int S, int KV, int G, int split,
                      int n_splits, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch_g<T, 16>(q, k, v, lengths, pm, pl, pa, out, B, S, KV, G,
                             split, n_splits, scale, stream);
    case 32:
      return launch_g<T, 32>(q, k, v, lengths, pm, pl, pa, out, B, S, KV, G,
                             split, n_splits, scale, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, lengths, pm, pl, pa, out, B, S, KV, G,
                             split, n_splits, scale, stream);
    case 128:
      return launch_g<T, 128>(q, k, v, lengths, pm, pl, pa, out, B, S, KV, G,
                              split, n_splits, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, 2 fp16 (q, k, v and out alike). part_m/part_l are
// (B, KV, G, n_splits) fp32 and part_acc (B, KV, G, n_splits, Dh) fp32
// scratch. Returns cudaGetLastError() after the two launches (0 = launched).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* part_m, void* part_l,
                        void* part_acc, void* out, int B, int S, int KV, int G,
                        int Dh, int split, int n_splits, int dtype, float scale,
                        void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_dh<float>(Dh, q, k, v, len, pm, pl, pa, out, B, S, KV, G,
                           split, n_splits, scale, st);
      break;
    case 1:
      e = launch_dh<__nv_bfloat16>(Dh, q, k, v, len, pm, pl, pa, out, B, S,
                                   KV, G, split, n_splits, scale, st);
      break;
    case 2:
      e = launch_dh<__half>(Dh, q, k, v, len, pm, pl, pa, out, B, S, KV, G,
                            split, n_splits, scale, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
