// Single-token GQA decode attention over a KV cache (flash-decoding) for
// Hopper (sm_90a), in one launch.
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
// What bounds it on the H100: bytes. Each valid (b, slot) row of k and of v
// is read once, 2 * KV * Dh * elt bytes, and feeds 4 * KV * G * Dh fp32
// operations: G operations per byte in bf16 (3 on the SmolLM-135M decode
// path), far under the card's ~20 fp32 operations per byte of memory
// bandwidth. The least time is those bytes over 3.35 TB/s (the path's first
// step, B=8, KV=3, Dh=64, 4097 slots, bf16: 25.2 MB, ~7.5 us; decode_32k's
// context, 32,768 slots: 201 MB, ~60 us). No tensor cores: the KV * G = 9
// query rows of a slot are far below wgmma's 64-row M, and the product is
// bytes-bound at G operations a byte.
//
// What the design does about it:
//  * Every byte once, contiguously. A block serves one sequence b, one
//    split of its slots and KVT of its KV heads (all of them when KV * Dh
//    fits the lane groups, as at SmolLM's widths), with the query heads of
//    each (up to GT, a template bound; larger G and KV are tiled over
//    blockIdx.y). A slot's KVT * Dh span of k and of v (384 B at SmolLM's
//    widths) is one contiguous run, and a tile of slots is one contiguous
//    run of the cache.
//  * Bytes in flight: a ring of 3 stages of (slots x KVT * Dh) k and v
//    tiles in shared memory, up to 32 KB a stage, filled by bulk copies
//    (TMA, cp.async.bulk) that thread 0 issues, one for k and one for v a
//    tile when the tile holds all KV heads (one a slot otherwise), each
//    stage handed over by an mbarrier; two tiles load while one is
//    computed. Splits are chosen (ops.split_slots) to put two 256-thread
//    blocks on each SM in one wave; at GT <= 4 the kernel is held to 128
//    registers so that both fit.
//  * Compute from shared memory: Dh / 8 (or / 4 in fp32) neighbouring
//    lanes, a lane group, take a (slot, kv) row of the tile with one
//    16-byte read each of k and of v; lane groups are bound to one kv head
//    and keep the running (m, l, acc) of its query heads in registers. A
//    group takes kRows rows at once: their dot products, shuffle
//    reductions across the group and exponentials are independent and
//    overlap, and the state is rescaled at most once a batch. Scores are
//    kept in base 2 (q pre-scaled by Dh^-1/2 log2 e; ex2.approx).
//  * One launch. After its slots, a block merges its lane groups through
//    shared memory and writes one partial (m, l, acc[Dh]) per query head
//    for its split, then __threadfence() and an atomicAdd on its (b, head
//    tile) counter. The last block to arrive brings the splits' partials
//    into shared memory (16-byte cp.async, all in flight at once) and
//    combines them in split order (one warp a head turns each split's max
//    into its weight, then a thread sums four columns of a head), so the
//    output has the same bits on every run, writes the output and sets the
//    counter back to 0 for the next call. The counters live in the
//    wrapper, zeroed once. The lane groups' merge inside a block is the
//    same combine.
//  * A split wholly past lengths[b] reads nothing and writes an empty
//    partial (m = -inf, l = 0, acc = 0), which the combine gives no weight.
//  * p and the PV sums stay fp32 (the TPU kernel rounds the unnormalised p
//    to v's dtype); the oracle's numerics, kept at the cost of fp32 FMAs.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// 2^x in one MUFU instruction (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Weight of a running state with max m (base 2) inside a merge whose max
// is M.
__device__ __forceinline__ float rescale(float m, float M) {
  return M == -INFINITY ? 0.f : ex2(m - M);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// One bulk copy (TMA, no tensor map) of `bytes` contiguous bytes, reported
// to the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr int kStages = 3;
constexpr int kRows = 4;       // rows a lane group takes from each tile

// Dynamic shared memory of one launch: the ring, or the lane groups'
// merge buffer after it, whichever is larger.
template <typename T, int DH, int GT>
struct Shape {
  static constexpr int kVec = Elt<T>::kVec;
  static constexpr int kLpr = DH / kVec;            // lanes per cache row
  static constexpr int kGroups = kThreads / kLpr;   // lane groups a block
  __host__ __device__ static int kvt(int KV) {
    return KV < kGroups ? KV : kGroups;
  }
  __host__ __device__ static int slots(int kvt) {
    return (kGroups / kvt) * kRows;
  }
  __host__ __device__ static int chunks(int kvt) {
    return kvt * DH * static_cast<int>(sizeof(T)) / 16;
  }
  __host__ __device__ static int smem(int kvt) {
    const int ring = kStages * 2 * slots(kvt) * chunks(kvt) * 16;
    const int merge = kGroups * GT * (DH + 4) * 4;
    return ring > merge ? ring : merge;
  }
};

// Combine n states (m, l, two pad words, acc[DH]) of each of kvt * ng query
// heads in a fixed order. Head h = (kk, g) keeps its n states consecutively
// at p + kk * kv_stride + g * n * kPart. One warp a head takes the max M and
// turns each state's m into its weight exp2(m - M) (M goes to the first
// state's pad word); then a thread sums weight * acc over four columns of a
// head, and weight * l, over the states in order. final: out = acc / l in
// T; else the (M, L, acc) partial of split sp goes to part. kGlobal: p is
// device memory that other blocks wrote, read through L2.
template <typename T, int DH, bool kGlobal>
__device__ __forceinline__ void combine(float* p, size_t kv_stride, int kvt,
                                        int ng, int n, bool final, T* out,
                                        float* part, int b, int KV, int G,
                                        int kv0, int g0, int n_splits,
                                        int sp) {
  constexpr int kPart = DH + 4;
  constexpr int kQuads = DH / 4;       // a thread takes 4 columns of a head
  auto ld = [](const float* a) { return kGlobal ? __ldcg(a) : *a; };
  auto ld4 = [](const float* a) {
    return kGlobal ? __ldcg(reinterpret_cast<const float4*>(a))
                   : *reinterpret_cast<const float4*>(a);
  };
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int heads = kvt * ng;
  for (int h = tid / 32; h < heads; h += kThreads / 32) {
    float* ph = p + (h / ng) * kv_stride +
                static_cast<size_t>(h % ng) * n * kPart;
    float M = -INFINITY;
    for (int i = lane; i < n; i += 32) M = fmaxf(M, ld(ph + i * kPart));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    for (int i = lane; i < n; i += 32)
      ph[i * kPart] = rescale(ld(ph + i * kPart), M);
    if (lane == 0) ph[3] = M;
  }
  __syncthreads();
  for (int e = tid; e < heads * kQuads; e += kThreads) {
    const int h = e / kQuads;
    const int d = (e % kQuads) * 4;
    const float* ph = p + (h / ng) * kv_stride +
                      static_cast<size_t>(h % ng) * n * kPart;
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float c = ld(ph + i * kPart);
      const float4 a = ld4(ph + i * kPart + 4 + d);
      L = fmaf(ld(ph + i * kPart + 1), c, L);
      A.x = fmaf(a.x, c, A.x);
      A.y = fmaf(a.y, c, A.y);
      A.z = fmaf(a.z, c, A.z);
      A.w = fmaf(a.w, c, A.w);
    }
    const size_t head =
        (static_cast<size_t>(b) * KV + kv0 + h / ng) * G + g0 + h % ng;
    if (final) {
      const float Lc = fmaxf(L, 1e-30f);
      T* o = out + head * DH + d;
      o[0] = Elt<T>::store(A.x / Lc);
      o[1] = Elt<T>::store(A.y / Lc);
      o[2] = Elt<T>::store(A.z / Lc);
      o[3] = Elt<T>::store(A.w / Lc);
    } else {
      float* pr = part + (head * n_splits + sp) * kPart;
      *reinterpret_cast<float4*>(pr + 4 + d) = A;
      if (d == 0) {
        pr[0] = ld(ph + 3);
        pr[1] = L;
      }
    }
  }
}

template <typename T, int DH, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 4 ? 2 : 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part, int* __restrict__ counters,
                    T* __restrict__ out, int S, int KV, int G, int KVT,
                    int split, int n_splits, float qscale, int smem_floats) {
  using Sh = Shape<T, DH, GT>;
  constexpr int kPart = DH + 4;        // a partial: m, l, 2 pad, acc[DH]
  constexpr int VEC = Sh::kVec;
  constexpr int LPR = Sh::kLpr;
  constexpr int NLG = Sh::kGroups;
  static_assert(LPR >= 1 && LPR <= 32 && (32 % LPR) == 0, "Dh / vector");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int last;

  const int sp = blockIdx.x;
  const int g_tiles = (G + GT - 1) / GT;
  const int kv0 = (blockIdx.y / g_tiles) * KVT;
  const int kvt = min(KVT, KV - kv0);
  const int g0 = (blockIdx.y % g_tiles) * GT;
  const int ng = min(GT, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lg = tid / LPR;            // this thread's lane group
  const int col = (tid % LPR) * VEC;   // its first column of a row
  const int n_sub = NLG / kvt;         // lane groups a kv head
  const int kvl = lg % kvt;            // the group's kv head, in the tile
  const int sub = lg / kvt;
  const bool active = sub < n_sub;
  const int TS = n_sub * kRows;        // slots a tile
  const int W = Sh::chunks(kvt);       // 16-byte chunks a slot's span
  const int half = TS * W * 16;        // bytes of k (then v) in a stage

  const int len = lengths[b];
  const bool uniform = len <= 0;       // no valid slot: all S weigh equally
  const int n = uniform ? S : min(len, S);
  const int lo = sp * split;
  const int hi = min(lo + split, n);
  const int n_tiles = hi > lo ? (hi - lo + TS - 1) / TS : 0;

  const size_t slot_bytes = static_cast<size_t>(KV) * DH * sizeof(T);
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(
      k + static_cast<size_t>(b) * S * KV * DH + static_cast<size_t>(kv0) * DH);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(
      v + static_cast<size_t>(b) * S * KV * DH + static_cast<size_t>(kv0) * DH);
  // Thread 0 loads each tile with bulk copies (TMA) reported to its stage's
  // mbarrier: a tile of all KV heads is one contiguous run of the cache
  // for k and one for v; a tile of some of them, one run a slot.
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int t) {
    uint8_t* dst = smem + (t % kStages) * 2 * half;
    const uint32_t bar = smem_u32(&full[t % kStages]);
    const int s0 = lo + t * TS;
    const int ns = min(TS, hi - s0);
    const uint32_t row = W * 16;       // bytes of a slot's span
    mbar_expect_tx(bar, (uniform ? 1 : 2) * ns * row);
    const size_t off = static_cast<size_t>(s0) * slot_bytes;
    if (kvt == KV) {
      if (!uniform) bulk_load(dst, kb + off, ns * row, bar);
      bulk_load(dst + half, vb + off, ns * row, bar);
    } else {
      for (int sl = 0; sl < ns; ++sl) {
        if (!uniform) bulk_load(dst + sl * row, kb + off + sl * slot_bytes,
                                row, bar);
        bulk_load(dst + half + sl * row, vb + off + sl * slot_bytes, row,
                  bar);
      }
    }
  };
  if (tid == 0)
    for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_tile(t);

  float qf[GT][VEC];
  const T* qb = q + ((static_cast<size_t>(b) * KV + kv0 + kvl) * G + g0) * DH +
                col;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (active && g < ng) {
      Elt<T>::load(qb + static_cast<size_t>(g) * DH, qf[g]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) qf[g][j] *= qscale;
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

  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(smem_u32(&full[t % kStages]), (t / kStages) & 1);
    __syncthreads();                   // tile t is in; tile t-1 is done
    if (tid == 0 && t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    const uint8_t* st = smem + (t % kStages) * 2 * half;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = reinterpret_cast<const T*>(st + half);
    const int s0 = lo + t * TS;
    // A lane group takes its kRows rows of the tile together: the rows'
    // dot products, their shuffle reductions and their exponentials are
    // independent, so they overlap; (m, l, acc) are rescaled once a batch.
    // The loop bounds are the same for every lane of a warp, so the
    // shuffles always see the whole warp; a dead row only idles.
    float sc[kRows][GT];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int sl = sub * kRows + r;
      live[r] = active && s0 + sl < hi;
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[r][g] = 0.f;
      if (live[r] && !uniform) {
        float kf[VEC];
        Elt<T>::load(ks + (sl * kvt + kvl) * DH + col, kf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            sc[r][g] = fmaf(qf[g][j], kf[j], sc[r][g]);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          sc[r][g] += __shfl_xor_sync(0xffffffffu, sc[r][g], o);
#pragma unroll
    for (int g = 0; g < GT; ++g) {     // scores become p, base 2
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (!live[r]) sc[r][g] = -INFINITY;
      float mt = m[g];
#pragma unroll
      for (int r = 0; r < kRows; ++r) mt = fmaxf(mt, sc[r][g]);
      const float ref = mt == -INFINITY ? 0.f : mt;   // no live row yet
      float ps = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sc[r][g] = ex2(sc[r][g] - ref);  // a dead row: 0
        ps += sc[r][g];
      }
      if (mt != m[g]) {                // the max moved: rescale the state
        const float c = rescale(m[g], mt);
        l[g] *= c;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= c;
        m[g] = mt;
      }
      l[g] += ps;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!live[r]) continue;
      float vf[VEC];
      Elt<T>::load(vs + ((sub * kRows + r) * kvt + kvl) * DH + col, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] = fmaf(sc[r][g], vf[j], acc[g][j]);
    }
  }
  __syncthreads();                     // the ring becomes the merge buffer

  // merge the lane groups of each kv head into this split's partials:
  // mb holds, for head (kk, g), the n_sub lane groups' states in order
  float* mb = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) break;
      float* row = mb + ((kvl * ng + g) * n_sub + sub) * kPart;
      if (col == 0) {
        row[0] = m[g];
        row[1] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) row[4 + col + j] = acc[g][j];
    }
  }
  __syncthreads();
  combine<T, DH, false>(mb, static_cast<size_t>(ng) * n_sub * kPart, kvt, ng,
                        n_sub, false, out, part, b, KV, G, kv0, g0, n_splits,
                        sp);

  // the last block of (b, head tile) combines the splits, in split order
  __threadfence();
  __syncthreads();
  int* counter = counters + b * gridDim.y + blockIdx.y;
  if (tid == 0) last = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The tile's partials come into shared memory with 16-byte copies, all in
  // flight at once (they are L2-resident), when they fit; else they are
  // combined where they are.
  const int per_kv = ng * n_splits * kPart;
  float* pt = part + ((static_cast<size_t>(b) * KV + kv0) * G + g0) *
                         n_splits * kPart;
  const size_t kv_stride = static_cast<size_t>(G) * n_splits * kPart;
  if (kvt * per_kv <= smem_floats) {
    float* st = reinterpret_cast<float*>(smem);
    const int q4 = per_kv / 4;       // rows of kPart floats: 16-byte chunks
    for (int c = tid; c < kvt * q4; c += kThreads) {
      const int kk = c / q4;
      const int i = 4 * (c - kk * q4);
      cp_async16(st + kk * per_kv + i, pt + kk * kv_stride + i);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    combine<T, DH, false>(st, per_kv, kvt, ng, n_splits, true, out, part, b,
                          KV, G, kv0, g0, n_splits, sp);
  } else {
    combine<T, DH, true>(pt, kv_stride, kvt, ng, n_splits, true, out, part,
                         b, KV, G, kv0, g0, n_splits, sp);
  }
  if (tid == 0) *counter = 0;
}

template <typename T, int DH, int GT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* part, int* counters, void* out,
                   int B, int S, int KV, int G, int split, int n_splits,
                   float qscale, cudaStream_t stream) {
  using Sh = Shape<T, DH, GT>;
  static int smem_set = 0;
  const int kvt = Sh::kvt(KV);
  const int smem = Sh::smem(kvt);
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, DH, GT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int g_tiles = (G + GT - 1) / GT;
  const dim3 grid(n_splits, ((KV + kvt - 1) / kvt) * g_tiles, B);
  flash_decode_kernel<T, DH, GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part, counters, static_cast<T*>(out),
      S, KV, G, kvt, split, n_splits, qscale, smem / 4);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* lengths, float* part, int* counters, void* out,
                     int B, int S, int KV, int G, int split, int n_splits,
                     float qscale, cudaStream_t stream) {
#define FD_LAUNCH(GT)                                                       \
  launch<T, DH, GT>(q, k, v, lengths, part, counters, out, B, S, KV, G,    \
                    split, n_splits, qscale, stream)
  if (G == 1) return FD_LAUNCH(1);
  if (G <= 3) return FD_LAUNCH(3);
  if (G <= 4) return FD_LAUNCH(4);
  return FD_LAUNCH(8);
#undef FD_LAUNCH
}

template <typename T>
cudaError_t launch_dh(int Dh, const void* q, const void* k, const void* v,
                      const int* lengths, float* part, int* counters,
                      void* out, int B, int S, int KV, int G, int split,
                      int n_splits, float qscale, cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch_g<T, 16>(q, k, v, lengths, part, counters, out, B, S, KV,
                             G, split, n_splits, qscale, stream);
    case 32:
      return launch_g<T, 32>(q, k, v, lengths, part, counters, out, B, S, KV,
                             G, split, n_splits, qscale, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, lengths, part, counters, out, B, S, KV,
                             G, split, n_splits, qscale, stream);
    case 128:
      return launch_g<T, 128>(q, k, v, lengths, part, counters, out, B, S, KV,
                              G, split, n_splits, qscale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, 2 fp16 (q, k, v and out alike). part is
// (B, KV, G, n_splits, 4 + Dh) fp32 scratch (m, l, two pad words and acc of
// each split, so that rows are 16-byte aligned);
// counters holds at least B * KV * G int32 zeros, and the kernel leaves
// them zero. Returns cudaGetLastError() after the one launch (0 =
// launched).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* part, void* counters,
                        void* out, int B, int S, int KV, int G, int Dh,
                        int split, int n_splits, int dtype, float scale,
                        void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  const float qscale = scale * 1.4426950408889634f;   // base-2 scores
  cudaError_t e;
  switch (dtype) {
    case 0:
      e = launch_dh<float>(Dh, q, k, v, len, pt, ct, out, B, S, KV, G, split,
                           n_splits, qscale, st);
      break;
    case 1:
      e = launch_dh<__nv_bfloat16>(Dh, q, k, v, len, pt, ct, out, B, S, KV, G,
                                   split, n_splits, qscale, st);
      break;
    case 2:
      e = launch_dh<__half>(Dh, q, k, v, len, pt, ct, out, B, S, KV, G, split,
                            n_splits, qscale, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
