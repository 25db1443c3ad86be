// IVF centroid scoring for Hopper (sm_90a): scores = Q . C^T.
//
// Replaces: src/repro/kernels/ivf_scan/ivf_scan.py:ivf_scan_pallas.
// q (B, D) fp32, centroids (N, D) fp32 -> out (B, N) fp32. This is the score
// matrix behind probe_cells; the caller takes a stable top-k of each row.
//
// What bounds it on the H100: bytes. At the query path's shape (B = 64
// queries, N = 3,703 cells, D = 128) q, the centroids and the scores are
// 2.88 MB: 0.86 us at 3.35 TB/s. The products below are 3 x 2*B*N*D = 182
// MFLOP on the TF32 tensor cores, 0.37 us at 495 TFLOP/s. Either is far
// under a launch, so what a design can win is latency: every block's loads
// in flight at once, work that starts as soon as its part has landed, few
// instructions a product, and short chains of products.
//
// What the design does about it:
//  * fp32-accurate products on the tensor cores, "3xTF32": each fp32
//    operand x is split into big = tf32(x) (cvt.rna: round to nearest, ties
//    away from zero, the low 13 bits zero) and small = tf32(x - big); the
//    kernel sums small_q.big_c, big_q.small_c and big_q.big_c, each in its
//    own fp32 accumulator (three short chains instead of one long one),
//    with mma.sync m16n8k8 (tf32 in, fp32 out), and adds them at the end.
//    What is left out, small.small and small's own rounding, is ~2^-21 of
//    |q_i c_i|, the size of an fp32 product's own rounding.
//  * A block owns a 32 x 32 tile of the scores: at N = 3,703 and B = 64 the
//    grid is 116 x 2 = 232 blocks, 2 on most of the 132 SMs. Its 8 warps
//    are 2 row warps (16 query rows, four 8-column n-tiles each) times 4
//    groups that split D: group w multiplies the 32-column chunks w, w + 4,
//    ... of q and the centroids.
//  * Every thread copies its share of each chunk with cp.async (16 bytes a
//    copy where D is a multiple of 4 and the rows are 16-byte aligned, 4
//    bytes otherwise; a source size of 0 zero-fills rows past B or N and
//    columns past D), then arrives on that chunk's barrier when its copies
//    land (cp.async.mbarrier.arrive), so a group starts as soon as its own
//    chunk is complete, not when the last one is. D past 4 chunks goes in
//    rounds, the next round in flight while this one is multiplied.
//  * Fragments come from shared memory in 16-byte loads: the order of k
//    inside an mma is free as long as a and b agree, so thread t takes the
//    4 adjacent columns 4t .. 4t + 3 of each 16-column step; rows 48
//    floats apart put each load phase's 8 threads in 8 bank groups.
//  * Each group stages its sums in shared memory; then every thread adds
//    the groups' sums of some elements of the tile in group order (the same
//    bits on every call) and writes them, consecutive threads on
//    consecutive columns, inside (B, N) only: there are no pad columns,
//    which equals what the TPU kernel returns after its [:B, :N] slice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;      // query rows per block
constexpr int kBN = 32;      // centroids per block
constexpr int kBK = 32;      // D columns per chunk (128 bytes)
constexpr int kSplit = 4;                // warp groups that split D
constexpr int kRowWarps = kBM / 16;      // warps of a group: 16 rows each
constexpr int kThreads = 32 * kRowWarps * kSplit;
constexpr int kMinBlocks = 2;            // blocks an SM holds at once
constexpr int kNT = kBN / 8;             // 8-column n-tiles a warp
constexpr int kPitch = kBK + 16;         // staged row, floats
constexpr int kSlot = (kBM + kBN) * kPitch;   // floats of one chunk
constexpr int kRedPitch = kBN + 1;       // staged output row, floats
constexpr int kRed = kSplit * kBM * kRedPitch;

// Dynamic shared memory: the chunks of one round (two when D needs more
// than one round), the staged sums, a barrier a chunk slot.
int smem_bytes(int D) {
  const int chunks = (D + kBK - 1) / kBK;
  const int buffers = chunks > kSplit ? 2 : 1;
  return (buffers * kSplit * kSlot + kRed) * 4 + 2 * kSplit * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32; small holds what big rounded off.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d (16 x 8, fp32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col). Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_1688(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The products of columns kk .. kk + 15 of a staged chunk (q rows 0..31,
// then centroid rows 32..63): two m16n8k8 steps of three products each.
// Thread t's k-indices t and t + 4 of step h are columns kk + 4t + 2h and
// kk + 4t + 2h + 1, so each of its rows is one 16-byte load.
__device__ __forceinline__ void step(const float* chunk, int kk, int r, int g,
                                     int t, float (&sb)[kNT][4],
                                     float (&bs)[kNT][4],
                                     float (&bb)[kNT][4]) {
  // a: rows r, r + 8 of this warp's 16 rows
  const float4 x =
      *reinterpret_cast<const float4*>(chunk + r * kPitch + kk + 4 * t);
  const float4 y = *reinterpret_cast<const float4*>(
      chunk + (r + 8) * kPitch + kk + 4 * t);
  uint32_t ab[2][4], as[2][4];
  split(x.x, ab[0][0], as[0][0]);
  split(y.x, ab[0][1], as[0][1]);
  split(x.y, ab[0][2], as[0][2]);
  split(y.y, ab[0][3], as[0][3]);
  split(x.z, ab[1][0], as[1][0]);
  split(y.z, ab[1][1], as[1][1]);
  split(x.w, ab[1][2], as[1][2]);
  split(y.w, ab[1][3], as[1][3]);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    // b: centroid 8j + g
    const float4 z = *reinterpret_cast<const float4*>(
        chunk + (kBM + 8 * j + g) * kPitch + kk + 4 * t);
    uint32_t b_big[2][2], b_small[2][2];
    split(z.x, b_big[0][0], b_small[0][0]);
    split(z.y, b_big[0][1], b_small[0][1]);
    split(z.z, b_big[1][0], b_small[1][0]);
    split(z.w, b_big[1][1], b_small[1][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma_1688(sb[j], as[h], b_big[h]);
      mma_1688(bs[j], ab[h], b_small[h]);
      mma_1688(bb[j], ab[h], b_big[h]);
    }
  }
}

// Copy `bytes` (kSize or 0) from src to dst, zero-filling the rest.
template <int kSize>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if (kSize == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// One arrival on bar once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
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

template <int kSize>   // bytes a copy: 16, or 4 for any D and alignment
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ c,
                float* __restrict__ out, int B, int N, int D) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVals = kSize / 4;     // floats a copy
  constexpr int kCopies = (kBM + kBN) * (kBK / kVals);   // a chunk's
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp % kRowWarps, wg = warp / kRowWarps;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int chunks = (D + kBK - 1) / kBK;
  const int rounds = (chunks + kSplit - 1) / kSplit;
  const int buffers = rounds > 1 ? 2 : 1;
  float* red = smem + buffers * kSplit * kSlot;
  const uint32_t bars = smem_u32(red + kRed);

  // Chunk ch's slot (and barrier): round ch / kSplit's buffer.
  auto slot = [&](int ch) {
    return (buffers > 1 ? (ch / kSplit) % 2 : 0) * kSplit + ch % kSplit;
  };
  auto load_round = [&](int rd) {
    for (int j = 0; j < kSplit; ++j) {
      const int ch = rd * kSplit + j;
      if (ch >= chunks) break;
      float* dst = smem + slot(ch) * kSlot;
      for (int e = tid; e < kCopies; e += kThreads) {
        const int r = e / (kBK / kVals);
        const int col = (e % (kBK / kVals)) * kVals;
        const int d = ch * kBK + col;
        const bool is_q = r < kBM;
        const int gr = is_q ? m0 + r : n0 + r - kBM;
        const float* src = is_q ? q : c;
        const bool ok = gr < (is_q ? B : N) && d < D;
        cp_async<kSize>(smem_u32(dst + r * kPitch + col),
                        ok ? src + static_cast<size_t>(gr) * D + d : src,
                        ok ? kSize : 0);
      }
      cp_async_arrive(bars + 8 * slot(ch));
    }
  };

  if (tid < buffers * kSplit) mbar_init(bars + 8 * tid, kThreads);
  __syncthreads();
  float sb[kNT][4] = {}, bs[kNT][4] = {}, bb[kNT][4] = {};
  load_round(0);
  for (int rd = 0; rd < rounds; ++rd) {
    // round rd + 1 into the buffer that round rd - 1 left free
    if (rd + 1 < rounds) load_round(rd + 1);
    const int ch = rd * kSplit + wg;
    if (ch < chunks) {
      // the slot's (rd / 2)-th use: its phase of that parity
      mbar_wait(bars + 8 * slot(ch), (rd / 2) & 1);
      if (m0 + 16 * wr < B) {          // this warp has a row inside B
        const float* chunk = smem + slot(ch) * kSlot;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16)
          step(chunk, kk, 16 * wr + g, g, t, sb, bs, bb);
      }
    }
    if (rounds > 1) __syncthreads();   // round rd's slots are free
  }

  // Each group's sum into red[group][row][column] (c0, c1: row g, columns
  // 2t, 2t + 1; c2, c3: row g + 8), then the tile's elements, the groups
  // added in group order.
  float* mine = red + wg * kBM * kRedPitch;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mine[(16 * wr + g + 8 * (i / 2)) * kRedPitch + 8 * j + 2 * t + i % 2] =
          (sb[j][i] + bs[j][i]) + bb[j][i];
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, col = e % kBN;
    const int gm = m0 + r, gn = n0 + col;
    if (gm >= B || gn >= N) continue;
    float v = red[r * kRedPitch + col];
#pragma unroll
    for (int w = 1; w < kSplit; ++w) v += red[(w * kBM + r) * kRedPitch + col];
    out[static_cast<size_t>(gm) * N + gn] = v;
  }
}

template <int kSize>
cudaError_t launch(const float* q, const float* c, float* out, int B, int N,
                   int D, cudaStream_t stream) {
  static bool smem_set = false;       // once: the two-buffer size
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_scan_kernel<kSize>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kSplit * kBK + 1));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  ivf_scan_kernel<kSize><<<grid, kThreads, smem_bytes(D), stream>>>(
      q, c, out, B, N, D);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int ivf_scan_launch(const void* q, const void* centroids, void* out, int B,
                    int N, int D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(centroids);
  float* of = static_cast<float*>(out);
  const cudaError_t e =
      D % 4 == 0 && aligned16(q) && aligned16(centroids)
          ? launch<16>(qf, cf, of, B, N, D, s)
          : launch<4>(qf, cf, of, B, N, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
