// Batched FDE inner products for Hopper (sm_90a): scores = Q . Docs^T.
//
// Replaces: src/repro/kernels/fdescan/fdescan.py:fdescan_pallas.
// q (B, D) fp32, docs (N, D) fp16 (the resident FDE table) or fp32
//   ->  out (B, N) fp32.
// This is the brute-force candidate scan of the fde and cascade backends;
// the caller takes a stable top-k of each row.
//
// What bounds it on the H100: bytes. At the query path's shape (B = 64
// queries, N = 1,000,000 docs, D = 256, fp16 table) the table is 512 MB
// and the output 256 MB of fp32: 0.229 ms at 3.35 TB/s. On the tensor
// cores the product takes two fp16 passes (q in two parts, below), 2 x
// 2*B*N*D = 65.5 GFLOP, 0.066 ms at 989 TFLOP/s.
//
// Two kernels; fdescan_launch picks one from the dtype, D and alignment
// before it launches (fdescan_kernel_for), never after a failure:
//
// * fdescan_wgmma, the main path's case: an fp16 table, D a multiple of 8
//   and at most 256, q and the table 16-byte aligned.
//   - Products on the tensor cores: wgmma.mma_async m64n128k16, f32 +=
//     f16 * f16. A is 64 query rows (one warpgroup's M) and B a tile of
//     128 docs, both K-major (the table's own row layout) in shared memory
//     in the 128-byte swizzle, K = D in 16-deep steps.
//   - q in two fp16 parts. q is fp32; one rounding to fp16 would cost
//     ~2^-11 of sum|q_i d_i|, ten times the check's tolerance. Each block
//     scales row r by a power of two 2^(1-e_r) (exact) so that its largest
//     |q| lies in [1, 2), and keeps hi = fp16(q') and lo = fp16((q' - hi)
//     * 2^11). Two fp32 accumulators; out = (acc_hi + 2^-11 acc_lo) *
//     2^(e_r-1). The fp16 table is exact in the tensor cores, so what is
//     left is lo's own rounding, ~2^-22 of max|q|.
//   - A ring of 6 stages of (128 docs x 64 columns) fp16 tiles, 16 KB
//     each, filled by TMA (one 2D box each, zero-filled past N and D) and
//     handed over with mbarriers: warp 4 is the producer, one lane issuing
//     the copies; warps 0-3 are the consumer warpgroup that runs wgmma and
//     the epilogue, so the next tiles' loads overlap this tile's epilogue.
//   - A persistent grid: one block per SM (~195 KB of shared memory) walks
//     the N tiles with a stride of the grid, for one 64-row group of q
//     (gridDim.y groups for B > 64).
//   - The epilogue stages the 64 x 128 fp32 tile in shared memory and
//     writes each row with 16-byte streaming stores (scalar at a ragged N
//     edge or an N that is no multiple of 4); rows past B are not written,
//     so the output is exactly (B, N).
// * fdescan_simt, every other case (an fp32 table, D not a multiple of 8
//   or above 256, unaligned rows): the SIMT product of the first port. Each
//   256-thread block computes a 64 x 64 tile in fp32 FMA over 32-wide
//   slices of D staged in shared memory, 4 x 4 a thread.
#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// SIMT kernel (fp32 tables, other widths)
// --------------------------------------------------------------------------

constexpr int kBM = 64;   // query rows per tile
constexpr int kBN = 64;   // doc columns per tile
constexpr int kBK = 32;   // depth slice staged per step
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename DocT>
__global__ void __launch_bounds__(kThreads)
fdescan_simt(const float* __restrict__ q, const DocT* __restrict__ docs,
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

// --------------------------------------------------------------------------
// Tensor-core kernel (fp16 tables)
// --------------------------------------------------------------------------

constexpr int kTM = 64;             // query rows: one warpgroup's M
constexpr int kTN = 128;            // docs per tile: wgmma's N
constexpr int kTK = 64;             // columns per swizzle atom (128 bytes)
constexpr int kMaxD = 256;
constexpr int kStages = 6;
constexpr int kStageBytes = kTN * kTK * 2;      // 16 KB
constexpr int kAtomBytes = kTM * kTK * 2;       // 8 KB: 64 rows of A
constexpr int kPitch = kTN + 4;                 // staged output row, floats
constexpr int kWgThreads = 160;                 // 4 consumer warps + 1
constexpr float kLoScale = 2048.f;              // 2^11

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes).
struct Smem {
  __host__ __device__ static constexpr int a(int part, int kc, int kcs) {
    return (part * kcs + kc) * kAtomBytes;
  }
  __host__ __device__ static constexpr int ring(int kcs) {
    return 2 * kcs * kAtomBytes;
  }
  __host__ __device__ static constexpr int stage_out(int kcs) {
    return ring(kcs) + kStages * kStageBytes;
  }
  __host__ __device__ static constexpr int unscale(int kcs) {
    return stage_out(kcs) + kTM * kPitch * 4;
  }
  __host__ __device__ static constexpr int bars(int kcs) {
    return unscale(kcs) + kTM * 4;
  }
  __host__ __device__ static constexpr int total(int kcs) {
    return bars(kcs) + 2 * kStages * 8 + 1024;   // + alignment slack
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused by this layout (1 by convention).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32, the wgmma fragment) += A (64 x 16) . B (128 x 16)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` inside a
// 128-byte-swizzled atom of 128-byte rows.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fdescan_wgmma(const __grid_constant__ CUtensorMap docs_map,
              const float* __restrict__ q, float* __restrict__ out, int B,
              int N, int D) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int kcs = (D + kTK - 1) / kTK;   // 64-column atoms of D
  float* stage_out = reinterpret_cast<float*>(base + Smem::stage_out(kcs));
  float* unscale = reinterpret_cast<float*>(base + Smem::unscale(kcs));
  const uint32_t bars = smem_u32(base + Smem::bars(kcs));
  const uint32_t ring = smem_u32(base + Smem::ring(kcs));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kTM;
  const int n_tiles = (N + kTN - 1) / kTN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: one lane keeps the ring full ----
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 1;            // the ring starts empty
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        for (int kc = 0; kc < kcs; ++kc) {
          mbar_wait(empty(stage), phase);
          mbar_expect_tx(full(stage), kStageBytes);
          tma_load_2d(ring + stage * kStageBytes, &docs_map, full(stage),
                      kc * kTK, t * kTN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup (warps 0-3, threads 0-127) ----
  // Prologue: each row's power-of-two scale, then hi and lo into A.
  for (int r = warp; r < kTM; r += 4) {
    const int gm = m0 + r;
    float mx = 0.f;
    if (gm < B)
      for (int d = lane; d < D; d += 32)
        mx = fmaxf(mx, fabsf(q[static_cast<size_t>(gm) * D + d]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    int e = 0;
    frexpf(mx, &e);                  // mx = f * 2^e, f in [0.5, 1)
    if (lane == 0) unscale[r] = ldexpf(1.f, e - 1);
    // the scale up, as an exponent shift of each element
    for (int g = lane; g < kcs * 8; g += 32) {   // 8-column groups
      uint4 hv = make_uint4(0, 0, 0, 0), lv = hv;
      const int d0 = g * 8;
      if (gm < B && d0 < D) {
        const float4* src = reinterpret_cast<const float4*>(
            q + static_cast<size_t>(gm) * D + d0);
        const float4 x0 = src[0], x1 = src[1];
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hb[2], lb[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float v = ldexpf(xs[2 * j + u], 1 - e);
            const __half h = __float2half_rn(v);
            hb[u] = __half_as_ushort(h);
            lb[u] = __half_as_ushort(
                __float2half_rn((v - __half2float(h)) * kLoScale));
          }
          hw[j] = hb[0] | (hb[1] << 16);
          lw[j] = lb[0] | (lb[1] << 16);
        }
        hv = make_uint4(hw[0], hw[1], hw[2], hw[3]);
        lv = make_uint4(lw[0], lw[1], lw[2], lw[3]);
      }
      const int kc = g / 8, chunk = g % 8;
      const int at = swz(r, chunk);
      *reinterpret_cast<uint4*>(base + Smem::a(0, kc, kcs) + at) = hv;
      *reinterpret_cast<uint4*>(base + Smem::a(1, kc, kcs) + at) = lv;
    }
  }
  // generic-proxy writes of A, then wgmma (async proxy) reads them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumer_sync();

  const int r0 = 16 * warp + lane / 4;   // this thread's rows r0, r0 + 8
  const float us0 = unscale[r0], us1 = unscale[r0 + 8];
  const uint32_t a_hi = smem_u32(base + Smem::a(0, 0, kcs));
  const uint32_t a_lo = smem_u32(base + Smem::a(1, 0, kcs));
  const bool vec_ok = (N & 3) == 0;
  int stage = 0;
  uint32_t phase = 0;
  float acc_hi[64], acc_lo[64];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_hi[i] = acc_lo[i] = 0.f;
    for (int kc = 0; kc < kcs; ++kc) {
      mbar_wait(full(stage), phase);
      fence_regs(acc_hi);
      fence_regs(acc_lo);
      wgmma_fence();
      const uint32_t b = ring + stage * kStageBytes;
#pragma unroll
      for (int k = 0; k < kTK / 16; ++k) {      // 16 columns = 32 bytes
        const uint64_t db = desc_sw128(b + 32 * k);
        wgmma_m64n128k16(acc_hi, desc_sw128(a_hi + kc * kAtomBytes + 32 * k),
                         db);
        wgmma_m64n128k16(acc_lo, desc_sw128(a_lo + kc * kAtomBytes + 32 * k),
                         db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_hi);
      fence_regs(acc_lo);
      mbar_arrive(empty(stage));
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: unscale into the staging tile, then whole rows out.
    consumer_sync();                 // the previous tile's rows are out
#pragma unroll
    for (int c = 0; c < kTN / 8; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float us = i ? us1 : us0;
        float2 v;
        v.x = fmaf(acc_lo[4 * c + 2 * i], 1.f / kLoScale,
                   acc_hi[4 * c + 2 * i]) * us;
        v.y = fmaf(acc_lo[4 * c + 2 * i + 1], 1.f / kLoScale,
                   acc_hi[4 * c + 2 * i + 1]) * us;
        *reinterpret_cast<float2*>(stage_out + (r0 + 8 * i) * kPitch + col) = v;
      }
    }
    consumer_sync();
    const int n0 = t * kTN;
    for (int r = warp; r < kTM; r += 4) {
      const int gm = m0 + r;
      if (gm >= B) break;
      const int gn = n0 + 4 * lane;
      const float4 v =
          *reinterpret_cast<const float4*>(stage_out + r * kPitch + 4 * lane);
      float* dst = out + static_cast<size_t>(gm) * N + gn;
      if (vec_ok && gn + 3 < N) {
        __stcs(reinterpret_cast<float4*>(dst), v);
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) dst[j] = vs[j];
      }
    }
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the CUDA runtime has loaded, so
// the library links against nothing but the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

cudaError_t launch_wgmma(const float* q, const __half* docs, float* out,
                         int B, int N, int D, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kTK, kTN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
                         const_cast<__half*>(docs), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int kcs = (D + kTK - 1) / kTK;
  const int smem = Smem::total(kcs);
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fdescan_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem::total(kMaxD / kTK));
    if (e != cudaSuccess) return e;
    smem_set = Smem::total(kMaxD / kTK);
  }
  const int n_tiles = (N + kTN - 1) / kTN;
  const int m_groups = (B + kTM - 1) / kTM;
  const int per_group = (sm_count() + m_groups - 1) / m_groups;
  const dim3 grid(n_tiles < per_group ? n_tiles : per_group, m_groups);
  fdescan_wgmma<<<grid, kWgThreads, smem, stream>>>(map, q, out, B, N, D);
  return cudaGetLastError();
}

template <typename DocT>
cudaError_t launch_simt(const float* q, const DocT* docs, float* out, int B,
                        int N, int D, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  fdescan_simt<DocT><<<grid, kThreads, 0, stream>>>(q, docs, out, B, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if fdescan_launch takes the tensor-core kernel for these inputs, 0 if
// the SIMT one.
int fdescan_kernel_for(const void* q, const void* docs, int D,
                       int docs_fp16) {
  return docs_fp16 && D > 0 && D % 8 == 0 && D <= kMaxD &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(docs) % 16 == 0;
}

// Returns cudaGetLastError() after the launch (0 = launched).
int fdescan_launch(const void* q, const void* docs, void* out, int B, int N,
                   int D, int docs_fp16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  cudaError_t e;
  if (fdescan_kernel_for(q, docs, D, docs_fp16))
    e = launch_wgmma(qf, static_cast<const __half*>(docs), of, B, N, D, s);
  else if (docs_fp16)
    e = launch_simt(qf, static_cast<const __half*>(docs), of, B, N, D, s);
  else
    e = launch_simt(qf, static_cast<const float*>(docs), of, B, N, D, s);
  return static_cast<int>(e);
}

}  // extern "C"
