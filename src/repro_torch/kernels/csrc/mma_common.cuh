// What the tensor-core MaxSim kernels share (maxsim/csrc/maxsim.cu and
// bitsim/csrc/bitsim.cu): the block's shape and its docs-a-block policy,
// the m16n8k16 product, and q's power-of-two scale and split into two fp16
// parts. Each kernel keeps its own A fragments (fp16 rows by ldmatrix in
// maxsim, signs built from lane words in bitsim).
//
// q in two fp16 parts: q is fp32, and one rounding to fp16 costs ~2^-12 of
// sum|q_i d_i| per query token. Query token i is scaled by the power of two
// that puts its largest |q| in [1, 2) (from the float's exponent bits,
// clamped to the normal range; exact), hi = fp16(q'), lo = fp16((q' - hi) *
// 2^11); two fp32 accumulators, v = acc_hi + 2^-11 acc_lo. The max over
// doc tokens commutes with the positive scale, so v is unscaled once per
// query token, after the max.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mma_common {

constexpr int kMmaWarps = 16;          // warps a block
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxDocs = 8;            // docs a block, at most
constexpr int kNT = 4;                 // n-tiles of 8 query tokens
constexpr int kMaxLq = 8 * kNT;
constexpr float kLoScale = 2048.f;     // 2^11

// The card's SM count, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Docs a block takes for K docs: as few as still give one block an SM
// (fewer items a warp, a shorter chain of latencies), 1, 2, 4 or kMaxDocs.
inline int docs_per_block(int K) {
  const int per_sm = (K + sm_count() - 1) / sm_count();
  return per_sm <= 1 ? 1 : per_sm <= 2 ? 2 : per_sm <= 4 ? 4 : kMaxDocs;
}

// launch(std::integral_constant<int, n>()) for n = docs_per_block(K): the
// launch of the kernel instance that takes n docs a block.
template <typename Launch>
cudaError_t launch_docs_per_block(int K, Launch&& launch) {
  switch (docs_per_block(K)) {
    case 1:
      return launch(std::integral_constant<int, 1>());
    case 2:
      return launch(std::integral_constant<int, 2>());
    case 4:
      return launch(std::integral_constant<int, 4>());
    default:
      return launch(std::integral_constant<int, kMaxDocs>());
  }
}

// Lets kernel take up to bytes of dynamic shared memory, once: done is the
// caller's record, one for each kernel instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

// d (16 x 8, fp32) += a (16 x 16, fp16, row) . b (16 x 8, fp16, col). Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A query token's scale, when each lane of the warp holds some of its
// columns and mx is the largest |q| among them: the power of two that puts
// the warp's largest in [1, 2). unscale gets its inverse.
__device__ __forceinline__ float warp_pow2_scale(float mx, float& unscale) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  // mx = 1.f * 2^(be - 127): the scale 2^(127 - be) puts it in [1, 2)
  const int be = min(253, max(1, static_cast<int>(
                                     (__float_as_uint(mx) >> 23) & 0xff)));
  unscale = __uint_as_float(static_cast<uint32_t>(be) << 23);
  return __uint_as_float(static_cast<uint32_t>(254 - be) << 23);
}

// A scaled q value v in two fp16 parts: hi = fp16(v), lo = fp16((v - hi) *
// 2^11), so that v = hi + 2^-11 lo to ~2^-22 |v|.
__device__ __forceinline__ void split_hi_lo(float v, __half& hi,
                                            __half& lo) {
  hi = __float2half_rn(v);
  lo = __float2half_rn((v - __half2float(hi)) * kLoScale);
}

}  // namespace mma_common
