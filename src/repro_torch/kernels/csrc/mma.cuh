// The tensor-core pieces shared by every hand-written kernel of the port
// that runs bf16 on the tensor cores (packed_flash/csrc/*.cu through
// common.cuh and tiles.cuh, ssd/csrc/ssd_chunk.cu): cp.async copies,
// ldmatrix fragments, mma.sync m16n8k16 on bf16 with f32 accumulators,
// and the two products built from them, S = A B^T from shared memory and
// acc += P B from score registers.  It declares no CTA shape and no
// constant a kernel file may declare for itself; the build passes its
// directory with -I and hashes it with every source that includes it.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;     // bf16 elements padding a shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes global -> shared (metadata gathered entry by entry)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&x);
}

// S (16 rows x BN slots of the warp) = A (16 rows of a_s) . B^T (BN rows
// of b_s), over DH: both operands row-major bf16 in shared memory
template <int DH, int BN>
__device__ __forceinline__ void mma_abt(float (&s)[BN / 8][4],
                                        const bf16* a_s, const bf16* b_s,
                                        int lane) {
  constexpr int PITCH = DH + kPad;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (lane & 15) * PITCH + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < BN / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (n * 8 + (lane >> 4) * 8 + (lane & 7)) * PITCH +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x DT n8 tiles from column tile d0) += P (16 x BN, from the
// score registers, rounded to bf16) . B (BN rows of b_s); with SPLIT the
// rounding error is multiplied in too (P = hi + lo, two products)
template <int DH, int BN, int DT, bool SPLIT>
__device__ __forceinline__ void mma_pb(float (&acc)[DT][4],
                                       const float (&p)[BN / 8][4],
                                       const bf16* b_s, int d0, int lane) {
  constexpr int PITCH = DH + kPad;
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) {
    uint32_t a[4], a_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* e = p[2 * kc + (i >> 1)] + 2 * (i & 1);
      a[i] = pack_bf16(e[0], e[1]);
      if constexpr (SPLIT) {
        const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&a[i]);
        a_lo[i] = pack_bf16(e[0] - __low2float(hi), e[1] - __high2float(hi));
      }
    }
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, b_s + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH +
                 (d0 + d) * 8 + (lane >> 4) * 8);
      mma_bf16(acc[d], a, b[0], b[1]);
      mma_bf16(acc[d + 1], a, b[2], b[3]);
      if constexpr (SPLIT) {
        mma_bf16(acc[d], a_lo, b[0], b[1]);
        mma_bf16(acc[d + 1], a_lo, b[2], b[3]);
      }
    }
  }
}

}  // namespace
