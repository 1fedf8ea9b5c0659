// Helpers shared by the packed-flash kernels (ragged_decode.cu,
// ca_server.cu, flash.cu): the CTA shape, the TPU kernels' finite
// sentinels, f32 staging of bf16 or f32 tiles, warp reductions, the
// softcap and softmax-backward arithmetic of kernel.py, and the pieces of
// the tensor-core kernels (cp.async, ldmatrix, mma.sync on bf16).
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1073741824.0f;  // -2**30, kernel.py NEG_INF
constexpr float kLseDead = 1073741824.0f;  // 2**30, kernel.py LSE_DEAD
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// scaled, softcapped logit (kernel.py _capped_masked_logits before the mask)
__device__ __forceinline__ float cap(float dot, float scale, float softcap) {
  const float x = dot * scale;
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

// kernel.py _ds_from_p: softmax backward, softcap chain rule and scale
__device__ __forceinline__ float ds_from_p(float p, float dp, float delta,
                                           float logit, bool ok, float scale,
                                           float softcap) {
  float ds = p * (dp - delta);
  if (softcap > 0.f) {
    const float sc = ok ? logit / softcap : 0.f;
    ds *= 1.f - sc * sc;
  }
  return ds * scale;
}

// stage `rows` rows of dh values (row stride `stride` elements) into f32
// shared memory with row pitch `pitch`
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      size_t stride, int rows) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    dst[r * pitch + d] = to_f32(src[(size_t)r * stride + d]);
  }
}

// ------------------------------------------- tensor-core building blocks
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPad = 8;     // bf16 elements padding a shared-memory row
constexpr int kStages = 2;  // ring of tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

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

// allow `bytes` of dynamic shared memory for `kernel`, once per
// instantiation (above 48 KB the launch is refused without it)
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = true;
  return e;
}

}  // namespace
