// Helpers shared by the packed-flash kernels (ragged_decode.cu,
// ca_server.cu, flash.cu): the CTA shape, the TPU kernels' finite
// sentinels, f32 staging of bf16 or f32 tiles, warp reductions, the
// softcap and softmax-backward arithmetic of kernel.py, and the tensor-core
// kernels' CTA shape; their cp.async, ldmatrix and mma.sync pieces come
// from kernels/csrc/mma.cuh, shared with the SSD kernels.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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
// (cp.async, ldmatrix, mma.sync and the bf16 alias are in mma.cuh)
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kStages = 2;  // ring of tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

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
