// RG-LRU linear recurrence, hand-written for Hopper (sm_90a): the forward
// scan and its backward as one reverse pass.
//
// Replaces the TPU kernel lru_scan of the JAX package
// (kernels/rglru/kernel.py:56, body _lru_kernel) and the custom VJP around
// it (kernels/rglru/ops.py:32-44).  Per (batch row, channel), over the
// sequence axis of [B, S, W]:
//   forward   h_t  = a_t * h_{t-1} + b_t            (h_{-1} = 0)
//   backward  db_t = g_t + a_{t+1} * db_{t+1}       (a_S = 0, db_S = 0)
//             da_t = db_t * h_{t-1}
// The TPU kernel computes a tile's rows as a log-depth prefix composition
// and carries h across sequence tiles in VMEM; its VJP reruns it on
// flipped, shifted copies of a and g.  Here the backward walks the
// sequence backwards once and needs no copies.
//
// What bounds them on an H100 SXM (3.35 TB/s): two multiply-adds a value,
// so bytes.  At recurrentgemma-9b's training shape [2, 4096, 4096] f32 the
// forward reads a, b and writes h, 402.7 MB (0.120 ms); the backward reads
// a, h, g and writes da, db, 671.1 MB (0.200 ms).
//
// Design (simple and right first): one thread per (batch row, channel)
// walks the sequence in order, so the recurrence has no cross-thread
// step; consecutive threads take consecutive channels, so each step's
// loads and stores of a warp are one coalesced 128-byte row.  Each thread
// loads the next kUnroll steps into registers while it runs the dependent
// chain over the current ones, to keep loads in flight.  Blocks are one
// warp, so the 8192 channels of [2, 4096, 4096] are 256 blocks over the
// 132 SMs.  Each step is a product and a sum rounded separately
// (__fmul_rn, __fadd_rn: no contraction to a fused multiply-add),
// accumulated in f32, and bf16 values are rounded only when stored, so
// the plain PyTorch versions (ops.py), which take the same steps, give
// the same bits.
//
// What the simple design gives up, a later change: with one thread per
// channel only ~2 warps run on an SM, too few loads in flight to reach
// the card's memory rate; a chunked scan (per-chunk (prod a, h) pairs,
// a short carry pass, then a fix-up) would spread the sequence over all
// SMs.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.  dtype 0 =
// float32, 1 = bfloat16, every tensor contiguous [B, S, W] of that dtype.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp a block: channels per block
constexpr int kUnroll = 16;   // steps loaded ahead of the dependent chain

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

// h_t = a_t * h_{t-1} + b_t for the thread's channel
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_scan_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  const int full = S - S % kUnroll;  // steps in whole chunks
  float acc = 0.f;
  float na[kUnroll], nb[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      na[u] = to_f32(ap[(size_t)u * W]);
      nb[u] = to_f32(bp[(size_t)u * W]);
    }
  }
  for (int t0 = 0; t0 < full; t0 += kUnroll) {
    float ca[kUnroll], cb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
    if (t0 + kUnroll < full) {  // the next chunk's loads, in flight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(t0 + kUnroll + u) * W;
        na[u] = to_f32(ap[off]);
        nb[u] = to_f32(bp[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = __fadd_rn(__fmul_rn(ca[u], acc), cb[u]);
      hp[(size_t)(t0 + u) * W] = from_f32<T>(acc);
    }
  }
  for (int t = full; t < S; ++t) {
    const size_t off = (size_t)t * W;
    acc = __fadd_rn(__fmul_rn(to_f32(ap[off]), acc), to_f32(bp[off]));
    hp[off] = from_f32<T>(acc);
  }
}

// one reverse step at time t: d <- g_t + a_{t+1} * d, db_t = d rounded to
// T, da_t = db_t * h_{t-1}; returns a_t, the next step's a_{t+1}
template <typename T>
__device__ __forceinline__ float bwd_step(float at, float gt, float hprev,
                                          float a_next, float& d, T* dap,
                                          T* dbp, size_t off) {
  d = __fadd_rn(gt, __fmul_rn(a_next, d));
  const T dbt = from_f32<T>(d);
  dbp[off] = dbt;
  dap[off] = from_f32<T>(__fmul_rn(to_f32(dbt), hprev));
  return at;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                        const T* __restrict__ g, T* __restrict__ da,
                        T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = g + base;
  T* dap = da + base;
  T* dbp = db + base;
  // the tail S % kUnroll steps first (the last ones in time), one by one
  const int full = S - S % kUnroll;
  float d = 0.f, a_next = 0.f;
  for (int t = S - 1; t >= full; --t) {
    const size_t off = (size_t)t * W;
    const float hprev = t > 0 ? to_f32(hp[off - W]) : 0.f;
    a_next = bwd_step<T>(to_f32(ap[off]), to_f32(gp[off]), hprev, a_next, d,
                         dap, dbp, off);
  }
  // then whole chunks from the end, chunk [t0, t0 + kUnroll) in reverse,
  // with the chunk before it loading meanwhile; slot u holds step t0 + u
  float na[kUnroll], ng[kUnroll], nh[kUnroll];
  if (full > 0) {
    const int t0 = full - kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = (size_t)(t0 + u) * W;
      na[u] = to_f32(ap[off]);
      ng[u] = to_f32(gp[off]);
      nh[u] = t0 + u > 0 ? to_f32(hp[off - W]) : 0.f;
    }
  }
  for (int t0 = full - kUnroll; t0 >= 0; t0 -= kUnroll) {
    float ca[kUnroll], cg[kUnroll], ch[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cg[u] = ng[u];
      ch[u] = nh[u];
    }
    if (t0 > 0) {  // the previous chunk's loads, in flight
      const int p0 = t0 - kUnroll;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(p0 + u) * W;
        na[u] = to_f32(ap[off]);
        ng[u] = to_f32(gp[off]);
        nh[u] = p0 + u > 0 ? to_f32(hp[off - W]) : 0.f;
      }
    }
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u)
      a_next = bwd_step<T>(ca[u], cg[u], ch[u], a_next, d, dap, dbp,
                           (size_t)(t0 + u) * W);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* b, void* h, int B, int S,
                       int W, cudaStream_t stream) {
  dim3 grid((W + kThreads - 1) / kThreads, B);
  lru_scan_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* h, const void* g, void* da,
                       void* db, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + kThreads - 1) / kThreads, B);
  lru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), static_cast<T*>(da), static_cast<T*>(db), S,
      W);
  return cudaGetLastError();
}

bool covered(int B, int S, int W, int dtype) {
  return B >= 1 && B <= 65535 && S >= 1 && W >= 1 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// a, b, h [B, S, W]
extern "C" int lru_scan_fwd(const void* a, const void* b, void* h, int B,
                            int S, int W, int dtype, void* stream) {
  if (!covered(B, S, W, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch_fwd<float>(a, b, h, B, S, W, s)
                    : (int)launch_fwd<__nv_bfloat16>(a, b, h, B, S, W, s);
}

// a, h, g, da, db [B, S, W]
extern "C" int lru_scan_bwd(const void* a, const void* h, const void* g,
                            void* da, void* db, int B, int S, int W,
                            int dtype, void* stream) {
  if (!covered(B, S, W, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? (int)launch_bwd<float>(a, h, g, da, db, B, S, W, s)
             : (int)launch_bwd<__nv_bfloat16>(a, h, g, da, db, B, S, W, s);
}
