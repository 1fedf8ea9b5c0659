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
// a, h, g and writes da, db, 671.1 MB (0.200 ms).  The dependent chain is
// not the limit: a step is one product and one sum, ~8 cycles, so 4096
// steps take ~20 us.
//
// The step order.  One lane walks one (batch row, channel) in sequence
// order, so the recurrence has no cross-thread step.  Each step is a
// product and a sum rounded separately (__fmul_rn, __fadd_rn: no
// contraction to a fused multiply-add), accumulated in f32, and bf16
// values are rounded only when stored.  The plain PyTorch versions
// (ops.py) take the same steps, so both variants below give their bits
// exactly, and whatever the ring's sizes, the bits do not move.
//
// The ring (lru_scan_fwd_kernel, lru_scan_bwd_kernel).  What the card
// needs is bytes in flight: by Little's law, 3.35 TB/s over 132 SMs is
// ~25 GB/s an SM, and at 1-2 us of loaded memory latency that is 25-50 KB
// in flight on every SM.  The grid is one CTA per (batch row, 32
// channels), ~256 CTAs at recurrentgemma's shape, two resident on an SM
// (more channels a CTA would leave SMs idle).  A CTA is two warps: the
// chain warp (lane = channel) and a producer warp whose one lane keeps a
// ring of kSteps-step stages full in shared memory, ~96 KB a CTA, so up
// to ~190 KB an SM is requested ahead of the chains.  A stage holds a
// [kSteps, 32] box of each input (forward: a and b; backward: a, g and h
// one step back, h_{t-1}), each box one TMA load through a 3-D tensor
// map over [B, S, W] that completes on the stage's "full" mbarrier.  A
// box costs one instruction: a bulk copy per 128-byte row measured at one
// row per ~26 cycles an SM on the H100, under half the memory's rate.
// Values outside the tensor arrive as zeros, which gives the backward
// h_{-1} = 0, the tail of S (not a multiple of kSteps) and a partial last
// chain (W not a multiple of 32) with no code of their own.  The chain
// warp reads kBlock steps at a time from shared memory into registers
// (lane = channel: no bank conflict), runs them, stores h (or da, db)
// straight to global memory, one coalesced row a warp store, through a
// pointer that steps a row a step, and releases the stage on its "empty"
// mbarrier.  The backward walks the stages from the last.
//
// The direct variant (lru_scan_fwd_direct_kernel, _bwd_direct_kernel).
// A tensor map needs 16-byte aligned inputs whose rows of W values are a
// multiple of 16 bytes (W a multiple of 4 in f32, of 8 in bf16).  Other
// layouts run a one-warp kernel whose lanes load kUnroll steps ahead into
// registers: the same steps in the same order, slower.  The C side picks
// the variant by shape and alignment; both are held bitwise against the
// plain versions.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.  dtype 0 =
// float32, 1 = bfloat16, every tensor contiguous [B, S, W] of that dtype.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChain = 32;               // channels a chain warp walks
constexpr int kSteps = 64;               // steps a ring stage holds
constexpr int kRingBytes = 96 * 1024;    // ring a CTA: two CTAs an SM
constexpr int kBlock = 16;               // ring: steps read ahead
constexpr int kUnroll = 16;              // direct variant: steps ahead

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

// --------------------------------------------------- mbarriers, TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also adds `bytes` to the phase's expected transfer
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (channel w, step t, batch row b) into shared
// memory, rows of kChain values; out-of-bounds values arrive as zeros and
// the whole box counts on `bar`'s transfer count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int w, int t, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(w), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ the ring
// shared memory of a ring kernel: kStages stages of kTensors row blocks
// [kSteps][kChain], then a full and an empty mbarrier a stage
template <typename T, int kTensors>
struct Ring {
  static constexpr int kStageElems = kTensors * kSteps * kChain;
  static constexpr int kStages = kRingBytes / (kStageElems * sizeof(T));
  static constexpr size_t kBytes =
      (size_t)kStages * kStageElems * sizeof(T) + 2 * kStages * 8;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// the barriers: full (one arrival, the producer's expect_tx, and the
// stage's bytes), empty (the chain warp's 32 lanes)
template <int kStages>
__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kChain);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// h_t = a_t * h_{t-1} + b_t; warp 0 the chain, warp 1 the producer
template <typename T>
__global__ void __launch_bounds__(2 * kChain)
    lru_scan_fwd_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        T* __restrict__ h, int S, int W) {
  using R = Ring<T, 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)R::kStages * R::kStageElems * sizeof(T));
  uint64_t* empty = full + R::kStages;
  init_barriers<R::kStages>(full, empty);

  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kChain;
  const int nw = min(kChain, W - w0);     // live channels of this chain
  const size_t base = (size_t)blockIdx.y * S * W + w0;
  const int n_stages = (S + kSteps - 1) / kSteps;

  if (threadIdx.x >= kChain) {            // producer: one lane
    if (threadIdx.x != kChain) return;
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % R::kStages;
      if (i >= R::kStages) mbar_wait(&empty[s], (i / R::kStages - 1) & 1);
      mbar_expect_tx(&full[s], R::kStageElems * sizeof(T));
      T* sa = ring + (size_t)s * R::kStageElems;
      tma_load(sa, ma, w0, i * kSteps, blockIdx.y, &full[s]);
      tma_load(sa + kSteps * kChain, mb, w0, i * kSteps, blockIdx.y,
               &full[s]);
    }
    return;
  }
  // the chain: lane = channel; hp steps a row a step (a pointer add: an
  // offset multiplied out at every store costs more than the step)
  const bool live = lane < nw;
  T* hp = h + base + lane;
  float acc = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % R::kStages;
    const int t0 = i * kSteps, n = min(kSteps, S - t0);
    const T* sa = ring + (size_t)s * R::kStageElems + lane;
    const T* sb = sa + kSteps * kChain;
    mbar_wait(&full[s], (i / R::kStages) & 1);
    if (n == kSteps) {
#pragma unroll
      for (int u0 = 0; u0 < kSteps; u0 += kBlock) {
        float ra[kBlock], rb[kBlock];     // loads ahead of the chain
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          ra[u] = to_f32(sa[(u0 + u) * kChain]);
          rb[u] = to_f32(sb[(u0 + u) * kChain]);
        }
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          acc = __fadd_rn(__fmul_rn(ra[u], acc), rb[u]);
          if (live) *hp = from_f32<T>(acc);
          hp += W;
        }
      }
    } else {
      for (int u = 0; u < n; ++u) {
        acc = __fadd_rn(__fmul_rn(to_f32(sa[u * kChain]), acc),
                        to_f32(sb[u * kChain]));
        if (live) *hp = from_f32<T>(acc);
        hp += W;
      }
    }
    mbar_arrive(&empty[s]);
  }
}

// one reverse step: d <- g_t + a_{t+1} * d, db_t = d rounded to T,
// da_t = db_t * h_{t-1}, stored at da_t and db_t when `live`
template <typename T>
__device__ __forceinline__ void bwd_step(float gt, float hprev, float a_next,
                                         float& d, T* da_t, T* db_t,
                                         bool live) {
  d = __fadd_rn(gt, __fmul_rn(a_next, d));
  const T dbt = from_f32<T>(d);
  if (live) {
    *db_t = dbt;
    *da_t = from_f32<T>(__fmul_rn(to_f32(dbt), hprev));
  }
}

// the reverse recurrence over the stages from the last; a stage holds a
// and g of steps [t0, t0 + n) and h of steps [t0 - 1, t0 + n - 1)
template <typename T>
__global__ void __launch_bounds__(2 * kChain)
    lru_scan_bwd_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mh,
                        const __grid_constant__ CUtensorMap mg,
                        T* __restrict__ da, T* __restrict__ db, int S,
                        int W) {
  using R = Ring<T, 3>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)R::kStages * R::kStageElems * sizeof(T));
  uint64_t* empty = full + R::kStages;
  init_barriers<R::kStages>(full, empty);

  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kChain;
  const int nw = min(kChain, W - w0);
  const size_t base = (size_t)blockIdx.y * S * W + w0;
  const int n_stages = (S + kSteps - 1) / kSteps;
  constexpr int kRows = kSteps * kChain;

  if (threadIdx.x >= kChain) {            // producer: one lane
    if (threadIdx.x != kChain) return;
    for (int j = 0; j < n_stages; ++j) {
      const int s = j % R::kStages;
      const int t0 = (n_stages - 1 - j) * kSteps;
      if (j >= R::kStages) mbar_wait(&empty[s], (j / R::kStages - 1) & 1);
      mbar_expect_tx(&full[s], R::kStageElems * sizeof(T));
      T* sa = ring + (size_t)s * R::kStageElems;
      tma_load(sa, ma, w0, t0, blockIdx.y, &full[s]);
      tma_load(sa + kRows, mg, w0, t0, blockIdx.y, &full[s]);
      // h of steps t0 - 1 ..., h_{-1} = 0 out of bounds
      tma_load(sa + 2 * kRows, mh, w0, t0 - 1, blockIdx.y, &full[s]);
    }
    return;
  }
  // dap, dbp step back a row a step, from the last
  const bool live = lane < nw;
  const size_t last = base + (size_t)(S - 1) * W + lane;
  T* dap = da + last;
  T* dbp = db + last;
  float d = 0.f, a_next = 0.f;
  for (int j = 0; j < n_stages; ++j) {
    const int s = j % R::kStages;
    const int t0 = (n_stages - 1 - j) * kSteps, n = min(kSteps, S - t0);
    const T* sa = ring + (size_t)s * R::kStageElems + lane;
    const T* sg = sa + kRows;
    const T* sh = sg + kRows;
    mbar_wait(&full[s], (j / R::kStages) & 1);
    if (n == kSteps) {
#pragma unroll
      for (int u0 = kSteps - kBlock; u0 >= 0; u0 -= kBlock) {
        float ra[kBlock], rg[kBlock], rh[kBlock];   // loads ahead
#pragma unroll
        for (int u = 0; u < kBlock; ++u) {
          ra[u] = to_f32(sa[(u0 + u) * kChain]);
          rg[u] = to_f32(sg[(u0 + u) * kChain]);
          rh[u] = to_f32(sh[(u0 + u) * kChain]);
        }
#pragma unroll
        for (int u = kBlock - 1; u >= 0; --u) {
          bwd_step<T>(rg[u], rh[u], a_next, d, dap, dbp, live);
          a_next = ra[u];
          dap -= W;
          dbp -= W;
        }
      }
    } else {
      for (int u = n - 1; u >= 0; --u) {
        bwd_step<T>(to_f32(sg[u * kChain]), to_f32(sh[u * kChain]), a_next,
                    d, dap, dbp, live);
        a_next = to_f32(sa[u * kChain]);
        dap -= W;
        dbp -= W;
      }
    }
    mbar_arrive(&empty[s]);
  }
}

// ------------------------------------------------------ direct variant
// h_t = a_t * h_{t-1} + b_t for the thread's channel, one warp a block
template <typename T>
__global__ void __launch_bounds__(kChain)
    lru_scan_fwd_direct_kernel(const T* __restrict__ a,
                               const T* __restrict__ b, T* __restrict__ h,
                               int S, int W) {
  const int w = blockIdx.x * kChain + threadIdx.x;
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

template <typename T>
__global__ void __launch_bounds__(kChain)
    lru_scan_bwd_direct_kernel(const T* __restrict__ a,
                               const T* __restrict__ h,
                               const T* __restrict__ g, T* __restrict__ da,
                               T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kChain + threadIdx.x;
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
    bwd_step<T>(to_f32(gp[off]), hprev, a_next, d, dap + off, dbp + off,
                true);
    a_next = to_f32(ap[off]);
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
    for (int u = kUnroll - 1; u >= 0; --u) {
      const size_t off = (size_t)(t0 + u) * W;
      bwd_step<T>(cg[u], ch[u], a_next, d, dap + off, dbp + off, true);
      a_next = ca[u];
    }
  }
}

// ------------------------------------------------------------ launches
// the ring's inputs go through TMA: 16-byte aligned, rows of W values a
// multiple of 16 bytes (the tensor map's stride)
template <typename T>
bool ring_fits(int W, std::initializer_list<const void*> inputs) {
  if ((size_t)W * sizeof(T) % 16 != 0) return false;
  for (const void* p : inputs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// cuTensorMapEncodeTiled of libcuda, looked up at run time through the
// CUDA runtime's entry-point query (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled find_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// the 3-D map over a contiguous [B, S, W] tensor (dimensions innermost
// first) with a box of kSteps rows of kChain channels; reads outside the
// tensor fill zeros
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int W) {
  static const EncodeTiled encode = find_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T),
                                 (cuuint64_t)S * W * sizeof(T)};
  const cuuint32_t box[3] = {kChain, kSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the ring kernels' dynamic shared memory, above the 48 KB default, and
// the carve-out that lets two CTAs share an SM
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* b, void* h, int B, int S,
                       int W, cudaStream_t stream) {
  dim3 grid((W + kChain - 1) / kChain, B);
  T* ht = static_cast<T*>(h);
  if (!ring_fits<T>(W, {a, b})) {
    lru_scan_fwd_direct_kernel<T><<<grid, kChain, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), ht, S, W);
    return cudaGetLastError();
  }
  constexpr size_t bytes = Ring<T, 2>::kBytes;
  CUtensorMap ma, mb;
  cudaError_t err;
  if ((err = make_map<T>(&ma, a, B, S, W)) != cudaSuccess ||
      (err = make_map<T>(&mb, b, B, S, W)) != cudaSuccess ||
      (err = configure(lru_scan_fwd_kernel<T>, bytes)) != cudaSuccess)
    return err;
  lru_scan_fwd_kernel<T><<<grid, 2 * kChain, bytes, stream>>>(ma, mb, ht, S,
                                                             W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* h, const void* g, void* da,
                       void* db, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + kChain - 1) / kChain, B);
  T* dat = static_cast<T*>(da);
  T* dbt = static_cast<T*>(db);
  if (!ring_fits<T>(W, {a, h, g})) {
    lru_scan_bwd_direct_kernel<T><<<grid, kChain, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(h),
        static_cast<const T*>(g), dat, dbt, S, W);
    return cudaGetLastError();
  }
  constexpr size_t bytes = Ring<T, 3>::kBytes;
  CUtensorMap ma, mh, mg;
  cudaError_t err;
  if ((err = make_map<T>(&ma, a, B, S, W)) != cudaSuccess ||
      (err = make_map<T>(&mh, h, B, S, W)) != cudaSuccess ||
      (err = make_map<T>(&mg, g, B, S, W)) != cudaSuccess ||
      (err = configure(lru_scan_bwd_kernel<T>, bytes)) != cudaSuccess)
    return err;
  lru_scan_bwd_kernel<T><<<grid, 2 * kChain, bytes, stream>>>(
      ma, mh, mg, dat, dbt, S, W);
  return cudaGetLastError();
}

bool covered(int B, int S, int W, int dtype) {
  return B >= 1 && B <= 65535 && S >= 1 && W >= 1 &&
         (dtype == 0 || dtype == 1);
}

// registers, shared memory (static + dynamic) and resident CTAs an SM
template <typename Kernel>
cudaError_t describe(Kernel kernel, int threads, size_t dynamic, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + dynamic);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       threads, dynamic);
}

template <typename T>
cudaError_t describe_all(int* out) {
  constexpr size_t fwd = Ring<T, 2>::kBytes, bwd = Ring<T, 3>::kBytes;
  cudaError_t err;
  if ((err = configure(lru_scan_fwd_kernel<T>, fwd)) != cudaSuccess ||
      (err = configure(lru_scan_bwd_kernel<T>, bwd)) != cudaSuccess ||
      (err = describe(lru_scan_fwd_kernel<T>, 2 * kChain, fwd, out)) !=
          cudaSuccess ||
      (err = describe(lru_scan_bwd_kernel<T>, 2 * kChain, bwd, out + 3)) !=
          cudaSuccess ||
      (err = describe(lru_scan_fwd_direct_kernel<T>, kChain, 0, out + 6)) !=
          cudaSuccess)
    return err;
  return describe(lru_scan_bwd_direct_kernel<T>, kChain, 0, out + 9);
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

// out[12]: for the forward ring, the backward ring, the direct forward
// and the direct backward kernel of `dtype`, in turn: registers a thread,
// shared memory a CTA in bytes, CTAs resident an SM (on the current
// device)
extern "C" int lru_scan_kernel_info(int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? (int)describe_all<float>(out)
                    : (int)describe_all<__nv_bfloat16>(out);
}
