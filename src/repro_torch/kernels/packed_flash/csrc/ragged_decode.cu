// Ragged cache attention for serving, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/packed_flash/kernel.py::ragged_decode_fwd
// (body _ragged_decode_kernel) of the JAX package.  Each q block
// [blk_q, Hq, dh] belongs to one request (block_req, -1 = dead block) and
// attends that request's cache slots [0, kv_len) where slot == absolute
// position: causal, optional sliding window and logit softcap, online
// softmax in f32, finite NEG_INF = -2**30 sentinel, dead rows and dead
// blocks write 0.  GQA maps q head h to kv head h / (Hq / Hkv).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense):
//   decode  (blk_q = 1):   the K/V bytes of the live slots / 3.35 TB/s;
//   prefill (blk_q = 128): 4 * q * kv * Hq * dh FLOPs / 989 TFLOP/s.
//
// Design (simple and right first):
//   * one CTA of 8 warps per (q block, q head); the sequential kv grid axis
//     of the TPU kernel becomes a loop inside the CTA over 64-slot K/V
//     tiles of the request, staged in shared memory as f32;
//   * the CTA loads its own block_req, kv_len and q_pos (Hopper has no
//     scalar prefetch) and prunes tiles: only tiles below
//     min(kv_len, max live position + 1), and with a window only tiles that
//     reach the smallest live position's window.  A warp also skips a tile
//     for a row that sees none of its slots.  A fully masked tile is an
//     exact no-op of the online softmax, so pruning changes no bit;
//   * one warp per query row at a time: for the logits each lane takes one
//     key (two per 64-slot tile) and runs the dot product over dh; for P.V
//     the lanes split dh.  The row's running max, sum and accumulator live
//     in shared memory between tiles.
//
// What the simple design gives up, each a later change:
//   * tensor cores: the products run on the f32 FMA pipes (mma.sync or
//     wgmma on bf16 tiles would be the prefill fix);
//   * the rep = Hq / Hkv q heads of a GQA group each load the same K/V tile
//     (one CTA per kv head would load it once);
//   * decode (blk_q = 1) keeps one warp of eight busy and puts one CTA per
//     (request, head) on the card: split-kv (flash-decoding) across CTAs
//     would fill it;
//   * head_dim 256 (gemma2) does not fit the f32 staging in shared memory.
//
// C interface (loaded with ctypes): ragged_decode_fwd returns
// cudaGetLastError() after the launch on the caller's stream.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;
constexpr int kMaxBlkQ = 128;
constexpr float kNegInf = -1073741824.0f;  // -2**30, kernel.py NEG_INF

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
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t smem_bytes(int blk_q) {
  // q rows + accumulators [blk_q][DH], K tile [kTileK][DH + 1] (padded so
  // lane-per-key reads fall in distinct banks), V tile [kTileK][DH],
  // running max, sum and position per row
  return sizeof(float) * (2 * (size_t)blk_q * DH + (size_t)kTileK * (DH + 1) +
                          (size_t)kTileK * DH + 2 * (size_t)blk_q) +
         sizeof(int) * (size_t)blk_q;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int32_t* __restrict__ block_req,
                         const int32_t* __restrict__ kv_len,
                         const int32_t* __restrict__ q_pos,
                         T* __restrict__ out, int blk_q, int hq, int hkv,
                         int S, int window, float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [blk_q][DH]
  float* acc_s = q_s + blk_q * DH;    // [blk_q][DH]
  float* k_s = acc_s + blk_q * DH;    // [kTileK][KS]
  float* v_s = k_s + kTileK * KS;     // [kTileK][DH]
  float* m_s = v_s + kTileK * DH;     // [blk_q]
  float* l_s = m_s + blk_q;           // [blk_q]
  int* pos_s = reinterpret_cast<int*>(l_s + blk_q);  // [blk_q]
  __shared__ int qmin_s, qmax_s;

  const int i = blockIdx.x;               // q block
  const int h = blockIdx.y;               // q head
  const int g = h / (hq / hkv);           // its kv head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)hq * DH;  // between q (and out) rows
  const T* qb = q + (size_t)i * blk_q * row_stride + (size_t)h * DH;
  T* ob = out + (size_t)i * blk_q * row_stride + (size_t)h * DH;

  const int req = block_req[i];
  if (req < 0) {  // dead block
    for (int idx = tid; idx < blk_q * DH; idx += kThreads)
      ob[(size_t)(idx / DH) * row_stride + idx % DH] = from_f32<T>(0.f);
    return;
  }
  const int len = min(kv_len[req], S);

  if (tid == 0) {
    qmin_s = INT_MAX;
    qmax_s = -1;
  }
  __syncthreads();
  int my_min = INT_MAX, my_max = -1;
  for (int r = tid; r < blk_q; r += kThreads) {
    const int p = q_pos[(size_t)i * blk_q + r];
    pos_s[r] = p;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    if (p >= 0) {
      my_min = min(my_min, p);
      my_max = max(my_max, p);
    }
  }
  for (int idx = tid; idx < blk_q * DH; idx += kThreads) {
    q_s[idx] = to_f32(qb[(size_t)(idx / DH) * row_stride + idx % DH]);
    acc_s[idx] = 0.f;
  }
  if (my_max >= 0) {
    atomicMin(&qmin_s, my_min);
    atomicMax(&qmax_s, my_max);
  }
  __syncthreads();
  const int qmin = qmin_s;
  const int qmax = qmax_s;

  // tiles [t_lo, t_hi): slots at or past kv_len, or past the largest live
  // position, are masked for every row; with a window, so are slots older
  // than the smallest live position's window
  int t_lo = 0, t_hi = 0;
  if (qmax >= 0) {
    t_hi = (min(len, qmax + 1) + kTileK - 1) / kTileK;
    if (window > 0 && qmin - (window - 1) > 0)
      t_lo = (qmin - (window - 1)) / kTileK;
  }

  const size_t slot_stride = (size_t)hkv * DH;
  const T* kb = k + (size_t)req * S * slot_stride + (size_t)g * DH;
  const T* vb = v + (size_t)req * S * slot_stride + (size_t)g * DH;

  for (int t = t_lo; t < t_hi; ++t) {
    const int s0 = t * kTileK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kTileK * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH;
      const size_t off = (size_t)(s0 + r) * slot_stride + d;
      k_s[r * KS + d] = to_f32(kb[off]);
      v_s[r * DH + d] = to_f32(vb[off]);
    }
    __syncthreads();

    for (int r = warp; r < blk_q; r += kWarps) {
      const int p = pos_s[r];
      if (p < 0 || s0 > p) continue;  // padded row, or tile wholly after it
      if (window > 0 && s0 + kTileK - 1 < p - (window - 1)) continue;

      // logits: lane takes slots s0 + lane and s0 + lane + 32
      const float* qr = q_s + r * DH;
      const float* k_lo = k_s + lane * KS;
      const float* k_hi = k_s + (lane + 32) * KS;
      float x_lo = 0.f, x_hi = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float qd = qr[d];
        x_lo = fmaf(qd, k_lo[d], x_lo);
        x_hi = fmaf(qd, k_hi[d], x_hi);
      }
      x_lo *= scale;
      x_hi *= scale;
      if (softcap > 0.f) {
        x_lo = tanhf(x_lo / softcap) * softcap;
        x_hi = tanhf(x_hi / softcap) * softcap;
      }
      const int sl = s0 + lane, sh = s0 + lane + 32;
      const bool ok_lo = sl < len && sl <= p && (window <= 0 || p - sl < window);
      const bool ok_hi = sh < len && sh <= p && (window <= 0 || p - sh < window);
      x_lo = ok_lo ? x_lo : kNegInf;
      x_hi = ok_hi ? x_hi : kNegInf;

      // online softmax update of this row
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x_lo, x_hi)));
      const float p_lo = ok_lo ? expf(x_lo - m_new) : 0.f;
      const float p_hi = ok_hi ? expf(x_hi - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float l_new = l_s[r] * corr + warp_sum(p_lo + p_hi);

      float* ar = acc_s + r * DH;
      float acc[PER_LANE];
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) acc[c] = ar[lane + 32 * c] * corr;
#pragma unroll 4
      for (int kk = 0; kk < 32; ++kk) {
        const float pl = __shfl_sync(0xffffffffu, p_lo, kk);
        const float ph = __shfl_sync(0xffffffffu, p_hi, kk);
        const float* vl = v_s + kk * DH;
        const float* vh = v_s + (kk + 32) * DH;
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c)
          acc[c] = fmaf(ph, vh[lane + 32 * c], fmaf(pl, vl[lane + 32 * c], acc[c]));
      }
#pragma unroll
      for (int c = 0; c < PER_LANE; ++c) ar[lane + 32 * c] = acc[c];
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int r = warp; r < blk_q; r += kWarps) {
    const bool alive = m_s[r] > kNegInf * 0.5f;
    const float l = fmaxf(l_s[r], 1e-30f);
    const float* ar = acc_s + r * DH;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int d = lane + 32 * c;
      ob[(size_t)r * row_stride + d] = from_f32<T>(alive ? ar[d] / l : 0.f);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* block_req, const void* kv_len,
                   const void* q_pos, void* out, int nq, int blk_q, int hq,
                   int hkv, int S, int window, float softcap, float scale,
                   cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_decode_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<DH>(kMaxBlkQ));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(nq, hq);
  ragged_decode_kernel<T, DH><<<grid, kThreads, smem_bytes<DH>(blk_q), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(block_req),
      static_cast<const int32_t*>(kv_len), static_cast<const int32_t*>(q_pos),
      static_cast<T*>(out), blk_q, hq, hkv, S, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [nq, blk_q, hq, dh];
// k, v [R, S, hkv, dh]; block_req [nq], kv_len [R], q_pos [nq, blk_q] int32.
// The caller checks shapes, types, contiguity and coverage; anything this
// function does not cover returns cudaErrorInvalidValue without launching.
extern "C" int ragged_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* block_req, const void* kv_len,
                                 const void* q_pos, void* out, int nq,
                                 int blk_q, int hq, int hkv, int S, int dh,
                                 int dtype, int window, float softcap,
                                 float scale, void* stream) {
  if (nq == 0) return cudaSuccess;
  if (blk_q < 1 || blk_q > kMaxBlkQ || hkv < 1 || hq % hkv != 0 ||
      S % kTileK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RD_LAUNCH(T, DH)                                                    \
  return (int)launch<T, DH>(q, k, v, block_req, kv_len, q_pos, out, nq,    \
                            blk_q, hq, hkv, S, window, softcap, scale, s)
  if (dtype == 0 && dh == 64) RD_LAUNCH(float, 64);
  if (dtype == 0 && dh == 128) RD_LAUNCH(float, 128);
  if (dtype == 1 && dh == 64) RD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 128) RD_LAUNCH(__nv_bfloat16, 128);
#undef RD_LAUNCH
  return cudaErrorInvalidValue;
}
