// Attention-server kernels (fused CA-task batch), hand-written for Hopper
// (sm_90a): forward, and the backward as a dq kernel and a dk/dv kernel.
//
// Replace the TPU kernels of the JAX package's
// kernels/packed_flash/kernel.py:
//   ca_server_fwd     (body _ca_server_kernel, masks _ca_mask/_ca_live_mask)
//   ca_server_bwd     (bodies _ca_bwd_dq_kernel and _ca_bwd_dkv_kernel)
// Task t's q block [blk, Hq, dh] attends kv blocks
// [kv_start[t], kv_start[t] + min(kv_len[t], jmax)) of a dense buffer
// [N, blk, Hkv, dh] (block index clamped to [0, N-1] as the TPU index map
// does).  The mask works on in-document positions (-1 = padding): causal,
// sliding window with sink, dilated rate over blk-token blocks.  Logit
// softcap, online softmax in f32, finite sentinels NEG_INF = -2**30 and
// LSE_DEAD = 2**30; dead rows give out 0 and lse LSE_DEAD.  GQA maps q
// head h to kv head h / (Hq / Hkv).
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// a server's batch does 4 * (live q, kv pairs) * Hq * dh FLOPs forward
// and about 2.5x that backward, and moves its q, k, v and outputs once.
// A task slot reads up to jmax kv blocks, so a full batch is bound by the
// products; a batch whose fixed-size task buffer is mostly empty or short
// tasks (the training step's plans) is bound by the bytes of the buffer.
// Either way the simple design below runs far from the bound: it does the
// products on the f32 FMA pipes, not the tensor cores.
//
// Design (simple and right first; the products run on the f32 FMA pipes):
//   * forward and dq: one CTA of 8 warps per (task, q head, 64-row half
//     of the q block).  The sequential kv grid axis of the TPU kernel is a
//     loop inside the CTA over the task's kv blocks, in 64-slot K/V tiles
//     staged in shared memory as f32.  The CTA loads its own kv_start /
//     kv_len (no scalar prefetch on Hopper).  One warp works on one q row
//     at a time: each lane takes two keys of the tile for the dot
//     products, and the lanes split dh for the P.V (or dS.K) update.
//   * dk/dv: the TPU kernel runs a sequential (N, Hq, T) grid predicated
//     on coverage and sums per q head, folding GQA outside.  Here one CTA
//     per (kv block n, kv head g, 64-row half of the block) walks every
//     task t in index order, and for a task whose range covers n
//     (0 <= n - kv_start[t] < min(kv_len[t], jmax)) every q head of group
//     g and every 64-row q tile, in order.  It accumulates dk and dv of
//     its rows in shared memory in f32 and writes them once, in k's dtype:
//     GQA is folded in the kernel, and with no float atomics the sums run
//     in one fixed order, so repeated runs are bitwise equal.  A warp works
//     on one kv row at a time: lanes take two q rows for the dot products
//     and split dh for the dV / dK update.
//   * pruning: a warp skips a (row, tile) pair in which the mask leaves no
//     pair visible.  A fully masked tile is an exact no-op of the online
//     softmax (max unchanged, p = 0, correction exp(0) = 1) and adds exact
//     zeros to dq, dk and dv, so skipping it changes no bit.
//   * shared memory: the 64-row split keeps every kernel under the 227 KB a
//     CTA may use at dh 128: forward 129 KB (q, accumulators, K tile, V
//     tile in f32), dq 161 KB (q, dO, dQ, K and V tiles), dk/dv 194 KB
//     (K, V, dK, dV rows and a q / dO tile).  Dynamic shared memory,
//     raised once per instantiation with cudaFuncSetAttribute.
//
// What the simple design gives up, each a later change: tensor cores
// (mma.sync / wgmma on bf16 tiles), sharing one K/V tile across the rep
// q heads of a GQA group in the forward and dq kernels, overlapping tile
// loads with compute, and head_dim 192/256.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // q rows (fwd, dq) or kv rows (dk/dv) per CTA
constexpr int kTile = 64;   // kv slots (fwd, dq) or q rows (dk/dv) per tile
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

struct Mask {
  int window;  // 0 = no window
  int sink;    // always-visible leading tokens (with a window)
  int rate;    // dilation over blk-token blocks, 1 = none
  int blk;
};

// kernel.py _ca_mask on in-document positions, causal always
__device__ __forceinline__ bool visible(int pq, int pk, const Mask& m) {
  if (pq < 0 || pk < 0 || pq < pk) return false;
  if (m.window > 0 && pq - pk >= m.window && !(m.sink > 0 && pk < m.sink))
    return false;
  // pq >= pk here, so both quotients and their difference are >= 0
  if (m.rate > 1 && (pq / m.blk - pk / m.blk) % m.rate != 0) return false;
  return true;
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

// the kv block a task reads at relative index j (kernel.py:626-631)
__device__ __forceinline__ int kv_block(int start, int j, int N) {
  return max(0, min(start + j, N - 1));
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

// ------------------------------------------------------------------ forward
template <int DH>
constexpr size_t fwd_smem() {
  // q, accumulators [kRows][DH]; K tile [kTile][DH + 1] (padded so the
  // lane-per-key reads fall in distinct banks); V tile [kTile][DH]; row
  // max, sum, position; tile positions
  return sizeof(float) * (2 * (size_t)kRows * DH + (size_t)kTile * (DH + 1) +
                          (size_t)kTile * DH + 2 * (size_t)kRows) +
         sizeof(int) * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ca_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const int32_t* __restrict__ kv_start,
                  const int32_t* __restrict__ kv_len,
                  const int32_t* __restrict__ q_pos,
                  const int32_t* __restrict__ kv_pos, T* __restrict__ out,
                  float* __restrict__ lse, int N, int blk, int hq, int hkv,
                  int jmax, Mask mask, float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows][DH]
  float* acc_s = q_s + kRows * DH;    // [kRows][DH]
  float* k_s = acc_s + kRows * DH;    // [kTile][KS]
  float* v_s = k_s + kTile * KS;      // [kTile][DH]
  float* m_s = v_s + kTile * DH;      // [kRows]
  float* l_s = m_s + kRows;           // [kRows]
  int* qp_s = reinterpret_cast<int*>(l_s + kRows);  // [kRows]
  int* kp_s = qp_s + kRows;                          // [kTile]

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;    // between q (and out) rows
  const size_t kv_stride = (size_t)hkv * DH;  // between k (and v) rows
  const size_t row0 = (size_t)t * blk + r0;
  const T* qb = q + row0 * q_stride + (size_t)h * DH;
  T* ob = out + row0 * q_stride + (size_t)h * DH;
  float* lb = lse + ((size_t)t * hq + h) * blk + r0;

  for (int r = tid; r < kRows; r += kThreads) {
    qp_s[r] = q_pos[row0 + r];
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  stage<T, DH>(q_s, DH, qb, q_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) acc_s[idx] = 0.f;

  const int start = kv_start[t];
  const int n_blk = min(kv_len[t], jmax);
  const int tiles = blk / kTile;
  for (int j = 0; j < n_blk; ++j) {
    const int b = kv_block(start, j, N);
    for (int tt = 0; tt < tiles; ++tt) {
      const size_t slot0 = (size_t)b * blk + tt * kTile;
      __syncthreads();  // every warp is done with the previous tile
      for (int idx = tid; idx < kTile * DH; idx += kThreads) {
        const int r = idx / DH, d = idx % DH;
        const size_t off = (slot0 + r) * kv_stride + (size_t)g * DH + d;
        k_s[r * KS + d] = to_f32(k[off]);
        v_s[r * DH + d] = to_f32(v[off]);
      }
      if (tid < kTile) kp_s[tid] = kv_pos[slot0 + tid];
      __syncthreads();

      const int pk_lo = kp_s[lane], pk_hi = kp_s[lane + 32];
      for (int r = warp; r < kRows; r += kWarps) {
        const int p = qp_s[r];
        const bool ok_lo = visible(p, pk_lo, mask);
        const bool ok_hi = visible(p, pk_hi, mask);
        if (!__any_sync(kFull, ok_lo || ok_hi)) continue;  // exact no-op

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
        x_lo = ok_lo ? cap(x_lo, scale, softcap) : kNegInf;
        x_hi = ok_hi ? cap(x_hi, scale, softcap) : kNegInf;

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
          const float pl = __shfl_sync(kFull, p_lo, kk);
          const float ph = __shfl_sync(kFull, p_hi, kk);
          const float* vl = v_s + kk * DH;
          const float* vh = v_s + (kk + 32) * DH;
#pragma unroll
          for (int c = 0; c < PER_LANE; ++c)
            acc[c] = fmaf(ph, vh[lane + 32 * c],
                          fmaf(pl, vl[lane + 32 * c], acc[c]));
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
  }
  __syncthreads();

  for (int r = warp; r < kRows; r += kWarps) {
    const bool alive = m_s[r] > kNegInf * 0.5f;
    const float l = fmaxf(l_s[r], 1e-30f);
    const float* ar = acc_s + r * DH;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int d = lane + 32 * c;
      ob[(size_t)r * q_stride + d] = from_f32<T>(alive ? ar[d] / l : 0.f);
    }
    if (lane == 0) lb[r] = alive ? m_s[r] + logf(l) : kLseDead;
  }
}

// ------------------------------------------------------------------ dq pass
template <int DH>
constexpr size_t dq_smem() {
  // q, dO, dQ [kRows][DH]; K and V tiles [kTile][DH + 1]; per-row lse,
  // delta, position; tile positions
  return sizeof(float) * (3 * (size_t)kRows * DH +
                          2 * (size_t)kTile * (DH + 1) + 2 * (size_t)kRows) +
         sizeof(int) * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ca_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int32_t* __restrict__ kv_start,
                     const int32_t* __restrict__ kv_len,
                     const int32_t* __restrict__ q_pos,
                     const int32_t* __restrict__ kv_pos, T* __restrict__ dq,
                     int N, int blk, int hq, int hkv, int jmax, Mask mask,
                     float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows][DH]
  float* do_s = q_s + kRows * DH;     // [kRows][DH]
  float* dq_s = do_s + kRows * DH;    // [kRows][DH]
  float* k_s = dq_s + kRows * DH;     // [kTile][KS]
  float* v_s = k_s + kTile * KS;      // [kTile][KS]
  float* lse_s = v_s + kTile * KS;    // [kRows]
  float* dl_s = lse_s + kRows;        // [kRows]
  int* qp_s = reinterpret_cast<int*>(dl_s + kRows);  // [kRows]
  int* kp_s = qp_s + kRows;                           // [kTile]

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;
  const size_t kv_stride = (size_t)hkv * DH;
  const size_t row0 = (size_t)t * blk + r0;
  const size_t head_off = (size_t)h * DH;
  const size_t stat0 = ((size_t)t * hq + h) * blk + r0;

  for (int r = tid; r < kRows; r += kThreads) {
    qp_s[r] = q_pos[row0 + r];
    lse_s[r] = lse[stat0 + r];
    dl_s[r] = delta[stat0 + r];
  }
  stage<T, DH>(q_s, DH, q + row0 * q_stride + head_off, q_stride, kRows);
  stage<T, DH>(do_s, DH, dout + row0 * q_stride + head_off, q_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) dq_s[idx] = 0.f;

  const int start = kv_start[t];
  const int n_blk = min(kv_len[t], jmax);
  const int tiles = blk / kTile;
  for (int j = 0; j < n_blk; ++j) {
    const int b = kv_block(start, j, N);
    for (int tt = 0; tt < tiles; ++tt) {
      const size_t slot0 = (size_t)b * blk + tt * kTile;
      __syncthreads();
      for (int idx = tid; idx < kTile * DH; idx += kThreads) {
        const int r = idx / DH, d = idx % DH;
        const size_t off = (slot0 + r) * kv_stride + (size_t)g * DH + d;
        k_s[r * KS + d] = to_f32(k[off]);
        v_s[r * KS + d] = to_f32(v[off]);
      }
      if (tid < kTile) kp_s[tid] = kv_pos[slot0 + tid];
      __syncthreads();

      const int pk_lo = kp_s[lane], pk_hi = kp_s[lane + 32];
      for (int r = warp; r < kRows; r += kWarps) {
        const int p = qp_s[r];
        const bool ok_lo = visible(p, pk_lo, mask);
        const bool ok_hi = visible(p, pk_hi, mask);
        if (!__any_sync(kFull, ok_lo || ok_hi)) continue;  // adds zeros

        const float* qr = q_s + r * DH;
        const float* dor = do_s + r * DH;
        const float* k_lo = k_s + lane * KS;
        const float* k_hi = k_s + (lane + 32) * KS;
        const float* v_lo = v_s + lane * KS;
        const float* v_hi = v_s + (lane + 32) * KS;
        float x_lo = 0.f, x_hi = 0.f, dp_lo = 0.f, dp_hi = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float qd = qr[d], dd = dor[d];
          x_lo = fmaf(qd, k_lo[d], x_lo);
          x_hi = fmaf(qd, k_hi[d], x_hi);
          dp_lo = fmaf(dd, v_lo[d], dp_lo);
          dp_hi = fmaf(dd, v_hi[d], dp_hi);
        }
        x_lo = cap(x_lo, scale, softcap);
        x_hi = cap(x_hi, scale, softcap);
        const float ls = lse_s[r], dl = dl_s[r];
        const float p_lo = ok_lo ? expf(x_lo - ls) : 0.f;
        const float p_hi = ok_hi ? expf(x_hi - ls) : 0.f;
        const float ds_lo =
            ds_from_p(p_lo, dp_lo, dl, x_lo, ok_lo, scale, softcap);
        const float ds_hi =
            ds_from_p(p_hi, dp_hi, dl, x_hi, ok_hi, scale, softcap);

        float* dqr = dq_s + r * DH;
        float acc[PER_LANE];
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) acc[c] = dqr[lane + 32 * c];
#pragma unroll 4
        for (int kk = 0; kk < 32; ++kk) {
          const float sl = __shfl_sync(kFull, ds_lo, kk);
          const float sh = __shfl_sync(kFull, ds_hi, kk);
          const float* kl = k_s + kk * KS;
          const float* kh = k_s + (kk + 32) * KS;
#pragma unroll
          for (int c = 0; c < PER_LANE; ++c)
            acc[c] = fmaf(sh, kh[lane + 32 * c],
                          fmaf(sl, kl[lane + 32 * c], acc[c]));
        }
#pragma unroll
        for (int c = 0; c < PER_LANE; ++c) dqr[lane + 32 * c] = acc[c];
      }
    }
  }
  __syncthreads();

  T* dqb = dq + row0 * q_stride + head_off;
  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    dqb[(size_t)r * q_stride + d] = from_f32<T>(dq_s[idx]);
  }
}

// ---------------------------------------------------------------- dk/dv pass
template <int DH>
constexpr size_t dkv_smem() {
  // K, V, dK, dV rows [kRows][DH]; q and dO tiles [kTile][DH + 1];
  // per-q-row lse, delta, position; kv row positions
  return sizeof(float) * (4 * (size_t)kRows * DH +
                          2 * (size_t)kTile * (DH + 1) + 2 * (size_t)kTile) +
         sizeof(int) * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    ca_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ kv_start,
                      const int32_t* __restrict__ kv_len,
                      const int32_t* __restrict__ q_pos,
                      const int32_t* __restrict__ kv_pos,
                      T* __restrict__ dk, T* __restrict__ dv, int T_tasks,
                      int blk, int hq, int hkv, int jmax, Mask mask,
                      float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kRows][DH]
  float* v_s = k_s + kRows * DH;      // [kRows][DH]
  float* dk_s = v_s + kRows * DH;     // [kRows][DH]
  float* dv_s = dk_s + kRows * DH;    // [kRows][DH]
  float* q_s = dv_s + kRows * DH;     // [kTile][KS]
  float* do_s = q_s + kTile * KS;     // [kTile][KS]
  float* lse_s = do_s + kTile * KS;   // [kTile]
  float* dl_s = lse_s + kTile;        // [kTile]
  int* qp_s = reinterpret_cast<int*>(dl_s + kTile);  // [kTile]
  int* kp_s = qp_s + kTile;                           // [kRows]
  __shared__ int any_row_s;

  const int n = blockIdx.x;
  const int g = blockIdx.y;
  const int c0 = blockIdx.z * kRows;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;
  const size_t kv_stride = (size_t)hkv * DH;
  const size_t krow0 = (size_t)n * blk + c0;
  const size_t kv_off = krow0 * kv_stride + (size_t)g * DH;

  if (tid == 0) any_row_s = 0;
  __syncthreads();
  for (int c = tid; c < kRows; c += kThreads) {
    kp_s[c] = kv_pos[krow0 + c];
    if (kp_s[c] >= 0) any_row_s = 1;
  }
  stage<T, DH>(k_s, DH, k + kv_off, kv_stride, kRows);
  stage<T, DH>(v_s, DH, v + kv_off, kv_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }
  __syncthreads();
  const bool any_row = any_row_s != 0;  // all padding: dk = dv = 0

  const int tiles = blk / kTile;
  for (int t = 0; any_row && t < T_tasks; ++t) {
    const int jrel = n - kv_start[t];
    if (jrel < 0 || jrel >= min(kv_len[t], jmax)) continue;  // not covered
    for (int hr = 0; hr < rep; ++hr) {
      const int h = g * rep + hr;
      for (int tt = 0; tt < tiles; ++tt) {
        const size_t qrow0 = (size_t)t * blk + tt * kTile;
        const size_t stat0 = ((size_t)t * hq + h) * blk + tt * kTile;
        __syncthreads();  // every warp is done with the previous q tile
        stage<T, DH>(q_s, KS, q + qrow0 * q_stride + (size_t)h * DH,
                     q_stride, kTile);
        stage<T, DH>(do_s, KS, dout + qrow0 * q_stride + (size_t)h * DH,
                     q_stride, kTile);
        for (int i = tid; i < kTile; i += kThreads) {
          qp_s[i] = q_pos[qrow0 + i];
          lse_s[i] = lse[stat0 + i];
          dl_s[i] = delta[stat0 + i];
        }
        __syncthreads();

        // lane takes q rows lane and lane + 32 of the tile
        const int pq_lo = qp_s[lane], pq_hi = qp_s[lane + 32];
        const float ls_lo = lse_s[lane], ls_hi = lse_s[lane + 32];
        const float dl_lo = dl_s[lane], dl_hi = dl_s[lane + 32];
        const float* q_lo = q_s + lane * KS;
        const float* q_hi = q_s + (lane + 32) * KS;
        const float* o_lo = do_s + lane * KS;
        const float* o_hi = do_s + (lane + 32) * KS;
        for (int c = warp; c < kRows; c += kWarps) {
          const int pk = kp_s[c];
          const bool ok_lo = visible(pq_lo, pk, mask);
          const bool ok_hi = visible(pq_hi, pk, mask);
          if (!__any_sync(kFull, ok_lo || ok_hi)) continue;  // adds zeros

          const float* kc = k_s + c * DH;
          const float* vc = v_s + c * DH;
          float x_lo = 0.f, x_hi = 0.f, dp_lo = 0.f, dp_hi = 0.f;
#pragma unroll 8
          for (int d = 0; d < DH; ++d) {
            const float kd = kc[d], vd = vc[d];
            x_lo = fmaf(q_lo[d], kd, x_lo);
            x_hi = fmaf(q_hi[d], kd, x_hi);
            dp_lo = fmaf(o_lo[d], vd, dp_lo);
            dp_hi = fmaf(o_hi[d], vd, dp_hi);
          }
          x_lo = cap(x_lo, scale, softcap);
          x_hi = cap(x_hi, scale, softcap);
          const float p_lo = ok_lo ? expf(x_lo - ls_lo) : 0.f;
          const float p_hi = ok_hi ? expf(x_hi - ls_hi) : 0.f;
          const float ds_lo =
              ds_from_p(p_lo, dp_lo, dl_lo, x_lo, ok_lo, scale, softcap);
          const float ds_hi =
              ds_from_p(p_hi, dp_hi, dl_hi, x_hi, ok_hi, scale, softcap);

          float* dkc = dk_s + c * DH;
          float* dvc = dv_s + c * DH;
          float ak[PER_LANE], av[PER_LANE];
#pragma unroll
          for (int cc = 0; cc < PER_LANE; ++cc) {
            ak[cc] = dkc[lane + 32 * cc];
            av[cc] = dvc[lane + 32 * cc];
          }
#pragma unroll 2
          for (int rr = 0; rr < 32; ++rr) {
            const float pl = __shfl_sync(kFull, p_lo, rr);
            const float ph = __shfl_sync(kFull, p_hi, rr);
            const float sl = __shfl_sync(kFull, ds_lo, rr);
            const float sh = __shfl_sync(kFull, ds_hi, rr);
            const float* ql = q_s + rr * KS;
            const float* qh = q_s + (rr + 32) * KS;
            const float* ol = do_s + rr * KS;
            const float* oh = do_s + (rr + 32) * KS;
#pragma unroll
            for (int cc = 0; cc < PER_LANE; ++cc) {
              const int d = lane + 32 * cc;
              av[cc] = fmaf(ph, oh[d], fmaf(pl, ol[d], av[cc]));
              ak[cc] = fmaf(sh, qh[d], fmaf(sl, ql[d], ak[cc]));
            }
          }
#pragma unroll
          for (int cc = 0; cc < PER_LANE; ++cc) {
            dkc[lane + 32 * cc] = ak[cc];
            dvc[lane + 32 * cc] = av[cc];
          }
        }
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int c = idx / DH, d = idx % DH;
    const size_t off = kv_off + (size_t)c * kv_stride + d;
    dk[off] = from_f32<T>(dk_s[idx]);
    dv[off] = from_f32<T>(dv_s[idx]);
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = true;
  return e;
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const void *kv_start, *kv_len, *q_pos, *kv_pos;
  void *out, *lse, *dq, *dk, *dv;
  int T, N, blk, hq, hkv, jmax;
  Mask mask;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch_fwd(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_fwd_kernel<T, DH>, fwd_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.T, a.hq, a.blk / kRows);
  ca_fwd_kernel<T, DH><<<grid, kThreads, fwd_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.kv_start),
      static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.q_pos),
      static_cast<const int32_t*>(a.kv_pos), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.N, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_bwd_dq_kernel<T, DH>, dq_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.T, a.hq, a.blk / kRows);
  ca_bwd_dq_kernel<T, DH><<<grid, kThreads, dq_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.kv_start),
      static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.q_pos),
      static_cast<const int32_t*>(a.kv_pos), static_cast<T*>(a.dq), a.N,
      a.blk, a.hq, a.hkv, a.jmax, a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_bwd_dkv_kernel<T, DH>, dkv_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.N, a.hkv, a.blk / kRows);
  ca_bwd_dkv_kernel<T, DH><<<grid, kThreads, dkv_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.kv_start),
      static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.q_pos),
      static_cast<const int32_t*>(a.kv_pos), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.T, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}

// which: 0 = forward, 1 = dq, 2 = dk/dv
int dispatch(int which, int dtype, int dh, const Args& a) {
  if (a.T <= 0 || a.N <= 0) return cudaSuccess;
  if ((a.blk != 64 && a.blk != 128) || a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.jmax < 0 || a.mask.rate < 1)
    return cudaErrorInvalidValue;
#define CA_CASE(T, DH)                                  \
  if (which == 0) return (int)launch_fwd<T, DH>(a);     \
  if (which == 1) return (int)launch_dq<T, DH>(a);      \
  return (int)launch_dkv<T, DH>(a)
  if (dtype == 0 && dh == 64) { CA_CASE(float, 64); }
  if (dtype == 0 && dh == 128) { CA_CASE(float, 128); }
  if (dtype == 1 && dh == 64) { CA_CASE(__nv_bfloat16, 64); }
  if (dtype == 1 && dh == 128) { CA_CASE(__nv_bfloat16, 128); }
#undef CA_CASE
  return cudaErrorInvalidValue;
}

Args make_args(int T, int N, int blk, int hq, int hkv, int jmax, int window,
               int sink, int rate, float softcap, float scale, void* stream) {
  Args a{};
  a.T = T;
  a.N = N;
  a.blk = blk;
  a.hq = hq;
  a.hkv = hkv;
  a.jmax = jmax;
  a.mask = Mask{window, sink, rate, blk};
  a.softcap = softcap;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [T, blk, hq, dh];
// k, v [N, blk, hkv, dh]; lse [T, hq, blk] f32; kv_start, kv_len [T],
// q_pos [T, blk], kv_pos [N, blk] int32.  The caller checks shapes, types
// and contiguity.
extern "C" int ca_server_fwd(const void* q, const void* k, const void* v,
                             const void* kv_start, const void* kv_len,
                             const void* q_pos, const void* kv_pos, void* out,
                             void* lse, int T, int N, int blk, int hq,
                             int hkv, int dh, int dtype, int jmax, int window,
                             int sink, int rate, float softcap, float scale,
                             void* stream) {
  Args a = make_args(T, N, blk, hq, hkv, jmax, window, sink, rate, softcap,
                     scale, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_start = kv_start;
  a.kv_len = kv_len;
  a.q_pos = q_pos;
  a.kv_pos = kv_pos;
  a.out = out;
  a.lse = lse;
  return dispatch(0, dtype, dh, a);
}

// dout like q; lse, delta [T, hq, blk] f32; dq like q.
extern "C" int ca_server_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* kv_start,
                                const void* kv_len, const void* q_pos,
                                const void* kv_pos, void* dq, int T, int N,
                                int blk, int hq, int hkv, int dh, int dtype,
                                int jmax, int window, int sink, int rate,
                                float softcap, float scale, void* stream) {
  Args a = make_args(T, N, blk, hq, hkv, jmax, window, sink, rate, softcap,
                     scale, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.kv_start = kv_start;
  a.kv_len = kv_len;
  a.q_pos = q_pos;
  a.kv_pos = kv_pos;
  a.dq = dq;
  return dispatch(1, dtype, dh, a);
}

// dk, dv like k (every row written, zeros where no task covers it).
extern "C" int ca_server_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_start,
                                 const void* kv_len, const void* q_pos,
                                 const void* kv_pos, void* dk, void* dv,
                                 int T, int N, int blk, int hq, int hkv,
                                 int dh, int dtype, int jmax, int window,
                                 int sink, int rate, float softcap,
                                 float scale, void* stream) {
  Args a = make_args(T, N, blk, hq, hkv, jmax, window, sink, rate, softcap,
                     scale, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.kv_start = kv_start;
  a.kv_len = kv_len;
  a.q_pos = q_pos;
  a.kv_pos = kv_pos;
  a.dk = dk;
  a.dv = dv;
  return dispatch(2, dtype, dh, a);
}
