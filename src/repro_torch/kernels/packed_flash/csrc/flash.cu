// Packed-document flash attention, hand-written for Hopper (sm_90a):
// forward (with lse), and the backward as a dq kernel and a dk/dv kernel.
//
// Replace the TPU kernels of the JAX package's
// kernels/packed_flash/kernel.py:
//   flash_fwd   (body _flash_kernel, masks _flash_mask/_flash_block_live)
//   flash_bwd   (bodies _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel)
// q [B, Sq, Hq, dh] attends k, v [B, Skv, Hkv, dh] of the same batch row.
// A (q row, kv slot) pair is visible when its block pair passes the TPU
// kernel's chunk-order block prune (_flash_block_live on row / blk_q and
// slot / blk_k: causal, window unless sink > 0, dilated (i - j) % rate)
// and its tokens pass the token mask (_flash_mask: equal segment ids > 0,
// causal on in-document positions, window with sink, dilated
// (pq // blk_q - pk // blk_q) % rate).  Logit softcap, online softmax in
// f32, finite sentinels NEG_INF = -2**30 and LSE_DEAD = 2**30; dead rows
// give out 0 and lse LSE_DEAD.  GQA maps q head h to kv head h / (Hq/Hkv).
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// the forward does 4 * (visible pairs) * Hq * dh FLOPs and moves q, k, v,
// out and lse once; the backward about 2.5x the FLOPs.  At the training
// step's shapes (4 x 4096 tokens of long documents, Hq 32, dh 128) that is
// ~140 GFLOP against ~0.3 GB a layer: bound by the products.  The simple
// design below runs far from that bound: it does the products on the f32
// FMA pipes, not the tensor cores.
//
// Design (simple and right first, the tile code of ca_server.cu; the
// helpers shared with it are in common.cuh):
//   * forward and dq: one CTA of 8 warps per (batch row b, q head h,
//     R-row q tile; R = 64, 32 at dh 256).  The TPU's sequential kv grid
//     axis is a loop inside the CTA over 64-slot kv tiles, K/V staged in
//     shared memory as f32.  One warp works on one q row at a time: each
//     lane takes two keys of the tile for the dot products, and the lanes
//     split dh for the P.V (or dS.K) update.
//   * dk/dv: one CTA per (b, kv head g, R-row kv tile; R = 64, 16 at dh
//     256) walks the 64-row q tiles in order and, for each, the rep =
//     Hq / Hkv q heads of group g in order, accumulating dk and dv of its
//     rows in shared memory in f32 and writing them once in k's dtype.
//     GQA is folded in the kernel (the TPU kernel writes per-q-head f32
//     gradients and folds them outside): no rep-times f32 intermediate
//     and no float atomics, so the sums run in one fixed order and
//     repeated runs are bitwise equal.
//     A warp works on one kv row at a time: lanes take two q rows for the
//     dot products and split dh for the dV / dK update.
//   * pruning: before staging a tile the CTA checks whether any pair of
//     (its rows) x (the tile) is visible, and a warp skips a (row, tile)
//     pair with none.  A fully masked tile is an exact no-op of the online
//     softmax (max unchanged, p = 0, correction exp(0) = 1) and adds exact
//     zeros to dq, dk and dv, so skipping it changes no bit; it prunes by
//     document, more than the TPU's block prune, never less.
//   * shared memory in f32: at dh 128 forward 130 KiB, dq 162 KiB, dk/dv
//     194 KiB, all under the 227 KiB a CTA may use.  At dh 256 the 64-row
//     staging of every kernel would need 257-322 KiB, so a CTA owns fewer
//     rows of its own while the tiles it walks keep 64 rows (two per lane,
//     as at dh 64 and 128): 32 q rows in the forward (193 KiB) and dq (225
//     KiB), 16 kv rows in dk/dv (194 KiB).  That keeps f32 staging for both
//     input types and every sum in the order of dh 64 and 128, whose code
//     is unchanged; staging bf16 would have halved the bytes only for bf16
//     inputs.  Under recurrentgemma's MQA (rep 16, one kv head) dk/dv then
//     has a CTA per 16 kv rows, each walking 16 q heads for every q tile.
//     Dynamic shared memory, raised once per instantiation with
//     cudaFuncSetAttribute.
//
// What the simple design gives up, each a later change: tensor cores
// (mma.sync / wgmma on bf16 tiles), one K/V tile shared across the rep q
// heads of a GQA group in the forward and dq kernels (16 heads re-read one
// K/V tile under MQA), and tile loads overlapped with compute.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // kv slots (fwd, dq) or q rows (dk/dv) per tile

// a CTA's own rows: q rows (fwd, dq) or kv rows (dk/dv); fewer at dh 256,
// where 64 rows of f32 staging do not fit in shared memory (header note)
template <int DH>
struct Rows {
  static constexpr int kQ = DH <= 128 ? 64 : 32;
  static constexpr int kKV = DH <= 128 ? 64 : 16;
  static_assert(kTile % kQ == 0 && kTile % kKV == 0, "rows divide tiles");
};

// Python's floor division (jnp //), for positions of either sign
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Mask {
  int causal;
  int window;  // 0 = no window
  int sink;    // always-visible leading tokens (with a window)
  int rate;    // dilation over blk_q-token blocks, 1 = none
  int blk_q;   // the TPU kernel's blocks: pruning and the dilation unit
  int blk_k;
};

// kernel.py _flash_block_live on chunk-order block indices
__device__ __forceinline__ bool block_live(int i, int j, const Mask& m) {
  if (m.causal && !(j * m.blk_k < (i + 1) * m.blk_q)) return false;
  if (m.window > 0 && m.sink == 0 &&
      !((j + 1) * m.blk_k - 1 >= i * m.blk_q - m.window))
    return false;
  if (m.rate > 1 && (i - j) % m.rate != 0) return false;
  return true;
}

// the pair (q row `row`, kv slot `col`): block prune and kernel.py
// _flash_mask (mblk = blk_q)
__device__ __forceinline__ bool visible(int row, int col, int sq, int pq,
                                        int sk, int pk, const Mask& m) {
  if (sq != sk || sq <= 0) return false;
  if (m.causal && pq < pk) return false;
  if (m.window > 0 && pq - pk >= m.window && !(m.sink > 0 && pk < m.sink))
    return false;
  if (m.rate > 1 &&
      (floor_div(pq, m.blk_q) - floor_div(pk, m.blk_q)) % m.rate != 0)
    return false;
  return block_live(row / m.blk_q, col / m.blk_k, m);
}

// whether any pair of rows [r0, r0 + NR) x slots [c0, c0 + NC) is
// visible, from the segment ids and positions staged in shared memory;
// the same answer on every thread of the CTA (a barrier)
template <int NR, int NC>
__device__ __forceinline__ bool tile_any_visible(int r0, int c0,
                                                 const int* rseg,
                                                 const int* rpos,
                                                 const int* cseg,
                                                 const int* cpos,
                                                 const Mask& m) {
  bool any = false;
  for (int idx = threadIdx.x; idx < NR * NC && !any; idx += kThreads) {
    const int r = idx / NC, c = idx % NC;
    any = visible(r0 + r, c0 + c, rseg[r], rpos[r], cseg[c], cpos[c], m);
  }
  return __syncthreads_or(any) != 0;
}

// ------------------------------------------------------------------ forward
template <int DH>
constexpr size_t fwd_smem() {
  // q, accumulators [kRows][DH]; K tile [kTile][DH + 1] (padded so the
  // lane-per-key reads fall in distinct banks); V tile [kTile][DH]; row
  // max and sum; row and slot segment ids and positions
  constexpr int kRows = Rows<DH>::kQ;
  return sizeof(float) * (2 * (size_t)kRows * DH + (size_t)kTile * (DH + 1) +
                          (size_t)kTile * DH + 2 * (size_t)kRows) +
         sizeof(int) * 2 * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int32_t* __restrict__ seg_q,
                     const int32_t* __restrict__ pos_q,
                     const int32_t* __restrict__ seg_kv,
                     const int32_t* __restrict__ pos_kv, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int hq,
                     int hkv, Mask mask, float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  constexpr int kRows = Rows<DH>::kQ;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows][DH]
  float* acc_s = q_s + kRows * DH;    // [kRows][DH]
  float* k_s = acc_s + kRows * DH;    // [kTile][KS]
  float* v_s = k_s + kTile * KS;      // [kTile][DH]
  float* m_s = v_s + kTile * DH;      // [kRows]
  float* l_s = m_s + kRows;           // [kRows]
  int* qs_s = reinterpret_cast<int*>(l_s + kRows);  // [kRows]
  int* qp_s = qs_s + kRows;                          // [kRows]
  int* ks_s = qp_s + kRows;                          // [kTile]
  int* kp_s = ks_s + kTile;                          // [kTile]

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;    // between q (and out) rows
  const size_t kv_stride = (size_t)hkv * DH;  // between k (and v) rows
  const size_t qrow0 = (size_t)b * Sq + r0;
  const size_t krow0 = (size_t)b * Skv;
  const T* qb = q + qrow0 * q_stride + (size_t)h * DH;
  T* ob = out + qrow0 * q_stride + (size_t)h * DH;
  float* lb = lse + ((size_t)b * hq + h) * Sq + r0;

  for (int r = tid; r < kRows; r += kThreads) {
    qs_s[r] = seg_q[qrow0 + r];
    qp_s[r] = pos_q[qrow0 + r];
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  stage<T, DH>(q_s, DH, qb, q_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) acc_s[idx] = 0.f;

  for (int c0 = 0; c0 < Skv; c0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    if (tid < kTile) {
      ks_s[tid] = seg_kv[krow0 + c0 + tid];
      kp_s[tid] = pos_kv[krow0 + c0 + tid];
    }
    __syncthreads();
    if (!tile_any_visible<kRows, kTile>(r0, c0, qs_s, qp_s, ks_s, kp_s,
                                         mask))
      continue;
    for (int idx = tid; idx < kTile * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH;
      const size_t off = (krow0 + c0 + r) * kv_stride + (size_t)g * DH + d;
      k_s[r * KS + d] = to_f32(k[off]);
      v_s[r * DH + d] = to_f32(v[off]);
    }
    __syncthreads();

    const int sk_lo = ks_s[lane], sk_hi = ks_s[lane + 32];
    const int pk_lo = kp_s[lane], pk_hi = kp_s[lane + 32];
    for (int r = warp; r < kRows; r += kWarps) {
      const int sq = qs_s[r], pq = qp_s[r];
      const bool ok_lo =
          visible(r0 + r, c0 + lane, sq, pq, sk_lo, pk_lo, mask);
      const bool ok_hi =
          visible(r0 + r, c0 + lane + 32, sq, pq, sk_hi, pk_hi, mask);
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
  // q, dO, dQ [kRows][DH]; K and V tiles [kTile][DH + 1]; per-row lse and
  // delta; row and slot segment ids and positions
  constexpr int kRows = Rows<DH>::kQ;
  return sizeof(float) * (3 * (size_t)kRows * DH +
                          2 * (size_t)kTile * (DH + 1) + 2 * (size_t)kRows) +
         sizeof(int) * 2 * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int32_t* __restrict__ seg_q,
                        const int32_t* __restrict__ pos_q,
                        const int32_t* __restrict__ seg_kv,
                        const int32_t* __restrict__ pos_kv,
                        T* __restrict__ dq, int Sq, int Skv, int hq, int hkv,
                        Mask mask, float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  constexpr int kRows = Rows<DH>::kQ;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows][DH]
  float* do_s = q_s + kRows * DH;     // [kRows][DH]
  float* dq_s = do_s + kRows * DH;    // [kRows][DH]
  float* k_s = dq_s + kRows * DH;     // [kTile][KS]
  float* v_s = k_s + kTile * KS;      // [kTile][KS]
  float* lse_s = v_s + kTile * KS;    // [kRows]
  float* dl_s = lse_s + kRows;        // [kRows]
  int* qs_s = reinterpret_cast<int*>(dl_s + kRows);  // [kRows]
  int* qp_s = qs_s + kRows;                           // [kRows]
  int* ks_s = qp_s + kRows;                           // [kTile]
  int* kp_s = ks_s + kTile;                           // [kTile]

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (hq / hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;
  const size_t kv_stride = (size_t)hkv * DH;
  const size_t qrow0 = (size_t)b * Sq + r0;
  const size_t krow0 = (size_t)b * Skv;
  const size_t head_off = (size_t)h * DH;
  const size_t stat0 = ((size_t)b * hq + h) * Sq + r0;

  for (int r = tid; r < kRows; r += kThreads) {
    qs_s[r] = seg_q[qrow0 + r];
    qp_s[r] = pos_q[qrow0 + r];
    lse_s[r] = lse[stat0 + r];
    dl_s[r] = delta[stat0 + r];
  }
  stage<T, DH>(q_s, DH, q + qrow0 * q_stride + head_off, q_stride, kRows);
  stage<T, DH>(do_s, DH, dout + qrow0 * q_stride + head_off, q_stride,
               kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) dq_s[idx] = 0.f;

  for (int c0 = 0; c0 < Skv; c0 += kTile) {
    __syncthreads();
    if (tid < kTile) {
      ks_s[tid] = seg_kv[krow0 + c0 + tid];
      kp_s[tid] = pos_kv[krow0 + c0 + tid];
    }
    __syncthreads();
    if (!tile_any_visible<kRows, kTile>(r0, c0, qs_s, qp_s, ks_s, kp_s,
                                         mask))
      continue;
    for (int idx = tid; idx < kTile * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH;
      const size_t off = (krow0 + c0 + r) * kv_stride + (size_t)g * DH + d;
      k_s[r * KS + d] = to_f32(k[off]);
      v_s[r * KS + d] = to_f32(v[off]);
    }
    __syncthreads();

    const int sk_lo = ks_s[lane], sk_hi = ks_s[lane + 32];
    const int pk_lo = kp_s[lane], pk_hi = kp_s[lane + 32];
    for (int r = warp; r < kRows; r += kWarps) {
      const int sq = qs_s[r], pq = qp_s[r];
      const bool ok_lo =
          visible(r0 + r, c0 + lane, sq, pq, sk_lo, pk_lo, mask);
      const bool ok_hi =
          visible(r0 + r, c0 + lane + 32, sq, pq, sk_hi, pk_hi, mask);
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
  __syncthreads();

  T* dqb = dq + qrow0 * q_stride + head_off;
  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    dqb[(size_t)r * q_stride + d] = from_f32<T>(dq_s[idx]);
  }
}

// ---------------------------------------------------------------- dk/dv pass
template <int DH>
constexpr size_t dkv_smem() {
  // K, V, dK, dV rows [kRows][DH]; q and dO tiles [kTile][DH + 1];
  // per-q-row lse and delta; q-row and kv-row segment ids and positions
  constexpr int kRows = Rows<DH>::kKV;
  return sizeof(float) * (4 * (size_t)kRows * DH +
                          2 * (size_t)kTile * (DH + 1) + 2 * (size_t)kTile) +
         sizeof(int) * 2 * (size_t)(kRows + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ seg_q,
                         const int32_t* __restrict__ pos_q,
                         const int32_t* __restrict__ seg_kv,
                         const int32_t* __restrict__ pos_kv,
                         T* __restrict__ dk, T* __restrict__ dv, int Sq,
                         int Skv, int hq, int hkv, Mask mask, float softcap,
                         float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  constexpr int kRows = Rows<DH>::kKV;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kRows][DH]
  float* v_s = k_s + kRows * DH;      // [kRows][DH]
  float* dk_s = v_s + kRows * DH;     // [kRows][DH]
  float* dv_s = dk_s + kRows * DH;    // [kRows][DH]
  float* q_s = dv_s + kRows * DH;     // [kTile][KS]
  float* do_s = q_s + kTile * KS;     // [kTile][KS]
  float* lse_s = do_s + kTile * KS;   // [kTile]
  float* dl_s = lse_s + kTile;        // [kTile]
  int* qs_s = reinterpret_cast<int*>(dl_s + kTile);  // [kTile]
  int* qp_s = qs_s + kTile;                           // [kTile]
  int* ks_s = qp_s + kTile;                           // [kRows]
  int* kp_s = ks_s + kRows;                           // [kRows]

  const int c0 = blockIdx.x * kRows;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = (size_t)hq * DH;
  const size_t kv_stride = (size_t)hkv * DH;
  const size_t krow0 = (size_t)b * Skv + c0;
  const size_t kv_off = krow0 * kv_stride + (size_t)g * DH;
  const size_t qrow_b = (size_t)b * Sq;

  for (int c = tid; c < kRows; c += kThreads) {
    ks_s[c] = seg_kv[krow0 + c];
    kp_s[c] = pos_kv[krow0 + c];
  }
  stage<T, DH>(k_s, DH, k + kv_off, kv_stride, kRows);
  stage<T, DH>(v_s, DH, v + kv_off, kv_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    dk_s[idx] = 0.f;
    dv_s[idx] = 0.f;
  }

  for (int t0 = 0; t0 < Sq; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous q tile
    if (tid < kTile) {
      qs_s[tid] = seg_q[qrow_b + t0 + tid];
      qp_s[tid] = pos_q[qrow_b + t0 + tid];
    }
    __syncthreads();
    // rows are q rows here: pairs (q rows of this tile) x (our kv rows)
    if (!tile_any_visible<kTile, kRows>(t0, c0, qs_s, qp_s, ks_s, kp_s,
                                         mask))
      continue;
    for (int hr = 0; hr < rep; ++hr) {
      const int h = g * rep + hr;
      const size_t stat0 = ((size_t)b * hq + h) * Sq + t0;
      __syncthreads();  // every warp is done with the previous head
      stage<T, DH>(q_s, KS, q + (qrow_b + t0) * q_stride + (size_t)h * DH,
                   q_stride, kTile);
      stage<T, DH>(do_s, KS,
                   dout + (qrow_b + t0) * q_stride + (size_t)h * DH,
                   q_stride, kTile);
      for (int i = tid; i < kTile; i += kThreads) {
        lse_s[i] = lse[stat0 + i];
        dl_s[i] = delta[stat0 + i];
      }
      __syncthreads();

      // lane takes q rows lane and lane + 32 of the tile
      const int sq_lo = qs_s[lane], sq_hi = qs_s[lane + 32];
      const int pq_lo = qp_s[lane], pq_hi = qp_s[lane + 32];
      const float ls_lo = lse_s[lane], ls_hi = lse_s[lane + 32];
      const float dl_lo = dl_s[lane], dl_hi = dl_s[lane + 32];
      const float* q_lo = q_s + lane * KS;
      const float* q_hi = q_s + (lane + 32) * KS;
      const float* o_lo = do_s + lane * KS;
      const float* o_hi = do_s + (lane + 32) * KS;
      for (int c = warp; c < kRows; c += kWarps) {
        const int sk = ks_s[c], pk = kp_s[c];
        const bool ok_lo =
            visible(t0 + lane, c0 + c, sq_lo, pq_lo, sk, pk, mask);
        const bool ok_hi =
            visible(t0 + lane + 32, c0 + c, sq_hi, pq_hi, sk, pk, mask);
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
  __syncthreads();

  for (int idx = tid; idx < kRows * DH; idx += kThreads) {
    const int c = idx / DH, d = idx % DH;
    const size_t off = kv_off + (size_t)c * kv_stride + d;
    dk[off] = from_f32<T>(dk_s[idx]);
    dv[off] = from_f32<T>(dv_s[idx]);
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const void *seg_q, *pos_q, *seg_kv, *pos_kv;
  void *out, *lse, *dq, *dk, *dv;
  int B, Sq, Skv, hq, hkv;
  Mask mask;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch_fwd(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_fwd_kernel<T, DH>, fwd_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Sq / Rows<DH>::kQ, a.hq, a.B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, fwd_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.seg_q),
      static_cast<const int32_t*>(a.pos_q),
      static_cast<const int32_t*>(a.seg_kv),
      static_cast<const int32_t*>(a.pos_kv), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.Sq, a.Skv, a.hq, a.hkv, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_bwd_dq_kernel<T, DH>, dq_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Sq / Rows<DH>::kQ, a.hq, a.B);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, dq_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.seg_q),
      static_cast<const int32_t*>(a.pos_q),
      static_cast<const int32_t*>(a.seg_kv),
      static_cast<const int32_t*>(a.pos_kv), static_cast<T*>(a.dq), a.Sq,
      a.Skv, a.hq, a.hkv, a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_bwd_dkv_kernel<T, DH>, dkv_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Skv / Rows<DH>::kKV, a.hkv, a.B);
  flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, dkv_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.seg_q),
      static_cast<const int32_t*>(a.pos_q),
      static_cast<const int32_t*>(a.seg_kv),
      static_cast<const int32_t*>(a.pos_kv), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Skv, a.hq, a.hkv, a.mask, a.softcap,
      a.scale);
  return cudaGetLastError();
}

// which: 0 = forward, 1 = dq, 2 = dk/dv
int dispatch(int which, int dtype, int dh, const Args& a) {
  const Mask& m = a.mask;
  if (a.B < 1 || a.Sq < 1 || a.Skv < 1 || a.Sq % kTile != 0 ||
      a.Skv % kTile != 0 || a.hkv < 1 || a.hq % a.hkv != 0 ||
      m.rate < 1 || m.blk_q < 1 || m.blk_k < 1 ||
      (m.rate > 1 && m.blk_q != m.blk_k))
    return cudaErrorInvalidValue;
#define FLASH_CASE(T, DH)                               \
  if (which == 0) return (int)launch_fwd<T, DH>(a);     \
  if (which == 1) return (int)launch_dq<T, DH>(a);      \
  return (int)launch_dkv<T, DH>(a)
  if (dtype == 0 && dh == 64) { FLASH_CASE(float, 64); }
  if (dtype == 0 && dh == 128) { FLASH_CASE(float, 128); }
  if (dtype == 0 && dh == 256) { FLASH_CASE(float, 256); }
  if (dtype == 1 && dh == 64) { FLASH_CASE(__nv_bfloat16, 64); }
  if (dtype == 1 && dh == 128) { FLASH_CASE(__nv_bfloat16, 128); }
  if (dtype == 1 && dh == 256) { FLASH_CASE(__nv_bfloat16, 256); }
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v,
               const void* seg_q, const void* pos_q, const void* seg_kv,
               const void* pos_kv, int B, int Sq, int Skv, int hq, int hkv,
               int causal, int window, int sink, int rate, int blk_q,
               int blk_k, float softcap, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = seg_q;
  a.pos_q = pos_q;
  a.seg_kv = seg_kv;
  a.pos_kv = pos_kv;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.hq = hq;
  a.hkv = hkv;
  a.mask = Mask{causal, window, sink, rate, blk_q, blk_k};
  a.softcap = softcap;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [B, Sq, hq, dh];
// k, v [B, Skv, hkv, dh]; lse [B, hq, Sq] f32; seg_q, pos_q [B, Sq],
// seg_kv, pos_kv [B, Skv] int32; dh 64, 128 or 256.  Sq and Skv multiples
// of 64.  The caller checks shapes, types and contiguity.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* seg_q, const void* pos_q,
                         const void* seg_kv, const void* pos_kv, void* out,
                         void* lse, int B, int Sq, int Skv, int hq, int hkv,
                         int dh, int dtype, int causal, int window, int sink,
                         int rate, int blk_q, int blk_k, float softcap,
                         float scale, void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, B, Sq, Skv, hq,
                     hkv, causal, window, sink, rate, blk_q, blk_k, softcap,
                     scale, stream);
  a.out = out;
  a.lse = lse;
  return dispatch(0, dtype, dh, a);
}

// dout like q; lse, delta [B, hq, Sq] f32; dq like q.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* seg_q,
                            const void* pos_q, const void* seg_kv,
                            const void* pos_kv, void* dq, int B, int Sq,
                            int Skv, int hq, int hkv, int dh, int dtype,
                            int causal, int window, int sink, int rate,
                            int blk_q, int blk_k, float softcap, float scale,
                            void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, B, Sq, Skv, hq,
                     hkv, causal, window, sink, rate, blk_q, blk_k, softcap,
                     scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch(1, dtype, dh, a);
}

// dk, dv like k (every row written, zeros where no pair reaches it).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* seg_q,
                             const void* pos_q, const void* seg_kv,
                             const void* pos_kv, void* dk, void* dv, int B,
                             int Sq, int Skv, int hq, int hkv, int dh,
                             int dtype, int causal, int window, int sink,
                             int rate, int blk_q, int blk_k, float softcap,
                             float scale, void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, B, Sq, Skv, hq,
                     hkv, causal, window, sink, rate, blk_q, blk_k, softcap,
                     scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch(2, dtype, dh, a);
}
