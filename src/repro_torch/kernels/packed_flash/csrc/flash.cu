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
// out and lse once; the backward 2.5x the FLOPs.  At the training step's
// shapes (4 x 4096 tokens of long documents, Hq 32, dh 128) that is ~140
// GFLOP against ~0.3 GB a layer: bound by the products, 0.15 ms forward
// and 0.36 ms backward at the data-sheet rate.
//
// Design.  bf16 inputs (the training path) take tensor-core kernels;
// f32 inputs (the exactness checks) keep the exact FMA kernels below,
// whose arithmetic is ca_server.cu's.
//
// bf16: flash_fwd_mma_kernel, flash_dq_mma_kernel, flash_dkv_mma_kernel,
// CTAs of 4 warps:
//   * every product on the tensor cores: mma.sync m16n8k16 with bf16
//     fragments from ldmatrix / ldmatrix.trans and f32 accumulators.  The
//     forward's online softmax runs in registers FA2-style in log2 units
//     (exp2), P rounded to bf16 for P.V as the TPU kernel does; l sums the
//     f32 p.  The backward forms P = exp(logit - lse) and dS = P (dP -
//     delta) (softcap chain rule, scale) in registers and feeds them to
//     the next product as bf16 A fragments.
//   * GQA in the M dimension: the forward's and dq's CTA rows are 64 (32
//     at dh 192/256 in dq) (q row, q head) pairs of one kv head's group,
//     q row major, so every K/V tile a CTA loads serves all rep heads of
//     the group (the f32 kernels load it once per q head).
//   * tiles stay bf16 in shared memory, rows padded by 16 bytes for
//     ldmatrix, loaded by cp.async into a ring of 2 stages (tile t + 1 in
//     flight while tile t is computed), with the tile's segment ids and
//     positions.
//   * pruning by document before a tile is touched: a pre-pass
//     (flash_keep_kernel and flash_q_range_kernel below, launched by
//     ops.py flash_tile_ranges; plain version flash_tile_ranges_reference)
//     gives each 64-row q tile the kv tiles [lo, hi) its documents and
//     window can reach, and each 64-slot kv tile the q tiles; a CTA walks
//     only those (the f32 kernels test every tile).  Inside, a warp
//     classifies each tile from the spans (live segment ids, positions,
//     chunk-order indices) of its 16 rows and of the tile: no visible pair
//     -> skipped (an exact no-op), every pair visible -> no mask
//     arithmetic, the block prune keeping every pair -> each pair's tokens
//     tested (segment, causal, window), else the whole pair mask with the
//     block prune's divisions.  Pruning changes no bit.
//   * dk/dv: a CTA per (b, kv head, 64 kv rows (32 at dh 192/256), head
//     part) walks its group rows (q row, q head) in tiles of 64 (32 at dh
//     >= 128), q row major, always in the same order: S^T = K Q^T, dV +=
//     P^T dO, dP^T = V dO^T, dK += dS^T Q.  P^T and dS^T enter their
//     products as bf16 hi + lo pairs (two products each): dK and dV sum
//     up to rep x S terms, and one bf16 rounding of each term (relative
//     2**-9) leaves an error of ~0.2% of the sum's scale, which reaches
//     the 2e-2 tolerance where that scale is several units and the sum
//     itself near 0 (a document's first slots under MQA).  No float
//     atomics.  When the grid is small
//     (recurrentgemma's MQA: 1 kv head, rep 16) the wrapper splits the
//     group's heads into n_split parts (ops.py flash_dkv_split); each part
//     writes f32 partial dk/dv, and the last CTA of a kv tile to finish,
//     found through an int counter it resets, sums them in part order.
//     Repeated calls are bitwise equal.
//   * head_dim 64, 128, 192, 256.  At 192 and 256 a warp cannot hold 16 x
//     dh f32 accumulators (twice in dk/dv) beside its scores, so in dq and
//     dk/dv two warps split dh for the accumulators and each computes the
//     shared S and dP whole; the forward and dq walk 32-slot kv tiles.
//
// f32: one CTA of 8 warps per (batch row b, q head h, R-row q tile; R =
// 64, 32 at dh 192/256) walks 64-slot kv tiles staged in shared memory as
// f32, a warp per q row (each lane takes two keys for the dot products,
// the lanes split dh for P.V or dS.K); dk/dv a CTA per (b, kv head, R kv
// rows; R = 64, 16 at dh 192/256) walks the q tiles and, inside each, the
// group's q heads in order, accumulating in shared memory.  A CTA scans
// every kv (or q) tile and skips those with no visible pair (64 x 64 pair
// tests).  Dynamic shared memory up to 225 KiB, raised once per
// instantiation.
//
// What is left for later: wgmma with TMA loads and a producer warp (FA3's
// shape), a ring of more stages, and one dS product in dk/dv instead of
// the hi + lo pair where the sums are short.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.

#include <climits>

#include "common.cuh"
#include "tiles.cuh"

namespace {

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
// the token mask without the dilation: same live segment, causal, window
// with sink
__device__ __forceinline__ bool token_visible(int sq, int pq, int sk, int pk,
                                              const Mask& m) {
  if (sq != sk || sq <= 0) return false;
  if (m.causal && pq < pk) return false;
  if (m.window > 0 && pq - pk >= m.window && !(m.sink > 0 && pk < m.sink))
    return false;
  return true;
}

__device__ __forceinline__ bool visible(int row, int col, int sq, int pq,
                                        int sk, int pk, const Mask& m) {
  if (!token_visible(sq, pq, sk, pk, m)) return false;
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

// ============================================= f32: exact FMA kernels
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


// ============================================ bf16: tensor-core kernels
// (GroupRows, Span, span_add, span_warp, the tile classes, KvStage and
// softmax_step are in tiles.cuh, shared with ca_server.cu, as are kTile
// and the f32 kernels' Rows; mma_abt and mma_pb are in kernels/csrc/
// mma.cuh)

// A warp tile of q rows (span q, chunk-order rows [qi0, qi1]) against kv
// slots (span k, slots [ki0, ki1]): kNone when it fails a condition every
// visible pair meets (same live segment, causal and window on the
// positions, the block prune at the corners), kAll when every pair is
// visible (one segment, no padding, every corner inside the masks),
// kTokens when the block prune keeps every pair and there is no dilation
// (each pair's tokens are tested), else kSome (each pair is tested whole).
// Pruning kNone tiles changes no bit: a tile without a visible pair is an
// exact no-op of the online softmax and adds exact zeros to the gradients.
__device__ __forceinline__ int classify(const Span& q, int qi0, int qi1,
                                        const Span& k, int ki0, int ki1,
                                        const Mask& m) {
  if (q.smax <= 0 || k.smax <= 0 || q.smax < k.smin || k.smax < q.smin)
    return kNone;
  if (m.causal && k.pmin > q.pmax) return kNone;
  if (m.window > 0 && q.pmin - k.pmax >= m.window &&
      !(m.sink > 0 && k.pmin < m.sink))
    return kNone;
  const int i0 = qi0 / m.blk_q, i1 = qi1 / m.blk_q;
  const int j0 = ki0 / m.blk_k, j1 = ki1 / m.blk_k;
  if (m.causal && j0 * m.blk_k >= (i1 + 1) * m.blk_q) return kNone;
  const bool wblk = m.window > 0 && m.sink == 0;  // _flash_block_live
  if (wblk && (j1 + 1) * m.blk_k - 1 < i0 * m.blk_q - m.window) return kNone;
  const bool blocks =
      m.rate == 1 && (!m.causal || j1 * m.blk_k < (i0 + 1) * m.blk_q) &&
      (!wblk || (j0 + 1) * m.blk_k - 1 >= i1 * m.blk_q - m.window);
  if (blocks && !q.dead && !k.dead && q.smin == q.smax &&
      k.smin == k.smax && q.smin == k.smin &&
      (!m.causal || k.pmax <= q.pmin) &&
      (m.window <= 0 || q.pmax - k.pmin < m.window))
    return kAll;
  return blocks ? kTokens : kSome;
}

// The visible pairs of a warp tile that this thread holds in its score
// registers, as bit n * 4 + e for element e of n8 tile n: row ra + 8 * (e
// / 2) of the warp, column n * 8 + 2 * (lane % 4) + e % 2 of the tile.
// The thread's two rows are (index, segment, position) ri, rs, rp;
// col(j) gives column j's.  Q_ROWS: the rows are q rows (forward, dq),
// else kv rows (dk/dv).
template <int NT, bool Q_ROWS, typename Col>
__device__ __forceinline__ uint32_t pair_bits(int cls, const int (&ri)[2],
                                              const int (&rs)[2],
                                              const int (&rp)[2], Col col,
                                              int lane, const Mask& m) {
  if (cls == kAll) return ~0u;
  uint32_t ok = 0u;
  if (cls == kNone) return ok;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int3 c = col(n * 8 + 2 * (lane & 3) + (e & 1));  // idx, seg, pos
      bool v;
      if (cls == kTokens)
        v = Q_ROWS ? token_visible(rs[h], rp[h], c.y, c.z, m)
                   : token_visible(c.y, c.z, rs[h], rp[h], m);
      else
        v = Q_ROWS ? visible(ri[h], c.x, rs[h], rp[h], c.y, c.z, m)
                   : visible(c.x, ri[h], c.y, c.z, rs[h], rp[h], m);
      if (v) ok |= 1u << (n * 4 + e);
    }
  return ok;
}

// the kv tiles [lo, hi) (units of kTile) that CTA rows [gr0, gr0 + rows)
// may see: the union of the ranges of the one or two 64-row q tiles they
// lie in (ops.py flash_tile_ranges); lo >= hi when none
__device__ __forceinline__ int2 row_tile_range(const int32_t* kv_range,
                                               int b, int Sq, int rep,
                                               int gr0, int rows) {
  const int qt0 = gr0 / rep / kTile, qt1 = (gr0 + rows - 1) / rep / kTile;
  int lo = INT_MAX, hi = 0;
  for (int qt = qt0; qt <= qt1; ++qt) {
    const int32_t* r = kv_range + ((size_t)b * (Sq / kTile) + qt) * 2;
    if (r[0] < r[1]) {
      lo = min(lo, r[0]);
      hi = max(hi, r[1]);
    }
  }
  return make_int2(lo, hi);
}

// ------------------------------------------------------- bf16 forward
template <int DH, int BN>
struct FwdCfg {
  static constexpr int BM = 16 * kMmaWarps;  // a warp owns 16 rows
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t q_bytes = sizeof(bf16) * BM * PITCH;
  static constexpr size_t smem =
      q_bytes + kStages * KvStage<DH, BN>::bytes + sizeof(int) * 3 * BM;
  static_assert(BN % 32 == 0 && BN <= 64 && DH % 16 == 0, "mma tiles");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int BN>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int32_t* __restrict__ seg_q,
                         const int32_t* __restrict__ pos_q,
                         const int32_t* __restrict__ seg_kv,
                         const int32_t* __restrict__ pos_kv,
                         const int32_t* __restrict__ kv_range,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int Sq, int Skv, int hq, int hkv, Mask mask,
                         float softcap, float scale) {
  using C = FwdCfg<DH, BN>;
  using Stage = KvStage<DH, BN>;
  constexpr int BM = C::BM, NT = BN / 8, DT = DH / 8, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + C::q_bytes;
  int* rseg = reinterpret_cast<int*>(ring + kStages * Stage::bytes);
  int* rpos = rseg + BM;
  int* ridx = rpos + BM;

  const GroupRows G{(int)blockIdx.z, (int)blockIdx.y, hq / hkv, Sq, hq};
  const int gr0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int r = tid; r < BM; r += kMmaThreads) {
    const int qr = G.qrow(gr0 + r);
    rseg[r] = seg_q[(size_t)G.b * Sq + qr];
    rpos[r] = pos_q[(size_t)G.b * Sq + qr];
    ridx[r] = qr;
  }
  const int2 range = row_tile_range(kv_range, G.b, Sq, G.rep, gr0, BM);
  if (range.x >= range.y) {  // no row sees a slot: dead rows
    for (int idx = tid; idx < BM * DH; idx += kMmaThreads)
      out[G.off(gr0 + idx / DH, DH) + idx % DH] = __float2bfloat16(0.f);
    for (int r = tid; r < BM; r += kMmaThreads) lse[G.stat(gr0 + r)] = kLseDead;
    return;
  }
  const int t_lo = range.x * (kTile / BN), t_hi = range.y * (kTile / BN);

  for (int c = tid; c < BM * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16(q_s + r * PITCH + col, q + G.off(gr0 + r, DH) + col, 16);
  }
  Stage(ring).load(k, v, seg_kv, pos_kv, G.b, G.g, Skv, hkv, t_lo * BN);
  cp_async_commit();
  __syncthreads();  // row metadata

  // this thread's rows ra and ra + 8 of the warp's 16; the warp's span
  const int ra = warp * 16 + (lane >> 2);
  int sq[2], pq[2], qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] = rseg[ra + 8 * h];
    pq[h] = rpos[ra + 8 * h];
    qi[h] = ridx[ra + 8 * h];
  }
  Span rs = span_empty();
  span_add(rs, rseg[warp * 16 + (lane & 15)], rpos[warp * 16 + (lane & 15)]);
  rs = span_warp(rs);
  const int qi0 = ridx[warp * 16], qi1 = ridx[warp * 16 + 15];
  const bf16* q_w = q_s + warp * 16 * PITCH;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo;
    if (t + 1 < t_hi) {
      Stage(ring + ((it + 1) % kStages) * Stage::bytes)
          .load(k, v, seg_kv, pos_kv, G.b, G.g, Skv, hkv, (t + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage st(ring + (it % kStages) * Stage::bytes);
    const int c0 = t * BN;
    Span ks = span_empty();
#pragma unroll
    for (int j = lane; j < BN; j += 32) span_add(ks, st.seg[j], st.pos[j]);
    ks = span_warp(ks);
    const uint32_t ok = pair_bits<NT, true>(
        classify(rs, qi0, qi1, ks, c0, c0 + BN - 1, mask), qi, sq, pq,
        [&](int j) { return make_int3(c0 + j, st.seg[j], st.pos[j]); }, lane,
        mask);
    if (__any_sync(kFull, ok != 0)) {
      float sc[NT][4];
      mma_abt<DH, BN>(sc, q_w, st.k, lane);
      softmax_step<NT, DT>(sc, ok, m, l, o, scale, softcap);
      // O += P V, P rounded to bf16 as the TPU kernel does
      mma_pb<DH, BN, DT, false>(o, sc, st.v, 0, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int gr = gr0 + ra + 8 * h;
    const bool alive = m[h] > kNegInf * 0.5f;
    const float ll = fmaxf(l[h], 1e-30f);
    const float inv = alive ? 1.f / ll : 0.f;
    bf16* orow = out + G.off(gr, DH) + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
    if ((lane & 3) == 0)
      lse[G.stat(gr)] = alive ? (m[h] + log2f(ll)) * kLn2 : kLseDead;
  }
}

// ----------------------------------------------------------- bf16 dq
// DS warps split dh for the dQ accumulators (DS = 2 at dh 192 and 256,
// where 16 rows x dh f32 would not fit one warp's registers beside the
// scores); each of them computes the warp row group's S and dP whole.
template <int DH, int BN, int DS>
struct DqCfg {
  static constexpr int WM = kMmaWarps / DS;
  static constexpr int BM = 16 * WM;
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t q_bytes = sizeof(bf16) * 2 * BM * PITCH;
  static constexpr size_t smem = q_bytes + kStages * KvStage<DH, BN>::bytes +
                                 sizeof(int) * 3 * BM +
                                 sizeof(float) * 2 * BM;
  static_assert(BN % 32 == 0 && BN <= 64 && (DH / 8 / DS) % 2 == 0,
                "mma tiles");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int BN, int DS>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int32_t* __restrict__ seg_q,
                        const int32_t* __restrict__ pos_q,
                        const int32_t* __restrict__ seg_kv,
                        const int32_t* __restrict__ pos_kv,
                        const int32_t* __restrict__ kv_range,
                        bf16* __restrict__ dq, int Sq, int Skv, int hq,
                        int hkv, Mask mask, float softcap, float scale) {
  using C = DqCfg<DH, BN, DS>;
  using Stage = KvStage<DH, BN>;
  constexpr int BM = C::BM, NT = BN / 8, DT = DH / 8 / DS, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BM * PITCH;
  unsigned char* ring = smem_raw + C::q_bytes;
  int* rseg = reinterpret_cast<int*>(ring + kStages * Stage::bytes);
  int* rpos = rseg + BM;
  int* ridx = rpos + BM;
  float* rlse = reinterpret_cast<float*>(ridx + BM);  // lse * log2(e)
  float* rdl = rlse + BM;

  const GroupRows G{(int)blockIdx.z, (int)blockIdx.y, hq / hkv, Sq, hq};
  const int gr0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / DS, wd = warp % DS;

  for (int r = tid; r < BM; r += kMmaThreads) {
    const int qr = G.qrow(gr0 + r);
    rseg[r] = seg_q[(size_t)G.b * Sq + qr];
    rpos[r] = pos_q[(size_t)G.b * Sq + qr];
    ridx[r] = qr;
    rlse[r] = lse[G.stat(gr0 + r)] * kLog2e;
    rdl[r] = delta[G.stat(gr0 + r)];
  }
  const int2 range = row_tile_range(kv_range, G.b, Sq, G.rep, gr0, BM);
  if (range.x >= range.y) {  // no row sees a slot: zero gradient
    for (int idx = tid; idx < BM * DH; idx += kMmaThreads)
      dq[G.off(gr0 + idx / DH, DH) + idx % DH] = __float2bfloat16(0.f);
    return;
  }
  const int t_lo = range.x * (kTile / BN), t_hi = range.y * (kTile / BN);

  for (int c = tid; c < BM * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const size_t off = G.off(gr0 + r, DH) + col;
    cp_async16(q_s + r * PITCH + col, q + off, 16);
    cp_async16(do_s + r * PITCH + col, dout + off, 16);
  }
  Stage(ring).load(k, v, seg_kv, pos_kv, G.b, G.g, Skv, hkv, t_lo * BN);
  cp_async_commit();
  __syncthreads();

  const int ra = wm * 16 + (lane >> 2);
  int sq[2], pq[2], qi[2];
  float ls2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] = rseg[ra + 8 * h];
    pq[h] = rpos[ra + 8 * h];
    qi[h] = ridx[ra + 8 * h];
    ls2[h] = rlse[ra + 8 * h];
    dl[h] = rdl[ra + 8 * h];
  }
  Span rs = span_empty();
  span_add(rs, rseg[wm * 16 + (lane & 15)], rpos[wm * 16 + (lane & 15)]);
  rs = span_warp(rs);
  const int qi0 = ridx[wm * 16], qi1 = ridx[wm * 16 + 15];
  const bf16* q_w = q_s + wm * 16 * PITCH;
  const bf16* do_w = do_s + wm * 16 * PITCH;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo;
    if (t + 1 < t_hi) {
      Stage(ring + ((it + 1) % kStages) * Stage::bytes)
          .load(k, v, seg_kv, pos_kv, G.b, G.g, Skv, hkv, (t + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage st(ring + (it % kStages) * Stage::bytes);
    const int c0 = t * BN;
    Span ks = span_empty();
#pragma unroll
    for (int j = lane; j < BN; j += 32) span_add(ks, st.seg[j], st.pos[j]);
    ks = span_warp(ks);
    const uint32_t ok = pair_bits<NT, true>(
        classify(rs, qi0, qi1, ks, c0, c0 + BN - 1, mask), qi, sq, pq,
        [&](int j) { return make_int3(c0 + j, st.seg[j], st.pos[j]); }, lane,
        mask);
    if (__any_sync(kFull, ok != 0)) {
      float sc[NT][4], dp[NT][4];
      mma_abt<DH, BN>(sc, q_w, st.k, lane);   // S = Q K^T
      mma_abt<DH, BN>(dp, do_w, st.v, lane);  // dP = dO V^T
      // P = exp(logit - lse), dS = P (dP - delta) with the softcap chain
      // rule and scale (kernel.py _ds_from_p); masked pairs exact zeros
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool on = (ok >> (n * 4 + e)) & 1u;
          const float x = cap(sc[n][e], scale, softcap);
          const float p = on ? exp2f(fmaf(x, kLog2e, -ls2[e >> 1])) : 0.f;
          sc[n][e] = on ? ds_from_p(p, dp[n][e], dl[e >> 1], x, true, scale,
                                    softcap)
                        : 0.f;
        }
      // dQ += dS K (dS rounded to bf16), this warp's dh columns
      mma_pb<DH, BN, DT, false>(acc, sc, st.k, wd * DT, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = dq + G.off(gr0 + ra + 8 * h, DH) + wd * DT * 8 + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * h], acc[d][2 * h + 1]);
  }
}

// --------------------------------------------------------- bf16 dk/dv
// One CTA per (b, kv head g, BKV kv rows, head part s): it walks the
// (q row, q head) pairs of its part of g's group (n_split parts of rep /
// n_split heads) in tiles of BQ, q row major, always in the same order.
// DS warps split dh for the dK and dV accumulators, as in dq.
template <int DH, int BQ, int DS>
struct DkvCfg {
  static constexpr int WM = kMmaWarps / DS;
  static constexpr int BKV = 16 * WM;
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t kv_bytes = sizeof(bf16) * 2 * BKV * PITCH;
  // a q-side stage: Q, dO [BQ][PITCH]; segment ids, positions, lse,
  // delta [BQ]
  static constexpr size_t stage_bytes =
      sizeof(bf16) * 2 * BQ * PITCH + sizeof(int) * 4 * BQ;
  static constexpr size_t smem =
      kv_bytes + kStages * stage_bytes + sizeof(int) * 2 * BKV;
  static_assert(BQ % 32 == 0 && BQ <= 64 && (DH / 8 / DS) % 2 == 0,
                "mma tiles");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int BQ, int DS>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ seg_q,
                         const int32_t* __restrict__ pos_q,
                         const int32_t* __restrict__ seg_kv,
                         const int32_t* __restrict__ pos_kv,
                         const int32_t* __restrict__ q_range,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ part, int* __restrict__ counters,
                         int Sq, int Skv, int hq, int hkv, int n_split,
                         Mask mask, float softcap, float scale) {
  using C = DkvCfg<DH, BQ, DS>;
  constexpr int BKV = C::BKV, NT = BQ / 8, DT = DH / 8 / DS, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BKV * PITCH;
  unsigned char* ring = smem_raw + C::kv_bytes;
  int* kseg = reinterpret_cast<int*>(ring + kStages * C::stage_bytes);
  int* kpos = kseg + BKV;
  __shared__ int last_s;

  const int c0 = blockIdx.x * BKV;  // first kv row
  const int g = blockIdx.y / n_split, s = blockIdx.y % n_split;
  const int b = blockIdx.z;
  const int rep = hq / hkv, rep_p = rep / n_split;
  const int h0 = g * rep + s * rep_p;  // first q head of this part
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / DS, wd = warp % DS;
  const size_t kv_off = (((size_t)b * Skv + c0) * hkv + g) * DH;
  const size_t kv_stride = (size_t)hkv * DH;

  for (int r = tid; r < BKV; r += kMmaThreads) {
    kseg[r] = seg_kv[(size_t)b * Skv + c0 + r];
    kpos[r] = pos_kv[(size_t)b * Skv + c0 + r];
  }
  for (int c = tid; c < BKV * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16(k_s + r * PITCH + col, k + kv_off + r * kv_stride + col, 16);
    cp_async16(v_s + r * PITCH + col, v + kv_off + r * kv_stride + col, 16);
  }
  // the q tiles that may see these kv rows, in group-row tiles of BQ
  const int32_t* qr_rg = q_range + ((size_t)b * (Skv / kTile) + c0 / kTile) * 2;
  const int per = kTile * rep_p / BQ;  // group-row tiles per 64 q rows
  const int u_lo = qr_rg[0] * per, u_hi = qr_rg[1] * per;

  // group row j of tile u: q row (u * BQ + j) / rep_p, q head h0 + (u * BQ
  // + j) % rep_p
  auto load_tile = [&](int u, int stage) {
    unsigned char* base = ring + stage * C::stage_bytes;
    bf16* qs = reinterpret_cast<bf16*>(base);
    bf16* os = qs + BQ * PITCH;
    int* sseg = reinterpret_cast<int*>(os + BQ * PITCH);
    for (int c = tid; c < BQ * CHUNKS; c += kMmaThreads) {
      const int j = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int gr = u * BQ + j;
      const size_t off =
          (((size_t)b * Sq + gr / rep_p) * hq + h0 + gr % rep_p) * DH + col;
      cp_async16(qs + j * PITCH + col, q + off, 16);
      cp_async16(os + j * PITCH + col, dout + off, 16);
    }
    for (int j = tid; j < BQ; j += kMmaThreads) {
      const int gr = u * BQ + j, qr = gr / rep_p;
      const size_t st = ((size_t)b * hq + h0 + gr % rep_p) * Sq + qr;
      cp_async4(sseg + j, seg_q + (size_t)b * Sq + qr);
      cp_async4(sseg + BQ + j, pos_q + (size_t)b * Sq + qr);
      cp_async4(sseg + 2 * BQ + j, lse + st);
      cp_async4(sseg + 3 * BQ + j, delta + st);
    }
  };
  if (u_lo < u_hi) load_tile(u_lo, 0);
  cp_async_commit();
  __syncthreads();  // kv row metadata

  const int ra = wm * 16 + (lane >> 2);
  int sk[2], pk[2], ki[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sk[h] = kseg[ra + 8 * h];
    pk[h] = kpos[ra + 8 * h];
    ki[h] = c0 + ra + 8 * h;
  }
  Span ks = span_empty();
  span_add(ks, kseg[wm * 16 + (lane & 15)], kpos[wm * 16 + (lane & 15)]);
  ks = span_warp(ks);
  const int ki0 = c0 + wm * 16, ki1 = ki0 + 15;
  const bf16* k_w = k_s + wm * 16 * PITCH;
  const bf16* v_w = v_s + wm * 16 * PITCH;

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[d][e] = av[d][e] = 0.f;

  for (int u = u_lo; u < u_hi; ++u) {
    const int it = u - u_lo;
    if (u + 1 < u_hi) {
      load_tile(u + 1, (it + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* base = ring + (it % kStages) * C::stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(base);
    const bf16* os = qs + BQ * PITCH;
    const int* sseg = reinterpret_cast<const int*>(os + BQ * PITCH);
    const int* spos = sseg + BQ;
    const float* slse = reinterpret_cast<const float*>(sseg + 2 * BQ);
    const float* sdl = slse + BQ;
    Span qsp = span_empty();
#pragma unroll
    for (int j = lane; j < BQ; j += 32) span_add(qsp, sseg[j], spos[j]);
    qsp = span_warp(qsp);
    const int qi0 = u * BQ / rep_p, qi1 = (u * BQ + BQ - 1) / rep_p;
    // columns are the tile's group rows: q row (u * BQ + j) / rep_p
    const uint32_t ok = pair_bits<NT, false>(
        classify(qsp, qi0, qi1, ks, ki0, ki1, mask), ki, sk, pk,
        [&](int j) {
          return make_int3((u * BQ + j) / rep_p, sseg[j], spos[j]);
        },
        lane, mask);
    if (__any_sync(kFull, ok != 0)) {
      float pt[NT][4], dpt[NT][4];
      mma_abt<DH, BQ>(pt, k_w, qs, lane);   // S^T = K Q^T
      mma_abt<DH, BQ>(dpt, v_w, os, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool on = (ok >> (n * 4 + e)) & 1u;
          const int j = n * 8 + 2 * (lane & 3) + (e & 1);
          const float x = cap(pt[n][e], scale, softcap);
          const float p = on ? exp2f(fmaf(x, kLog2e, -slse[j] * kLog2e)) : 0.f;
          pt[n][e] = p;
          dpt[n][e] = on ? ds_from_p(p, dpt[n][e], sdl[j], x, true, scale,
                                     softcap)
                         : 0.f;
        }
      // dV += P^T dO and dK += dS^T Q over the tile's group rows, with the
      // bf16 rounding of P and dS multiplied in as well (hi + lo): these
      // sums run over up to rep x S terms
      mma_pb<DH, BQ, DT, true>(av, pt, os, wd * DT, lane);
      mma_pb<DH, BQ, DT, true>(ak, dpt, qs, wd * DT, lane);
    }
    __syncthreads();
  }

  const int col0 = wd * DT * 8 + 2 * (lane & 3);
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = kv_off + (size_t)(ra + 8 * h) * kv_stride + col0;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + d * 8) =
            __floats2bfloat162_rn(ak[d][2 * h], ak[d][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + d * 8) =
            __floats2bfloat162_rn(av[d][2 * h], av[d][2 * h + 1]);
      }
    }
    return;
  }
  // head split: this part's f32 dK, dV [BKV][DH] into scratch; the last of
  // the n_split parts of a (b, g, kv rows) to finish, found through an int
  // counter it resets, sums them in part order
  const int base = (b * hkv + g) * gridDim.x + blockIdx.x;
  float* mine = part + ((size_t)base * n_split + s) * 2 * BKV * DH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<float2*>(mine + r * DH + col0 + d * 8) =
          make_float2(ak[d][2 * h], ak[d][2 * h + 1]);
      *reinterpret_cast<float2*>(mine + (BKV + r) * DH + col0 + d * 8) =
          make_float2(av[d][2 * h], av[d][2 * h + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + base, 1);
    last_s = prev == n_split - 1;
    if (last_s) counters[base] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* parts = part + (size_t)base * n_split * 2 * BKV * DH;
  for (int idx = tid; idx < BKV * DH; idx += kMmaThreads) {
    float sk_ = 0.f, sv_ = 0.f;
    for (int p = 0; p < n_split; ++p) {
      sk_ += __ldcg(parts + (size_t)p * 2 * BKV * DH + idx);
      sv_ += __ldcg(parts + ((size_t)p * 2 + 1) * BKV * DH + idx);
    }
    const size_t off = kv_off + (size_t)(idx / DH) * kv_stride + idx % DH;
    dk[off] = __float2bfloat16(sk_);
    dv[off] = __float2bfloat16(sv_);
  }
}

// ------------------------------------------------ bf16: the document prune
// ops.py flash_tile_ranges_reference on the card.  Per 64-slot kv tile,
// its live slots in three groups (the smallest segment id, the largest,
// those between) with their positions; a q row may see the tile only if
// a group may hold its segment id and meets its masks on the group's
// positions.  flash_keep_kernel: a CTA per (64-row q tile, batch row),
// a thread per kv tile, writes whether any of the q tile's rows may see
// the kv tile, and the q tile's kv range [first, last + 1);
// flash_q_range_kernel: a thread per kv tile, its q range.  (0, 0) where
// none.  Integer arithmetic only: equal to the plain version.
__global__ void __launch_bounds__(kTile)
    flash_keep_kernel(const int32_t* __restrict__ seg_q,
                      const int32_t* __restrict__ pos_q,
                      const int32_t* __restrict__ seg_kv,
                      const int32_t* __restrict__ pos_kv,
                      uint8_t* __restrict__ keep, int32_t* __restrict__ kv_range,
                      int Sq, int Skv, int causal, int window, int sink) {
  __shared__ int rseg[kTile], rpos[kTile], lo_s, hi_s;
  const int I = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nQ = Sq / kTile, nT = Skv / kTile;
  rseg[tid] = seg_q[(size_t)b * Sq + I * kTile + tid];
  rpos[tid] = pos_q[(size_t)b * Sq + I * kTile + tid];
  if (tid == 0) {
    lo_s = nT;
    hi_s = 0;
  }
  __syncthreads();
  int lo = nT, hi = 0;
  for (int T = tid; T < nT; T += kTile) {
    const int32_t* sk = seg_kv + (size_t)b * Skv + (size_t)T * kTile;
    const int32_t* pk = pos_kv + (size_t)b * Skv + (size_t)T * kTile;
    int s_lo = INT_MAX, s_hi = 0;
    for (int j = 0; j < kTile; ++j) {
      const int sj = sk[j];
      if (sj > 0) s_lo = min(s_lo, sj);
      s_hi = max(s_hi, sj);
    }
    const int g_s0[3] = {s_lo, s_hi, s_lo + 1}, g_s1[3] = {s_lo, s_hi, s_hi - 1};
    int g_p0[3] = {INT_MAX, INT_MAX, INT_MAX}, g_p1[3] = {INT_MIN, INT_MIN, INT_MIN};
    for (int j = 0; j < kTile; ++j) {
      const int sj = sk[j];
      if (sj <= 0) continue;
      const int gi = sj == s_lo ? 0 : (sj == s_hi ? 1 : 2);
      g_p0[gi] = min(g_p0[gi], pk[j]);
      g_p1[gi] = max(g_p1[gi], pk[j]);
    }
    bool see = false;
    for (int r = 0; r < kTile && !see; ++r) {
      const int s = rseg[r], p = rpos[r];
      if (s <= 0) continue;
      for (int gi = 0; gi < 3; ++gi) {
        if (g_p0[gi] == INT_MAX || s < g_s0[gi] || s > g_s1[gi]) continue;
        if (causal && g_p0[gi] > p) continue;
        if (window > 0 && p - g_p1[gi] >= window &&
            !(sink > 0 && g_p0[gi] < sink))
          continue;
        see = true;
      }
    }
    keep[((size_t)b * nQ + I) * nT + T] = see;
    if (see) {
      lo = min(lo, T);
      hi = max(hi, T + 1);
    }
  }
  atomicMin(&lo_s, lo);
  atomicMax(&hi_s, hi);
  __syncthreads();
  if (tid == 0) {
    int32_t* out = kv_range + ((size_t)b * nQ + I) * 2;
    out[0] = lo_s < hi_s ? lo_s : 0;
    out[1] = hi_s;
  }
}

__global__ void flash_q_range_kernel(const uint8_t* __restrict__ keep,
                                     int32_t* __restrict__ q_range, int nQ,
                                     int nT) {
  const int T = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (T >= nT) return;
  int lo = nQ, hi = 0;
  for (int I = 0; I < nQ; ++I)
    if (keep[((size_t)b * nQ + I) * nT + T]) {
      lo = min(lo, I);
      hi = I + 1;
    }
  q_range[((size_t)b * nT + T) * 2] = lo < hi ? lo : 0;
  q_range[((size_t)b * nT + T) * 2 + 1] = hi;
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  const void *seg_q, *pos_q, *seg_kv, *pos_kv;
  const void* range;  // bf16: kv tile ranges (fwd, dq) or q tile ranges
  void *out, *lse, *dq, *dk, *dv, *part, *counters;
  int B, Sq, Skv, hq, hkv, n_split;
  Mask mask;
  float softcap, scale;
  cudaStream_t stream;
};

#define FLASH_INS                                                        \
  static_cast<const int32_t*>(a.seg_q),                                  \
      static_cast<const int32_t*>(a.pos_q),                              \
      static_cast<const int32_t*>(a.seg_kv),                             \
      static_cast<const int32_t*>(a.pos_kv)

template <typename T, int DH>
cudaError_t launch_fwd(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_fwd_kernel<T, DH>, fwd_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Sq / Rows<DH>::kQ, a.hq, a.B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, fwd_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), FLASH_INS, static_cast<T*>(a.out),
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
      static_cast<const float*>(a.delta), FLASH_INS, static_cast<T*>(a.dq),
      a.Sq, a.Skv, a.hq, a.hkv, a.mask, a.softcap, a.scale);
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
      static_cast<const float*>(a.delta), FLASH_INS, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Skv, a.hq, a.hkv, a.mask, a.softcap,
      a.scale);
  return cudaGetLastError();
}

template <int DH, int BN>
cudaError_t launch_fwd_mma(const Args& a) {
  using C = FwdCfg<DH, BN>;
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_fwd_mma_kernel<DH, BN>, C::smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Sq * (a.hq / a.hkv) / C::BM, a.hkv, a.B);
  flash_fwd_mma_kernel<DH, BN><<<grid, kMmaThreads, C::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), FLASH_INS,
      static_cast<const int32_t*>(a.range), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), a.Sq, a.Skv, a.hq, a.hkv, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}

template <int DH, int BN, int DS>
cudaError_t launch_dq_mma(const Args& a) {
  using C = DqCfg<DH, BN, DS>;
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_dq_mma_kernel<DH, BN, DS>, C::smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Sq * (a.hq / a.hkv) / C::BM, a.hkv, a.B);
  flash_dq_mma_kernel<DH, BN, DS><<<grid, kMmaThreads, C::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), FLASH_INS,
      static_cast<const int32_t*>(a.range), static_cast<bf16*>(a.dq), a.Sq,
      a.Skv, a.hq, a.hkv, a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int DH, int BQ, int DS>
cudaError_t launch_dkv_mma(const Args& a) {
  using C = DkvCfg<DH, BQ, DS>;
  static bool configured = false;
  cudaError_t e =
      raise_smem(flash_dkv_mma_kernel<DH, BQ, DS>, C::smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Skv / C::BKV, a.hkv * a.n_split, a.B);
  flash_dkv_mma_kernel<DH, BQ, DS><<<grid, kMmaThreads, C::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), FLASH_INS,
      static_cast<const int32_t*>(a.range), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), static_cast<float*>(a.part),
      static_cast<int*>(a.counters), a.Sq, a.Skv, a.hq, a.hkv, a.n_split,
      a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}
#undef FLASH_INS

// which: 0 = forward, 1 = dq, 2 = dk/dv
int dispatch(int which, int dtype, int dh, const Args& a) {
  const Mask& m = a.mask;
  if (a.B < 1 || a.Sq < 1 || a.Skv < 1 || a.Sq % kTile != 0 ||
      a.Skv % kTile != 0 || a.hkv < 1 || a.hq % a.hkv != 0 ||
      m.rate < 1 || m.blk_q < 1 || m.blk_k < 1 ||
      (m.rate > 1 && m.blk_q != m.blk_k))
    return cudaErrorInvalidValue;
  if (dtype == 0) {  // exact f32 on the FMA pipes
#define FLASH_CASE(DH)                                      \
  if (which == 0) return (int)launch_fwd<float, DH>(a);     \
  if (which == 1) return (int)launch_dq<float, DH>(a);      \
  return (int)launch_dkv<float, DH>(a)
    if (dh == 64) { FLASH_CASE(64); }
    if (dh == 128) { FLASH_CASE(128); }
    if (dh == 192) { FLASH_CASE(192); }
    if (dh == 256) { FLASH_CASE(256); }
#undef FLASH_CASE
    return cudaErrorInvalidValue;
  }
  const int rep = a.hq / a.hkv;
  if (dtype != 1 || a.range == nullptr ||
      (which == 2 && (a.n_split < 1 || rep % a.n_split != 0 ||
                      (a.n_split > 1 &&
                       (a.part == nullptr || a.counters == nullptr)))))
    return cudaErrorInvalidValue;
  // (dh, slots a kv tile, dh split, group rows a q tile of dk/dv)
#define MMA_CASE(DH, BN, DS, BQ)                                  \
  if (which == 0) return (int)launch_fwd_mma<DH, BN>(a);          \
  if (which == 1) return (int)launch_dq_mma<DH, BN, DS>(a);       \
  return (int)launch_dkv_mma<DH, BQ, DS>(a)
  if (dh == 64) { MMA_CASE(64, 64, 1, 64); }
  if (dh == 128) { MMA_CASE(128, 64, 1, 32); }
  if (dh == 192) { MMA_CASE(192, 32, 2, 32); }
  if (dh == 256) { MMA_CASE(256, 32, 2, 32); }
#undef MMA_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v,
               const void* seg_q, const void* pos_q, const void* seg_kv,
               const void* pos_kv, const void* range, int B, int Sq, int Skv,
               int hq, int hkv, int causal, int window, int sink, int rate,
               int blk_q, int blk_k, float softcap, float scale,
               void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = seg_q;
  a.pos_q = pos_q;
  a.seg_kv = seg_kv;
  a.pos_kv = pos_kv;
  a.range = range;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.hq = hq;
  a.hkv = hkv;
  a.n_split = 1;
  a.mask = Mask{causal, window, sink, rate, blk_q, blk_k};
  a.softcap = softcap;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [B, Sq, hq, dh];
// k, v [B, Skv, hkv, dh]; lse [B, hq, Sq] f32; seg_q, pos_q [B, Sq],
// seg_kv, pos_kv [B, Skv] int32; dh 64, 128, 192 or 256.  Sq and Skv
// multiples of 64.  bf16 only: kv_range [B, Sq / 64, 2] int32, per 64-row q
// tile the kv tiles [lo, hi) that may hold a visible pair (ops.py
// flash_tile_ranges); f32 ignores it.  The caller checks shapes, types
// and contiguity.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* seg_q, const void* pos_q,
                         const void* seg_kv, const void* pos_kv, void* out,
                         void* lse, const void* kv_range, int B, int Sq,
                         int Skv, int hq, int hkv, int dh, int dtype,
                         int causal, int window, int sink, int rate,
                         int blk_q, int blk_k, float softcap, float scale,
                         void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, kv_range, B, Sq,
                     Skv, hq, hkv, causal, window, sink, rate, blk_q, blk_k,
                     softcap, scale, stream);
  a.out = out;
  a.lse = lse;
  return dispatch(0, dtype, dh, a);
}

// dout like q; lse, delta [B, hq, Sq] f32; dq like q; kv_range as above.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* seg_q,
                            const void* pos_q, const void* seg_kv,
                            const void* pos_kv, void* dq,
                            const void* kv_range, int B, int Sq, int Skv,
                            int hq, int hkv, int dh, int dtype, int causal,
                            int window, int sink, int rate, int blk_q,
                            int blk_k, float softcap, float scale,
                            void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, kv_range, B, Sq,
                     Skv, hq, hkv, causal, window, sink, rate, blk_q, blk_k,
                     softcap, scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch(1, dtype, dh, a);
}

// dk, dv like k (every row written, zeros where no pair reaches it).
// bf16 only: q_range [B, Skv / 64, 2] int32, per 64-slot kv tile the q
// tiles [lo, hi) that may see it; n_split head parts, and with n_split > 1
// part holds B * hkv * Skv * n_split * 2 * dh f32 and counters
// B * hkv * Skv / rows int32 zeros, rows = 64 (dh <= 128) or 32 (ops.py
// flash_dkv_split).  f32 ignores them.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* seg_q,
                             const void* pos_q, const void* seg_kv,
                             const void* pos_kv, void* dk, void* dv,
                             const void* q_range, void* part, void* counters,
                             int B, int Sq, int Skv, int hq, int hkv, int dh,
                             int dtype, int causal, int window, int sink,
                             int rate, int blk_q, int blk_k, float softcap,
                             float scale, int n_split, void* stream) {
  Args a = make_args(q, k, v, seg_q, pos_q, seg_kv, pos_kv, q_range, B, Sq,
                     Skv, hq, hkv, causal, window, sink, rate, blk_q, blk_k,
                     softcap, scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.part = part;
  a.counters = counters;
  a.n_split = dtype == 1 ? n_split : 1;
  return dispatch(2, dtype, dh, a);
}

// The document prune of the bf16 kernels: seg_q, pos_q [B, Sq], seg_kv,
// pos_kv [B, Skv] int32, Sq and Skv multiples of 64; writes kv_range
// [B, Sq / 64, 2], q_range [B, Skv / 64, 2] int32 and the scratch keep
// [B, Sq / 64, Skv / 64] uint8 (ops.py flash_tile_ranges).
extern "C" int flash_tile_ranges(const void* seg_q, const void* pos_q,
                                 const void* seg_kv, const void* pos_kv,
                                 void* kv_range, void* q_range, void* keep,
                                 int B, int Sq, int Skv, int causal,
                                 int window, int sink, void* stream) {
  if (B < 1 || Sq < kTile || Skv < kTile || Sq % kTile != 0 ||
      Skv % kTile != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nQ = Sq / kTile, nT = Skv / kTile;
  flash_keep_kernel<<<dim3(nQ, B), kTile, 0, st>>>(
      static_cast<const int32_t*>(seg_q), static_cast<const int32_t*>(pos_q),
      static_cast<const int32_t*>(seg_kv),
      static_cast<const int32_t*>(pos_kv), static_cast<uint8_t*>(keep),
      static_cast<int32_t*>(kv_range), Sq, Skv, causal, window, sink);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_q_range_kernel<<<dim3((nT + 127) / 128, B), 128, 0, st>>>(
      static_cast<const uint8_t*>(keep), static_cast<int32_t*>(q_range), nQ,
      nT);
  return cudaGetLastError();
}
