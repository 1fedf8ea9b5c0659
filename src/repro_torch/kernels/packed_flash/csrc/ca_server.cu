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
// LSE_DEAD = 2**30; dead rows and zero-length tasks give out 0 and lse
// LSE_DEAD.  GQA maps q head h to kv head h / (Hq / Hkv).
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// a server's batch does 4 * (live q, kv pairs) * Hq * dh FLOPs forward
// and 2.5x that backward.  At the training step's plans (core/plan.py,
// cad/session.py: per server T = 160 task slots of which 30-34 are live,
// a kv buffer of N = 160 blocks of 128, jmax 32; llama3-8b's 32 q over 8
// kv heads of 128) one layer's 4 servers do 144 GFLOP forward and 360
// backward, but write their whole outputs (out, lse, dq, dk, dv for every
// slot, live or not): 0.87 GB forward and 1.45 GB backward, so the bound
// is the bytes, 0.26 and 0.43 ms; the products at the tensor cores' rate
// would take 0.15 and 0.36 ms.  The kernels below are held by the
// products at mma.sync's rate, about as fast as flash.cu's on the same
// pairs and far from either bound (PERF.md has their times).
//
// Design.  bf16 inputs (the training path) take tensor-core kernels;
// f32 inputs (the exactness checks) keep the exact FMA kernels, whose
// arithmetic flash.cu's f32 kernels share.
//
// bf16: ca_fwd_mma_kernel, ca_dq_mma_kernel, ca_dkv_mma_kernel, CTAs of 4
// warps, built from the tile pieces of tiles.cuh and kernels/csrc/mma.cuh
// that flash.cu's kernels use:
//   * every product on the tensor cores: mma.sync m16n8k16 with bf16
//     fragments from ldmatrix / ldmatrix.trans and f32 accumulators.  The
//     forward's online softmax runs in registers in log2 units (exp2), P
//     rounded to bf16 for P.V as the TPU kernel does; l sums the f32 p.
//     The backward forms P = exp(logit - lse) and dS = P (dP - delta)
//     (softcap chain rule, scale) in registers and feeds them to the next
//     product as bf16 A fragments.
//   * forward and dq: one CTA per (task, kv head g, 64 group rows; 32 at
//     dh 192/256 in dq).  A group row is a (q row, q head) pair of the
//     task's block over g's rep heads, q row major, so every K/V tile the
//     CTA loads serves the whole GQA group (the f32 kernels load it once
//     per q head).  The CTA walks the task's kv range in 64-slot tiles
//     (32 at dh 192/256) through a 2-stage cp.async ring of bf16 tiles
//     (rows padded by 16 bytes for ldmatrix), tile i + 1 in flight while
//     tile i is computed.  A zero-length task, or a CTA of padded rows
//     only, writes its zeros (and LSE_DEAD) and exits.
//   * delta = rowsum(dO * O) in f32, a torch op in the reference and in
//     the f32 path, is the dq kernel's: a thread a row, for its rows, read
//     by dq and written for dk/dv (launched after it on the same stream),
//     so no f32 copy of the whole dO and O buffers is made.
//   * pruning: before a tile is touched, each warp classifies it from the
//     position spans of its 16 rows and of the tile: no visible pair ->
//     skipped (an exact no-op), every pair visible -> no mask arithmetic,
//     no dilation -> each pair's causal and window terms tested, else the
//     whole pair mask with the dilated term.  Pruning changes no bit, and
//     nothing depends on the slot or server a task runs in.
//   * dk/dv: one CTA per (64 kv slots of buffer block n, 32 at dh
//     192/256; kv head g).  Its first warp lists the tasks that cover n
//     (0 <= n - kv_start[t] < min(kv_len[t], jmax)) in ascending t, in
//     shared memory, a ballot and a running count per 32 tasks; the CTA
//     then walks each listed task's group rows in tiles of 64 (32 at dh
//     >= 128), always in that order, the order of the TPU kernel's (N, Hq,
//     T) grid up to the heads: S^T = K Q^T, dV += P^T dO, dP^T = V dO^T,
//     dK += dS^T Q.  P^T and dS^T enter their products as bf16 hi + lo
//     pairs (two products each): a kv slot sums rep x (covering tasks) x
//     blk terms, and one bf16 rounding of each would leave an error of a
//     few tenths of a percent of the sum's scale.  No float atomics and
//     GQA folded inside: repeated calls are bitwise equal, and a slot that
//     no task covers gets zero dk and dv.  No host synchronisation or
//     extra launch builds the list.
//   * head_dim 64, 128, 192, 256.  At 192 and 256 a warp cannot hold 16 x
//     dh f32 accumulators (twice in dk/dv) beside its scores, so in dq and
//     dk/dv two warps split dh for the accumulators and each computes the
//     shared S and dP whole.
//
// f32: one CTA of 8 warps per (task, q head, R-row part of the q block;
// R = 64, 32 at dh 192/256) walks the task's kv blocks in 64-slot K/V
// tiles staged in shared memory as f32, a warp per q row (each lane takes
// two keys for the dot products, the lanes split dh for P.V or dS.K);
// dk/dv a CTA per (kv block n, kv head g, R kv rows; R = 64, 16 at dh
// 192/256) walks every task in index order and, for a task that covers
// n, every q head of the group and 64-row q tile, accumulating in shared
// memory and writing once: GQA folded, no float atomics.  A warp skips a
// (row, tile) pair with no visible pair.  Dynamic shared memory up to 225
// KiB, raised once per instantiation.
//
// Chunked KV streaming and the ring baseline (DESIGN.md §11, §13) add two
// uses.  ca_server_fwd_range runs either forward over relative kv blocks
// [j0, j1) with a carry (struct Range): the state between ranges is
// stored exactly as the kernel holds it (the bf16 kernel's registers, l
// still per lane; the f32 kernel's shared-memory rows), so ranges that
// split [0, jmax) give the unstreamed bits; the unstreamed call takes
// every new branch the same way in every CTA.  The bf16 dq kernel takes
// an lse cotangent (g_lse, a ring partial's): delta - g_lse replaces
// delta in dS = P (dP - delta), for dq and for dk/dv, which reads it.
//
// What is left for later: wgmma with TMA loads and a producer warp (FA3's
// shape), persistent CTAs over the live tasks, and sizing the task buffer
// to the plan (the dispatch's work: most of the bytes are the outputs of
// empty task slots, written because the function returns them whole).
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.

#include "common.cuh"
#include "tiles.cuh"

namespace {

struct Mask {
  int window;  // 0 = no window
  int sink;    // always-visible leading tokens (with a window)
  int rate;    // dilation over blk-token blocks, 1 = none
  int blk;
};

// A forward over relative kv blocks [j0, min(j1, jmax)) with a carry: the
// unit of chunked KV streaming (DESIGN.md §11).  The unstreamed call is
// {0, jmax, null, 0, 1}, and takes every branch below the same way for
// every CTA, so it runs the instructions it ran before.  carry: f32, the
// kernel's whole state between ranges, exactly as it holds it (see each
// kernel); load: read it first (else start fresh); finalize: write out
// and lse (else store the state back into carry, in place).  A CTA with
// no tile in a middle range leaves its carry untouched; a first range
// with no tile stores the fresh state; a finalizing range with no tile
// finalizes the carry.
struct Range {
  int j0, j1;
  float* carry;
  int load, finalize;
};

// kernel.py _ca_mask on in-document positions, causal always, without
// the dilation: both live, causal, window with sink
__device__ __forceinline__ bool token_visible(int pq, int pk, const Mask& m) {
  if (pq < 0 || pk < 0 || pq < pk) return false;
  if (m.window > 0 && pq - pk >= m.window && !(m.sink > 0 && pk < m.sink))
    return false;
  return true;
}

// kernel.py _ca_mask whole
__device__ __forceinline__ bool visible(int pq, int pk, const Mask& m) {
  if (!token_visible(pq, pk, m)) return false;
  // pq >= pk here, so both quotients and their difference are >= 0
  if (m.rate > 1 && (pq / m.blk - pk / m.blk) % m.rate != 0) return false;
  return true;
}

// the kv block a task reads at relative index j (kernel.py:626-631)
__device__ __forceinline__ int kv_block(int start, int j, int N) {
  return max(0, min(start + j, N - 1));
}

// ------------------------------------------------------------------ forward
template <int DH>
constexpr size_t fwd_smem() {
  // q, accumulators [kRows][DH]; K tile [kTile][DH + 1] (padded so the
  // lane-per-key reads fall in distinct banks); V tile [kTile][DH]; row
  // max, sum, position; tile positions
  constexpr int kRows = Rows<DH>::kQ;
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
                  int jmax, Mask mask, float softcap, float scale,
                  Range rg) {
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
  const size_t stat0 = ((size_t)t * hq + h) * blk + r0;
  float* lb = lse + stat0;
  const int start = kv_start[t];
  const int n_blk = min(kv_len[t], jmax);
  const int j_end = min(rg.j1, n_blk);
  if (rg.load && !rg.finalize && rg.j0 >= j_end) return;  // carry kept

  // the carry: m [T, hq, blk], l like it, acc [T, hq, blk, DH] (the
  // shared-memory state of each CTA's rows)
  const size_t plane = (size_t)gridDim.x * hq * blk;
  float* c_m = rg.carry + stat0;
  float* c_l = rg.carry + plane + stat0;
  float* c_acc = rg.carry + 2 * plane + stat0 * DH;
  for (int r = tid; r < kRows; r += kThreads) {
    qp_s[r] = q_pos[row0 + r];
    m_s[r] = rg.load ? c_m[r] : kNegInf;
    l_s[r] = rg.load ? c_l[r] : 0.f;
  }
  stage<T, DH>(q_s, DH, qb, q_stride, kRows);
  for (int idx = tid; idx < kRows * DH; idx += kThreads)
    acc_s[idx] = rg.load ? c_acc[idx] : 0.f;

  const int tiles = blk / kTile;
  for (int j = rg.j0; j < j_end; ++j) {
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

  if (!rg.finalize) {
    for (int r = tid; r < kRows; r += kThreads) {
      c_m[r] = m_s[r];
      c_l[r] = l_s[r];
    }
    for (int idx = tid; idx < kRows * DH; idx += kThreads)
      c_acc[idx] = acc_s[idx];
    return;
  }
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
  constexpr int kRows = Rows<DH>::kQ;
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
  constexpr int kRows = Rows<DH>::kQ;
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
  constexpr int kRows = Rows<DH>::kKV;
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

// ============================================ bf16: tensor-core kernels
// A warp tile of q rows (span q) against kv slots (span k), from the
// positions alone (live = position >= 0, entered into the span as segment
// 1): kNone when no pair can be visible (no live row or slot, every slot
// after every row, every slot outside the window and no sink slot), kAll
// when every pair is (no padding, every slot at or before every row,
// inside the window, no dilation), kTokens when the dilation is out of
// play (each pair's causal and window terms tested), else kSome (each
// pair tested whole).  Pruning kNone tiles changes no bit: a tile without
// a visible pair is an exact no-op of the online softmax and adds exact
// zeros to the gradients.
__device__ __forceinline__ int classify(const Span& q, const Span& k,
                                        const Mask& m) {
  if (q.smax <= 0 || k.smax <= 0 || k.pmin > q.pmax) return kNone;
  if (m.window > 0 && q.pmin - k.pmax >= m.window &&
      !(m.sink > 0 && k.pmin < m.sink))
    return kNone;
  if (m.rate > 1) return kSome;
  if (!q.dead && !k.dead && k.pmax <= q.pmin &&
      (m.window <= 0 || q.pmax - k.pmin < m.window))
    return kAll;
  return kTokens;
}

__device__ __forceinline__ void span_pos(Span& s, int pos) {
  span_add(s, pos >= 0 ? 1 : 0, pos);
}

// The visible pairs of a warp tile that this thread holds in its score
// registers, as bit n * 4 + e for element e of n8 tile n: row ra + 8 * (e
// / 2) of the warp, column n * 8 + 2 * (lane % 4) + e % 2 of the tile.
// rp: the thread's two rows' positions; col(j): column j's.  Q_ROWS: the
// rows are q rows (forward, dq), else kv rows (dk/dv).
template <int NT, bool Q_ROWS, typename Col>
__device__ __forceinline__ uint32_t pair_bits(int cls, const int (&rp)[2],
                                              Col col, int lane,
                                              const Mask& m) {
  if (cls == kAll) return ~0u;
  uint32_t ok = 0u;
  if (cls == kNone) return ok;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col(n * 8 + 2 * (lane & 3) + (e & 1));
      const int pq = Q_ROWS ? rp[e >> 1] : c, pk = Q_ROWS ? c : rp[e >> 1];
      if (cls == kTokens ? token_visible(pq, pk, m) : visible(pq, pk, m))
        ok |= 1u << (n * 4 + e);
    }
  return ok;
}

// The kv slots of a task's i-th BN-slot tile: tile i lies in relative
// block i / (blk / BN), clamped to the buffer (kernel.py:626-631).
template <int BN>
__device__ __forceinline__ size_t tile_slot0(int start, int i, int blk,
                                             int N) {
  const int per = blk / BN;
  return (size_t)kv_block(start, i / per, N) * blk + (size_t)(i % per) * BN;
}

// zeros into group rows [gr0, gr0 + BM) of x [T, blk, hq, DH], 16 bytes a
// store (a dead CTA's whole output: most task slots of a plan are empty)
template <int DH, int BM>
__device__ __forceinline__ void zero_rows(bf16* x, const GroupRows& G,
                                          int gr0) {
  constexpr int CHUNKS = DH / 8;
  for (int c = threadIdx.x; c < BM * CHUNKS; c += kMmaThreads)
    *reinterpret_cast<uint4*>(x + G.off(gr0 + c / CHUNKS, DH) +
                              (c % CHUNKS) * 8) = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------- bf16 forward
template <int DH, int BN>
struct FwdCfg {
  static constexpr int BM = 16 * kMmaWarps;  // a warp owns 16 group rows
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t q_bytes = sizeof(bf16) * BM * PITCH;
  static constexpr size_t smem =
      q_bytes + kStages * KvStage<DH, BN>::bytes + sizeof(int) * BM;
  static_assert(BN % 32 == 0 && BN <= 64 && DH % 16 == 0, "mma tiles");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int BN>
__global__ void __launch_bounds__(kMmaThreads)
    ca_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int32_t* __restrict__ kv_start,
                      const int32_t* __restrict__ kv_len,
                      const int32_t* __restrict__ q_pos,
                      const int32_t* __restrict__ kv_pos,
                      bf16* __restrict__ out, float* __restrict__ lse, int N,
                      int blk, int hq, int hkv, int jmax, Mask mask,
                      float softcap, float scale, Range rg) {
  using C = FwdCfg<DH, BN>;
  using Stage = KvStage<DH, BN>;
  constexpr int BM = C::BM, NT = BN / 8, DT = DH / 8, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + C::q_bytes;
  int* rpos = reinterpret_cast<int*>(ring + kStages * Stage::bytes);

  const GroupRows G{(int)blockIdx.z, (int)blockIdx.y, hq / hkv, blk, hq};
  const int gr0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = kv_start[G.b];
  // the tiles [i0, i1) of this range (unstreamed: all of the task's)
  const int kvl = max(0, min(kv_len[G.b], jmax));
  const int i0 = min(rg.j0, kvl) * (blk / BN);
  const int i1 = min(rg.j1, kvl) * (blk / BN);

  bool live = false;
  for (int r = tid; r < BM; r += kMmaThreads) {
    rpos[r] = q_pos[G.row(gr0 + r)];
    live |= rpos[r] >= 0;
  }
  if (!__syncthreads_or(live) || (i0 >= i1 && rg.finalize && !rg.load)) {
    if (!rg.finalize) return;  // dead rows: nothing carried
    zero_rows<DH, BM>(out, G, gr0);  // dead rows, no tile: 0, LSE_DEAD
    for (int r = tid; r < BM; r += kMmaThreads) lse[G.stat(gr0 + r)] = kLseDead;
    return;
  }
  if (i0 >= i1 && rg.load && !rg.finalize) return;  // carry kept

  if (i0 < i1) {
    for (int c = tid; c < BM * CHUNKS; c += kMmaThreads) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      cp_async16(q_s + r * PITCH + col, q + G.off(gr0 + r, DH) + col, 16);
    }
    Stage(ring + (i0 % kStages) * Stage::bytes)
        .load_rows(k, v, kv_pos, tile_slot0<BN>(start, i0, blk, N), G.g,
                   hkv);
    cp_async_commit();
  }

  // this thread's rows ra and ra + 8 of the warp's 16; the warp's span
  const int ra = warp * 16 + (lane >> 2);
  const int rp[2] = {rpos[ra], rpos[ra + 8]};
  Span rs = span_empty();
  span_pos(rs, rpos[warp * 16 + (lane & 15)]);
  rs = span_warp(rs);
  const bf16* q_w = q_s + warp * 16 * PITCH;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // the carry: each thread's registers as they are (m and l of its rows
  // ra and ra + 8, l not yet reduced over the quad, its o fragments),
  // word e of thread tid of CTA c at [c][e][tid]
  constexpr int kWords = 4 + 4 * DT;
  float* cw = nullptr;
  if (rg.carry != nullptr)
    cw = rg.carry +
         ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x) * (kWords * kMmaThreads) + tid;
  if (rg.load) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = cw[h * kMmaThreads];
      l[h] = cw[(2 + h) * kMmaThreads];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[d][c] = cw[(4 + 4 * d + c) * kMmaThreads];
  }

  for (int i = i0; i < i1; ++i) {
    if (i + 1 < i1) {
      Stage(ring + ((i + 1) % kStages) * Stage::bytes)
          .load_rows(k, v, kv_pos, tile_slot0<BN>(start, i + 1, blk, N), G.g,
                     hkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage st(ring + (i % kStages) * Stage::bytes);
    Span ks = span_empty();
#pragma unroll
    for (int j = lane; j < BN; j += 32) span_pos(ks, st.pos[j]);
    ks = span_warp(ks);
    const uint32_t ok = pair_bits<NT, true>(
        classify(rs, ks, mask), rp, [&](int j) { return st.pos[j]; }, lane,
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

  if (!rg.finalize) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cw[h * kMmaThreads] = m[h];
      cw[(2 + h) * kMmaThreads] = l[h];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) cw[(4 + 4 * d + c) * kMmaThreads] = o[d][c];
    return;
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
                                 sizeof(int) * BM + sizeof(float) * 2 * BM;
  static_assert(BN % 32 == 0 && BN <= 64 && (DH / 8 / DS) % 2 == 0,
                "mma tiles");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int BN, int DS>
__global__ void __launch_bounds__(kMmaThreads)
    ca_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const bf16* __restrict__ out,
                     const float* __restrict__ lse,
                     float* __restrict__ delta,
                     const float* __restrict__ g_lse,
                     const int32_t* __restrict__ kv_start,
                     const int32_t* __restrict__ kv_len,
                     const int32_t* __restrict__ q_pos,
                     const int32_t* __restrict__ kv_pos,
                     bf16* __restrict__ dq, int N, int blk, int hq, int hkv,
                     int jmax, Mask mask, float softcap, float scale) {
  using C = DqCfg<DH, BN, DS>;
  using Stage = KvStage<DH, BN>;
  constexpr int BM = C::BM, NT = BN / 8, DT = DH / 8 / DS, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BM * PITCH;
  unsigned char* ring = smem_raw + C::q_bytes;
  int* rpos = reinterpret_cast<int*>(ring + kStages * Stage::bytes);
  float* rlse = reinterpret_cast<float*>(rpos + BM);  // lse * log2(e)
  float* rdl = rlse + BM;

  const GroupRows G{(int)blockIdx.z, (int)blockIdx.y, hq / hkv, blk, hq};
  const int gr0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / DS, wd = warp % DS;
  const int start = kv_start[G.b];
  const int n_tiles = max(0, min(kv_len[G.b], jmax)) * (blk / BN);

  bool live = false;
  for (int r = tid; r < BM; r += kMmaThreads) {
    rpos[r] = q_pos[G.row(gr0 + r)];
    rlse[r] = lse[G.stat(gr0 + r)] * kLog2e;
    live |= rpos[r] >= 0;
  }
  if (!__syncthreads_or(live) || n_tiles == 0) {  // zero gradient
    zero_rows<DH, BM>(dq, G, gr0);
    // padded rows and empty tasks: out is 0 there, and dk/dv masks them
    for (int r = tid; r < BM; r += kMmaThreads) delta[G.stat(gr0 + r)] = 0.f;
    return;
  }
  // delta = rowsum(dO * O) in f32 (the reference's torch op), a thread a
  // row in dh order, for this kernel and for dk/dv, launched after it
  for (int r = tid; r < BM; r += kMmaThreads) {
    const size_t off = G.off(gr0 + r, DH);
    float sum = 0.f;
    for (int c = 0; c < DH; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c);
      const uint4 b = *reinterpret_cast<const uint4*>(out + off + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum = fmaf(__low2float(a2[i]), __low2float(b2[i]), sum);
        sum = fmaf(__high2float(a2[i]), __high2float(b2[i]), sum);
      }
    }
    // the lse cotangent of a ring partial: ds = p (dp - (delta - g_lse))
    if (g_lse != nullptr) sum -= g_lse[G.stat(gr0 + r)];
    rdl[r] = sum;
    delta[G.stat(gr0 + r)] = sum;
  }

  for (int c = tid; c < BM * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const size_t off = G.off(gr0 + r, DH) + col;
    cp_async16(q_s + r * PITCH + col, q + off, 16);
    cp_async16(do_s + r * PITCH + col, dout + off, 16);
  }
  Stage(ring).load_rows(k, v, kv_pos, tile_slot0<BN>(start, 0, blk, N), G.g,
                        hkv);
  cp_async_commit();
  __syncthreads();  // delta

  const int ra = wm * 16 + (lane >> 2);
  const int rp[2] = {rpos[ra], rpos[ra + 8]};
  const float ls2[2] = {rlse[ra], rlse[ra + 8]};
  const float dl[2] = {rdl[ra], rdl[ra + 8]};
  Span rs = span_empty();
  span_pos(rs, rpos[wm * 16 + (lane & 15)]);
  rs = span_warp(rs);
  const bf16* q_w = q_s + wm * 16 * PITCH;
  const bf16* do_w = do_s + wm * 16 * PITCH;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      Stage(ring + ((i + 1) % kStages) * Stage::bytes)
          .load_rows(k, v, kv_pos, tile_slot0<BN>(start, i + 1, blk, N), G.g,
                     hkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage st(ring + (i % kStages) * Stage::bytes);
    Span ks = span_empty();
#pragma unroll
    for (int j = lane; j < BN; j += 32) span_pos(ks, st.pos[j]);
    ks = span_warp(ks);
    const uint32_t ok = pair_bits<NT, true>(
        classify(rs, ks, mask), rp, [&](int j) { return st.pos[j]; }, lane,
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
// One CTA per (BKV kv slots of buffer block n, kv head g).  It builds the
// ascending list of the tasks that cover n (0 <= n - kv_start[t] <
// min(kv_len[t], jmax)) in shared memory, then walks each listed task's
// group rows (its blk q rows x g's rep heads, q row major) in tiles of BQ,
// always in that order: S^T = K Q^T, dV += P^T dO, dP^T = V dO^T, dK +=
// dS^T Q.  DS warps split dh for the dK and dV accumulators, as in dq.
template <int DH, int BQ, int DS>
struct DkvCfg {
  static constexpr int WM = kMmaWarps / DS;
  static constexpr int BKV = 16 * WM;
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t kv_bytes = sizeof(bf16) * 2 * BKV * PITCH;
  // a q-side stage: Q, dO [BQ][PITCH]; positions, lse, delta [BQ]
  static constexpr size_t stage_bytes =
      sizeof(bf16) * 2 * BQ * PITCH + sizeof(int) * 3 * BQ;
  // before the task list [T] int32, which the launch adds
  static constexpr size_t smem =
      kv_bytes + kStages * stage_bytes + sizeof(int) * BKV;
  static_assert(BQ % 32 == 0 && BQ <= 64 && (DH / 8 / DS) % 2 == 0,
                "mma tiles");
  static_assert(smem % 16 == 0 && smem <= 232448, "shared memory");
};

template <int DH, int BQ, int DS>
__global__ void __launch_bounds__(kMmaThreads)
    ca_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ kv_start,
                      const int32_t* __restrict__ kv_len,
                      const int32_t* __restrict__ q_pos,
                      const int32_t* __restrict__ kv_pos,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int T_tasks, int blk, int hq, int hkv, int jmax,
                      Mask mask, float softcap, float scale) {
  using C = DkvCfg<DH, BQ, DS>;
  constexpr int BKV = C::BKV, NT = BQ / 8, DT = DH / 8 / DS, PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BKV * PITCH;
  unsigned char* ring = smem_raw + C::kv_bytes;
  int* kpos = reinterpret_cast<int*>(ring + kStages * C::stage_bytes);
  int* tasks = reinterpret_cast<int*>(smem_raw + C::smem);  // [T_tasks]
  __shared__ int n_tasks_s;

  const int c0 = blockIdx.x * BKV;  // first kv slot of the buffer
  const int n = c0 / blk;           // its block
  const int g = blockIdx.y;
  const int rep = hq / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / DS, wd = warp % DS;
  const size_t kv_stride = (size_t)hkv * DH;
  const size_t kv_off = (size_t)c0 * kv_stride + (size_t)g * DH;

  // the covering tasks in ascending order: a ballot per 32 tasks, each
  // covering lane writing at the running count plus the covering lanes
  // below it
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < T_tasks; t0 += 32) {
      const int t = t0 + lane;
      bool covers = false;
      if (t < T_tasks) {
        const int jrel = n - kv_start[t];
        covers = jrel >= 0 && jrel < min(kv_len[t], jmax);
      }
      const unsigned ballot = __ballot_sync(kFull, covers);
      if (covers) tasks[count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) n_tasks_s = count;
  }
  bool live = false;
  for (int r = tid; r < BKV; r += kMmaThreads) {
    kpos[r] = kv_pos[c0 + r];
    live |= kpos[r] >= 0;
  }
  for (int c = tid; c < BKV * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16(k_s + r * PITCH + col, k + kv_off + r * kv_stride + col, 16);
    cp_async16(v_s + r * PITCH + col, v + kv_off + r * kv_stride + col, 16);
  }
  // all kv rows padding: dk = dv = 0
  live = __syncthreads_or(live) != 0;  // the list and metadata too
  const int per = blk * rep / BQ;       // group-row tiles of a task
  const int n_units = live ? n_tasks_s * per : 0;

  // unit i: group rows [u * BQ, u * BQ + BQ) of listed task i / per, u = i
  // % per; group row gr is q row gr / rep, q head g * rep + gr % rep
  auto load_tile = [&](int i, int stage) {
    const GroupRows G{tasks[i / per], g, rep, blk, hq};
    const int gr0 = (i % per) * BQ;
    unsigned char* base = ring + stage * C::stage_bytes;
    bf16* qs = reinterpret_cast<bf16*>(base);
    bf16* os = qs + BQ * PITCH;
    int* spos = reinterpret_cast<int*>(os + BQ * PITCH);
    for (int c = tid; c < BQ * CHUNKS; c += kMmaThreads) {
      const int j = c / CHUNKS, col = (c % CHUNKS) * 8;
      const size_t off = G.off(gr0 + j, DH) + col;
      cp_async16(qs + j * PITCH + col, q + off, 16);
      cp_async16(os + j * PITCH + col, dout + off, 16);
    }
    for (int j = tid; j < BQ; j += kMmaThreads) {
      cp_async4(spos + j, q_pos + G.row(gr0 + j));
      cp_async4(spos + BQ + j, lse + G.stat(gr0 + j));
      cp_async4(spos + 2 * BQ + j, delta + G.stat(gr0 + j));
    }
  };
  if (n_units > 0) load_tile(0, 0);
  cp_async_commit();

  const int ra = wm * 16 + (lane >> 2);
  const int kp[2] = {kpos[ra], kpos[ra + 8]};
  Span ks = span_empty();
  span_pos(ks, kpos[wm * 16 + (lane & 15)]);
  ks = span_warp(ks);
  const bf16* k_w = k_s + wm * 16 * PITCH;
  const bf16* v_w = v_s + wm * 16 * PITCH;

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[d][e] = av[d][e] = 0.f;

  for (int i = 0; i < n_units; ++i) {
    if (i + 1 < n_units) {
      load_tile(i + 1, (i + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* base = ring + (i % kStages) * C::stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(base);
    const bf16* os = qs + BQ * PITCH;
    const int* spos = reinterpret_cast<const int*>(os + BQ * PITCH);
    const float* slse = reinterpret_cast<const float*>(spos + BQ);
    const float* sdl = slse + BQ;
    Span qsp = span_empty();
#pragma unroll
    for (int j = lane; j < BQ; j += 32) span_pos(qsp, spos[j]);
    qsp = span_warp(qsp);
    // rows are kv rows here, columns the tile's group rows
    const uint32_t ok = pair_bits<NT, false>(
        classify(qsp, ks, mask), kp, [&](int j) { return spos[j]; }, lane,
        mask);
    if (__any_sync(kFull, ok != 0)) {
      float pt[NT][4], dpt[NT][4];
      mma_abt<DH, BQ>(pt, k_w, qs, lane);   // S^T = K Q^T
      mma_abt<DH, BQ>(dpt, v_w, os, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n8 = 0; n8 < NT; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool on = (ok >> (n8 * 4 + e)) & 1u;
          const int j = n8 * 8 + 2 * (lane & 3) + (e & 1);
          const float x = cap(pt[n8][e], scale, softcap);
          const float p = on ? exp2f(fmaf(x, kLog2e, -slse[j] * kLog2e)) : 0.f;
          pt[n8][e] = p;
          dpt[n8][e] = on ? ds_from_p(p, dpt[n8][e], sdl[j], x, true, scale,
                                      softcap)
                          : 0.f;
        }
      // dV += P^T dO and dK += dS^T Q over the tile's group rows, with the
      // bf16 rounding of P and dS multiplied in as well (hi + lo): a kv
      // slot sums rep x (covering tasks) x blk terms
      mma_pb<DH, BQ, DT, true>(av, pt, os, wd * DT, lane);
      mma_pb<DH, BQ, DT, true>(ak, dpt, qs, wd * DT, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // with no unit, the K/V rows are still in flight

  const int col0 = wd * DT * 8 + 2 * (lane & 3);
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
}

// ------------------------------------------------------------------ launch
struct Args {
  const void *q, *k, *v, *dout, *out_in, *lse_in, *delta, *g_lse;
  const void *kv_start, *kv_len, *q_pos, *kv_pos;
  void *out, *lse, *dq, *dk, *dv, *delta_out;
  int T, N, blk, hq, hkv, jmax;
  Mask mask;
  float softcap, scale;
  Range rg;
  cudaStream_t stream;
};

#define CA_INS                                                           \
  static_cast<const int32_t*>(a.kv_start),                               \
      static_cast<const int32_t*>(a.kv_len),                             \
      static_cast<const int32_t*>(a.q_pos),                              \
      static_cast<const int32_t*>(a.kv_pos)

template <typename T, int DH>
cudaError_t launch_fwd(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_fwd_kernel<T, DH>, fwd_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.T, a.hq, a.blk / Rows<DH>::kQ);
  ca_fwd_kernel<T, DH><<<grid, kThreads, fwd_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), CA_INS, static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.N, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale, a.rg);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_bwd_dq_kernel<T, DH>, dq_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.T, a.hq, a.blk / Rows<DH>::kQ);
  ca_bwd_dq_kernel<T, DH><<<grid, kThreads, dq_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), CA_INS, static_cast<T*>(a.dq), a.N,
      a.blk, a.hq, a.hkv, a.jmax, a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_bwd_dkv_kernel<T, DH>, dkv_smem<DH>(), &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.N, a.hkv, a.blk / Rows<DH>::kKV);
  ca_bwd_dkv_kernel<T, DH><<<grid, kThreads, dkv_smem<DH>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), CA_INS, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.T, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}

template <int DH, int BN>
cudaError_t launch_fwd_mma(const Args& a) {
  using C = FwdCfg<DH, BN>;
  static bool configured = false;
  cudaError_t e = raise_smem(ca_fwd_mma_kernel<DH, BN>, C::smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.blk * (a.hq / a.hkv) / C::BM, a.hkv, a.T);
  ca_fwd_mma_kernel<DH, BN><<<grid, kMmaThreads, C::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), CA_INS, static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), a.N, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale, a.rg);
  return cudaGetLastError();
}

template <int DH, int BN, int DS>
cudaError_t launch_dq_mma(const Args& a) {
  using C = DqCfg<DH, BN, DS>;
  static bool configured = false;
  cudaError_t e =
      raise_smem(ca_dq_mma_kernel<DH, BN, DS>, C::smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.blk * (a.hq / a.hkv) / C::BM, a.hkv, a.T);
  ca_dq_mma_kernel<DH, BN, DS><<<grid, kMmaThreads, C::smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const bf16*>(a.out_in), static_cast<const float*>(a.lse_in),
      static_cast<float*>(a.delta_out), static_cast<const float*>(a.g_lse),
      CA_INS, static_cast<bf16*>(a.dq),
      a.N, a.blk, a.hq, a.hkv, a.jmax, a.mask, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int DH, int BQ, int DS>
cudaError_t launch_dkv_mma(const Args& a) {
  using C = DkvCfg<DH, BQ, DS>;
  // the covering-task list takes T int32 after the tiles: the allowance
  // grows with the largest T seen (past the CTA's shared memory the
  // attribute call fails, and so does the launch)
  const size_t smem = C::smem + sizeof(int) * (size_t)a.T;
  static size_t raised = 0;
  if (smem > raised) {
    cudaError_t e = cudaFuncSetAttribute(
        ca_dkv_mma_kernel<DH, BQ, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised = smem;
  }
  dim3 grid(a.N * a.blk / C::BKV, a.hkv);
  ca_dkv_mma_kernel<DH, BQ, DS><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), CA_INS, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.T, a.blk, a.hq, a.hkv, a.jmax, a.mask,
      a.softcap, a.scale);
  return cudaGetLastError();
}
#undef CA_INS

// which: 0 = forward, 1 = dq, 2 = dk/dv
int dispatch(int which, int dtype, int dh, const Args& a) {
  if (a.T <= 0 || a.N <= 0) return cudaSuccess;
  if ((a.blk != 64 && a.blk != 128) || a.hkv < 1 || a.hq % a.hkv != 0 ||
      a.jmax < 0 || a.mask.rate < 1)
    return cudaErrorInvalidValue;
  if (dtype == 0) {  // exact f32 on the FMA pipes
#define CA_CASE(DH)                                        \
  if (which == 0) return (int)launch_fwd<float, DH>(a);    \
  if (which == 1) return (int)launch_dq<float, DH>(a);     \
  return (int)launch_dkv<float, DH>(a)
    if (dh == 64) { CA_CASE(64); }
    if (dh == 128) { CA_CASE(128); }
    if (dh == 192) { CA_CASE(192); }
    if (dh == 256) { CA_CASE(256); }
#undef CA_CASE
    return cudaErrorInvalidValue;
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  // (dh, slots a kv tile, dh split, group rows a q tile of dk/dv), as
  // flash.cu's tensor-core kernels
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
  a.rg = Range{0, jmax, nullptr, 0, 1};  // unstreamed
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [T, blk, hq, dh];
// k, v [N, blk, hkv, dh]; lse [T, hq, blk] f32; kv_start, kv_len [T],
// q_pos [T, blk], kv_pos [N, blk] int32; dh 64, 128, 192 or 256; blk 64
// or 128.  bf16 loads 16 bytes a thread: q, k, v, dout and kv_pos 16-byte
// aligned.  The caller checks shapes, types, contiguity and alignment.
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

// The forward over relative kv blocks [j0, min(j1, jmax)) with a carry
// (struct Range): carry f32, (dh + 8) words per (task, q head, q row),
// updated in place; load: read it first; finalize: write out and lse
// (which may be null otherwise).
extern "C" int ca_server_fwd_range(
    const void* q, const void* k, const void* v, const void* kv_start,
    const void* kv_len, const void* q_pos, const void* kv_pos, void* out,
    void* lse, void* carry, int T, int N, int blk, int hq, int hkv, int dh,
    int dtype, int jmax, int window, int sink, int rate, float softcap,
    float scale, int j0, int j1, int load, int finalize, void* stream) {
  if (j0 < 0 || carry == nullptr || (finalize && (out == nullptr ||
                                                  lse == nullptr)))
    return cudaErrorInvalidValue;
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
  a.rg = Range{j0, j1, static_cast<float*>(carry), load != 0,
               finalize != 0};
  return dispatch(0, dtype, dh, a);
}

// dout and out like q; lse, delta [T, hq, blk] f32; dq like q.  f32
// reads delta = rowsum(dout * out), which the caller computes; bf16
// computes it from dout and out and writes it into delta, for dk/dv.
// g_lse (bf16 only; null for none): the lse cotangent [T, hq, blk] f32,
// subtracted from delta (the f32 caller subtracts it itself).
extern "C" int ca_server_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* out,
                                const void* lse, void* delta,
                                const void* g_lse,
                                const void* kv_start, const void* kv_len,
                                const void* q_pos, const void* kv_pos,
                                void* dq, int T, int N, int blk, int hq,
                                int hkv, int dh, int dtype, int jmax,
                                int window, int sink, int rate,
                                float softcap, float scale, void* stream) {
  Args a = make_args(T, N, blk, hq, hkv, jmax, window, sink, rate, softcap,
                     scale, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out_in = out;
  a.lse_in = lse;
  a.delta = delta;
  a.delta_out = delta;
  a.g_lse = g_lse;
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
