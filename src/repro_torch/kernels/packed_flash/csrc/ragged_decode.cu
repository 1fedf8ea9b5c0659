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
//   decode  (blk_q = 1):   bytes, the K/V of the live slots / 3.35 TB/s
//                          (4 requests at kv 2000, 8 kv heads of 128:
//                          32.8 MB, 9.8 us);
//   prefill (blk_q = 128): operations, 4 * visible pairs * Hq * dh FLOPs
//                          / 989 TFLOP/s (a 512-row chunk at kv ~2000,
//                          32 q heads of 128: 16.65 GFLOP, 16.8 us).
//
// Design.  bf16 inputs (the serving path) take the tensor-core kernel
// ragged_mma_kernel; f32 inputs (the exactness checks) keep exact f32
// arithmetic on the FMA pipes in ragged_f32_kernel.
//
// ragged_mma_kernel, one CTA of 4 warps per (q block, kv head, row tile,
// kv split):
//   * GQA in the M dimension: a CTA's rows are the blk_q x rep (q row, q
//     head) pairs of one kv head's group, ordered q row major, so one K/V
//     tile serves every q head of the group (the old design loaded it once
//     per q head).  Prefill takes 64 of those rows a CTA (16 a warp);
//     decode (rep rows, padded to 16) puts its 4 warps on 16-slot quarters
//     of each 64-slot tile, and merges their softmax states at the end.
//   * Q.K^T and P.V on the tensor cores: mma.sync m16n8k16 with bf16
//     fragments loaded by ldmatrix and f32 accumulators.  The online
//     softmax runs in registers FA2-style: a warp owns 16 rows, each
//     thread two of them, m and l live in registers across tiles (the old
//     kernel walked rows one by one through shared memory).  Logits are
//     kept in log2 units so the exponentials are exp2; a warp tile that
//     every one of its rows sees whole skips the mask arithmetic.  P is
//     rounded to bf16 for P.V, as the TPU kernel does (p.astype(v.dtype));
//     l sums the f32 p.
//   * K/V tiles stay bf16 in shared memory (no f32 staging), loaded with
//     cp.async, 16 bytes a thread, into a ring of 2 stages: tile t+1 is in
//     flight while tile t is computed.  Slots at or past kv_len are
//     zero-filled instead of read, so whatever an unused cache slot holds
//     never reaches the sums.  Rows are padded by 16 bytes so ldmatrix
//     reads hit distinct banks.
//   * tile prune as before: only tiles below min(kv_len, max live position
//     + 1) and, with a window, tiles that reach the smallest live
//     position's window; a warp skips a tile none of its rows sees.  A
//     fully masked tile is an exact no-op (max unchanged, p = 0 by the
//     mask, correction exp(0) = 1), so pruning changes no bit.
//   * split-kv (flash-decoding): the wrapper picks n_split from the grid
//     and the cache length (ops.py ragged_split_plan), so that a decode
//     step puts ~2 CTAs an SM on the card instead of one CTA per (request,
//     head).  Each CTA cuts the live tile range [t_lo, t_hi) that it
//     computes from the data into n_split contiguous parts (empty parts
//     exit at once).  Every part writes (m, l, acc) of its rows to f32
//     scratch; the last CTA of a (q block, kv head, row tile) to finish,
//     found through an int atomic on a counter (wrapper-allocated zeros,
//     reset by that CTA), merges the parts in split order.  No float
//     atomics: a repeated call is bitwise equal.  One launch per call.
//   * head_dim 64, 128, 192 and 256.  At 256 the accumulators are 128
//     f32 registers a thread; prefill then walks 32-slot tiles to keep the
//     score fragment small.  At 192 they are 96, and with the 32 of a
//     64-slot score fragment fit beside them (128 in all, as at 256 with
//     32-slot tiles' 16 fewer), so prefill keeps 64-slot tiles.  Shared
//     memory per CTA: 85 / 125 / 99 KiB (prefill dh 128 / 192 / 256),
//     73 / 106 / 140 KiB (decode), set once per instantiation.
//   * epilogue: a prefill warp owns its rows whole and writes the output
//     (or its part's state) from registers; decode's warps, which share
//     rows, merge their states through shared memory in warp order.
//
// ragged_f32_kernel (f32 inputs): one CTA of 8 warps per (q block, q head,
// 32-row chunk) walks 64-slot tiles staged in shared memory as f32, a warp
// per q row: each lane takes two keys for the logits and the lanes split
// dh for P.V, in f32 FMAs.  The 32-row chunks make dh 256 fit (197 KiB).
//
// What is left for later: TMA loads with mbarriers instead of cp.async,
// wgmma for the 64-row prefill tiles (mma.sync reaches a fraction of the
// 989 TFLOP/s), persistent CTAs that walk several (block, head) items, and
// a warp-specialised producer.
//
// C interface (loaded with ctypes): ragged_decode_fwd returns
// cudaGetLastError() after the launch on the caller's stream.

#include <climits>

#include "common.cuh"

namespace {

// ------------------------------------------------ f32: exact FMA kernel
constexpr int kTileK = 64;
constexpr int kRowChunk = 32;

template <int DH>
constexpr size_t f32_smem_bytes() {
  // q rows + accumulators [kRowChunk][DH], K tile [kTileK][DH + 1] (padded
  // so lane-per-key reads fall in distinct banks), V tile [kTileK][DH],
  // running max, sum and position per row
  return sizeof(float) * (2 * (size_t)kRowChunk * DH +
                          (size_t)kTileK * (DH + 1) + (size_t)kTileK * DH +
                          2 * (size_t)kRowChunk) +
         sizeof(int) * (size_t)kRowChunk;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    ragged_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int32_t* __restrict__ block_req,
                      const int32_t* __restrict__ kv_len,
                      const int32_t* __restrict__ q_pos,
                      float* __restrict__ out, int blk_q, int hq, int hkv,
                      int S, int window, float softcap, float scale) {
  constexpr int KS = DH + 1;
  constexpr int PER_LANE = DH / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kRowChunk][DH]
  float* acc_s = q_s + kRowChunk * DH;    // [kRowChunk][DH]
  float* k_s = acc_s + kRowChunk * DH;    // [kTileK][KS]
  float* v_s = k_s + kTileK * KS;         // [kTileK][DH]
  float* m_s = v_s + kTileK * DH;         // [kRowChunk]
  float* l_s = m_s + kRowChunk;           // [kRowChunk]
  int* pos_s = reinterpret_cast<int*>(l_s + kRowChunk);  // [kRowChunk]
  __shared__ int qmin_s, qmax_s;

  const int i = blockIdx.x;               // q block
  const int h = blockIdx.y;               // q head
  const int r0 = blockIdx.z * kRowChunk;  // first row of this chunk
  const int rows = min(kRowChunk, blk_q - r0);
  const int g = h / (hq / hkv);           // its kv head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)hq * DH;  // between q (and out) rows
  const float* qb = q + ((size_t)i * blk_q + r0) * row_stride + (size_t)h * DH;
  float* ob = out + ((size_t)i * blk_q + r0) * row_stride + (size_t)h * DH;

  const int req = block_req[i];
  if (req < 0) {  // dead block
    for (int idx = tid; idx < rows * DH; idx += kThreads)
      ob[(size_t)(idx / DH) * row_stride + idx % DH] = 0.f;
    return;
  }
  const int len = min(kv_len[req], S);

  if (tid == 0) {
    qmin_s = INT_MAX;
    qmax_s = -1;
  }
  __syncthreads();
  int my_min = INT_MAX, my_max = -1;
  for (int r = tid; r < rows; r += kThreads) {
    const int p = q_pos[(size_t)i * blk_q + r0 + r];
    pos_s[r] = p;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    if (p >= 0) {
      my_min = min(my_min, p);
      my_max = max(my_max, p);
    }
  }
  for (int idx = tid; idx < rows * DH; idx += kThreads) {
    q_s[idx] = qb[(size_t)(idx / DH) * row_stride + idx % DH];
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
  const float* kb = k + (size_t)req * S * slot_stride + (size_t)g * DH;
  const float* vb = v + (size_t)req * S * slot_stride + (size_t)g * DH;

  for (int t = t_lo; t < t_hi; ++t) {
    const int s0 = t * kTileK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kTileK * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH;
      const size_t off = (size_t)(s0 + r) * slot_stride + d;
      k_s[r * KS + d] = kb[off];
      v_s[r * DH + d] = vb[off];
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
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
      x_lo = cap(x_lo, scale, softcap);
      x_hi = cap(x_hi, scale, softcap);
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
        const float pl = __shfl_sync(kFull, p_lo, kk);
        const float ph = __shfl_sync(kFull, p_hi, kk);
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

  for (int r = warp; r < rows; r += kWarps) {
    const bool alive = m_s[r] > kNegInf * 0.5f;
    const float l = fmaxf(l_s[r], 1e-30f);
    const float* ar = acc_s + r * DH;
#pragma unroll
    for (int c = 0; c < PER_LANE; ++c) {
      const int d = lane + 32 * c;
      ob[(size_t)r * row_stride + d] = alive ? ar[d] / l : 0.f;
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* block_req, const void* kv_len,
                       const void* q_pos, void* out, int nq, int blk_q,
                       int hq, int hkv, int S, int window, float softcap,
                       float scale, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = raise_smem(ragged_f32_kernel<DH>, f32_smem_bytes<DH>(),
                             &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(nq, hq, (blk_q + kRowChunk - 1) / kRowChunk);
  ragged_f32_kernel<DH><<<grid, kThreads, f32_smem_bytes<DH>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(block_req),
      static_cast<const int32_t*>(kv_len), static_cast<const int32_t*>(q_pos),
      static_cast<float*>(out), blk_q, hq, hkv, S, window, softcap, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16: tensor-core kernel
constexpr int kMaxSplit = 32;  // ops.py MAX_SPLITS

// Tiling of one instantiation: WM warps along the rows (16 rows each), the
// other WN = 4 / WM along the BN slots of a tile (CW slots each).
template <int DH, int WM, int BN>
struct Mma {
  static constexpr int WN = kMmaWarps / WM;
  static constexpr int BM = 16 * WM;
  static constexpr int CW = BN / WN;
  static constexpr int NT = CW / 8;   // n8 tiles of a warp's scores
  static constexpr int DT = DH / 8;   // n8 tiles of a warp's output
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t q_bytes = sizeof(bf16) * BM * PITCH;
  static constexpr size_t ring_bytes =
      sizeof(bf16) * kStages * 2 * BN * PITCH;
  // after the loop the ring holds the split weights [kMaxSplit][BM] and
  // 1 / l [BM], and with WN > 1 first the warps' states: acc [WN][BM][DH],
  // m and l [WN][BM]
  static constexpr size_t epi_bytes =
      sizeof(float) * ((WN > 1 ? (size_t)WN * BM * (DH + 2) : 0) +
                       (kMaxSplit + 1) * BM);
  static constexpr size_t kv_bytes =
      ring_bytes > epi_bytes ? ring_bytes : epi_bytes;
  static constexpr size_t smem = q_bytes + kv_bytes + sizeof(int) * BM;
  static_assert(CW % 16 == 0 && DH % 16 == 0, "mma tiles");
  static_assert(NT * 4 <= 32, "a mask bit per score register");
  static_assert(smem <= 232448, "shared memory of one CTA");
};

template <int DH, int WM, int BN>
__global__ void __launch_bounds__(kMmaThreads)
    ragged_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int32_t* __restrict__ block_req,
                      const int32_t* __restrict__ kv_len,
                      const int32_t* __restrict__ q_pos,
                      bf16* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ counters, int blk_q, int hq, int hkv,
                      int S, int n_mt, int n_split, int window, float softcap,
                      float scale) {
  using C = Mma<DH, WM, BN>;
  constexpr int BM = C::BM, WN = C::WN, CW = C::CW, NT = C::NT, DT = C::DT;
  constexpr int PITCH = C::PITCH;
  constexpr int CHUNKS = DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + C::q_bytes);
  float* epi = reinterpret_cast<float*>(smem_raw + C::q_bytes);
  int* pos_s = reinterpret_cast<int*>(smem_raw + C::q_bytes + C::kv_bytes);
  __shared__ int qmin_s, qmax_s, last_s;

  const int base = blockIdx.x;  // (q block, kv head, row tile)
  const int split = blockIdx.y;
  const int mt = base % n_mt;
  const int g = (base / n_mt) % hkv;
  const int i = base / n_mt / hkv;
  const int rep = hq / hkv;
  const int M = blk_q * rep;  // (q row, q head) rows of the group
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  // CTA row r is group row gr = mt * BM + r: q row gr / rep, q head
  // g * rep + gr % rep, at element offset row_off(gr) of q and out
  auto row_off = [&](int gr) {
    return (((size_t)i * blk_q + gr / rep) * hq + (size_t)g * rep + gr % rep) *
           DH;
  };

  const int req = block_req[i];
  if (tid == 0) {
    qmin_s = INT_MAX;
    qmax_s = -1;
  }
  __syncthreads();
  for (int r = tid; r < BM; r += kMmaThreads) {
    const int gr = mt * BM + r;
    const int p = (req >= 0 && gr < M) ? q_pos[(size_t)i * blk_q + gr / rep]
                                       : -1;
    pos_s[r] = p;
    if (p >= 0) {
      atomicMin(&qmin_s, p);
      atomicMax(&qmax_s, p);
    }
  }
  __syncthreads();
  const int qmin = qmin_s, qmax = qmax_s;
  const int len = req >= 0 ? min(kv_len[req], S) : 0;

  // the live tiles [t_lo, t_hi) as in the f32 kernel, cut into n_split
  // parts of `per` tiles; n_act parts are non-empty (ops.py kv_split_ranges)
  int t_lo = 0, t_hi = 0;
  if (qmax >= 0) {
    t_hi = (min(len, qmax + 1) + BN - 1) / BN;
    if (window > 0 && qmin - (window - 1) > 0)
      t_lo = (qmin - (window - 1)) / BN;
  }
  const int n_tiles = max(0, t_hi - t_lo);
  const int per = n_tiles > 0 ? (n_tiles + n_split - 1) / n_split : 1;
  const int n_act = (n_tiles + per - 1) / per;

  if (n_act == 0) {  // dead block, or no row sees a slot: zeros
    if (split == 0) {
      for (int idx = tid; idx < BM * DH; idx += kMmaThreads) {
        const int gr = mt * BM + idx / DH;
        if (gr < M) out[row_off(gr) + idx % DH] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  if (split >= n_act) return;
  const int lo = t_lo + split * per;
  const int hi = min(t_hi, lo + per);

  const size_t slot_stride = (size_t)hkv * DH;
  const bf16* kb = k + (size_t)req * S * slot_stride + (size_t)g * DH;
  const bf16* vb = v + (size_t)req * S * slot_stride + (size_t)g * DH;

  // q rows of the CTA (padded and missing rows zero-filled)
  for (int c = tid; c < BM * CHUNKS; c += kMmaThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int gr = mt * BM + r;
    const bool ok = gr < M && pos_s[r] >= 0;
    cp_async16(q_s + r * PITCH + col, ok ? q + row_off(gr) + col : q,
               ok ? 16 : 0);
  }
  auto load_tile = [&](int t, int stage) {
    bf16* ks = ring + stage * 2 * BN * PITCH;
    bf16* vs = ks + BN * PITCH;
    for (int c = tid; c < BN * CHUNKS; c += kMmaThreads) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int slot = t * BN + r;
      const bool ok = slot < len;
      const size_t off = ok ? (size_t)slot * slot_stride + col : 0;
      cp_async16(ks + r * PITCH + col, kb + off, ok ? 16 : 0);
      cp_async16(vs + r * PITCH + col, vb + off, ok ? 16 : 0);
    }
  };
  load_tile(lo, 0);
  cp_async_commit();

  // this thread's rows: r0 and r0 + 8 of the warp's 16
  const int r0 = wm * 16 + (lane >> 2);
  int pr[2];
  float m[2], l[2];
  float o[DT][4];
  // the warp's live positions, to skip tiles none of its rows sees
  int wmin = INT_MAX, wmax = -1;
  bool live = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = pos_s[r0 + 8 * h];
    pr[h] = p;
    m[h] = kNegInf;
    l[h] = 0.f;
    live = live && p >= 0;
    if (p >= 0) {
      wmin = min(wmin, p);
      wmax = max(wmax, p);
    }
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(kFull, wmin, s));
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, s));
  }
  const bool all_live = __all_sync(kFull, live);

  for (int t = lo; t < hi; ++t) {
    const int it = t - lo;
    if (t + 1 < hi) {
      load_tile(t + 1, (it + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = ring + (it % kStages) * 2 * BN * PITCH;
    const bf16* vs = ks + BN * PITCH;
    const int c0 = t * BN + wn * CW;  // first slot of this warp's columns
    const bool run = wmax >= c0 && c0 < len &&
                     !(window > 0 && c0 + CW - 1 < wmin - (window - 1));
    if (run) {
      // scores S = Q K^T of the warp's 16 rows x CW slots
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_s + (wm * 16 + (lane & 15)) * PITCH + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (wn * CW + n * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                  PITCH +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[n], a, b[0], b[1]);
          mma_bf16(sc[n + 1], a, b[2], b[3]);
        }
      }
      // scaled, softcapped logits in log2 units (the softmax runs on
      // exp2), masked by bit n * 4 + e of `ok`; element e of n8 tile n is
      // row r0 + 8 * (e / 2), slot c0 + n * 8 + 2 * (lane % 4) + e % 2.  A
      // warp tile that every one of its rows sees whole skips the mask
      // arithmetic.
      const bool whole = all_live && c0 + CW - 1 <= wmin && c0 + CW <= len &&
                         (window <= 0 || wmax - c0 < window);
      float mx[2] = {kNegInf, kNegInf};
      uint32_t ok = whole ? ~0u : 0u;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!whole) {
            const int p = pr[e >> 1];
            const int slot = c0 + n * 8 + 2 * (lane & 3) + (e & 1);
            if (p >= 0 && slot < len && slot <= p &&
                (window <= 0 || p - slot < window))
              ok |= 1u << (n * 4 + e);
          }
          const float x = (ok >> (n * 4 + e)) & 1u
                              ? cap(sc[n][e], scale, softcap) * kLog2e
                              : kNegInf;
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok >> (n * 4 + e)) & 1u
                              ? exp2f(sc[n][e] - m[e >> 1])
                              : 0.f;
          sc[n][e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
      // O += P V: P from the score registers (bf16), V by ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < CW / 16; ++kc) {
        uint32_t a[4];
        a[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
        a[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
        a[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
        a[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vs + (wn * CW + kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                          PITCH +
                     d * 8 + (lane >> 4) * 8);
          mma_bf16(o[d], a, b[0], b[1]);
          mma_bf16(o[d + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // l summed over the quad of threads that share a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  // the ring is free: split weights [kMaxSplit][BM] and 1 / l [BM] at its
  // end, the warps' states (WN > 1) before them
  float* wts = epi + (WN > 1 ? (size_t)WN * BM * (DH + 2) : 0);
  float* inv_l = wts + kMaxSplit * BM;
  float* p_acc = part + ((size_t)base * n_split + split) * BM * DH;
  float* p_ml = part + (size_t)gridDim.x * n_split * BM * DH +
                ((size_t)base * n_split + split) * BM * 2;

  if constexpr (WN == 1) {
    // a warp owns its rows whole: the output, or this part's state, from
    // the registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int gr = mt * BM + r;
      if (gr >= M) continue;
      if (n_act == 1) {
        const float inv = m[h] > kNegInf * 0.5f ? 1.f / fmaxf(l[h], 1e-30f)
                                                 : 0.f;
        bf16* orow = out + row_off(gr) + 2 * (lane & 3);
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
              __floats2bfloat162_rn(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
      } else {
        float* arow = p_acc + (size_t)r * DH + 2 * (lane & 3);
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<float2*>(arow + d * 8) =
              make_float2(o[d][2 * h], o[d][2 * h + 1]);
        if ((lane & 3) == 0) {
          p_ml[2 * r] = m[h];
          p_ml[2 * r + 1] = l[h];
        }
      }
    }
  } else {
    // warps split the slots: their states into shared memory, merged in
    // warp order
    float* e_acc = epi;                         // [WN][BM][DH]
    float* e_m = e_acc + (size_t)WN * BM * DH;  // [WN][BM]
    float* e_l = e_m + WN * BM;                 // [WN][BM]
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float* row = e_acc + ((size_t)wn * BM + r0) * DH + d * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(row) = make_float2(o[d][0], o[d][1]);
      *reinterpret_cast<float2*>(row + 8 * DH) = make_float2(o[d][2], o[d][3]);
    }
    if ((lane & 3) == 0) {
      e_m[wn * BM + r0] = m[0];
      e_l[wn * BM + r0] = l[0];
      e_m[wn * BM + r0 + 8] = m[1];
      e_l[wn * BM + r0 + 8] = l[1];
    }
    __syncthreads();
    // per row the max, each warp's weight exp2(m_w - max) and the sum
    for (int r = tid; r < BM; r += kMmaThreads) {
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < WN; ++w) mm = fmaxf(mm, e_m[w * BM + r]);
      float ll = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        const float wt = exp2f(e_m[w * BM + r] - mm);
        wts[w * BM + r] = wt;
        ll += e_l[w * BM + r] * wt;
      }
      e_m[r] = mm;  // row w = 0 holds the merged state from here on
      e_l[r] = ll;
    }
    __syncthreads();
    for (int idx = tid; idx < BM * DH; idx += kMmaThreads) {
      const int r = idx / DH, d = idx % DH;
      const int gr = mt * BM + r;
      if (gr >= M) continue;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w)
        a += e_acc[((size_t)w * BM + r) * DH + d] * wts[w * BM + r];
      if (n_act == 1) {
        const bool alive = e_m[r] > kNegInf * 0.5f;
        out[row_off(gr) + d] =
            __float2bfloat16(alive ? a / fmaxf(e_l[r], 1e-30f) : 0.f);
      } else {
        p_acc[idx] = a;
        if (d == 0) {
          p_ml[2 * r] = e_m[r];
          p_ml[2 * r + 1] = e_l[r];
        }
      }
    }
  }
  if (n_act == 1) return;

  // split-kv: the last of the n_act parts to finish merges them in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + base, 1);
    last_s = prev == n_act - 1;
    if (last_s) counters[base] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* a_base = part + (size_t)base * n_split * BM * DH;
  const float* ml_base = part + (size_t)gridDim.x * n_split * BM * DH +
                         (size_t)base * n_split * BM * 2;
  for (int r = tid; r < BM; r += kMmaThreads) {
    float mm = kNegInf;
    for (int s = 0; s < n_act; ++s)
      mm = fmaxf(mm, __ldcg(ml_base + ((size_t)s * BM + r) * 2));
    float ll = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float wt = exp2f(__ldcg(ml_base + ((size_t)s * BM + r) * 2) - mm);
      wts[s * BM + r] = wt;
      ll += __ldcg(ml_base + ((size_t)s * BM + r) * 2 + 1) * wt;
    }
    inv_l[r] = mm > kNegInf * 0.5f ? 1.f / fmaxf(ll, 1e-30f) : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < BM * DH; idx += kMmaThreads) {
    const int r = idx / DH;
    const int gr = mt * BM + r;
    if (gr >= M) continue;
    float a = 0.f;
    for (int s = 0; s < n_act; ++s)
      a += __ldcg(a_base + (size_t)s * BM * DH + idx) * wts[s * BM + r];
    out[row_off(gr) + idx % DH] = __float2bfloat16(a * inv_l[r]);
  }
}

template <int DH, int WM, int BN>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* block_req, const void* kv_len,
                       const void* q_pos, void* out, void* part,
                       void* counters, int nq, int blk_q, int hq, int hkv,
                       int S, int n_split, int window, float softcap,
                       float scale, cudaStream_t stream) {
  using C = Mma<DH, WM, BN>;
  static bool configured = false;
  cudaError_t e = raise_smem(ragged_mma_kernel<DH, WM, BN>, C::smem,
                             &configured);
  if (e != cudaSuccess) return e;
  const int n_mt = (blk_q * (hq / hkv) + C::BM - 1) / C::BM;
  dim3 grid(nq * hkv * n_mt, n_split);
  ragged_mma_kernel<DH, WM, BN><<<grid, kMmaThreads, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(block_req),
      static_cast<const int32_t*>(kv_len), static_cast<const int32_t*>(q_pos),
      static_cast<bf16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), blk_q, hq, hkv, S, n_mt, n_split, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q, out [nq, blk_q, hq, dh];
// k, v [R, S, hkv, dh]; block_req [nq], kv_len [R], q_pos [nq, blk_q] int32.
// bf16 only: n_split kv parts; with n_split > 1, part holds
// base * n_split * BM * (dh + 2) f32 and counters base int32 zeros, where
// base = nq * hkv * ceil(blk_q * hq / hkv / BM) and BM = 16 for blk_q 1,
// else 64 (ops.py ragged_split_plan).  f32 takes n_split 1.  The caller
// checks shapes, types, contiguity and coverage; anything this function
// does not cover returns cudaErrorInvalidValue without launching.
extern "C" int ragged_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* block_req, const void* kv_len,
                                 const void* q_pos, void* out, void* part,
                                 void* counters, int nq, int blk_q, int hq,
                                 int hkv, int S, int dh, int dtype,
                                 int n_split, int window, float softcap,
                                 float scale, void* stream) {
  if (nq == 0) return cudaSuccess;
  if (blk_q < 1 || hkv < 1 || hq % hkv != 0 || S % kTileK != 0 ||
      n_split < 1 || n_split > kMaxSplit ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (n_split != 1) return cudaErrorInvalidValue;
#define RD_F32(DH)                                                         \
  return (int)launch_f32<DH>(q, k, v, block_req, kv_len, q_pos, out, nq,  \
                             blk_q, hq, hkv, S, window, softcap, scale, s)
    if (dh == 64) RD_F32(64);
    if (dh == 128) RD_F32(128);
    if (dh == 192) RD_F32(192);
    if (dh == 256) RD_F32(256);
#undef RD_F32
    return cudaErrorInvalidValue;
  }
  if (dtype != 1) return cudaErrorInvalidValue;
#define RD_MMA(DH, WM, BN)                                                 \
  return (int)launch_mma<DH, WM, BN>(q, k, v, block_req, kv_len, q_pos,   \
                                     out, part, counters, nq, blk_q, hq,  \
                                     hkv, S, n_split, window, softcap,    \
                                     scale, s)
  if (blk_q == 1) {  // decode: 16 rows, 4 warps over a tile's slots
    if (dh == 64) RD_MMA(64, 1, 64);
    if (dh == 128) RD_MMA(128, 1, 64);
    if (dh == 192) RD_MMA(192, 1, 64);
    if (dh == 256) RD_MMA(256, 1, 64);
  } else {           // prefill: 64 rows, a warp's 16 over the whole tile
    if (dh == 64) RD_MMA(64, 4, 64);
    if (dh == 128) RD_MMA(128, 4, 64);
    if (dh == 192) RD_MMA(192, 4, 64);
    if (dh == 256) RD_MMA(256, 4, 32);
  }
#undef RD_MMA
  return cudaErrorInvalidValue;
}
