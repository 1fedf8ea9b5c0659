// Pieces shared by the kernels of flash.cu and ca_server.cu: the f32
// kernels' rows a CTA, and the bf16 kernels' tile pieces (the group rows
// of a CTA, the position spans a warp classifies a tile by, the cp.async
// ring stage of K/V tiles and the forward's online-softmax step in exp2;
// the two mma.sync products, S = A B^T and acc += P B from the score
// registers, are mma_abt and mma_pb of kernels/csrc/mma.cuh).  Each file
// keeps its own mask arithmetic; these pieces hold none of it.
#pragma once

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // f32: kv slots (fwd, dq) or q rows (dk/dv) a tile

// the f32 kernels' own rows a CTA: q rows (fwd, dq) or kv rows (dk/dv);
// fewer at dh 192/256, where 64 rows of f32 staging do not fit in shared
// memory
template <int DH>
struct Rows {
  static constexpr int kQ = DH <= 128 ? 64 : 32;
  static constexpr int kKV = DH <= 128 ? 64 : 16;
  static_assert(kTile % kQ == 0 && kTile % kKV == 0, "rows divide tiles");
};

constexpr float kLn2 = 0.6931471805599453f;

// What a set of q rows or kv slots holds: the segment ids and positions
// of its live entries (seg > 0) and whether any entry is padding.
struct Span {
  int smin, smax, pmin, pmax, dead;
};

__device__ __forceinline__ Span span_empty() {
  return Span{INT_MAX, 0, INT_MAX, INT_MIN, 0};
}

__device__ __forceinline__ void span_add(Span& s, int seg, int pos) {
  const bool live = seg > 0;
  s.smin = min(s.smin, live ? seg : INT_MAX);
  s.smax = max(s.smax, seg);
  s.pmin = min(s.pmin, live ? pos : INT_MAX);
  s.pmax = max(s.pmax, live ? pos : INT_MIN);
  s.dead |= !live;
}

// the span of every lane's entries, on every lane
__device__ __forceinline__ Span span_warp(Span s) {
  s.smin = __reduce_min_sync(kFull, s.smin);
  s.smax = __reduce_max_sync(kFull, s.smax);
  s.pmin = __reduce_min_sync(kFull, s.pmin);
  s.pmax = __reduce_max_sync(kFull, s.pmax);
  s.dead = __reduce_or_sync(kFull, (unsigned)s.dead);
  return s;
}

// a warp tile's class: no visible pair (skipped, an exact no-op), every
// pair visible (no mask arithmetic), each pair's token terms tested, or
// each pair tested whole
enum { kNone = 0, kAll = 1, kTokens = 2, kSome = 3 };

// Row tiles of the bf16 forward and dq kernels: each CTA row is a (q row,
// q head) pair of batch row b over kv head g's rep heads, q row major, so
// a CTA's rows share every K/V tile it loads.  (ca_server.cu: b is the
// task, Sq its block's blk q rows.)
struct GroupRows {
  int b, g, rep, Sq, hq;
  __device__ __forceinline__ int qrow(int gr) const { return gr / rep; }
  __device__ __forceinline__ int head(int gr) const {
    return g * rep + gr % rep;
  }
  // element offset of group row gr in q, out, dout, dq [B, Sq, hq, DH]
  __device__ __forceinline__ size_t off(int gr, int dh) const {
    return (((size_t)b * Sq + qrow(gr)) * hq + head(gr)) * dh;
  }
  // index of group row gr in lse, delta [B, hq, Sq]
  __device__ __forceinline__ size_t stat(int gr) const {
    return ((size_t)b * hq + head(gr)) * Sq + qrow(gr);
  }
  // index of group row gr's q row in the row metadata [B, Sq]
  __device__ __forceinline__ size_t row(int gr) const {
    return (size_t)b * Sq + qrow(gr);
  }
};

// a column tile of BN kv slots in the ring: K, V [BN][PITCH] bf16, then
// the slots' segment ids and positions
template <int DH, int BN>
struct KvStage {
  static constexpr int PITCH = DH + kPad;
  static constexpr size_t bytes =
      sizeof(bf16) * 2 * BN * PITCH + sizeof(int) * 2 * BN;
  bf16 *k, *v;
  int *seg, *pos;
  __device__ __forceinline__ KvStage(unsigned char* base) {
    k = reinterpret_cast<bf16*>(base);
    v = k + BN * PITCH;
    seg = reinterpret_cast<int*>(v + BN * PITCH);
    pos = seg + BN;
  }
  // rows [row0, row0 + BN) of a [rows, hkv, DH] buffer at kv head g, and
  // their positions (ca_server.cu: no segment ids, seg left unwritten)
  __device__ __forceinline__ void load_rows(const bf16* kg, const bf16* vg,
                                            const int32_t* pos_kv,
                                            size_t row0, int g, int hkv) {
    constexpr int CHUNKS = DH / 8;  // 16-byte chunks of a row
    for (int c = threadIdx.x; c < BN * CHUNKS; c += kMmaThreads) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const size_t off = ((row0 + r) * hkv + g) * DH + col;
      cp_async16(k + r * PITCH + col, kg + off, 16);
      cp_async16(v + r * PITCH + col, vg + off, 16);
    }
    for (int c = threadIdx.x; c < BN / 4; c += kMmaThreads)
      cp_async16(pos + 4 * c, pos_kv + row0 + 4 * c, 16);
  }
  // slots [s0, s0 + BN) of batch row b, kv head g, with their segment ids
  __device__ __forceinline__ void load(const bf16* kg, const bf16* vg,
                                       const int32_t* seg_kv,
                                       const int32_t* pos_kv, int b, int g,
                                       int Skv, int hkv, int s0) {
    const size_t row0 = (size_t)b * Skv + s0;
    load_rows(kg, vg, pos_kv, row0, g, hkv);
    for (int c = threadIdx.x; c < BN / 4; c += kMmaThreads)
      cp_async16(seg + 4 * c, seg_kv + row0 + 4 * c, 16);
  }
};

// One kv tile of the forward's online softmax, FA2-style in registers:
// sc holds the warp tile's raw dot products, ok its visible pairs (bit n
// * 4 + e for element e of n8 tile n).  The logits are scaled and
// softcapped and the softmax runs in log2 units (exp2); on return sc holds
// p (0 on masked pairs), the thread's row maxima m and partial sums l are
// updated, and the accumulators o are rescaled for the new maxima (the
// caller then adds P V).
template <int NT, int DT>
__device__ __forceinline__ void softmax_step(float (&sc)[NT][4], uint32_t ok,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[DT][4], float scale,
                                             float softcap) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
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
}

}  // namespace
