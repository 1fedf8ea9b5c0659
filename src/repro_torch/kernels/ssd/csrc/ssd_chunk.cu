// Mamba-2 SSD intra-chunk step, hand-written for Hopper (sm_90a): the
// forward, and its backward as a row kernel and a column kernel.
//
// Replaces the TPU kernel ssd_chunk of the JAX package
// (kernels/ssd/kernel.py:57, body _ssd_chunk_kernel at :25).  The TPU
// kernel has no backward; the two backward kernels compute the gradient
// of the same function, written by hand.  Per (batch, chunk, head) tile,
// with S = C·Bᵀ (head h reads group g = h / (H / G)):
//   dec[i,j] = exp(clip(csum_i - csum_j, -80, 0)) if i >= j and
//              nr_i == nr_j, else 0
//   y[i]     = sum_j S_ij · dec_ij · dt_j · x_j
//   e_j      = exp(clip(csum_end - csum_j, -80, 0)) · [nr_j == nr_end]
//   state    = sum_j (B_j · e_j · dt_j) x_jᵀ
// and, given dy and dstate, with W = S ∘ dec ∘ dt_j, u_j = e_j · dt_j,
// q_j = dstate x_j, s_j = B_j · q_j:
//   dW = dy·xᵀ          dS = dW ∘ dec ∘ dt_j
//   dC_i  = sum_j dS_ij B_j                      (row kernel)
//   dcsum_i += sum_{j != i} G_ij,  G_ij = dW S dt_j dec clip'(csum_i - csum_j)
//   dx_j  = sum_i W_ij dy_i + u_j · dstateᵀ B_j  (column kernel)
//   dB_j  = sum_i dS_ij C_i + u_j · q_j
//   ddt_j = sum_i dW_ij S_ij dec_ij + e_j · s_j
//   dcsum_j -= sum_{i != j} G_ij + H_j,
//              H_j = dt_j s_j e_j clip'(csum_end - csum_j)
//   dcsum_end += sum_{j != end} H_j              (a torch op sums hend)
// clip' is 1 strictly inside (-80, 0), 1/2 at a bound and 0 outside, as
// JAX differentiates jnp.clip.  On the diagonal (and at j = end) both
// sides of the difference are one variable, so those terms cancel and
// are left out.
//
// What bounds them on an H100 SXM (3.35 TB/s; 495 TFLOP/s for f32
// operands on the TF32 tensor cores, 67 TFLOP/s on the FMA pipes): at
// mamba2-370m's training shape (Bt 4, K 16, c 256, H 32, N 128, P 64,
// G 1), counting the live (i, j) pairs of a batch of long documents
// (~1.9 M, about half of c² per chunk) and C·Bᵀ, dC and dB once per
// group, the forward needs ~16 GFLOP and moves ~0.36 GB, the backward
// ~32 GFLOP and ~0.51 GB.  At the tensor-core rate bytes bound both
// (~0.11 and ~0.15 ms); on the FMA pipes operations would (~0.24 and
// ~0.48 ms).  This first design does its products on the f32 FMA pipes
// and computes C·Bᵀ, dC and dB per head, so it executes ~2.5x the
// forward's and ~3.5x the backward's needed FLOPs.  It keeps every
// intermediate in shared memory and registers: S, dec and W never reach
// device memory, and the G-sized C and B are read per head instead of
// being repeated H/G times in device memory.
//
// Design (simple and right first):
//   * 64-row tiles: one tile's C and B at c 256, N 128 in f32 are 128 KB
//     each, more than a CTA's 227 KB together, so the chunk is cut into
//     64-row i-tiles against the causal j-tiles <= i, as the flash
//     kernels tile q against kv.  256 threads as 16 x 16; a thread owns
//     rows ty + 16a and columns tx + 16b of every 64-wide tile product
//     (register tiles), reading shared memory with a row pitch of width
//     + 1 so that the 16 rows a warp reads lie in distinct banks.
//   * forward: one CTA per (batch·chunk, head, i-tile) for y, walking the
//     j-tiles <= i; one more CTA per (batch·chunk, head) for the end
//     state, walking all j-tiles.
//   * backward, no float atomics, each sum in one fixed order, so
//     repeated runs are bitwise equal: the row kernel has one CTA per
//     (batch·chunk, group, i-tile) and the column kernel one per
//     (batch·chunk, group, j-tile); each walks the group's heads in
//     order and folds dC (dB) over them in registers, as flash_bwd_dkv
//     folds GQA.  Each kernel writes its own part of dcsum.
//   * shared memory at N 128, P 64: forward 98 KiB, row kernel 115 KiB,
//     column kernel 164 KiB, dynamic, raised once per instantiation with
//     cudaFuncSetAttribute; a refused launch returns its error code.
//
// What the simple design gives up, each a later change: tensor cores
// (mma.sync / wgmma), one C·Bᵀ per group instead of per head (with G = 1
// all heads compute the same scores), cp.async / TMA loads overlapped
// with compute, and the end-state pass fused into the y CTAs.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.  All tensors f32
// (nr int32), contiguous: C, B, dC, dB [BK, c, G, N]; x, y, dy, dx
// [BK, c, H, P]; dt, csum, ddt, row, col, hend [BK, c, H]; nr [BK, c];
// states, dstate [BK, H, N, P], BK = batch x chunks.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // rows of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kClipLo = -80.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip(float d) {
  return fminf(fmaxf(d, kClipLo), 0.0f);
}

// d clip(d, -80, 0) / dd, JAX's convention at the bounds
__device__ __forceinline__ float clip_grad(float d) {
  if (d > kClipLo && d < 0.0f) return 1.0f;
  return (d == kClipLo || d == 0.0f) ? 0.5f : 0.0f;
}

// sum over the 16 lanes that share ty (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// copy `rows` rows of W floats (source row stride `stride`) into shared
// memory with row pitch `pitch`
template <int W>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src,
                                      size_t stride, int rows) {
  for (int idx = threadIdx.x; idx < rows * W; idx += kThreads) {
    const int r = idx / W, d = idx % W;
    dst[r * pitch + d] = src[(size_t)r * stride + d];
  }
}

// kT values of a [.., c, H] array (stride H) or of nr (stride 1)
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src,
                                          size_t stride) {
  for (int r = threadIdx.x; r < kT; r += kThreads) dst[r] = src[r * stride];
}

struct Args {
  const float* C;
  const float* B;
  const float* x;
  const float* dt;
  const float* csum;
  const int* nr;
  const float* dy;
  const float* dstate;
  float* y;
  float* states;
  float* dC;
  float* dB;
  float* dx;
  float* ddt;
  float* row;
  float* col;
  float* hend;
  int BK, c, H, G;
  cudaStream_t stream;
};

// acc[a][b] += sum_k A[(ty + 16a) * pa + k] * Bm[(tx + 16b) * pb + k]
template <int K>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         int pa, const float* Bm, int pb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * pa + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bm[(tx + 16 * b) * pb + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
  }
}

// ---------------------------------------------------------------- forward
template <int N, int P>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int c = a.c, H = a.H, G = a.G, nt = c / kT;
  const int bk = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row0 = (size_t)bk * c;      // first row of this chunk

  if ((int)blockIdx.y == nt) {
    // the chunk end state: sum_j B_j u_j x_jᵀ, n = ty + 16a, p = tx + 16b
    float* sB = smem;                      // [kT][N]
    float* sX = sB + kT * N;               // [kT][P]
    float* sU = sX + kT * P;               // [kT]
    const float cs_end = a.csum[(row0 + c - 1) * H + h];
    const int nr_end = a.nr[row0 + c - 1];
    float acc[N / 16][P / 16] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const size_t r0 = row0 + (size_t)jt * kT;
      __syncthreads();
      stage<N>(sB, N, a.B + (r0 * G + g) * N, (size_t)G * N, kT);
      stage<P>(sX, P, a.x + (r0 * H + h) * P, (size_t)H * P, kT);
      for (int j = threadIdx.x; j < kT; j += kThreads) {
        const size_t r = r0 + j;
        const float e = a.nr[r] == nr_end
                            ? expf(clip(cs_end - a.csum[r * H + h]))
                            : 0.0f;
        sU[j] = e * a.dt[r * H + h];
      }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        const float u = sU[j];
        float xv[P / 16];
#pragma unroll
        for (int b = 0; b < P / 16; ++b) xv[b] = sX[j * P + tx + 16 * b];
#pragma unroll
        for (int i = 0; i < N / 16; ++i) {
          const float bn = sB[j * N + ty + 16 * i] * u;
#pragma unroll
          for (int b = 0; b < P / 16; ++b) acc[i][b] += bn * xv[b];
        }
      }
    }
    float* out = a.states + ((size_t)bk * H + h) * N * P;
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
#pragma unroll
      for (int b = 0; b < P / 16; ++b)
        out[(ty + 16 * i) * P + tx + 16 * b] = acc[i][b];
    return;
  }

  // y of i-tile `it`: rows ty + 16a, columns p = tx + 16b
  const int it = blockIdx.y;
  constexpr int NP = N + 1, WP = kT + 1;
  float* sC = smem;                        // [kT][N+1] C_i
  float* sB = sC + kT * NP;                // [kT][N+1] B_j
  float* sX = sB + kT * NP;                // [kT][P]   x_j
  float* sW = sX + kT * P;                 // [kT][kT+1]
  float* sCsI = sW + kT * WP;
  float* sCsJ = sCsI + kT;
  float* sDtJ = sCsJ + kT;
  int* sNrI = reinterpret_cast<int*>(sDtJ + kT);
  int* sNrJ = sNrI + kT;
  const size_t ri = row0 + (size_t)it * kT;
  stage<N>(sC, NP, a.C + (ri * G + g) * N, (size_t)G * N, kT);
  stage_vec(sCsI, a.csum + ri * H + h, H);
  stage_vec(sNrI, a.nr + ri, 1);
  float acc[4][P / 16] = {};
  for (int jt = 0; jt <= it; ++jt) {
    const size_t rj = row0 + (size_t)jt * kT;
    __syncthreads();
    stage<N>(sB, NP, a.B + (rj * G + g) * N, (size_t)G * N, kT);
    stage<P>(sX, P, a.x + (rj * H + h) * P, (size_t)H * P, kT);
    stage_vec(sCsJ, a.csum + rj * H + h, H);
    stage_vec(sDtJ, a.dt + rj * H + h, H);
    stage_vec(sNrJ, a.nr + rj, 1);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<N>(s, sC, NP, sB, NP);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ii = ty + 16 * i, jj = tx + 16 * b;
        float w = 0.0f;
        if (it * kT + ii >= jt * kT + jj && sNrI[ii] == sNrJ[jj])
          w = s[i][b] * expf(clip(sCsI[ii] - sCsJ[jj])) * sDtJ[jj];
        sW[ii * WP + jj] = w;
      }
    __syncthreads();
    for (int j = 0; j < kT; ++j) {
      float xv[P / 16];
#pragma unroll
      for (int b = 0; b < P / 16; ++b) xv[b] = sX[j * P + tx + 16 * b];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = sW[(ty + 16 * i) * WP + j];
#pragma unroll
        for (int b = 0; b < P / 16; ++b) acc[i][b] += w * xv[b];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < P / 16; ++b)
      a.y[((ri + ty + 16 * i) * H + h) * P + tx + 16 * b] = acc[i][b];
}

// -------------------------------------------------- backward: row kernel
// one CTA per (batch·chunk, group, i-tile): dC_i folded over the group's
// heads, and each head's row part of dcsum
template <int N, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dc_kernel(Args a) {
  extern __shared__ float smem[];
  const int c = a.c, H = a.H, G = a.G, rep = H / G;
  const int bk = blockIdx.x / G, g = blockIdx.x % G, it = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int NP = N + 1, PP = P + 1, WP = kT + 1;
  float* sC = smem;                        // [kT][N+1] C_i
  float* sB = sC + kT * NP;                // [kT][N+1] B_j
  float* sDy = sB + kT * NP;               // [kT][P+1] dy_i
  float* sX = sDy + kT * PP;               // [kT][P+1] x_j
  float* sDS = sX + kT * PP;               // [kT][kT+1] dS
  float* sCsI = sDS + kT * WP;
  float* sCsJ = sCsI + kT;
  float* sDtJ = sCsJ + kT;
  int* sNrI = reinterpret_cast<int*>(sDtJ + kT);
  int* sNrJ = sNrI + kT;
  const size_t row0 = (size_t)bk * c, ri = row0 + (size_t)it * kT;
  stage<N>(sC, NP, a.C + (ri * G + g) * N, (size_t)G * N, kT);
  stage_vec(sNrI, a.nr + ri, 1);
  float dc[4][N / 16] = {};
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    __syncthreads();
    stage<P>(sDy, PP, a.dy + (ri * H + h) * P, (size_t)H * P, kT);
    stage_vec(sCsI, a.csum + ri * H + h, H);
    float rowg[4] = {};
    for (int jt = 0; jt <= it; ++jt) {
      const size_t rj = row0 + (size_t)jt * kT;
      __syncthreads();
      stage<N>(sB, NP, a.B + (rj * G + g) * N, (size_t)G * N, kT);
      stage<P>(sX, PP, a.x + (rj * H + h) * P, (size_t)H * P, kT);
      stage_vec(sCsJ, a.csum + rj * H + h, H);
      stage_vec(sDtJ, a.dt + rj * H + h, H);
      stage_vec(sNrJ, a.nr + rj, 1);
      __syncthreads();
      float s[4][4] = {}, dw[4][4] = {};
      tile_dot<N>(s, sC, NP, sB, NP);
      tile_dot<P>(dw, sDy, PP, sX, PP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int ii = ty + 16 * i, jj = tx + 16 * b;
          const int gi = it * kT + ii, gj = jt * kT + jj;
          float ds = 0.0f;
          if (gi >= gj && sNrI[ii] == sNrJ[jj]) {
            const float d = sCsI[ii] - sCsJ[jj];
            const float dec = expf(clip(d)), dtj = sDtJ[jj];
            ds = dw[i][b] * dec * dtj;
            if (gi != gj)
              rowg[i] += dw[i][b] * s[i][b] * dtj * dec * clip_grad(d);
          }
          sDS[ii * WP + jj] = ds;
        }
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        float bv[N / 16];
#pragma unroll
        for (int b = 0; b < N / 16; ++b) bv[b] = sB[j * NP + tx + 16 * b];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ds = sDS[(ty + 16 * i) * WP + j];
#pragma unroll
          for (int b = 0; b < N / 16; ++b) dc[i][b] += ds * bv[b];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = sum16(rowg[i]);
      if (tx == 0) a.row[(ri + ty + 16 * i) * H + h] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < N / 16; ++b)
      a.dC[((ri + ty + 16 * i) * G + g) * N + tx + 16 * b] = dc[i][b];
}

// ----------------------------------------------- backward: column kernel
// one CTA per (batch·chunk, group, j-tile): dB_j folded over the group's
// heads; per head dx_j, ddt_j, the column part of dcsum and the end
// state's terms.  Tile products are transposed (rows j, columns i) so
// that the sums over i are a thread's own and its 16 lanes'.
template <int N, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dbx_kernel(Args a) {
  extern __shared__ float smem[];
  const int c = a.c, H = a.H, G = a.G, rep = H / G, nt = c / kT;
  const int bk = blockIdx.x / G, g = blockIdx.x % G, jt = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  constexpr int NP = N + 1, PP = P + 1, WP = kT + 1;
  float* sBj = smem;                       // [kT][N+1] B_j
  float* sCi = sBj + kT * NP;              // [kT][N+1] C_i
  float* sXj = sCi + kT * NP;              // [kT][P+1] x_j
  float* sDyI = sXj + kT * PP;             // [kT][P+1] dy_i
  float* sDst = sDyI + kT * PP;            // [N][P+1]  dstate
  float* sW = sDst + N * PP;               // [kT][kT+1] W (rows j)
  float* sDS = sW + kT * WP;               // [kT][kT+1] dS (rows j)
  float* sCsJ = sDS + kT * WP;
  float* sDtJ = sCsJ + kT;
  float* sE = sDtJ + kT;                   // e_j
  float* sDend = sE + kT;                  // csum_end - csum_j
  float* sCsI = sDend + kT;
  int* sNrJ = reinterpret_cast<int*>(sCsI + kT);
  int* sNrI = sNrJ + kT;
  const size_t row0 = (size_t)bk * c, rj = row0 + (size_t)jt * kT;
  const int nr_end = a.nr[row0 + c - 1];
  stage<N>(sBj, NP, a.B + (rj * G + g) * N, (size_t)G * N, kT);
  stage_vec(sNrJ, a.nr + rj, 1);
  float db[4][N / 16] = {};
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const float cs_end = a.csum[(row0 + c - 1) * H + h];
    __syncthreads();
    stage<P>(sXj, PP, a.x + (rj * H + h) * P, (size_t)H * P, kT);
    stage<P>(sDst, PP, a.dstate + ((size_t)bk * H + h) * N * P, P, N);
    stage_vec(sCsJ, a.csum + rj * H + h, H);
    stage_vec(sDtJ, a.dt + rj * H + h, H);
    __syncthreads();
    for (int j = threadIdx.x; j < kT; j += kThreads) {
      const float d = cs_end - sCsJ[j];
      sDend[j] = d;
      sE[j] = sNrJ[j] == nr_end ? expf(clip(d)) : 0.0f;
    }
    float dxa[4][P / 16] = {};
    float ddtp[4] = {}, colg[4] = {};
    for (int it = jt; it < nt; ++it) {
      const size_t ri = row0 + (size_t)it * kT;
      __syncthreads();
      stage<N>(sCi, NP, a.C + (ri * G + g) * N, (size_t)G * N, kT);
      stage<P>(sDyI, PP, a.dy + (ri * H + h) * P, (size_t)H * P, kT);
      stage_vec(sCsI, a.csum + ri * H + h, H);
      stage_vec(sNrI, a.nr + ri, 1);
      __syncthreads();
      float s[4][4] = {}, dw[4][4] = {};
      tile_dot<N>(s, sBj, NP, sCi, NP);      // S_ij at [j][i]
      tile_dot<P>(dw, sXj, PP, sDyI, PP);    // dW_ij at [j][i]
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = ty + 16 * j, ii = tx + 16 * b;
          const int gi = it * kT + ii, gj = jt * kT + jj;
          float w = 0.0f, ds = 0.0f;
          if (gi >= gj && sNrI[ii] == sNrJ[jj]) {
            const float d = sCsI[ii] - sCsJ[jj];
            const float dec = expf(clip(d)), dtj = sDtJ[jj];
            w = s[j][b] * dec * dtj;
            ds = dw[j][b] * dec * dtj;
            ddtp[j] += dw[j][b] * s[j][b] * dec;
            if (gi != gj)
              colg[j] += dw[j][b] * s[j][b] * dtj * dec * clip_grad(d);
          }
          sW[jj * WP + ii] = w;
          sDS[jj * WP + ii] = ds;
        }
      __syncthreads();
      for (int i = 0; i < kT; ++i) {
        float dyv[P / 16], cv[N / 16];
#pragma unroll
        for (int b = 0; b < P / 16; ++b) dyv[b] = sDyI[i * PP + tx + 16 * b];
#pragma unroll
        for (int b = 0; b < N / 16; ++b) cv[b] = sCi[i * NP + tx + 16 * b];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = sW[(ty + 16 * j) * WP + i];
          const float ds = sDS[(ty + 16 * j) * WP + i];
#pragma unroll
          for (int b = 0; b < P / 16; ++b) dxa[j][b] += w * dyv[b];
#pragma unroll
          for (int b = 0; b < N / 16; ++b) db[j][b] += ds * cv[b];
        }
      }
    }
    // the end state's terms: q_j = dstate x_j (n = tx + 16b), then
    // dB_j += u_j q_j and s_j = B_j · q_j
    float sp[4] = {};
    {
      float q[4][N / 16] = {};
      for (int p = 0; p < P; ++p) {
        float xv[4], dv[N / 16];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sXj[(ty + 16 * j) * PP + p];
#pragma unroll
        for (int b = 0; b < N / 16; ++b) dv[b] = sDst[(tx + 16 * b) * PP + p];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < N / 16; ++b) q[j][b] += xv[j] * dv[b];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = ty + 16 * j;
        const float u = sE[jj] * sDtJ[jj];
#pragma unroll
        for (int b = 0; b < N / 16; ++b) {
          db[j][b] += u * q[j][b];
          sp[j] += sBj[jj * NP + tx + 16 * b] * q[j][b];
        }
      }
    }
    // dx_j += u_j · dstateᵀ B_j (p = tx + 16b)
    {
      float rr[4][P / 16] = {};
      for (int n = 0; n < N; ++n) {
        float bv[4], dv[P / 16];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sBj[(ty + 16 * j) * NP + n];
#pragma unroll
        for (int b = 0; b < P / 16; ++b) dv[b] = sDst[n * PP + tx + 16 * b];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int b = 0; b < P / 16; ++b) rr[j][b] += bv[j] * dv[b];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = ty + 16 * j;
        const float u = sE[jj] * sDtJ[jj];
#pragma unroll
        for (int b = 0; b < P / 16; ++b)
          a.dx[((rj + jj) * H + h) * P + tx + 16 * b] =
              dxa[j][b] + u * rr[j][b];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = ty + 16 * j;
      const float sj = sum16(sp[j]);
      const float ddt = sum16(ddtp[j]);
      const float cg = sum16(colg[j]);
      if (tx == 0) {
        const float e = sE[jj];
        const float hj = jt * kT + jj == c - 1
                             ? 0.0f
                             : sDtJ[jj] * sj * e * clip_grad(sDend[jj]);
        const size_t o = (rj + jj) * H + h;
        a.ddt[o] = ddt + e * sj;
        a.col[o] = -cg - hj;
        a.hend[o] = hj;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < N / 16; ++b)
      a.dB[((rj + ty + 16 * j) * G + g) * N + tx + 16 * b] = db[j][b];
}

// ------------------------------------------------------------------ host
template <int N, int P>
size_t smem_bytes(int which) {
  constexpr int NP = N + 1, PP = P + 1, WP = kT + 1;
  size_t floats = 0;
  if (which == 0) {
    const size_t y = 2 * kT * NP + kT * P + kT * WP + 5 * kT;
    const size_t st = kT * N + kT * P + kT;
    floats = y > st ? y : st;
  } else if (which == 1) {
    floats = 2 * kT * NP + 2 * kT * PP + kT * WP + 5 * kT;
  } else {
    floats = 2 * kT * NP + 2 * kT * PP + N * PP + 2 * kT * WP + 7 * kT;
  }
  return floats * sizeof(float);
}

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

// which: 0 = forward, 1 = row kernel, 2 = column kernel
template <int N, int P>
cudaError_t launch(int which, const Args& a) {
  static bool configured[3] = {false, false, false};
  const size_t bytes = smem_bytes<N, P>(which);
  const int nt = a.c / kT;
  cudaError_t e;
  if (which == 0) {
    e = raise_smem(ssd_fwd_kernel<N, P>, bytes, &configured[0]);
    if (e != cudaSuccess) return e;
    ssd_fwd_kernel<N, P><<<dim3(a.BK * a.H, nt + 1), kThreads, bytes,
                           a.stream>>>(a);
  } else if (which == 1) {
    e = raise_smem(ssd_bwd_dc_kernel<N, P>, bytes, &configured[1]);
    if (e != cudaSuccess) return e;
    ssd_bwd_dc_kernel<N, P><<<dim3(a.BK * a.G, nt), kThreads, bytes,
                              a.stream>>>(a);
  } else {
    e = raise_smem(ssd_bwd_dbx_kernel<N, P>, bytes, &configured[2]);
    if (e != cudaSuccess) return e;
    ssd_bwd_dbx_kernel<N, P><<<dim3(a.BK * a.G, nt), kThreads, bytes,
                               a.stream>>>(a);
  }
  return cudaGetLastError();
}

int dispatch(int which, int N, int P, const Args& a) {
  if (a.BK < 1 || a.c < kT || a.c % kT != 0 || a.G < 1 || a.H < a.G ||
      a.H % a.G != 0)
    return cudaErrorInvalidValue;
#define SSD_CASE(NN, PP) \
  if (N == NN && P == PP) return (int)launch<NN, PP>(which, a)
  SSD_CASE(32, 32);
  SSD_CASE(32, 64);
  SSD_CASE(64, 32);
  SSD_CASE(64, 64);
  SSD_CASE(128, 32);
  SSD_CASE(128, 64);
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const void* C, const void* B, const void* x, const void* dt,
               const void* csum, const void* nr, int BK, int c, int H, int G,
               void* stream) {
  Args a{};
  a.C = static_cast<const float*>(C);
  a.B = static_cast<const float*>(B);
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.csum = static_cast<const float*>(csum);
  a.nr = static_cast<const int*>(nr);
  a.BK = BK;
  a.c = c;
  a.H = H;
  a.G = G;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" int ssd_chunk_fwd(const void* C, const void* B, const void* x,
                             const void* dt, const void* csum,
                             const void* nr, void* y, void* states, int BK,
                             int c, int H, int G, int N, int P,
                             void* stream) {
  Args a = make_args(C, B, x, dt, csum, nr, BK, c, H, G, stream);
  a.y = static_cast<float*>(y);
  a.states = static_cast<float*>(states);
  return dispatch(0, N, P, a);
}

// row: the csum_i part of dcsum, [BK, c, H]
extern "C" int ssd_chunk_bwd_dc(const void* C, const void* B, const void* x,
                                const void* dt, const void* csum,
                                const void* nr, const void* dy, void* dC,
                                void* row, int BK, int c, int H, int G,
                                int N, int P, void* stream) {
  Args a = make_args(C, B, x, dt, csum, nr, BK, c, H, G, stream);
  a.dy = static_cast<const float*>(dy);
  a.dC = static_cast<float*>(dC);
  a.row = static_cast<float*>(row);
  return dispatch(1, N, P, a);
}

// col: the csum_j part of dcsum with -H_j; hend: H_j, which the caller
// sums into dcsum at the chunk's last row
extern "C" int ssd_chunk_bwd_dbx(const void* C, const void* B, const void* x,
                                 const void* dt, const void* csum,
                                 const void* nr, const void* dy,
                                 const void* dstate, void* dB, void* dx,
                                 void* ddt, void* col, void* hend, int BK,
                                 int c, int H, int G, int N, int P,
                                 void* stream) {
  Args a = make_args(C, B, x, dt, csum, nr, BK, c, H, G, stream);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dB = static_cast<float*>(dB);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.col = static_cast<float*>(col);
  a.hend = static_cast<float*>(hend);
  return dispatch(2, N, P, a);
}
