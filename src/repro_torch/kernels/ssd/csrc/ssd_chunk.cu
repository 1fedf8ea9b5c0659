// Mamba-2 SSD intra-chunk step, hand-written for Hopper (sm_90a): a
// forward and its backward, in two designs chosen by the dtype of C, B
// and x: bf16 (the training path) on the tensor cores, f32 on the exact
// FMA pipes.
//
// Replaces the TPU kernel ssd_chunk of the JAX package
// (kernels/ssd/kernel.py:57, body _ssd_chunk_kernel at :25).  The TPU
// kernel has no backward; the backward kernels compute the gradient of
// the same function, written by hand.  Per (batch, chunk, head) tile,
// with S = C·Bᵀ (head h reads group g = h / (H / G)):
//   dec[i,j] = exp(clip(csum_i - csum_j, -80, 0)) if i >= j and
//              nr_i == nr_j, else 0
//   y[i]     = sum_j S_ij · dec_ij · dt_j · x_j
//   e_j      = exp(clip(csum_end - csum_j, -80, 0)) · [nr_j == nr_end]
//   state    = sum_j (B_j · e_j · dt_j) x_jᵀ
// and, given dy and dstate, with W = S ∘ dec ∘ dt_j, u_j = e_j · dt_j,
// q_j = dstate x_j, s_j = B_j · q_j:
//   dW = dy·xᵀ          dS = dW ∘ dec ∘ dt_j
//   dC_i  = sum_j dS_ij B_j
//   dcsum_i += sum_{j != i} G_ij,  G_ij = dW S dt_j dec clip'(csum_i - csum_j)
//   dx_j  = sum_i W_ij dy_i + u_j · dstateᵀ B_j
//   dB_j  = sum_i dS_ij C_i + u_j · q_j
//   ddt_j = sum_i dW_ij S_ij dec_ij + e_j · s_j
//   dcsum_j -= sum_{i != j} G_ij + H_j,
//              H_j = dt_j s_j e_j clip'(csum_end - csum_j)
//   dcsum_end += sum_{j != end} H_j
// clip' is 1 strictly inside (-80, 0), 1/2 at a bound and 0 outside, as
// JAX differentiates jnp.clip.  On the diagonal (and at j = end) both
// sides of the difference are one variable, so those terms cancel and
// are left out.  dC and dB sum over the group's heads.
//
// What bounds them on an H100 SXM (3.35 TB/s; 989 TFLOP/s for bf16
// operands on the tensor cores, 495 for f32 ones on the TF32 tensor
// cores, 67 TFLOP/s on the FMA pipes): at mamba2-370m's training shape
// (Bt 4, K 16, c 256, H 32, N 128, P 64, G 1), counting the live (i, j)
// pairs of a batch of long documents (~1.9 M, about half of c² per chunk)
// and C·Bᵀ, dC and dB once per group, the forward needs ~16 GFLOP, the
// backward ~32 GFLOP; bytes bound both at the tensor-core rate (f32
// inputs: ~0.36 and ~0.51 GB, ~0.11 and ~0.15 ms; bf16 C, B, x move less,
// chip_smoke.py phase 12 counts it).
//
// f32 (the first design, kept bit for bit for the exactness checks: its
// forward sums in the order cuBLAS's f32 products do, so mamba2's einsum
// and kernel routes agree bitwise in f32): the products on the f32 FMA
// pipes, C·Bᵀ per head.
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
//     folds GQA.  Each kernel writes its own part of dcsum, and
//     ssd_dcsum_kernel folds them into dcsum.
//   * shared memory at N 128, P 64: forward 98 KiB, row kernel 115 KiB,
//     column kernel 164 KiB, dynamic, raised once per instantiation with
//     cudaFuncSetAttribute; a refused launch returns its error code.
// It executes ~2.5x the forward's and ~3.5x the backward's needed FLOPs
// and runs 22x and 57x off the bound there.
//
// bf16 (the section "bf16: tensor-core kernels" below): what held the
// f32 design back, and what the bf16 one does about it:
//   * scalar FMA products -> mma.sync m16n8k16 on ldmatrix fragments, f32
//     accumulators, cp.async loads of the bf16 tiles;
//   * C·Bᵀ per head -> once per (chunk, group, i-tile, j-tile) in the
//     forward (the CTA walks all the group's heads over it) and once per
//     CTA of a head part in the backward, kept in shared memory;
//   * a separate end-state pass re-reading B and x -> folded into the CTAs
//     of the last i-tile, over the B and x tiles they hold;
//   * 256 backward CTAs, 1 an SM, walking 32 heads -> the heads split into
//     parts (1024 CTAs at mamba2's shape), the parts' dC, dB and dcsum
//     pieces summed in one fixed order by a fold kernel: no float atomics;
//   * dcsum assembled by torch ops -> written whole by the kernels;
//   * tile pairs across a document boundary computed then masked ->
//     skipped when the tiles' reset counts do not meet.
//
// C interface (loaded with ctypes): each function launches on the
// caller's stream and returns cudaGetLastError(); anything it does not
// cover returns cudaErrorInvalidValue without launching.  f32 kernels:
// all tensors f32 (nr int32), contiguous: C, B, dC, dB [BK, c, G, N]; x,
// y, dy, dx [BK, c, H, P]; dt, csum, ddt, row, col, hend, dcsum [BK, c,
// H]; nr [BK, c]; states, dstate [BK, H, N, P], BK = batch x chunks.  bf16
// kernels: C, B and x bf16, the rest as for f32 (gradients f32), with the
// backward's scratch described at ssd_chunk_bwd_part_bf16.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "mma.cuh"

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

// ============================================ bf16: tensor-core kernels
// C, B and x in bf16 (the model's compute dtype: they come out of a bf16
// projection and causal conv, so the TPU kernel's in-kernel f32 cast of
// them is exact); dt, csum, dy, dstate f32, nr int32; every output f32.
// Three kernels, CTAs of 8 warps: warp w owns the tile rows 16 (w % 4) ..
// +16 (its row group rg) and half w / 4 of the columns or heads.  Every
// product runs on the tensor cores, mma.sync m16n8k16 on ldmatrix /
// ldmatrix.trans fragments with f32 accumulators (mma.cuh); the decays,
// masks and clip derivatives are computed in f32 registers as the FMA
// kernels compute them.  The chunk is cut into 64-row tiles (c <= 256, up
// to 4 tiles); a tile pair (i, j) whose ranges of reset counts nr do not
// meet holds no live pair and is skipped whole.

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kT;

// per 64-row tile of the chunk, the least and largest reset count: sNr
// [c] in shared memory, lo / hi [nt] written by warps 0..nt-1
__device__ __forceinline__ void tile_ranges(const int* sNr, int* lo, int* hi,
                                            int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nt) {
    int a = INT_MAX, b = INT_MIN;
    for (int r = lane; r < kT; r += 32) {
      const int v = sNr[warp * kT + r];
      a = min(a, v);
      b = max(b, v);
    }
    a = __reduce_min_sync(kFull, a);
    b = __reduce_max_sync(kFull, b);
    if (lane == 0) {
      lo[warp] = a;
      hi[warp] = b;
    }
  }
}

// a live pair (i >= j, nr_i == nr_j) may lie in tiles a and b only if
// their nr ranges meet (nr counts resets, so it never falls along a chunk)
__device__ __forceinline__ bool tiles_meet(const int* lo, const int* hi,
                                           int a, int b) {
  return lo[a] <= hi[b] && lo[b] <= hi[a];
}

// index of the tile pair (i, j <= i) in the lower triangle
__device__ __forceinline__ int tile_pair(int i, int j) {
  return i * (i + 1) / 2 + j;
}

struct MArgs {
  const bf16 *C, *B, *x;
  const float *dt, *csum;
  const int* nr;
  const float *dy, *dstate;
  float *y, *states, *dC, *dB, *dx, *ddt, *dcsum;
  float *dsp, *dbp, *rowp, *hsum;  // backward scratch (see the kernels)
  int BK, c, H, G, n_parts;
  cudaStream_t stream;
};

// cp.async `rows` rows of W bf16 (source row stride `stride` elements)
// into shared memory rows of pitch W + kPad
template <int W>
__device__ __forceinline__ void load_bf16_rows(bf16* dst, const bf16* src,
                                               size_t stride, int rows) {
  constexpr int CH = W / 8;        // 16-byte chunks of a row
  for (int q = threadIdx.x; q < rows * CH; q += kThreads) {
    const int r = q / CH, col = (q % CH) * 8;
    cp_async16(dst + r * (W + kPad) + col, src + (size_t)r * stride + col, 16);
  }
}

// `rows` rows of W f32 (row stride `stride`) rounded to bf16 into shared
// memory rows of pitch W + kPad, through registers
template <int W>
__device__ __forceinline__ void stage_f32_rows(bf16* dst, const float* src,
                                               size_t stride, int rows) {
  constexpr int Q = W / 4;         // float4s of a row
  for (int q = threadIdx.x; q < rows * Q; q += kThreads) {
    const int r = q / Q, col = (q % Q) * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        src + (size_t)r * stride + col);
    uint2 packed;
    packed.x = pack_bf16(v.x, v.y);
    packed.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(dst + r * (W + kPad) + col) = packed;
  }
}

// a fragment-order slot of a 64 x 64 f32 tile in shared memory: warp (rg,
// half) keeps its 16 x 32 accumulator block there, element e of n8 tile n
// of lane `lane`, so each lane reads and writes consecutive words
__device__ __forceinline__ int frag(int rg, int half, int n, int e, int lane) {
  return (((rg * 2 + half) * 4 + n) * 4 + e) * 32 + lane;
}

// acc (16 rows x DT n8 tiles from column tile d0) += A (16 rows of a_s,
// row-major over K) . B (K rows of b_s, row-major), both bf16 in shared
// memory with pitches PA and PB
template <int K, int PA, int PB, int DT>
__device__ __forceinline__ void mma_ab(float (&acc)[DT][4], const bf16* a_s,
                                       const bf16* b_s, int d0, int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (lane & 15) * PA + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, b_s + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PB +
                 (d0 + d) * 8 + (lane >> 4) * 8);
      mma_bf16(acc[d], a, b[0], b[1]);
      mma_bf16(acc[d + 1], a, b[2], b[3]);
    }
  }
}

// an f32 pair as three bf16 pairs, hi + mid + lo: each term takes the
// next 8 significant bits of what the ones before left, so the three
// carry an f32's 24 and a product of them with a bf16 operand is the f32
// product, up to the order of the sums
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  mid = pack_bf16(r0, r1);
  const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(&mid);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

// acc (16 rows x DT n8 tiles) += P (16 x BN, from the score registers, as
// three bf16 terms: split3) . B (BN rows of b_s, row-major bf16, pitch DH
// + kPad): mma_pb's product at f32 precision, the small terms first
template <int DH, int BN, int DT>
__device__ __forceinline__ void mma_pb3(float (&acc)[DT][4],
                                        const float (&p)[BN / 8][4],
                                        const bf16* b_s, int lane) {
  constexpr int PITCH = DH + kPad;
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) {
    uint32_t a[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* e = p[2 * kc + (i >> 1)] + 2 * (i & 1);
      split3(e[0], e[1], a[0][i], a[1][i], a[2][i]);
    }
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, b_s + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PITCH +
                 d * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int t = 2; t >= 0; --t) {
        mma_bf16(acc[d], a[t], b[0], b[1]);
        mma_bf16(acc[d + 1], a[t], b[2], b[3]);
      }
    }
  }
}

// ------------------------------------------------------ bf16: forward
// ssd_fwd_mma_kernel: a CTA per (batch·chunk, group, i-tile), the i-tiles
// of the last tile first (those CTAs do the most work).  S = C_i·B_jᵀ is
// computed once per live j-tile <= i for all the group's heads and kept
// in shared memory (f32, fragment order); then the two warp halves walk
// the group's heads two at a time through a 2-stage cp.async ring of x
// tiles: W = S ∘ dec ∘ dt_j formed in registers, y += W·x with W as three
// bf16 terms (split3: the product at f32 precision).  The CTA of the last
// i-tile also folds in the chunk end state, state += (B_j ∘ u_j)ᵀ·x_j over
// the j-tiles that reach the end, B ∘ u as three bf16 terms: B and x are
// tiles it holds already.  The TPU kernel forms these products in f32;
// three terms keep them f32 (two, hi + lo, leave ~2**-18 of each W), so y
// and the states match the plain version to f32 rounding.
template <int N, int P>
struct FwdMma {
  static constexpr int NP = N + kPad, PP = P + kPad;
  // the end state's [N][P] tile over a half's 4 warps
  static constexpr int WM = N / 16 < 4 ? N / 16 : 4;  // warps over n
  static constexpr int MW = N / 16 / WM;              // m16 tiles a warp
  static constexpr int NW = P / 8 / (4 / WM);         // n8 tiles a warp
  static_assert(NW % 2 == 0, "n8 tiles come in pairs");
  static constexpr size_t x_bytes = sizeof(bf16) * kT * PP;
  // a stage: x of two heads, then csum_i, csum_j, dt_j of each
  static constexpr size_t stage_bytes = 2 * x_bytes + sizeof(float) * 6 * kT;
  static size_t smem(int c) {
    const int nt = c / kT;
    return sizeof(bf16) * (size_t)(kT + c) * NP +
           sizeof(float) * (size_t)nt * kT * kT + 2 * stage_bytes +
           sizeof(int) * (size_t)(c + 2 * nt);
  }
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_mma_kernel(MArgs a) {
  using L = FwdMma<N, P>;
  constexpr int NP = L::NP, PP = L::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = a.c, H = a.H, G = a.G, rep = H / G, nt = c / kT;
  const int nbg = a.BK * G;
  const int it = nt - 1 - (int)blockIdx.x / nbg;
  const int bg = blockIdx.x % nbg, bk = bg / G, g = bg % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;
  const size_t row0 = (size_t)bk * c, ri = row0 + (size_t)it * kT;

  bf16* sC = reinterpret_cast<bf16*>(smem_raw);     // [kT][NP] C_i
  bf16* sB = sC + kT * NP;                          // [c][NP] B of the chunk
  float* sS = reinterpret_cast<float*>(sB + (size_t)c * NP);  // [nt][kT*kT]
  unsigned char* ring = reinterpret_cast<unsigned char*>(sS + nt * kT * kT);
  int* sNr = reinterpret_cast<int*>(ring + 2 * L::stage_bytes);
  int* sLo = sNr + c;
  int* sHi = sLo + nt;

  for (int r = tid; r < c; r += kThreads) sNr[r] = a.nr[row0 + r];
  __syncthreads();
  tile_ranges(sNr, sLo, sHi, nt);
  __syncthreads();
  int live[kMaxTiles], nlive = 0;
  for (int jt = 0; jt <= it; ++jt)
    if (tiles_meet(sLo, sHi, it, jt)) live[nlive++] = jt;
  const int nr_end = sNr[c - 1];
  const bool last = it == nt - 1;

  load_bf16_rows<N>(sC, a.C + (ri * G + g) * N, (size_t)G * N, kT);
  for (int k = 0; k < nlive; ++k) {
    const size_t rj = row0 + (size_t)live[k] * kT;
    load_bf16_rows<N>(sB + (size_t)live[k] * kT * NP, a.B + (rj * G + g) * N,
                      (size_t)G * N, kT);
  }
  cp_async_commit();

  // item q: head pair q / nlive (heads 2m, 2m + 1 of the group), j-tile
  // live[q % nlive]
  const int npair = (rep + 1) / 2, total = npair * nlive;
  auto load_stage = [&](int q, int slot) {
    const int m = q / nlive, jt = live[q % nlive];
    const size_t rj = row0 + (size_t)jt * kT;
    unsigned char* st = ring + slot * L::stage_bytes;
    float* vec = reinterpret_cast<float*>(st + 2 * L::x_bytes);
    for (int hh = 0; hh < 2; ++hh) {
      const int l = 2 * m + hh;
      if (l >= rep) break;
      const int h = g * rep + l;
      load_bf16_rows<P>(reinterpret_cast<bf16*>(st + hh * L::x_bytes),
                        a.x + (rj * H + h) * P, (size_t)H * P, kT);
      for (int r = tid; r < kT; r += kThreads) {
        cp_async4(vec + hh * kT + r, a.csum + (ri + r) * H + h);
        cp_async4(vec + (2 + hh) * kT + r, a.csum + (rj + r) * H + h);
        cp_async4(vec + (4 + hh) * kT + r, a.dt + (rj + r) * H + h);
      }
    }
  };
  load_stage(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // S_ij for the live j-tiles: warp (rg, half) the 16 x 32 block of rows
  // 16 rg and j columns 32 half
  for (int k = 0; k < nlive; ++k) {
    const int jt = live[k];
    float s[4][4];
    mma_abt<N, 32>(s, sC + rg * 16 * NP, sB + ((size_t)jt * kT + half * 32) * NP,
                   lane);
    float* dst = sS + jt * kT * kT;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[frag(rg, half, n, e, lane)] = s[n][e];
  }

  const int wm = rg % L::WM, wn = rg / L::WM;
  const int i0 = rg * 16 + (lane >> 2);           // the thread's rows i0, i0+8
  float accy[P / 8][4] = {};
  float accs[L::MW][L::NW][4] = {};
  for (int q = 0; q < total; ++q) {
    if (q + 1 < total) {
      load_stage(q + 1, (q + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int m = q / nlive, k = q % nlive, jt = live[k];
    const int l = 2 * m + half, h = g * rep + l;
    if (l < rep) {
      const unsigned char* st = ring + (q & 1) * L::stage_bytes;
      const bf16* sx = reinterpret_cast<const bf16*>(st + half * L::x_bytes);
      const float* vec = reinterpret_cast<const float*>(st + 2 * L::x_bytes);
      const float* csi = vec + half * kT;
      const float* csj = vec + (2 + half) * kT;
      const float* dtj = vec + (4 + half) * kT;
      const float* S = sS + jt * kT * kT;
      const int* nrj = sNr + jt * kT;
      const float cs_i[2] = {csi[i0], csi[i0 + 8]};
      const int nr_i[2] = {sNr[it * kT + i0], sNr[it * kT + i0 + 8]};
      float w[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = i0 + (e >> 1) * 8;
          const int jj = n * 8 + 2 * (lane & 3) + (e & 1);
          const float s = S[frag(rg, n >> 2, n & 3, e, lane)];
          w[n][e] = it * kT + ii >= jt * kT + jj && nr_i[e >> 1] == nrj[jj]
                        ? s * expf(clip(cs_i[e >> 1] - csj[jj])) * dtj[jj]
                        : 0.0f;
        }
      mma_pb3<P, kT, P / 8>(accy, w, sx, lane);

      if (last && sLo[jt] <= nr_end && nr_end <= sHi[jt]) {
        const float cs_end = a.csum[(row0 + c - 1) * H + h];
#pragma unroll
        for (int kc = 0; kc < kT / 16; ++kc) {
          float u[4];     // u_j at j = kc*16 + 8 (t/2) + 2 (lane%4) + t%2
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = kc * 16 + (t >> 1) * 8 + 2 * (lane & 3) + (t & 1);
            u[t] = nrj[j] == nr_end ? expf(clip(cs_end - csj[j])) * dtj[j]
                                    : 0.0f;
          }
#pragma unroll
          for (int mt = 0; mt < L::MW; ++mt) {
            const int n0 = (wm * L::MW + mt) * 16;
            // (B_j ∘ u_j)ᵀ rows n, columns j: B's [j][n] tile transposed
            uint32_t ar[4], a3[3][4];
            ldmatrix_x4_trans(
                ar, sB + ((size_t)jt * kT + kc * 16 + (lane >> 4) * 8 +
                          (lane & 7)) * NP + n0 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const __nv_bfloat162 v =
                  *reinterpret_cast<const __nv_bfloat162*>(&ar[i]);
              split3(__low2float(v) * u[(i >> 1) * 2],
                     __high2float(v) * u[(i >> 1) * 2 + 1], a3[0][i],
                     a3[1][i], a3[2][i]);
            }
#pragma unroll
            for (int nn = 0; nn < L::NW; nn += 2) {
              uint32_t b[4];
              ldmatrix_x4_trans(
                  b, sx + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * PP +
                         (wn * L::NW + nn) * 8 + (lane >> 4) * 8);
#pragma unroll
              for (int t = 2; t >= 0; --t) {
                mma_bf16(accs[mt][nn], a3[t], b[0], b[1]);
                mma_bf16(accs[mt][nn + 1], a3[t], b[2], b[3]);
              }
            }
          }
        }
      }

      if (k == nlive - 1) {        // the head's last j-tile: write it out
#pragma unroll
        for (int d = 0; d < P / 8; ++d)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            *reinterpret_cast<float2*>(
                a.y + ((ri + i0 + hr * 8) * H + h) * P + d * 8 +
                2 * (lane & 3)) = make_float2(accy[d][2 * hr],
                                              accy[d][2 * hr + 1]);
            accy[d][2 * hr] = accy[d][2 * hr + 1] = 0.0f;
          }
        if (last) {
          float* out = a.states + ((size_t)bk * H + h) * N * P;
#pragma unroll
          for (int mt = 0; mt < L::MW; ++mt)
#pragma unroll
            for (int nn = 0; nn < L::NW; ++nn)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int n = (wm * L::MW + mt) * 16 + (lane >> 2) + hr * 8;
                const int p = (wn * L::NW + nn) * 8 + 2 * (lane & 3);
                *reinterpret_cast<float2*>(out + (size_t)n * P + p) =
                    make_float2(accs[mt][nn][2 * hr], accs[mt][nn][2 * hr + 1]);
                accs[mt][nn][2 * hr] = accs[mt][nn][2 * hr + 1] = 0.0f;
              }
        }
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------- bf16: backward, head parts
// ssd_bwd_part_kernel: a CTA per (batch·chunk, group, j-tile, head part),
// the first j-tiles first (they walk the most i-tiles).  A part is
// rep / n_parts consecutive heads of the group; the wrapper picks n_parts
// so that the grid fills the card.  The CTA computes Sᵀ = B_j·C_iᵀ for its
// live i-tiles >= j once and keeps it (f32, fragment order), then walks
// its heads in order; per head and live i-tile, with dy rounded to bf16:
//   dWᵀ = x_j·dy_iᵀ, Wᵀ and dSᵀ formed in registers, dx_j += Wᵀ·dy_i,
//   dS̄ᵀ += dSᵀ (shared memory: the sum over the part's heads),
//   ddt_j and the csum_j side of dcsum summed over i in registers, the
//   csum_i side's partial sums over this j-tile written out (rowp);
// then the end state's terms from q = x_j·dstateᵀ and B_j·dstate (dstate
// rounded to bf16): dB_j += u_j q_j, dx_j += u_j B_j·dstate, s_j = B_j·q_j.
// It writes dx, ddt and dcsum's csum_j side whole, the end state's terms
// of its rows summed (hsum), and after the last head its part of dB_j,
// dS̄ᵀ·C + Σ_h u q, and its dS̄ᵀ tiles (dbp, dsp), for the fold kernel.
// The two warp halves split each product's columns (i for dWᵀ, n for q,
// p for B_j·dstate) and sum their halves of dx in shared memory, so every
// sum runs in one fixed order.  dy, dstate, Wᵀ and dS̄ᵀ enter their
// products rounded to bf16 once (unlike the forward's f32 products): the
// gradients of the bf16 C, B and x are rounded to bf16 right after, and
// nothing downstream of a gradient feeds the loss of its own step.
template <int N, int P>
struct BwdPart {
  static constexpr int NP = N + kPad, PP = P + kPad;
  static constexpr size_t tile_bytes = sizeof(bf16) * kT * NP;
  // the ring region holds two C_i tiles before and after the heads, and
  // during them dstate [N][PP] and the dx exchange [4][16][P] f32
  static constexpr size_t dst_bytes = sizeof(bf16) * N * PP;
  static constexpr size_t xch_bytes = sizeof(float) * kT * P;
  static constexpr size_t ring_bytes = 2 * tile_bytes > dst_bytes + xch_bytes
                                           ? 2 * tile_bytes
                                           : dst_bytes + xch_bytes;
  static constexpr size_t x_bytes = sizeof(bf16) * kT * PP;
  static size_t smem(int c) {
    const int nt = c / kT;
    return tile_bytes + ring_bytes + 2 * x_bytes +
           sizeof(float) * (2 * (size_t)nt * kT * kT + 12 * kT +
                            (size_t)nt * 4 * kT) +
           sizeof(int) * (size_t)(c + 2 * nt);
  }
};

template <int OFF, int N4, int P8>
__device__ __forceinline__ void add_scaled(float (&acc)[P8][4],
                                           const float (&r)[N4][4],
                                           const float (&u)[2]) {
#pragma unroll
  for (int d = 0; d < N4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[OFF + d][e] += u[e >> 1] * r[d][e];
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_part_kernel(MArgs a) {
  using L = BwdPart<N, P>;
  constexpr int NP = L::NP, PP = L::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = a.c, H = a.H, G = a.G, rep = H / G, nt = c / kT;
  const int np = a.n_parts, hpp = rep / np;
  const int per = a.BK * G * np;
  const int jt = (int)blockIdx.x / per;
  const int rest = blockIdx.x % per, bg = rest / np, s = rest % np;
  const int bk = bg / G, g = bg % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;
  const size_t row0 = (size_t)bk * c, rj = row0 + (size_t)jt * kT;

  bf16* sBj = reinterpret_cast<bf16*>(smem_raw);             // [kT][NP]
  unsigned char* ring = smem_raw + L::tile_bytes;
  bf16* sDst = reinterpret_cast<bf16*>(ring);                // [N][PP]
  float* sXch = reinterpret_cast<float*>(ring + L::dst_bytes);
  bf16* sX = reinterpret_cast<bf16*>(ring + L::ring_bytes);  // [kT][PP]
  bf16* sDy = sX + kT * PP;                                  // [kT][PP]
  float* sS = reinterpret_cast<float*>(sDy + kT * PP);       // [nt][kT*kT]
  float* sDS = sS + nt * kT * kT;                            // [nt][kT*kT]
  float* sCsJ = sDS + nt * kT * kT;
  float* sDtJ = sCsJ + kT;
  float* sE = sDtJ + kT;
  float* sDend = sE + kT;
  float* sCsI = sDend + kT;
  float* sRed = sCsI + kT;       // [2][kT] ddt halves
  float* sRed2 = sRed + 2 * kT;  // [2][kT] csum_j-side halves
  float* sSp = sRed2 + 2 * kT;   // [2][kT] s_j halves
  float* sH = sSp + 2 * kT;      // [kT]
  float* sRowp = sH + kT;        // [nt][4][kT]
  int* sNr = reinterpret_cast<int*>(sRowp + nt * 4 * kT);
  int* sLo = sNr + c;
  int* sHi = sLo + nt;

  for (int r = tid; r < c; r += kThreads) sNr[r] = a.nr[row0 + r];
  __syncthreads();
  tile_ranges(sNr, sLo, sHi, nt);
  __syncthreads();
  int live[kMaxTiles], nlive = 0;
  for (int it = jt; it < nt; ++it)
    if (tiles_meet(sLo, sHi, it, jt)) live[nlive++] = it;
  const int nr_end = sNr[c - 1];
  const bool state_live = sLo[jt] <= nr_end && nr_end <= sHi[jt];

  // Sᵀ for the live i-tiles, C_i through the 2-tile ring
  load_bf16_rows<N>(sBj, a.B + (rj * G + g) * N, (size_t)G * N, kT);
  auto load_c = [&](int k) {
    const size_t ri = row0 + (size_t)live[k] * kT;
    load_bf16_rows<N>(reinterpret_cast<bf16*>(ring + (k & 1) * L::tile_bytes),
                      a.C + (ri * G + g) * N, (size_t)G * N, kT);
    cp_async_commit();
  };
  load_c(0);
  for (int k = 0; k < nlive; ++k) {
    if (k + 1 < nlive) {
      load_c(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sCi = reinterpret_cast<const bf16*>(ring + (k & 1) * L::tile_bytes);
    float st[4][4];
    mma_abt<N, 32>(st, sBj + rg * 16 * NP, sCi + half * 32 * NP, lane);
    float* S = sS + k * kT * kT;
    float* DS = sDS + k * kT * kT;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[frag(rg, half, n, e, lane)] = st[n][e];
        DS[frag(rg, half, n, e, lane)] = 0.0f;
      }
    __syncthreads();
  }

  const int j0 = rg * 16 + (lane >> 2);        // the thread's rows j0, j0+8
  float dbacc[N / 16][4] = {};                 // dB_j, n columns half·N/2
  for (int r = 0; r < hpp; ++r) {
    const int h = g * rep + s * hpp + r;
    const float cs_end = a.csum[(row0 + c - 1) * H + h];
    __syncthreads();
    load_bf16_rows<P>(sX, a.x + (rj * H + h) * P, (size_t)H * P, kT);
    for (int j = tid; j < kT; j += kThreads) {
      cp_async4(sCsJ + j, a.csum + (rj + j) * H + h);
      cp_async4(sDtJ + j, a.dt + (rj + j) * H + h);
    }
    cp_async_commit();
    if (state_live)
      stage_f32_rows<P>(sDst, a.dstate + ((size_t)bk * H + h) * N * P, P, N);
    cp_async_wait<0>();
    __syncthreads();
    for (int j = tid; j < kT; j += kThreads) {
      const float d = cs_end - sCsJ[j];
      sDend[j] = d;
      sE[j] = sNr[jt * kT + j] == nr_end ? expf(clip(d)) : 0.0f;
    }

    float dxp[P / 8][4] = {};
    float ddtp[2] = {}, colg[2] = {};
    for (int k = 0; k < nlive; ++k) {
      const int it = live[k];
      const size_t ri = row0 + (size_t)it * kT;
      __syncthreads();
      stage_f32_rows<P>(sDy, a.dy + (ri * H + h) * P, (size_t)H * P, kT);
      for (int i = tid; i < kT; i += kThreads) sCsI[i] = a.csum[(ri + i) * H + h];
      __syncthreads();
      float dwt[4][4];                          // dWᵀ: rows j, columns i
      mma_abt<P, 32>(dwt, sX + rg * 16 * PP, sDy + half * 32 * PP, lane);
      const float* S = sS + k * kT * kT;
      float* DS = sDS + k * kT * kT;
      float wt[4][4], gc[4][2] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j0 + (e >> 1) * 8;
          const int ii = half * 32 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int gi = it * kT + ii, gj = jt * kT + jj;
          const int f = frag(rg, half, n, e, lane);
          const float sv = S[f], dw = dwt[n][e];
          float w = 0.0f, ds = 0.0f;
          if (gi >= gj && sNr[gi] == sNr[gj]) {
            const float d = sCsI[ii] - sCsJ[jj];
            const float dec = expf(clip(d)), dtj = sDtJ[jj];
            w = sv * dec * dtj;
            ds = dw * dec * dtj;
            ddtp[e >> 1] += dw * sv * dec;
            if (gi != gj) {
              const float gg = dw * sv * dtj * dec * clip_grad(d);
              colg[e >> 1] += gg;
              gc[n][e & 1] += gg;
            }
          }
          wt[n][e] = w;
          DS[f] += ds;
        }
      mma_pb<P, 32, P / 8, false>(dxp, wt, sDy + half * 32 * PP, 0, lane);
      // the csum_i side: column sums of this warp's 16 rows, then of the
      // 4 row groups (sRowp, summed in order at the head's end)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float v = gc[n][b];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (lane < 4)
            sRowp[(k * 4 + rg) * kT + half * 32 + n * 8 + 2 * lane + b] = v;
        }
    }

    // the end state's terms: rows j0, j0+8 with u_j = e_j dt_j
    const float u[2] = {sE[j0] * sDtJ[j0], sE[j0 + 8] * sDtJ[j0 + 8]};
    if (state_live) {
      float q[N / 16][4];                      // q = x_j·dstateᵀ, n half
      mma_abt<P, N / 2>(q, sX + rg * 16 * PP, sDst + half * (N / 2) * PP, lane);
      float sp[2] = {};
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = half * (N / 2) + nn * 8 + 2 * (lane & 3) + (e & 1);
          const int jj = j0 + (e >> 1) * 8;
          dbacc[nn][e] += u[e >> 1] * q[nn][e];
          sp[e >> 1] += __bfloat162float(sBj[jj * NP + n]) * q[nn][e];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sp[hr] += __shfl_xor_sync(kFull, sp[hr], 1);
        sp[hr] += __shfl_xor_sync(kFull, sp[hr], 2);
        if ((lane & 3) == 0) sSp[half * kT + j0 + hr * 8] = sp[hr];
      }
      float rr[P / 16][4] = {};                // B_j·dstate, p half
      mma_ab<N, NP, PP, P / 16>(rr, sBj + rg * 16 * NP, sDst, half * (P / 16),
                                lane);
      if (half == 0)
        add_scaled<0>(dxp, rr, u);
      else
        add_scaled<P / 16>(dxp, rr, u);
    }
    // the rows' sums over i: a quad holds a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v = ddtp[hr], w = colg[hr];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      w += __shfl_xor_sync(kFull, w, 1);
      w += __shfl_xor_sync(kFull, w, 2);
      if ((lane & 3) == 0) {
        sRed[half * kT + j0 + hr * 8] = v;
        sRed2[half * kT + j0 + hr * 8] = w;
      }
    }
    if (half == 1) {
#pragma unroll
      for (int d = 0; d < P / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sXch[((rg * (P / 8) + d) * 4 + e) * 32 + lane] = dxp[d][e];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int d = 0; d < P / 8; ++d)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v0 = dxp[d][2 * hr] +
                           sXch[((rg * (P / 8) + d) * 4 + 2 * hr) * 32 + lane];
          const float v1 = dxp[d][2 * hr + 1] +
                           sXch[((rg * (P / 8) + d) * 4 + 2 * hr + 1) * 32 + lane];
          *reinterpret_cast<float2*>(a.dx + ((rj + j0 + hr * 8) * H + h) * P +
                                     d * 8 + 2 * (lane & 3)) =
              make_float2(v0, v1);
        }
    }
    for (int j = tid; j < kT; j += kThreads) {
      const float sj = state_live ? sSp[j] + sSp[kT + j] : 0.0f;
      const float e = sE[j];
      const float hj = jt * kT + j == c - 1
                           ? 0.0f
                           : sDtJ[j] * sj * e * clip_grad(sDend[j]);
      const size_t o = (rj + j) * H + h;
      a.ddt[o] = sRed[j] + sRed[kT + j] + e * sj;
      a.dcsum[o] = -(sRed2[j] + sRed2[kT + j]) - hj;
      sH[j] = hj;
    }
    // the csum_i side's partial sums over this j-tile, every i-tile >= j
    // (0 where the pair holds no live pair)
    for (int idx = tid; idx < (nt - jt) * kT; idx += kThreads) {
      const int it = jt + idx / kT, col = idx % kT;
      float v = 0.0f;
      for (int k = 0; k < nlive; ++k)
        if (live[k] == it) {
          const float* rp = sRowp + k * 4 * kT + col;
          v = ((rp[0] + rp[kT]) + rp[2 * kT]) + rp[3 * kT];
        }
      a.rowp[(((size_t)bk * H + h) * nt + jt) * c + it * kT + col] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float hs = 0.0f;
      for (int j = 0; j < kT; ++j) hs += sH[j];
      a.hsum[((size_t)bk * H + h) * nt + jt] = hs;
    }
  }

  // this part's dB_j = dS̄ᵀ·C + Σ_h u q (C_i through the ring again), and
  // its dS̄ᵀ tiles, for the fold kernel
  __syncthreads();
  load_c(0);
  for (int k = 0; k < nlive; ++k) {
    if (k + 1 < nlive) {
      load_c(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sCi = reinterpret_cast<const bf16*>(ring + (k & 1) * L::tile_bytes);
    const float* DS = sDS + k * kT * kT;
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = DS[frag(rg, n >> 2, n & 3, e, lane)];
    mma_pb<N, kT, N / 16, false>(dbacc, p, sCi, half * (N / 16), lane);
    float* out = a.dsp + (((size_t)bg * (nt * (nt + 1) / 2) +
                           tile_pair(live[k], jt)) * np + s) * kT * kT;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (j0 + hr * 8) * kT + half * 32 +
                                   n * 8 + 2 * (lane & 3)) =
            make_float2(DS[frag(rg, half, n, 2 * hr, lane)],
                        DS[frag(rg, half, n, 2 * hr + 1, lane)]);
    __syncthreads();
  }
  float* out = a.dbp + (((size_t)bg * nt + jt) * np + s) * kT * N;
#pragma unroll
  for (int nn = 0; nn < N / 16; ++nn)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(out + (j0 + hr * 8) * N + half * (N / 2) +
                                 nn * 8 + 2 * (lane & 3)) =
          make_float2(dbacc[nn][2 * hr], dbacc[nn][2 * hr + 1]);
}

// ---------------------------------------------- bf16: backward, fold
// ssd_bwd_fold_kernel: a CTA per (batch·chunk, group, tile t), the last
// tiles first.  It sums the head parts in part order: dB_t from the parts'
// dB; dC_t = Σ_{j-tiles <= t} dS̄_tj·B_j with dS̄ the parts' dS̄ᵀ tiles
// summed and rounded to bf16 (a product on the tensor cores); and dcsum's
// csum_i side (the parts' rowp, in j-tile order) and the end state's sum
// into csum_end (hsum, in j-tile order) added to what the part kernel
// wrote.  No float atomics anywhere: every sum has one order.
template <int N>
struct BwdFold {
  static constexpr int NP = N + kPad, TP = kT + kPad;
  static size_t smem(int c) {
    const int nt = c / kT;
    return sizeof(bf16) * (size_t)kT * (NP + TP) +
           sizeof(int) * (size_t)(c + 2 * nt);
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_fold_kernel(MArgs a) {
  using L = BwdFold<N>;
  constexpr int NP = L::NP, TP = L::TP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = a.c, H = a.H, G = a.G, rep = H / G, nt = c / kT;
  const int np = a.n_parts, nbg = a.BK * G;
  const int t = nt - 1 - (int)blockIdx.x / nbg;
  const int bg = blockIdx.x % nbg, bk = bg / G, g = bg % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;
  const size_t row0 = (size_t)bk * c, rt = row0 + (size_t)t * kT;

  bf16* sBt = reinterpret_cast<bf16*>(smem_raw);   // [kT][NP] B_j
  bf16* sT = sBt + kT * NP;                        // [kT][TP] dS̄ᵀ rows j
  int* sNr = reinterpret_cast<int*>(sT + kT * TP);
  int* sLo = sNr + c;
  int* sHi = sLo + nt;
  for (int r = tid; r < c; r += kThreads) sNr[r] = a.nr[row0 + r];
  __syncthreads();
  tile_ranges(sNr, sLo, sHi, nt);
  __syncthreads();

  float acc[N / 16][4] = {};                       // dC_t, n half
  for (int jt = 0; jt <= t; ++jt) {
    if (!tiles_meet(sLo, sHi, t, jt)) continue;
    __syncthreads();
    load_bf16_rows<N>(sBt, a.B + ((row0 + (size_t)jt * kT) * G + g) * N,
                      (size_t)G * N, kT);
    cp_async_commit();
    const float* parts = a.dsp + ((size_t)bg * (nt * (nt + 1) / 2) +
                                  tile_pair(t, jt)) * np * kT * kT;
    for (int q = tid; q < kT * kT / 4; q += kThreads) {
      float4 v = reinterpret_cast<const float4*>(parts)[q];
      for (int p = 1; p < np; ++p) {
        const float4 w =
            reinterpret_cast<const float4*>(parts + (size_t)p * kT * kT)[q];
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      const int r = (4 * q) / kT, col = (4 * q) % kT;
      uint2 packed;
      packed.x = pack_bf16(v.x, v.y);
      packed.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(sT + r * TP + col) = packed;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      // dS̄ rows i, columns j: the [j][i] tile transposed
      uint32_t af[4];
      ldmatrix_x4_trans(af, sT + (kc * 16 + (lane >> 4) * 8 + (lane & 7)) * TP +
                                rg * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int d = 0; d < N / 16; d += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, sBt + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * NP +
                   (half * (N / 16) + d) * 8 + (lane >> 4) * 8);
        mma_bf16(acc[d], af, b[0], b[1]);
        mma_bf16(acc[d + 1], af, b[2], b[3]);
      }
    }
  }
  const int i0 = rg * 16 + (lane >> 2);
#pragma unroll
  for (int d = 0; d < N / 16; ++d)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(a.dC + ((rt + i0 + hr * 8) * G + g) * N +
                                 half * (N / 2) + d * 8 + 2 * (lane & 3)) =
          make_float2(acc[d][2 * hr], acc[d][2 * hr + 1]);

  const float* dbp = a.dbp + ((size_t)bg * nt + t) * np * kT * N;
  for (int q = tid; q < kT * N / 4; q += kThreads) {
    float4 v = reinterpret_cast<const float4*>(dbp)[q];
    for (int p = 1; p < np; ++p) {
      const float4 w =
          reinterpret_cast<const float4*>(dbp + (size_t)p * kT * N)[q];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int r = (4 * q) / N, col = (4 * q) % N;
    *reinterpret_cast<float4*>(a.dB + ((rt + r) * G + g) * N + col) = v;
  }

  for (int idx = tid; idx < kT * rep; idx += kThreads) {
    const int i = idx / rep, h = g * rep + idx % rep;
    const size_t o = (rt + i) * H + h;
    float v = a.dcsum[o];
    const float* rp = a.rowp + ((size_t)bk * H + h) * nt * c + t * kT + i;
    for (int jt = 0; jt <= t; ++jt) v += rp[(size_t)jt * c];
    if (t == nt - 1 && i == kT - 1)
      for (int jt = 0; jt < nt; ++jt) v += a.hsum[((size_t)bk * H + h) * nt + jt];
    a.dcsum[o] = v;
  }
}

// ------------------------------------- f32: the backward's dcsum fold
// ssd_dcsum_kernel, after the f32 FMA kernels: dcsum = row + col, then
// the end state's terms hend summed in row order into csum_end.  A CTA per
// batch·chunk.
__global__ void __launch_bounds__(kThreads) ssd_dcsum_kernel(
    const float* __restrict__ row, const float* __restrict__ col,
    const float* __restrict__ hend, float* __restrict__ dcsum, int c, int H) {
  const size_t base = (size_t)blockIdx.x * c * H;
  for (int idx = threadIdx.x; idx < c * H; idx += kThreads)
    dcsum[base + idx] = row[base + idx] + col[base + idx];
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < c; ++j) s += hend[base + (size_t)j * H + h];
    dcsum[base + (size_t)(c - 1) * H + h] += s;
  }
}

// ------------------------------------------------------------ bf16 host
// which: 0 = forward, 1 = head parts, 2 = fold
template <int N, int P>
cudaError_t launch_mma(int which, const MArgs& a) {
  static bool configured[3] = {false, false, false};
  const int nt = a.c / kT;
  cudaError_t e;
  if (which == 0) {
    e = raise_smem(ssd_fwd_mma_kernel<N, P>, FwdMma<N, P>::smem(kMaxChunk),
                   &configured[0]);
    if (e != cudaSuccess) return e;
    ssd_fwd_mma_kernel<N, P><<<a.BK * a.G * nt, kThreads,
                               FwdMma<N, P>::smem(a.c), a.stream>>>(a);
  } else if (which == 1) {
    e = raise_smem(ssd_bwd_part_kernel<N, P>, BwdPart<N, P>::smem(kMaxChunk),
                   &configured[1]);
    if (e != cudaSuccess) return e;
    ssd_bwd_part_kernel<N, P><<<a.BK * a.G * nt * a.n_parts, kThreads,
                                BwdPart<N, P>::smem(a.c), a.stream>>>(a);
  } else {
    ssd_bwd_fold_kernel<N><<<a.BK * a.G * nt, kThreads, BwdFold<N>::smem(a.c),
                             a.stream>>>(a);
  }
  return cudaGetLastError();
}

int dispatch_mma(int which, int N, int P, const MArgs& a) {
  if (a.BK < 1 || a.c < kT || a.c % kT != 0 || a.c > kMaxChunk || a.G < 1 ||
      a.H < a.G || a.H % a.G != 0 || a.n_parts < 1 ||
      (a.H / a.G) % a.n_parts != 0)
    return cudaErrorInvalidValue;
#define SSD_MMA_CASE(NN, PP) \
  if (N == NN && P == PP) return (int)launch_mma<NN, PP>(which, a)
  SSD_MMA_CASE(32, 32);
  SSD_MMA_CASE(32, 64);
  SSD_MMA_CASE(64, 32);
  SSD_MMA_CASE(64, 64);
  SSD_MMA_CASE(128, 32);
  SSD_MMA_CASE(128, 64);
#undef SSD_MMA_CASE
  return cudaErrorInvalidValue;
}

MArgs make_margs(const void* C, const void* B, const void* x, const void* dt,
                 const void* csum, const void* nr, int BK, int c, int H, int G,
                 int n_parts, void* stream) {
  MArgs a{};
  a.C = static_cast<const bf16*>(C);
  a.B = static_cast<const bf16*>(B);
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.csum = static_cast<const float*>(csum);
  a.nr = static_cast<const int*>(nr);
  a.BK = BK;
  a.c = c;
  a.H = H;
  a.G = G;
  a.n_parts = n_parts;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// bf16 C, B, x [BK, c, G|H, N|P]; y, states f32 as ssd_chunk_fwd's
extern "C" int ssd_chunk_fwd_bf16(const void* C, const void* B, const void* x,
                                  const void* dt, const void* csum,
                                  const void* nr, void* y, void* states,
                                  int BK, int c, int H, int G, int N, int P,
                                  void* stream) {
  MArgs a = make_margs(C, B, x, dt, csum, nr, BK, c, H, G, 1, stream);
  a.y = static_cast<float*>(y);
  a.states = static_cast<float*>(states);
  return dispatch_mma(0, N, P, a);
}

// the head parts: dx, ddt [BK, c, H(, P)] and dcsum's csum_j side whole;
// scratch dsp [BK·G, nt(nt+1)/2, n_parts, 64, 64], dbp [BK·G, nt,
// n_parts, 64, N], rowp [BK, H, nt, c], hsum [BK, H, nt], all f32
extern "C" int ssd_chunk_bwd_part_bf16(
    const void* C, const void* B, const void* x, const void* dt,
    const void* csum, const void* nr, const void* dy, const void* dstate,
    void* dx, void* ddt, void* dcsum, void* dsp, void* dbp, void* rowp,
    void* hsum, int BK, int c, int H, int G, int N, int P, int n_parts,
    void* stream) {
  MArgs a = make_margs(C, B, x, dt, csum, nr, BK, c, H, G, n_parts, stream);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dcsum = static_cast<float*>(dcsum);
  a.dsp = static_cast<float*>(dsp);
  a.dbp = static_cast<float*>(dbp);
  a.rowp = static_cast<float*>(rowp);
  a.hsum = static_cast<float*>(hsum);
  return dispatch_mma(1, N, P, a);
}

// the fold, after the head parts on the same stream: dC, dB [BK, c, G, N]
// f32, dcsum completed in place
extern "C" int ssd_chunk_bwd_fold_bf16(
    const void* B, const void* nr, const void* dsp, const void* dbp,
    const void* rowp, const void* hsum, void* dC, void* dB, void* dcsum,
    int BK, int c, int H, int G, int N, int P, int n_parts, void* stream) {
  MArgs a = make_margs(nullptr, B, nullptr, nullptr, nullptr, nr, BK, c, H, G,
                       n_parts, stream);
  a.dsp = static_cast<float*>(const_cast<void*>(dsp));
  a.dbp = static_cast<float*>(const_cast<void*>(dbp));
  a.rowp = static_cast<float*>(const_cast<void*>(rowp));
  a.hsum = static_cast<float*>(const_cast<void*>(hsum));
  a.dC = static_cast<float*>(dC);
  a.dB = static_cast<float*>(dB);
  a.dcsum = static_cast<float*>(dcsum);
  return dispatch_mma(2, N, P, a);
}

// the f32 backward's dcsum from the FMA kernels' row, col and hend [BK, c,
// H]
extern "C" int ssd_chunk_bwd_dcsum(const void* row, const void* col,
                                   const void* hend, void* dcsum, int BK,
                                   int c, int H, void* stream) {
  if (BK < 1 || c < 1 || H < 1) return cudaErrorInvalidValue;
  ssd_dcsum_kernel<<<BK, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(row), static_cast<const float*>(col),
      static_cast<const float*>(hend), static_cast<float*>(dcsum), c, H);
  return cudaGetLastError();
}

// dynamic shared memory of a bf16 kernel (which: 0 forward, 1 head parts,
// 2 fold) at N, P and chunk c, in bytes; 0 for a shape not covered
extern "C" long long ssd_chunk_smem_bf16(int which, int N, int P, int c) {
  if (c < kT || c % kT != 0 || c > kMaxChunk) return 0;
#define SSD_SMEM_CASE(NN, PP)                                         \
  if (N == NN && P == PP)                                             \
    return (long long)(which == 0   ? FwdMma<NN, PP>::smem(c)         \
                       : which == 1 ? BwdPart<NN, PP>::smem(c)        \
                                    : BwdFold<NN>::smem(c))
  SSD_SMEM_CASE(32, 32);
  SSD_SMEM_CASE(32, 64);
  SSD_SMEM_CASE(64, 32);
  SSD_SMEM_CASE(64, 64);
  SSD_SMEM_CASE(128, 32);
  SSD_SMEM_CASE(128, 64);
#undef SSD_SMEM_CASE
  return 0;
}
