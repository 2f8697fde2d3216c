// Shared pieces of the obs-fused GRU forward (K9 fused_gru_fwd.cu) and of the
// iall-fed forward (K11 gru_seq.cuh); the backward kernels K10, K12 and K13 (on
// the tensor cores, gru_mma.cuh, gru_bwd.cuh) take the band layout,
// GruSeqDims and the rounding helpers, the recurrent collector (K2c
// collect_gru.cuh) the sigmoid.
//
// A launch works on an env band of the stored (T, B, N, ...) trajectory, read
// in place: envs (start_env + i) % B for i < n_env, wrapping, so no rolled or
// doubled copy of the dataset exists.  Sequence q < Q = n_env * N of the band
// is agent q % N of band env q / N.
//
// A block of 256 threads owns S = 16 * RT sequences for all T steps and keeps
// their tiles (observation, embedding, hidden) in shared memory as bf16 rows.
// Thread (ty, tx) = (tid / 16, tid % 16) computes rows ty * RT .. + RT and the
// eight columns tx * 8 .. + 8 of each product, and for the gate matrices
// [r | z | n] the same eight columns of all three gates, so the gate
// arithmetic of a hidden unit needs no other thread.  Weights are bf16
// (in, out) matrices read from device memory through the read-only cache, 16
// bytes a load; they stay in L1/L2.  Embed and hidden widths are multiples of
// 8, at most 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GRU_THREADS 256
#define GRU_CW 8  // columns per thread and chunk

struct GruSeqDims {
  int L, E, Hg;          // obs length, embed width, hidden width
  int T, B, N;           // trajectory length, envs, agents
  int start_env, n_env;  // the band
  int Lp;                // row stride of the obs tile in shared memory
};

static __device__ __forceinline__ float gru_bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

static __device__ __forceinline__ float gru_sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// Eight consecutive bf16 values (16 bytes, aligned) as floats.
static __device__ __forceinline__ void gru_load8(const __nv_bfloat16* p, float* w) {
  const uint4 v = __ldg((const uint4*)p);
  const __nv_bfloat162* h = (const __nv_bfloat162*)&v;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    w[2 * q] = f.x;
    w[2 * q + 1] = f.y;
  }
}

// Eight floats rounded to bf16 and stored as 16 aligned bytes.
static __device__ __forceinline__ void gru_store8(__nv_bfloat16* p, const float* v) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *(uint4*)p = *(const uint4*)h;
}

// Trajectory env of band sequence q, and its agent.
static __device__ __forceinline__ int gru_env(const GruSeqDims& d, int q) {
  return (d.start_env + q / d.N) % d.B;
}

// acc[r][c * 8 + jj] += sum over k < K of A[row0 + r][k] * W[k][col[c] + jj]:
// A a shared-memory bf16 tile with row stride lda, W a bf16 (K, ldw) matrix in
// device memory.
template <int RT, int NC>
static __device__ __forceinline__ void gru_tile_gemm(float (&acc)[RT][NC * GRU_CW],
                                                     const __nv_bfloat16* A, int lda, int row0,
                                                     int K, const __nv_bfloat16* W, int ldw,
                                                     const int (&col)[NC]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) a[r] = __bfloat162float(A[(size_t)(row0 + r) * lda + k]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float w[GRU_CW];
      gru_load8(W + (size_t)k * ldw + col[c], w);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj)
          acc[r][c * GRU_CW + jj] = fmaf(a[r], w[jj], acc[r][c * GRU_CW + jj]);
    }
  }
}

// The observation rows of step t of the block's sequences q0 .. q0 + S into
// the shared tile xs (rows past Q are zero).
static __device__ __forceinline__ void gru_load_obs(const GruSeqDims& d, int S, int q0, int Q,
                                                    int t, const __nv_bfloat16* __restrict__ obs,
                                                    __nv_bfloat16* xs) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int idx = threadIdx.x; idx < S * d.L; idx += GRU_THREADS) {
    const int s = idx / d.L, k = idx - s * d.L, q = q0 + s;
    __nv_bfloat16 v = zero;
    if (q < Q) v = obs[(((size_t)t * d.B + gru_env(d, q)) * d.N + q % d.N) * d.L + k];
    xs[(size_t)s * d.Lp + k] = v;
  }
}

// es = bf16(tanh(bf16(xs We + be))) for the thread's rows and columns.
template <int RT>
static __device__ __forceinline__ void gru_embed(const GruSeqDims& d, int row0, int j0,
                                                 const __nv_bfloat16* xs,
                                                 const __nv_bfloat16* __restrict__ we,
                                                 const float* __restrict__ be,
                                                 __nv_bfloat16* es) {
  if (j0 >= d.E) return;
  float acc[RT][GRU_CW];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int jj = 0; jj < GRU_CW; ++jj) acc[r][jj] = 0.f;
  const int col[1] = {j0};
  gru_tile_gemm<RT, 1>(acc, xs, d.Lp, row0, d.L, we, d.E, col);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float v[GRU_CW];
#pragma unroll
    for (int jj = 0; jj < GRU_CW; ++jj) v[jj] = tanhf(gru_bf16r(acc[r][jj] + be[j0 + jj]));
    gru_store8(es + (size_t)(row0 + r) * d.E + j0, v);
  }
}

// ia = bf16(es Wi + bi) and hh = h Wh for the thread's rows and its eight
// columns of each gate (ia and hh hold [r | z | n] x 8).
template <int RT>
static __device__ __forceinline__ void gru_gates(const GruSeqDims& d, int row0, int j0,
                                                 const __nv_bfloat16* es, const __nv_bfloat16* hs,
                                                 const __nv_bfloat16* __restrict__ wi,
                                                 const float* __restrict__ bi,
                                                 const __nv_bfloat16* __restrict__ wh,
                                                 float (&ia)[RT][3 * GRU_CW],
                                                 float (&hh)[RT][3 * GRU_CW]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 3 * GRU_CW; ++c) ia[r][c] = hh[r][c] = 0.f;
  const int col[3] = {j0, d.Hg + j0, 2 * d.Hg + j0};
  gru_tile_gemm<RT, 3>(ia, es, d.E, row0, d.E, wi, 3 * d.Hg, col);
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int jj = 0; jj < GRU_CW; ++jj)
        ia[r][c * GRU_CW + jj] = gru_bf16r(ia[r][c * GRU_CW + jj] + bi[col[c] + jj]);
  gru_tile_gemm<RT, 3>(hh, hs, d.Hg, row0, d.Hg, wh, 3 * d.Hg, col);
}
