// Shared pieces of the GRU sequence kernels: the band layout and GruSeqDims
// that K9-K13 take, the rounding helpers and the sigmoid (also the recurrent
// collector's, K2c collect_gru.cuh), and the FP32 tile product of the
// iall-fed forward K11 (gru_seq.cuh).  K9 (fused_gru_fwd.cu) and the backward
// kernels K10, K12 and K13 run their products on the tensor cores
// (gru_mma.cuh, gru_bwd.cuh).
//
// A launch works on an env band of the stored (T, B, N, ...) trajectory, read
// in place: envs (start_env + i) % B for i < n_env, wrapping, so no rolled or
// doubled copy of the dataset exists.  Sequence q < Q = n_env * N of the band
// is agent q % N of band env q / N.
//
// K11's layout: a block of 256 threads owns S = 16 * RT sequences for all T
// steps and keeps their hidden in shared memory as bf16 rows.  Thread (ty, tx)
// = (tid / 16, tid % 16) computes rows ty * RT .. + RT and the eight columns
// tx * 8 .. + 8 of each of the three gates [r | z | n], so the gate arithmetic
// of a hidden unit needs no other thread.  Wh is a bf16 (in, out) matrix read
// from device memory through the read-only cache, 16 bytes a load.  Hidden
// widths are multiples of 8, at most 128.
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
