// Shared pieces of the GRU sequence kernels: the band layout and GruSeqDims
// that K9-K13 take, the rounding helper and the sigmoid (also the recurrent
// collectors', K2c and K2d′ collect_gru.cuh, and the message bits',
// collect_core.cuh).  The sequence kernels run their products on the tensor
// cores (gru_mma.cuh): the forwards K9 and K11 on the sweep they share
// (gru_fwd_sweep.cuh), the backwards K10, K12 and K13 on K10's parts
// (gru_bwd.cuh, gru_wgrad.cuh).
//
// A launch works on an env band of the stored (T, B, N, ...) trajectory, read
// in place: envs (start_env + i) % B for i < n_env, wrapping, so no rolled or
// doubled copy of the dataset exists.  Sequence q < Q = n_env * N of the band
// is agent q % N of band env q / N.  Hidden widths are multiples of 8, at
// most 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Trajectory env of band sequence q, and its agent.
static __device__ __forceinline__ int gru_env(const GruSeqDims& d, int q) {
  return (d.start_env + q / d.N) % d.B;
}
