// The iall-fed GRU sequence kernels: the forward K11 (fused_gru_seq_fwd.cu)
// and, in gru_seq_bwd.cuh, its backward K12 (fused_gru_seq_bwd.cu) and the
// loss-fused backward K13 (fused_gru_loss_bwd.cu).
//
// Unlike K9/K10 they take the fused input gates iall = bf16(e Wi + bi) as a
// band-local tensor (T, n_env, N, 3Hg) [r | z | n] that the caller computed;
// the kernels run only the time recurrence.  done (T, B), h0 (B, N, Hg) and
// K13's per-sample streams (T, B, N) are the whole trajectory's, read in place
// through the band (envs (start_env + i) % B); hseq, dhseq, d_iall (T, n_env,
// N, .) and dh0 (n_env, N, Hg) are band-local, row t * Q + q for sequence q <
// Q = n_env * N (agent q % N of band env q / N).
//
// This file holds K11's pieces.  K11's thread layout is gru_core.cuh's: a
// block of 256 threads owns S = 16 * RT sequences for all T; thread (ty, tx)
// takes rows ty * RT .. + RT and the eight hidden units tx * 8 .. + 8 of all
// three gates.  K12 and K13 are chains of kernels on K10's parts: a
// time-parallel prologue (hprev Wh on the tensor cores, the gates and, for
// K13, the heads and the loss), K10's reverse sweep (gru_bwd.cuh), the dWh
// pass (gru_wgrad.cuh) and a fixed-order reduction (gru_seq_bwd.cuh).
#pragma once

#include "gru_core.cuh"

namespace {

// K11's cell (pallas_gru.py:100-123) for the eight hidden units of one row: ia
// the bf16 input gates [r | z | n] x 8, hh the f32 hidden products [r | z |
// n] x 8, hp the previous hidden (bf16 values).  r and z are sigmoids of f32
// sums rounded to bf16; the candidate and new_h are bf16 arithmetic.
__device__ __forceinline__ void gsq_cell_fwd(const float* ia, const float* hh,
                                             const float* __restrict__ bhn, const float* hp,
                                             float* nh) {
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) {
    const float rg = gru_bf16r(gru_sigmoid(ia[jj] + hh[jj]));
    const float zg = gru_bf16r(gru_sigmoid(ia[GRU_CW + jj] + hh[GRU_CW + jj]));
    const float hn = gru_bf16r(hh[2 * GRU_CW + jj] + bhn[jj]);
    const float nn = gru_bf16r(tanhf(gru_bf16r(ia[2 * GRU_CW + jj] + gru_bf16r(rg * hn))));
    nh[jj] = gru_bf16r(gru_bf16r(gru_bf16r(1.f - zg) * nn) + gru_bf16r(zg * hp[jj]));
  }
}

// The eight bf16 input gates of each gate [r | z | n] of band row `row`.
__device__ __forceinline__ void gsq_load_gates(const __nv_bfloat16* __restrict__ iall,
                                               size_t row, int Hg, int j0, float* ia) {
  const __nv_bfloat16* p = iall + row * 3 * Hg + j0;
  gru_load8(p, ia);
  gru_load8(p + Hg, ia + GRU_CW);
  gru_load8(p + 2 * Hg, ia + 2 * GRU_CW);
}

inline bool gsq_widths_ok(int Hg, int T, int B, int n_env) {
  return Hg % GRU_CW == 0 && Hg <= 128 && Hg > 0 && T > 0 && n_env >= 1 && n_env <= B;
}

}  // namespace
