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
// This file holds what the three share: gsq_widths_ok, the widths their
// library functions take (hidden a multiple of 8 up to 128).  K11 runs the
// forward sweep it shares with K9 (gru_fwd_sweep.cuh).  K12 and K13 are
// chains of kernels on K10's parts: a time-parallel prologue (hprev Wh on the
// tensor cores, the gates and, for K13, the heads and the loss), K10's reverse
// sweep (gru_bwd.cuh), the dWh pass (gru_wgrad.cuh) and a fixed-order
// reduction (gru_seq_bwd.cuh).
#pragma once

#include "gru_core.cuh"

namespace {

inline bool gsq_widths_ok(int Hg, int T, int B, int n_env) {
  return Hg % 8 == 0 && Hg <= 128 && Hg > 0 && T > 0 && n_env >= 1 && n_env <= B;
}

}  // namespace
