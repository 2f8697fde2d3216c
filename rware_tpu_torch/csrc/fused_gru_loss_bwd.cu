// K13: the loss-fused GRU backward — the reverse sweep of K12 with the heads,
// the clipped-PPO loss and its backward inside: from the hidden sequence of
// K11, the f32 heads [W_policy | W_value] and the band's per-sample streams
// (action, old logp, old value, advantage, target) to d_iall (T, n_env, N,
// 3Hg) bf16, (dWh, dbhn, dW_head, db_head, mets[4]) (one flat f32 vector) and
// dh0 (n_env, N, Hg) f32.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_loss_bwd (kernel lines
// 856-1009).  Per step of the reverse sweep (gru_seq.cuh, kLoss = true) a
// block takes the heads of hseq[t] in f32, one thread per (row, column);
// the loss and its backward, one thread per row, with the band's [adv_mean,
// 1 / (adv_std + 1e-8)]; adds dheads W_head^T to the carried adjoint; then
// runs K12's step.  The TPU kernel batches the head algebra over a whole time
// chunk only to keep it off Mosaic's sequential loop, and reads its chunk
// boundaries from hboundary rows because Mosaic cannot select a scalar; a
// block here reads hseq[t-1] and done[t-1] directly.  dW_head, db_head, dbhn
// and the metric sums are per-block partials, dWh is a second pass over
// hprev and [dr | dz | dhhn] (d_iall holds dr and dz, only dhhn has
// scratch), all reduced in a fixed order: two launches give the same bits.
//
// Bound on the card: bytes (iall, hseq in, d_iall out, the five streams:
// 14 Hg + 20 bytes per sequence-step) against 3 x 49k multiply-adds at
// Hg = 128 plus the heads; the sweep's run on the FP32 pipes in this version,
// dWh on the tensor cores (gru_wgrad.cuh).
#include "gru_seq.cuh"

// A = n_actions (A + 1 <= 8); inv_n = 1 / (T n_env N); rows_per_thread,
// chunk, n_chunks and the scratch as gsq_bwd_launch; head (Hg + 1, A + 1) f32
// = [W_policy | W_value] with the bias row last; stats (2,) f32 on the card.
extern "C" int rw_fused_gru_loss_bwd(int Hg, int A, int T, int B, int N, int start_env,
                                     int n_env, int rows_per_thread, int chunk, int n_chunks,
                                     float clip_eps, float vf_coef, float ent_coef, float inv_n,
                                     const void* stats, const void* iall, const void* done,
                                     const void* h0, const void* hseq, const void* action,
                                     const void* logp, const void* value, const void* adv,
                                     const void* target, const void* wh, const void* bhn,
                                     const void* whT, const void* head, void* dhhn_s,
                                     void* part_blk, void* partial, void* d_iall, void* grads,
                                     void* dh0, void* stream) {
  if (!gsq_widths_ok(Hg, T, B, n_env) || A < 1 || A + 1 > GSQ_HEADS
      || (Hg + 1) * (A + 1) > GSQ_KPT * GRU_THREADS)
    return (int)cudaErrorInvalidValue;
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env, 0};
  const GsqLoss ls = {(const float*)stats, (const int*)action, (const float*)logp,
                      (const float*)value, (const float*)adv, (const float*)target,
                      (const float*)head, A + 1, clip_eps, vf_coef, ent_coef, inv_n};
  return gsq_bwd_launch<true>(d, rows_per_thread, chunk, n_chunks, iall, done, h0, hseq, nullptr,
                              wh, bhn, whT, ls, dhhn_s, part_blk, partial, d_iall, grads, dh0,
                              (cudaStream_t)stream);
}
