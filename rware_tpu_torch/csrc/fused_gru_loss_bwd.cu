// K13: the loss-fused GRU backward — K12's chain with the heads, the
// clipped-PPO loss and its backward inside: from the hidden sequence of K11,
// the f32 heads [W_policy | W_value] and the band's per-sample streams
// (action, old logp, old value, advantage, target) to d_iall (T, n_env, N,
// 3Hg) bf16, (dWh, dbhn, dW_head, db_head, mets[4]) (one flat f32 vector) and
// dh0 (n_env, N, Hg) f32.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_loss_bwd (kernel lines
// 856-1009).  Only the product [dr | dz | dhhn] Wh^T depends on the carried
// adjoint; hprev Wh depends only on the stored hseq and h0, and the heads, the
// loss and its backward only on hseq[t] and the band's streams.  So the
// prologue (gru_seq_bwd.cuh, kLoss = true) takes them all time-parallel: the
// gates on the tensor cores, the heads of hseq[t] in f32, the loss's backward
// with the band's [adv_mean, 1 / (adv_std + 1e-8)], dheads (stored f32), and
// per-block partials of dW_head, db_head and the metric sums; K10's reverse
// sweep (gru_bwd.cuh) adds dheads W_head^T in f32 to the carried adjoint and
// runs the one product on the sequential path on the tensor cores with Wh
// resident in shared memory; dWh is K10's weight-gradient pass; one
// reduction sums every partial in a fixed order: two launches give the same
// bits.  The TPU kernel batches the head algebra over a time chunk for the
// same reason (pallas_gru.py:886-951).
//
// Bound on the card: bytes (iall, hseq in, d_iall out, the five streams:
// 14 Hg + 20 bytes per sequence-step) against 3 x 49k multiply-adds at
// Hg = 128 on the tensor cores plus the heads, the head gradients and dheads
// W_head^T (3 x Hg (A + 1)) on the FP32 pipes.
#include "gru_seq_bwd.cuh"

// A = n_actions (A + 1 <= 8, (Hg + 1) (A + 1) <= 1024); inv_n = 1 / (T n_env
// N); the plan's numbers and the scratch as gsq_bwd_run; head (Hg + 1, A + 1)
// f32 = [W_policy | W_value] with the bias row last; stats (2,) f32 on the
// card.
extern "C" int rw_fused_gru_loss_bwd(int Hg, int A, int T, int B, int N, int start_env,
                                     int n_env, int sweep_rows, int tiles_per_block,
                                     int prologue_smem, int sweep_smem, int wgrad_smem, int chunk,
                                     int n_chunks, float clip_eps, float vf_coef, float ent_coef,
                                     float inv_n, const void* stats, const void* iall,
                                     const void* done, const void* h0, const void* hseq,
                                     const void* action, const void* logp, const void* value,
                                     const void* adv, const void* target, const void* wh,
                                     const void* bhn, const void* head, void* rz_s, void* hn_s,
                                     void* dhhn_s, void* dheads_s, void* part_bhn,
                                     void* part_head, void* partial, void* d_iall, void* grads,
                                     void* dh0, float* split_ms, void* stream) {
  if (A < 1 || A + 1 > GB_HEADS || (Hg + 1) * (A + 1) > GSQ_HEAD_OUTS)
    return (int)cudaErrorInvalidValue;
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env};
  const GsqPlan p = {sweep_rows, tiles_per_block, prologue_smem, sweep_smem, wgrad_smem, chunk,
                     n_chunks};
  const GruBwdScratch ws = {nullptr, (float*)rz_s, (gm_bf16*)hn_s, nullptr, nullptr,
                            (float*)part_bhn};
  const GsqLoss ls = {(const float*)stats, (const int*)action, (const float*)logp,
                      (const float*)value, (const float*)adv, (const float*)target,
                      (const float*)head, A + 1, clip_eps, vf_coef, ent_coef, inv_n};
  const GbCotHeads cot = {(const float*)dheads_s, (const float*)head, A + 1};
  return gsq_bwd_run<true>(d, p, ls, cot, iall, done, h0, hseq, wh, bhn, ws, dhhn_s, dheads_s,
                           part_head, partial, d_iall, grads, dh0, split_ms,
                           (cudaStream_t)stream);
}
