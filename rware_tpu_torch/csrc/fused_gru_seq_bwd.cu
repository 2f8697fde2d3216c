// K12: the backward of K11 — from the cotangent dhseq of the hidden sequence
// to (dWh, dbhn) (one flat f32 vector), d_iall (T, n_env, N, 3Hg) bf16 =
// [dr | dz | dn] and dh0 (n_env, N, Hg) f32, recomputing the gates from iall
// and the stored hidden sequence.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_seq_bwd (kernel lines
// 193-274).  It is K13's chain without the heads and the loss
// (gru_seq_bwd.cuh, kLoss = false): a time-parallel prologue (hprev Wh on the
// tensor cores, the gates), K10's reverse sweep fed dhseq (gru_bwd.cuh), dWh on
// K10's weight-gradient pass (gru_wgrad.cuh) and a fixed-order reduction.  The
// TPU kernel accumulates dWh in a VMEM-resident output block across its
// sequential grid and needs precomputed chunk-boundary rows (hboundary) to
// avoid a scalar select; neither is carried across.
//
// Numerics as the TPU kernel: r and z stay f32 in the derivatives, the
// candidate is recomputed in bf16 arithmetic, [dr | dz | dhhn] is rounded to
// bf16 before the Wh products, dbhn sums the unrounded f32 dhhn.  Every
// product's operands are bf16 values, so the tensor cores change only the
// order of the sums.
//
// Bound on the card: bytes (iall, hseq, dhseq in, d_iall out: 14 Hg bytes
// per sequence-step) against 3 x 49k multiply-adds at Hg = 128 (the gates'
// hprev Wh, dh, dWh), all on the tensor cores.  The kernels sit above that:
// the gate scratch (12 Hg bytes a sample, written once and read once) and the
// sweep's latency.
#include "gru_seq_bwd.cuh"

// The plan's numbers and the scratch as gsq_bwd_run.
extern "C" int rw_fused_gru_seq_bwd(int Hg, int T, int B, int N, int start_env, int n_env,
                                    int sweep_rows, int tiles_per_block, int prologue_smem,
                                    int sweep_smem, int wgrad_smem, int chunk, int n_chunks,
                                    const void* iall, const void* done, const void* h0,
                                    const void* hseq, const void* dhseq, const void* wh,
                                    const void* bhn, void* rz_s, void* hn_s, void* dhhn_s,
                                    void* part_bhn, void* partial, void* d_iall, void* grads,
                                    void* dh0, float* split_ms, void* stream) {
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env};
  const GsqPlan p = {sweep_rows, tiles_per_block, prologue_smem, sweep_smem, wgrad_smem, chunk,
                     n_chunks};
  const GruBwdScratch ws = {nullptr, (float*)rz_s, (gm_bf16*)hn_s, nullptr, nullptr,
                            (float*)part_bhn};
  const GsqLoss ls = {};
  const GbCotSeq cot = {(const gm_bf16*)dhseq};
  return gsq_bwd_run<false>(d, p, ls, cot, iall, done, h0, hseq, wh, bhn, ws, dhhn_s, nullptr,
                            nullptr, partial, d_iall, grads, dh0, split_ms,
                            (cudaStream_t)stream);
}
