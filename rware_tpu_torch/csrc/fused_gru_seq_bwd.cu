// K12: the backward of K11 — from the cotangent dhseq of the hidden sequence
// to (dWh, dbhn) (one flat f32 vector), d_iall (T, n_env, N, 3Hg) bf16 =
// [dr | dz | dn] and dh0 (n_env, N, Hg) f32, recomputing the gates from iall
// and the stored hidden sequence.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_seq_bwd (kernel lines
// 193-274).  It is K13's sweep without the head and loss prologue, the
// hidden cotangent read in (gru_seq.cuh, kLoss = false): a reverse sweep per
// block of 16 or 32 sequences, then dWh over every sample in 128 x 128 tiles
// on the tensor cores (gru_wgrad.cuh, K10's) and a fixed-order reduction.
// The TPU kernel accumulates dWh in a VMEM-resident output block across its
// sequential grid and needs precomputed chunk-boundary rows (hboundary) to
// avoid a scalar select; neither is carried across.
//
// Numerics as the TPU kernel: r and z stay f32 in the derivatives, the
// candidate is recomputed in bf16 arithmetic, [dr | dz | dhhn] is rounded to
// bf16 before the Wh products, dbhn sums the unrounded f32 dhhn.
//
// Bound on the card: bytes (iall, hseq, dhseq in, d_iall out: 14 Hg bytes
// per sequence-step) against 3 x 49k multiply-adds at Hg = 128 (the gate
// recomputation, dh, dWh); the sweep's two run on the FP32 pipes in this
// version, dWh on the tensor cores.
#include "gru_seq.cuh"

// rows_per_thread: 1 or 2; chunk, n_chunks and the scratch as gsq_bwd_launch.
extern "C" int rw_fused_gru_seq_bwd(int Hg, int T, int B, int N, int start_env, int n_env,
                                    int rows_per_thread, int chunk, int n_chunks,
                                    const void* iall, const void* done, const void* h0,
                                    const void* hseq, const void* dhseq, const void* wh,
                                    const void* bhn, const void* whT, void* dhhn_s,
                                    void* part_blk, void* partial, void* d_iall, void* grads,
                                    void* dh0, void* stream) {
  if (!gsq_widths_ok(Hg, T, B, n_env)) return (int)cudaErrorInvalidValue;
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env, 0};
  GsqLoss ls = {};
  return gsq_bwd_launch<false>(d, rows_per_thread, chunk, n_chunks, iall, done, h0, hseq, dhseq,
                               wh, bhn, whT, ls, dhhn_s, part_blk, partial, d_iall, grads, dh0,
                               (cudaStream_t)stream);
}
