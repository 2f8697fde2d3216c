// K4: gradients of the clipped-PPO loss of one minibatch window, and the
// window's four metric sums.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_ppo_grads (kernel body
// _make_update_kernel) in zero-copy mode, with or without the message head
// (msg_bits M > 0: the head block [policy | value | message] of A + 1 + M
// columns, the joint move + Bernoulli-bits log-probability and entropy, the
// message cotangent rows dlogp (bit - sigma) + ent_coef inv_n l sigma (1 -
// sigma) in dcat, so the head's weight gradient and bias sums cover them;
// pallas_update.py:185-244): the window is rows (start + t) % T_full of the
// (T_full, B, N, ...) trajectory, read in place (no rolled or sliced copy).  The TPU kernel walks a
// sequential grid and accumulates weight gradients in VMEM; Hopper blocks
// run in no order, so the work is split in four kernels per window:
//
//  1. ppo_sample_kernel (ppo_sample.cuh, mode PPO_ACTOR, or PPO_MSG with the
//     message head): persistent blocks walk tiles of 64 samples with W1 (and
//     W0 where it fits) resident in shared memory as bf16: the forward, the
//     loss pieces and the backward down to dz1, the bf16 products x W0, h1 W1
//     and dz2 W1^T on the tensor cores (mma.sync, f32 sums), the f32 head on
//     the FP32 pipes.  It writes the per-sample activations the weight
//     gradients need (h1, h2, dz1, dz2 bf16, 16-byte row stores), each
//     block's f32 head gradient [h2 | 1]^T dcat summed over its tiles, and
//     its partial metric sums (fixed order).
//  2. gru_wgrad_kernel (gru_wgrad.cuh, the weight-gradient pass of K10, K12
//     and K13), twice: x^T dz1 (the obs rows read through the window, source
//     PpoObsSrc below) and h1^T dz2 (GruRowSrc), bf16 on the tensor cores,
//     128 x 128 output tiles over chunks of samples staged by cp.async in a
//     ring of three buffers, the bias rows as column sums of the staged dz;
//     each mma's 16 samples summed from zero and added to the running sums
//     in rounded f32 (a chunk is up to 8,192 samples); one partial per chunk.
//  3. gru_reduce_kernel: the chunk partials, then the per-sample blocks' head
//     partials, summed in a fixed order; ppo_metrics_kernel: the metric
//     partials.  No float atomics, so two launches give the same bits.
//
// Numerics follow pallas_update.py:1065-1160: bf16 inputs and hidden
// weights, f32 sums, bf16(z + b) then bf16(tanh), f32 heads;
// dz = bf16(bf16(dh) * bf16(1 - bf16(h * h))).  Sums run in another order
// than the plain version's torch.matmul, so the two agree to float32
// rounding, and to a bf16 step where a rounding boundary is crossed.
//
// Bound on the card: at L=71, hidden (128, 128) a sample takes about 69k
// multiply-adds (forward 26k, backward 17k, weight gradients 26k), all but
// 2.3k of them bf16 on the tensor cores, and moves 142 bytes of obs in and
// the 1 KB of scratch rows out and back; so the bytes bound it.  The f32
// head (three 768-term products a sample) is the largest share of the
// per-sample kernel's instructions.
#include "ppo_sample.cuh"

// A = the obs rows of the window: row (start + t) % T_full of the
// trajectory for sample t * bn + q (start on the device).  Rows have odd
// lengths, so they are read element by element (GruObsSrc's way); the
// GruSeqDims argument of gru_wgrad_kernel is not used.
struct PpoObsSrc {
  static constexpr bool kVec = false;
  const gm_bf16* obs;
  int ia, bias, jb;
  GruCols cols;
  const int* start;
  int T_full;
  long long bn;

  __device__ long long a_row(const GruSeqDims&, long long smp) const {
    const long long t = smp / bn;
    return ((__ldg(start) + t) % T_full) * bn + (smp - t * bn);
  }
  __device__ gm_bf16 a_at(long long row, int i) const { return obs[(size_t)row * ia + i]; }
};

// mets[m] = the blocks' partials of buffer a in order, then those of b.
__global__ void ppo_metrics_kernel(const float* __restrict__ part_a, int n_a,
                                   const float* __restrict__ part_b, int n_b,
                                   float* __restrict__ mets) {
  const int m = threadIdx.x;
  if (m >= 4) return;
  float acc = 0.f;
  for (int b = 0; b < n_a; ++b) acc += part_a[(size_t)b * 4 + m];
  for (int b = 0; b < n_b; ++b) acc += part_b[(size_t)b * 4 + m];
  mets[m] = acc;
}

int ppo_plan_check(const PpoDims& d, int backward) {
  const long long S = (long long)d.T_mb * d.B * d.N;
  bool ok = d.tile == PPO_TM && d.grid >= 1 && d.L >= 1 && d.heads >= 1 && d.heads <= d.hc
            && d.H1 >= 4 && d.H2 >= 4 && d.H1 % 4 == 0 && d.H2 % 4 == 0 && d.H1 <= PPO_HMAX
            && d.H2 <= PPO_HMAX && S >= 1
            && d.smem == ppo_smem(d.L, d.H1, d.H2, d.hc, d.w0_smem).total;
  if (backward)
    ok = ok && d.chunk >= GW_SK && d.chunk % GW_SK == 0 && d.n_chunks >= 1
         && (long long)d.chunk * d.n_chunks >= S && d.wgrad_smem == gru_wgrad_smem();
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

int ppo_actor_sample_launch(const PpoDims& d, const int* start, const float* stats,
                            const PpoData& data, const float* params, const PpoScratch& ws,
                            cudaStream_t stream) {
  if (ppo_plan_check(d, 1) != 0 || (d.msg_bits == 0 && d.hc != PPO_HC) || d.hc > PPO_HC_MAX)
    return (int)cudaErrorInvalidValue;
  const auto kernel = d.msg_bits > 0 ? ppo_sample_kernel<PPO_MSG> : ppo_sample_kernel<PPO_ACTOR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         d.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<d.grid, PPO_THREADS, d.smem, stream>>>(d, start, stats, data, params, ws);
  return (int)cudaGetLastError();
}

int ppo_wgrads_launch(const PpoDims& d, const int* start, const __nv_bfloat16* obs,
                      const PpoScratch& ws, float* grads, cudaStream_t stream,
                      const cudaEvent_t* marks) {
  if (ppo_plan_check(d, 1) != 0) return (int)cudaErrorInvalidValue;
  const PpoOffsets o = ppo_offsets(d);
  const long long S = (long long)d.T_mb * d.B * d.N;
  const GruSeqDims gd = {};
  if (marks != nullptr) cudaEventRecord(marks[0], stream);
  const PpoObsSrc x = {obs, d.L, 1, d.H1, gru_cols(ws.dz1, ppo_r8(d.H1)),
                       start, d.T_full, (long long)d.B * d.N};
  int err = gru_wgrad_launch<PpoObsSrc, true>(gd, x, S, d.chunk, d.n_chunks, ws.partial, 0,
                                              o.wc, stream);
  if (err != 0) return err;
  const GruRowSrc h1 = {ws.h1, ppo_r8(d.H1), d.H1, 1, d.H2, gru_cols(ws.dz2, ppo_r8(d.H2))};
  err = gru_wgrad_launch<GruRowSrc, true>(gd, h1, S, d.chunk, d.n_chunks, ws.partial, o.w1,
                                          o.wc, stream);
  if (err != 0) return err;
  if (marks != nullptr) cudaEventRecord(marks[1], stream);
  const int n_blk = (d.H2 + 1) * d.heads;
  gru_reduce_kernel<<<(unsigned)((o.n + 255) / 256), 256, 0, stream>>>(
      ws.partial, d.n_chunks, o.wc, ws.part_head, d.grid, n_blk, grads);
  return (int)cudaGetLastError();
}

int ppo_metrics_launch(const float* part_a, int n_a, const float* part_b, int n_b, float* mets,
                       cudaStream_t stream) {
  ppo_metrics_kernel<<<1, 32, 0, stream>>>(part_a, n_a, part_b, n_b, mets);
  return (int)cudaGetLastError();
}

int ppo_grads_enqueue(const PpoDims& d, const int* start, const float* stats,
                      const PpoData& data, const float* params, const PpoScratch& ws,
                      float* grads, float* mets, cudaStream_t stream, const cudaEvent_t* marks) {
  if (marks != nullptr) cudaEventRecord(marks[0], stream);
  int err = ppo_actor_sample_launch(d, start, stats, data, params, ws, stream);
  if (err != 0) return err;
  err = ppo_wgrads_launch(d, start, data.obs, ws, grads, stream,
                          marks != nullptr ? marks + 1 : nullptr);
  if (err != 0) return err;
  err = ppo_metrics_launch(ws.part_mets, d.grid, nullptr, 0, mets, stream);
  if (marks != nullptr) cudaEventRecord(marks[3], stream);
  return err;
}

// The plan's numbers (rware_tpu_torch/ops/fused_update.py::ppo_plan): tile
// 64; grid persistent per-sample blocks; smem their dynamic shared memory and
// wgrad_smem the weight-gradient kernel's, both as this library computes
// them; w0_smem whether W0 is resident; chunk * n_chunks >= T_mb * B * N
// samples.  Scratch: h1, dz1 (S, r8(H1)) and h2, dz2 (S, r8(H2)) bf16,
// part_head (grid, (H2 + 1) * heads), partial (n_chunks, (L + 1) H1 +
// (H1 + 1) H2) and part_mets (grid, 4) f32.
extern "C" int rw_fused_ppo_grads(int L, int H1, int H2, int A, int T_full, int T_mb, int B,
                                  int N, float clip_eps, float vf_coef, float ent_coef,
                                  float inv_n, int tile, int grid, int smem, int w0_smem,
                                  int chunk, int n_chunks, int wgrad_smem, int msg_bits, int hc,
                                  const void* start, const void* stats,
                                  const void* obs, const void* action, const void* logp,
                                  const void* value, const void* adv, const void* target,
                                  const void* bits, const void* params, void* h1, void* h2,
                                  void* dz1, void* dz2, void* part_head, void* partial,
                                  void* part_mets, void* grads, void* mets, void* stream) {
  PpoDims d = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef, inv_n,
                       tile, grid, smem, w0_smem, chunk, n_chunks, wgrad_smem);
  d.msg_bits = msg_bits;
  d.heads = A + 1 + msg_bits;
  d.hc = hc;
  if (d.heads > hc || hc > PPO_HC_MAX || (msg_bits > 0 && bits == nullptr))
    return (int)cudaErrorInvalidValue;
  const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                        (const float*)value, (const float*)adv, (const float*)target,
                        (const int*)bits};
  const PpoScratch ws = {(__nv_bfloat16*)h1, (__nv_bfloat16*)h2, (__nv_bfloat16*)dz1,
                         (__nv_bfloat16*)dz2, (float*)part_head, (float*)partial,
                         (float*)part_mets, nullptr};
  return ppo_grads_enqueue(d, (const int*)start, (const float*)stats, data,
                           (const float*)params, ws, (float*)grads, (float*)mets,
                           (cudaStream_t)stream);
}
