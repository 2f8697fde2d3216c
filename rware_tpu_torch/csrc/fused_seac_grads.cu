// K8: SEAC-PPO's gradients of one minibatch window for every agent's own
// parameters, and the window's four metric sums.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_seac_ppo_grads (kernel
// body _make_seac_update_kernel).  For each agent i, the loss of agent i's
// network on the samples (t, b, j) of EVERY agent j: the ratio of agent i's
// policy to agent j's behaviour policy, clipped; pair weight 1 on the diagonal
// j == i and seac_lambda off it on the policy and value terms; the entropy
// bonus and the KL sum on the diagonal only.  The window is rows
// (start + t) % T_full, t < T_mb, of the (T_full, B, N, ...) trajectory and of
// slab i of the (N_i, T_full, B, N_j) cross arrays (old values, advantages,
// targets), read in place; inv_n = 1 / (T_mb * B * N) scales every term
// (pallas_update.py:561), and the advantage statistics [mean, 1/std] of the
// whole window's cross advantages come in on the device.
//
// The TPU kernel folds the N_j sharing axis into each grid cell and carries
// agent i's gradient blocks in VMEM across its sequential grid.  Here the
// window's work is K4's scheme (fused_ppo_grads.cu) once per agent, on one
// stream and one workspace, so the scratch is one agent's (the per-sample
// h1, h2, dz1 and dz2 of T_mb * B * N samples: 1 GB at tiny-2ag, B=16,384,
// T_mb=32; 8.6 GB at 16 agents), whatever N is:
//
//  for i: ppo_sample_kernel<PPO_SEAC> (ppo_sample.cuh) with agent i's
//         parameters at params + i * P: forward, loss pieces, backward to dz1,
//         the head's gradient per block; then the two bf16 weight-gradient
//         products and the fixed-order reduction into grads + i * P;
//  then:  the metric sums of all agents' per-block partials, agent by agent
//         in block order.
//
// No float atomics, so two launches give the same bits.  Numerics are K4's
// (bf16 inputs and hidden weights, f32 sums and heads).
//
// Bound on the card: N times K4's per window (its bytes: about 1.2 KB of obs
// and scratch rows per sample, 2 x 1M samples at tiny-2ag).
#include "ppo_sample.cuh"

extern "C" int rw_fused_seac_grads(int L, int H1, int H2, int A, int T_full, int T_mb, int B,
                                   int N, float clip_eps, float vf_coef, float ent_coef,
                                   float inv_n, int tile, int grid, int smem, int w0_smem,
                                   int chunk, int n_chunks, int wgrad_smem, float seac_lambda,
                                   const void* start, const void* stats, const void* obs,
                                   const void* action, const void* logp, const void* value,
                                   const void* adv, const void* target, const void* params,
                                   void* h1, void* h2, void* dz1, void* dz2, void* part_head,
                                   void* partial, void* part_mets, void* grads, void* mets,
                                   void* stream) {
  PpoDims d = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef, inv_n,
                       tile, grid, smem, w0_smem, chunk, n_chunks, wgrad_smem);
  if (ppo_plan_check(d, 1) != 0) return (int)cudaErrorInvalidValue;
  d.seac_lambda = seac_lambda;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_params = ppo_offsets(d).n;
  const size_t slab = (size_t)T_full * B * N;  // one agent's rows of the cross arrays
  cudaError_t err = cudaFuncSetAttribute(ppo_sample_kernel<PPO_SEAC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < N; ++i) {
    d.agent = i;
    const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                          (const float*)value + i * slab, (const float*)adv + i * slab,
                          (const float*)target + i * slab};
    const PpoScratch ws = {(__nv_bfloat16*)h1, (__nv_bfloat16*)h2, (__nv_bfloat16*)dz1,
                           (__nv_bfloat16*)dz2, (float*)part_head, (float*)partial,
                           (float*)part_mets + (size_t)i * grid * 4, nullptr};
    ppo_sample_kernel<PPO_SEAC><<<grid, PPO_THREADS, smem, st>>>(
        d, (const int*)start, (const float*)stats, data, (const float*)params + i * n_params, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int code = ppo_wgrads_launch(d, (const int*)start, data.obs, ws,
                                       (float*)grads + i * n_params, st);
    if (code != 0) return code;
  }
  return ppo_metrics_launch((const float*)part_mets, N * grid, nullptr, 0, (float*)mets, st);
}
