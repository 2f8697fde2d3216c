// K5: MAPPO's gradients of one minibatch window — the shared-parameter
// actor's and the central critic's — and the window's four metric sums.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_mappo_grads (kernel
// body _make_mappo_update_kernel), with_actor true and false.  The TPU kernel
// feeds both networks from one VMEM obs block per grid cell and carries the
// weight gradients in VMEM across its sequential grid.  Hopper blocks run in
// no order and keep nothing between them, so the window's work is K4's scheme
// (fused_ppo_grads.cu) once per network, on one stream:
//
//  actor:  ppo_sample_kernel<PPO_ACTOR> with value_head = 0 over the
//          T_mb*B*N samples (t, b, n): policy and entropy terms only, the
//          local value head's dcat row exactly zero (so its gradient is
//          exactly 0.0); then the two bf16 weight-gradient products and the
//          fixed-order reduction of their partials and the head partials.
//  critic: ppo_sample_kernel<PPO_CRITIC> over the T_mb*B samples (t, b): the
//          joint observation is the contiguous row obs[t, b] (N, L), read in
//          place (agent-major n * L + l, dense_0 in flax's order: no
//          permutation); forward, clipped value loss per agent, backward; then
//          its own weight-gradient products and reduction.
//
// Each network has its own activations, partials and reduction (the two run
// over different sample counts), and inv_n = 1 / (T_mb * B * N) scales both
// losses.  The metric sums add the actor's per-block partials in block order,
// then the critic's.  No float atomics: two launches give the same bits.
//
// Bound on the card: the bytes (K4's per actor sample; per critic sample the
// joint obs, 2 N L bytes, in and the same 1 KB of scratch rows out and back),
// the products, about 69k multiply-adds per actor sample and 86k per critic
// sample at N=2, L=71, hidden (128, 128), being bf16 on the tensor cores but
// for the f32 heads.
#include "ppo_sample.cuh"

int mappo_grads_enqueue(const PpoDims& da, const PpoDims& dc, int with_actor, const int* start,
                        const float* stats, const PpoData& data, const float* aparams,
                        const float* cparams, const PpoScratch& wsa, const PpoScratch& wsc,
                        float* agrads, float* cgrads, float* mets, cudaStream_t stream) {
  int err;
  if (with_actor) {
    err = ppo_actor_sample_launch(da, start, stats, data, aparams, wsa, stream);
    if (err != 0) return err;
    err = ppo_wgrads_launch(da, start, data.obs, wsa, agrads, stream);
    if (err != 0) return err;
  }
  if (ppo_plan_check(dc, 1) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t cerr = cudaFuncSetAttribute(
      ppo_sample_kernel<PPO_CRITIC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dc.smem);
  if (cerr != cudaSuccess) return (int)cerr;
  ppo_sample_kernel<PPO_CRITIC><<<dc.grid, PPO_THREADS, dc.smem, stream>>>(dc, start, stats, data,
                                                                           cparams, wsc);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  err = ppo_wgrads_launch(dc, start, data.obs, wsc, cgrads, stream);
  if (err != 0) return err;
  return ppo_metrics_launch(wsa.part_mets, with_actor ? da.grid : 0, wsc.part_mets, dc.grid, mets,
                            stream);
}

extern "C" int rw_fused_mappo_grads(
    int L, int H1, int H2, int A, int T_full, int T_mb, int B, int N, float clip_eps,
    float vf_coef, float ent_coef, float inv_n, int tile, int grid, int smem, int w0_smem,
    int chunk, int n_chunks, int wgrad_smem, int c_tile, int c_grid, int c_smem, int c_w0_smem,
    int c_chunk, int c_n_chunks, int c_wgrad_smem, int CH1, int CH2, int with_actor,
    const void* start, const void* stats, const void* obs, const void* action,
    const void* logp, const void* value, const void* adv, const void* target,
    const void* aparams, const void* cparams, void* a_h1, void* a_h2, void* a_dz1, void* a_dz2,
    void* a_part_head, void* a_partial, void* a_part_mets, void* c_h1, void* c_h2, void* c_dz1,
    void* c_dz2, void* c_part_head, void* c_partial, void* c_part_mets, void* agrads,
    void* cgrads, void* mets, void* stream) {
  PpoDims da = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef, inv_n,
                        tile, grid, smem, w0_smem, chunk, n_chunks, wgrad_smem);
  da.value_head = 0;
  const PpoDims dc = critic_dims(N * L, CH1, CH2, N, T_full, T_mb, B, clip_eps, vf_coef, inv_n,
                                 c_tile, c_grid, c_smem, c_w0_smem, c_chunk, c_n_chunks,
                                 c_wgrad_smem);
  const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                        (const float*)value, (const float*)adv, (const float*)target};
  const PpoScratch wsa = {(__nv_bfloat16*)a_h1,  (__nv_bfloat16*)a_h2, (__nv_bfloat16*)a_dz1,
                          (__nv_bfloat16*)a_dz2, (float*)a_part_head,  (float*)a_partial,
                          (float*)a_part_mets,   nullptr};
  const PpoScratch wsc = {(__nv_bfloat16*)c_h1,  (__nv_bfloat16*)c_h2, (__nv_bfloat16*)c_dz1,
                          (__nv_bfloat16*)c_dz2, (float*)c_part_head,  (float*)c_partial,
                          (float*)c_part_mets,   nullptr};
  return mappo_grads_enqueue(da, dc, with_actor, (const int*)start, (const float*)stats, data,
                             (const float*)aparams, (const float*)cparams, wsa, wsc,
                             (float*)agrads, (float*)cgrads, (float*)mets, (cudaStream_t)stream);
}
