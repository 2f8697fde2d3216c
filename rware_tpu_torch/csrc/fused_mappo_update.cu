// K7: the whole MAPPO update phase — every epoch x minibatch pass of the
// combined actor + central-critic gradient, and after each pass a global-norm
// clip and an Adam step per part — from one C call.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_mappo_update_phase.
// As for K3 (fused_ppo_update.cu), a kernel boundary is the grid-wide barrier
// that the TPU kernel gets from its sequential grid: for each pass p,
// rw_fused_mappo_update_phase enqueues on one stream the K5 kernels
// (fused_mappo_grads.cu) on the window starts[p] with advstats[p], then one
// ppo_clip_adam_kernel launch of two blocks: block 0 steps the actor, block 1
// the critic, each with its own global norm (the split optimizer of
// mappo.py:120-150) and the shared hyper row hyper[p] (the actor's count
// drives both, mappo.py:1083-1098).  Parameters and moments of both parts
// stay in device buffers, updated in place; nothing returns to the host
// between passes.
//
// Bound on the card: the gradient kernels (see fused_mappo_grads.cu).
#include "ppo_core.cuh"

extern "C" int rw_fused_mappo_update_phase(
    int L, int H1, int H2, int A, int T_full, int T_mb, int B, int N, float clip_eps,
    float vf_coef, float ent_coef, float inv_n, int tile, int grid, int smem, int w0_smem,
    int chunk, int n_chunks, int wgrad_smem, int c_tile, int c_grid, int c_smem, int c_w0_smem,
    int c_chunk, int c_n_chunks, int c_wgrad_smem, int CH1, int CH2, float max_grad_norm,
    int n_passes, const void* starts, const void* advstats, const void* hyper, const void* obs,
    const void* action, const void* logp, const void* value, const void* adv,
    const void* target, void* aparams, void* amu, void* anu, void* cparams, void* cmu,
    void* cnu, void* a_h1, void* a_h2, void* a_dz1, void* a_dz2, void* a_part_head,
    void* a_partial, void* a_part_mets, void* c_h1, void* c_h2, void* c_dz1, void* c_dz2,
    void* c_part_head, void* c_partial, void* c_part_mets, void* agrads, void* cgrads,
    void* mets, void* stream) {
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
  const cudaStream_t st = (cudaStream_t)stream;
  AdamParts parts = {};
  parts.part[0] = {(float*)aparams, (float*)amu, (float*)anu, (const float*)agrads,
                   ppo_offsets(da).n};
  parts.part[1] = {(float*)cparams, (float*)cmu, (float*)cnu, (const float*)cgrads,
                   ppo_offsets(dc).n};
  for (int p = 0; p < n_passes; ++p) {
    int err = mappo_grads_enqueue(da, dc, 1, (const int*)starts + p,
                                  (const float*)advstats + 2 * p, data, (const float*)aparams,
                                  (const float*)cparams, wsa, wsc, (float*)agrads,
                                  (float*)cgrads, (float*)mets + 4 * p, st);
    if (err != 0) return err;
    err = ppo_clip_adam_launch(parts, 2, (const float*)hyper + 3 * p, max_grad_norm, st);
    if (err != 0) return err;
  }
  return 0;
}
