// K6: the central critic's forward over the whole stored trajectory:
// obs (T, B, N, L) bf16 -> values (T, B, N) float32, one launch per update.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_critic_values.  The
// TPU kernel flattens its (L, N, rows, lanes) obs block feature-major and
// permutes dense_0's rows to match; here the joint observation of env b at
// time t is the contiguous row obs[t, b] (N, L), which already is the critic's
// agent-major feature order n * L + l: no permutation, no relayout.
//
// The kernel is mode PPO_VALUES of the per-sample kernel (ppo_sample.cuh) on
// the critic's PpoDims (ppo_core.cuh): per (t, b),
//   h1 = bf16(tanh(bf16(C0^T x + cb0))), h2 = bf16(tanh(bf16(C1^T h1 + cb1))),
//   v = Cv^T f32(h2) + cbv                       (pallas_update.py:1786-1804)
// with the two bf16 products on the tensor cores (f32 sums) and the head in
// f32 on the FP32 pipes.  The plain version sums with torch.matmul in another
// order, so the two agree to float32 rounding, and to a bf16 step of a hidden
// unit where a rounding boundary is crossed.
//
// Bound on the card: the bytes, the obs read once (2*N*L bytes per (t, b))
// and the values written; the products, N*L*CH1 + CH1*CH2 bf16 and CH2*N f32
// multiply-adds per (t, b) (34.8k at N=2, L=71, hidden (128, 128)), take
// less.
#include "ppo_sample.cuh"

extern "C" int rw_fused_critic_values(int K0, int CH1, int CH2, int agents, int T, int B,
                                      int tile, int grid, int smem, int w0_smem,
                                      const void* obs, const void* cparams, void* values,
                                      void* stream) {
  const PpoDims d = critic_dims(K0, CH1, CH2, agents, T, T, B, 0.f, 0.f, 0.f, tile, grid, smem,
                                w0_smem, 0, 0, 0);
  if (ppo_plan_check(d, 0) != 0) return (int)cudaErrorInvalidValue;
  PpoData data = {};
  data.obs = (const __nv_bfloat16*)obs;
  PpoScratch ws = {};
  ws.values = (float*)values;
  cudaError_t err = cudaFuncSetAttribute(
      ppo_sample_kernel<PPO_VALUES>, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
  if (err != cudaSuccess) return (int)err;
  ppo_sample_kernel<PPO_VALUES><<<d.grid, PPO_THREADS, d.smem, (cudaStream_t)stream>>>(
      d, nullptr, nullptr, data, (const float*)cparams, ws);
  return (int)cudaGetLastError();
}
