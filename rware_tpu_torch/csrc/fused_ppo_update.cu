// K3: the whole PPO update phase — every epoch x minibatch pass of the
// clipped-PPO gradient plus the optimizer step (global-norm clip, then Adam
// with bias correction and the pass's learning rate) — from one C call.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_ppo_update_phase.
// The TPU kernel is one Pallas program because a Mosaic grid has no cheap
// barrier: it keeps parameters and moments in VMEM and applies the optimizer
// in a boundary grid cell.  On Hopper a kernel boundary is the grid-wide
// barrier, so rw_fused_ppo_update_phase enqueues on one stream, for each
// pass p: the K4 gradient kernels (fused_ppo_grads.cu) on the window
// starts[p] with advstats[p], then ppo_clip_adam_kernel with hyper[p].
// Starts, stats and hyper rows are read from device memory; parameters and
// moments stay in device buffers, updated in place; nothing returns to the
// host between passes.
//
// Bound on the card: the gradient kernels (see fused_ppo_grads.cu).  The
// optimizer step is one block over about 26k parameters at L=71, hidden
// (128, 128): a few microseconds.
//
// With split_ms (host memory, four floats) not null the call waits for its
// kernels and writes there the milliseconds, summed over the passes, of the
// per-sample kernel, the weight-gradient products, their reduction with the
// metric sums, and the optimizer step, timed by CUDA events between them.
#include "ppo_core.cuh"

#define ADAM_THREADS 1024

// Formulas of pallas_update.py:1014-1033, with the constants as float32
// roundings of the Python doubles the plain version uses; products and sums
// rounded one by one as torch's elementwise kernels round them.  Block b
// steps parts.part[b] with that part's own global norm.
__global__ void __launch_bounds__(ADAM_THREADS)
    ppo_clip_adam_kernel(AdamParts parts, const float* __restrict__ hyper, float max_grad_norm) {
  __shared__ float red[ADAM_THREADS];
  const AdamPart& q = parts.part[blockIdx.x];
  float* __restrict__ params = q.params;
  float* __restrict__ mu = q.mu;
  float* __restrict__ nu = q.nu;
  const float* __restrict__ grads = q.grads;
  const long long n = q.n;
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (long long e = tid; e < n; e += ADAM_THREADS)
    acc = __fadd_rn(acc, __fmul_rn(grads[e], grads[e]));
  red[tid] = acc;
  __syncthreads();
  for (int s = ADAM_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float gn = __fsqrt_rn(red[0]);
  const float scale = gn >= max_grad_norm ? __fdiv_rn(max_grad_norm, fmaxf(gn, 1e-30f)) : 1.f;
  const float lr = hyper[0], bc1 = hyper[1], bc2 = hyper[2];
  const float b1 = 0.9f, one_b1 = 0.1f, b2 = 0.999f, one_b2 = 0.001f, eps = 1e-5f;
  for (long long e = tid; e < n; e += ADAM_THREADS) {
    const float g = __fmul_rn(grads[e], scale);
    const float m = __fadd_rn(__fmul_rn(b1, mu[e]), __fmul_rn(one_b1, g));
    const float v = __fadd_rn(__fmul_rn(b2, nu[e]), __fmul_rn(__fmul_rn(one_b2, g), g));
    mu[e] = m;
    nu[e] = v;
    const float step = __fdiv_rn(__fmul_rn(lr, __fmul_rn(m, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fmul_rn(v, bc2)), eps));
    params[e] = __fsub_rn(params[e], step);
  }
}

int ppo_clip_adam_launch(const AdamParts& parts, int n_parts, const float* hyper,
                         float max_grad_norm, cudaStream_t stream) {
  ppo_clip_adam_kernel<<<n_parts, ADAM_THREADS, 0, stream>>>(parts, hyper, max_grad_norm);
  return (int)cudaGetLastError();
}

extern "C" int rw_fused_ppo_update_phase(
    int L, int H1, int H2, int A, int T_full, int T_mb, int B, int N, float clip_eps,
    float vf_coef, float ent_coef, float inv_n, int tile, int grid, int smem, int w0_smem,
    int chunk, int n_chunks, int wgrad_smem, float max_grad_norm, int n_passes,
    const void* starts, const void* advstats, const void* hyper, const void* obs,
    const void* action, const void* logp, const void* value, const void* adv,
    const void* target, void* params, void* mu, void* nu, void* h1, void* h2, void* dz1,
    void* dz2, void* part_head, void* partial, void* part_mets, void* grads, void* mets,
    float* split_ms, void* stream) {
  const PpoDims d = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef,
                             inv_n, tile, grid, smem, w0_smem, chunk, n_chunks, wgrad_smem);
  const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                        (const float*)value, (const float*)adv, (const float*)target};
  const PpoScratch ws = {(__nv_bfloat16*)h1, (__nv_bfloat16*)h2, (__nv_bfloat16*)dz1,
                         (__nv_bfloat16*)dz2, (float*)part_head, (float*)partial,
                         (float*)part_mets, nullptr};
  const cudaStream_t st = (cudaStream_t)stream;
  AdamParts parts = {};
  parts.part[0] = {(float*)params, (float*)mu, (float*)nu, (const float*)grads,
                   ppo_offsets(d).n};
  // with split_ms: five events a pass, [sample | wgrad | reduce | adam | end]
  const int n_ev = split_ms != nullptr ? 5 * n_passes : 0;
  cudaEvent_t* ev = n_ev ? new cudaEvent_t[n_ev] : nullptr;
  for (int i = 0; i < n_ev; ++i) cudaEventCreate(&ev[i]);
  int err = 0;
  for (int p = 0; p < n_passes && err == 0; ++p) {
    const cudaEvent_t* marks = ev != nullptr ? ev + 5 * p : nullptr;
    err = ppo_grads_enqueue(d, (const int*)starts + p, (const float*)advstats + 2 * p, data,
                            (const float*)params, ws, (float*)grads, (float*)mets + 4 * p, st,
                            marks);
    if (err == 0)
      err = ppo_clip_adam_launch(parts, 1, (const float*)hyper + 3 * p, max_grad_norm, st);
    if (marks != nullptr) cudaEventRecord(marks[4], st);
  }
  if (ev != nullptr) {
    for (int k = 0; k < 4; ++k) split_ms[k] = 0.f;
    if (err == 0) err = (int)cudaEventSynchronize(ev[n_ev - 1]);
    for (int p = 0; p < n_passes && err == 0; ++p)
      for (int k = 0; k < 4 && err == 0; ++k) {
        float ms = 0.f;
        err = (int)cudaEventElapsedTime(&ms, ev[5 * p + k], ev[5 * p + k + 1]);
        split_ms[k] += ms;
      }
    for (int i = 0; i < n_ev; ++i) cudaEventDestroy(ev[i]);
    delete[] ev;
  }
  return err;
}
