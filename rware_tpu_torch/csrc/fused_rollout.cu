// K1: the fused rollout kernel — T env steps per launch, random or scripted
// actions, autoreset, per-agent reward sums and episode counts.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_rollout (kernel
// body _make_kernel, core _env_step_core).  One thread per env; the env's
// state stays in registers / local memory for all T steps, so device memory
// is read once (packed state, scripted actions) and written once per launch.
// The packed state is (ROWS, B) int32 with the env index minor, so a warp's
// loads and stores of one row are coalesced; the wrapper
// (rware_tpu_torch/ops/fused_rollout.py) transposes from and to the public
// (B, ...) layout.  B need not be a multiple of the block: the tail masks.
//
// Bound on the card: per-env integer work (the resolver's O(N^2) loops and
// the O(S) shelf scans) plus local-memory traffic; it does not touch device
// memory inside the time loop except for scripted actions.
#include "env_core.cuh"

__global__ void fused_rollout_kernel(EnvDims d, int T, int B, const int* __restrict__ layout,
                                     const int* __restrict__ state_in, int* __restrict__ state_out,
                                     const int* __restrict__ actions, float* __restrict__ rewards,
                                     int* __restrict__ episodes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const EnvLayout lay = make_layout(d, layout);
  const int N = d.n;
  EnvState st;
  load_state(st, d, state_in, e, B);
  float acc[RW_MAX_N];
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  int epis = 0;
  int acts[RW_MAX_N];
  float rew[RW_MAX_N];
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < N; ++i) {
      acts[i] = actions ? actions[((size_t)t * N + i) * B + e]
                        : rand_mod(draw_bits(d, e, t, RW_ACTION, i), 5);
    }
    bool done = env_step(st, acts, rew, d, lay, e, t);
    for (int i = 0; i < N; ++i) acc[i] += rew[i];
    epis += done ? 1 : 0;
  }
  store_state(st, d, state_out, e, B);
  for (int i = 0; i < N; ++i) rewards[(size_t)i * B + e] = acc[i];
  episodes[e] = epis;
}

extern "C" int rw_fused_rollout(int n, int s, int r, int g, int h, int w, int reward_type,
                                int max_steps, int max_inactive, unsigned long long seed,
                                int scripted, int T, int B, const void* layout,
                                const void* state_in, void* state_out, const void* actions,
                                void* rewards, void* episodes, void* stream) {
  EnvDims d;
  d.n = n;
  d.s = s;
  d.r = r;
  d.g = g;
  d.h = h;
  d.w = w;
  d.reward_type = reward_type;
  d.max_steps = max_steps;
  d.max_inactive = max_inactive;
  d.scripted = scripted;
  d.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  d.seed_hi = (uint32_t)(seed >> 32);
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  fused_rollout_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      d, T, B, (const int*)layout, (const int*)state_in, (int*)state_out,
      (const int*)actions, (float*)rewards, (int*)episodes);
  return (int)cudaGetLastError();
}

extern "C" const char* rw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
