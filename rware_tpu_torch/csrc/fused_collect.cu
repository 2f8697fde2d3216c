// The MLP collector's launcher: K2a (one network for all agents) and K2d
// (agent i runs network i), with their message (K2b) and image (K2e) modes;
// the whole-tile instantiations here, the chunked ones in
// fused_collect_chunked.cu.  The kernel and its design: collect_mlp.cuh.
#include "collect_mlp.cuh"

// img_*: the image mode (K2e; ObsDims), img_n_layers = 0 for FLATTENED.
// plan: the n_plan ints of ops/fused_rollout.py::CollectPlan.args (host
// memory).  dense_0 and dense_1 arrive as bf16 (in, out) stacks, the heads
// and biases as f32 stacks; the plan says whether they are held in shared
// memory or read from device memory (kGlobal), and whether the observation
// tile is chunked (kChunk).
extern "C" int rw_fused_collect(int n, int s, int r, int g, int h, int w, int reward_type,
                                int max_steps, int max_inactive, int msg_bits,
                                unsigned long long seed, unsigned int env_offset,
                                int deterministic, int T, int B,
                                int sensor_range, int normalised, int img_layers, int img_n_layers,
                                int img_directional, int img_self, int L, int H1, int H2, int A,
                                int n_stacks, const int* plan, int n_plan, const void* layout,
                                const void* state_in, void* state_out, const void* w0,
                                const void* b0, const void* w1, const void* b1, const void* wp,
                                const void* bp, const void* wv, const void* bv, const void* wm,
                                const void* bm, void* obs, void* action, void* bits, void* logp,
                                void* value, void* reward, void* done, void* stream) {
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
  d.m = msg_bits;
  d.scripted = deterministic;
  d.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  d.seed_hi = (uint32_t)(seed >> 32);
  d.env_offset = env_offset;
  MlpDims m;
  m.L = L;
  m.H1 = H1;
  m.H2 = H2;
  m.A = A;
  m.deterministic = deterministic;
  m.n_stacks = n_stacks;
  m.M = msg_bits;
  m.obs.L = L;
  m.obs.sensor_range = sensor_range;
  m.obs.normalised = normalised;
  m.obs.img_layers = img_layers;
  m.obs.img_n_layers = img_n_layers;
  m.obs.img_directional = img_directional;
  m.obs.img_self = img_self;
  CollectPlan p;
  if (n_plan * sizeof(int) != sizeof(CollectPlan)) return (int)cudaErrorInvalidValue;
  std::memcpy(&p, plan, sizeof(CollectPlan));
  if (A > RW_MAX_A || H1 % 8 || H2 % 8 || (n_stacks != 1 && n_stacks != n) || n > RW_MAX_N ||
      msg_bits > RW_MAX_M || img_n_layers < 0 || img_n_layers > RW_MAX_LAYERS ||
      !collect_plan_ok(p, m, d) || ((size_t)w0 & 15) || ((size_t)w1 & 15))
    return (int)cudaErrorInvalidValue;
  const CollectArgs a = {layout, state_in, state_out, w0, b0, w1, b1, wp, bp, wv, bv, wm, bm,
                         obs, action, bits, logp, value, reward, done, stream};
  if (p.kx) return launch_collect_chunked(d, m, p, T, B, a);
  // [image][message][weights in device memory]
  decltype(&fused_collect_kernel<false, false, false, false>) const kernels[2][2][2] = {
      {{fused_collect_kernel<false, false, false, false>,
        fused_collect_kernel<true, false, false, false>},
       {fused_collect_kernel<false, true, false, false>,
        fused_collect_kernel<true, true, false, false>}},
      {{fused_collect_kernel<false, false, true, false>,
        fused_collect_kernel<true, false, true, false>},
       {fused_collect_kernel<false, true, true, false>,
        fused_collect_kernel<true, true, true, false>}}};
  return launch_collect(kernels[img_n_layers > 0][msg_bits > 0][p.weights_global != 0], d, m, p,
                        T, B, a);
}
