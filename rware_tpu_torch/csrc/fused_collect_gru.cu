// The recurrent collector's launcher: K2c (one GRU for all agents) and K2d′
// (agent i runs GRU i), K2d′'s FLATTENED instantiations here, K2c's in
// fused_collect_gru_one_stack.cu, the image ones (K2e) in
// fused_collect_gru_image.cu (K2d′) and fused_collect_gru_image_one_stack.cu
// (K2c), K2d′'s chunked ones in fused_collect_gru_chunked.cu and
// fused_collect_gru_chunked_image.cu.  The kernel and its design:
// collect_gru.cuh.
#include "collect_gru.cuh"

// img_*: the image mode (K2e; ObsDims), img_n_layers = 0 for FLATTENED.
// n_stacks: weight stacks, 1 (K2c, or one agent) or N (K2d′, agent i runs
// stack i, each input array the stacks back to back).  plan: the n_plan ints
// of ops/fused_rollout.py::GruCollectPlan.args (host memory), which say
// whether the f32 bias and head blocks are held in shared memory or read
// from device memory, and whether the observation tile is chunked.  h0 and
// new_h are (B, N, Hg) bf16.
extern "C" int rw_fused_collect_gru(int n, int s, int r, int g, int h, int w, int reward_type,
                                    int max_steps, int max_inactive, int msg_bits,
                                    unsigned long long seed, unsigned int env_offset,
                                    int deterministic, int T, int B,
                                    int sensor_range, int normalised, int img_layers,
                                    int img_n_layers, int img_directional, int img_self, int L,
                                    int E, int Hg, int A, int n_stacks, const int* plan,
                                    int n_plan, const void* layout, const void* state_in,
                                    void* state_out, const void* we, const void* be,
                                    const void* wi, const void* bi, const void* wh,
                                    const void* bhn, const void* wc, const void* bc,
                                    const void* h0, void* new_h, void* obs, void* action,
                                    void* bits, void* logp, void* value, void* reward, void* done,
                                    void* stream) {
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
  GruCollectDims m;
  m.L = L;
  m.E = E;
  m.Hg = Hg;
  m.A = A;
  m.deterministic = deterministic;
  m.n_stacks = n_stacks;
  m.obs.L = L;
  m.obs.sensor_range = sensor_range;
  m.obs.normalised = normalised;
  m.obs.img_layers = img_layers;
  m.obs.img_n_layers = img_n_layers;
  m.obs.img_directional = img_directional;
  m.obs.img_self = img_self;
  GruCollectPlan p;
  if (n_plan * sizeof(int) != sizeof(GruCollectPlan)) return (int)cudaErrorInvalidValue;
  std::memcpy(&p, plan, sizeof(GruCollectPlan));
  if (T < 1 || B < 1 || A > RW_MAX_A || n > RW_MAX_N || msg_bits < 0 || msg_bits > RW_MAX_M ||
      (n_stacks != 1 && n_stacks != n) || img_n_layers < 0 || img_n_layers > RW_MAX_LAYERS ||
      !collect_gru_plan_ok(p, m, d) || ((size_t)we & 15) || ((size_t)wi & 15) ||
      ((size_t)wh & 15) || ((size_t)h0 & 15) || ((size_t)new_h & 15))
    return (int)cudaErrorInvalidValue;
  const GruCollectArgs a = {layout, state_in, state_out, we, be, wi, bi, wh, bhn, wc, bc,
                            h0, new_h, obs, action, bits, logp, value, reward, done, stream};
  if (p.kx) return img_n_layers > 0 ? launch_collect_gru_chunked_image(d, m, p, T, B, a)
                                    : launch_collect_gru_chunked(d, m, p, T, B, a);
  if (img_n_layers > 0)
    return m.n_stacks == 1 ? launch_collect_gru_image_one_stack(d, m, p, T, B, a)
                           : launch_collect_gru_image(d, m, p, T, B, a);
  return m.n_stacks == 1 ? launch_collect_gru_one_stack(d, m, p, T, B, a)
                         : launch_collect_gru<true, false, false>(d, m, p, T, B, a);
}
