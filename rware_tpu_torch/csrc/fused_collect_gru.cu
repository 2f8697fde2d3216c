// The recurrent collector's launcher: K2c (one GRU for all agents) and K2d′
// (agent i runs GRU i), FLATTENED instantiations here, image ones (K2e) in
// fused_collect_gru_image.cu.  The kernel and its design: collect_gru.cuh.
#include "collect_gru.cuh"

// img_*: the image mode (K2e; ObsDims), img_n_layers = 0 for FLATTENED.
// n_stacks: weight stacks, 1 (K2c, or one agent) or N (K2d′, agent i runs
// stack i, each input array the stacks back to back); smem_stacks (K2d′): N
// where the agents' bias and head blocks fit in shared memory beside the
// tiles, else 0 (K2c keeps its one block there).
extern "C" int rw_fused_collect_gru(int n, int s, int r, int g, int h, int w, int reward_type,
                                    int max_steps, int max_inactive, int msg_bits,
                                    unsigned long long seed,
                                    int deterministic, int T, int B, int sensor_range,
                                    int normalised, int img_layers, int img_n_layers,
                                    int img_directional, int img_self, int L, int E, int Hg,
                                    int A, int threads, int smem_bytes, int n_stacks,
                                    int smem_stacks,
                                    const void* layout, const void* state_in,
                                    void* state_out, const void* we, const void* be,
                                    const void* wi, const void* bi, const void* wh,
                                    const void* bhn, const void* wc, const void* bc, void* hbuf,
                                    void* obs, void* action, void* bits, void* logp, void* value,
                                    void* reward, void* done, void* stream) {
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
  GruCollectDims m;
  m.L = L;
  m.E = E;
  m.Hg = Hg;
  m.A = A;
  m.deterministic = deterministic;
  m.obs.L = L;
  m.obs.sensor_range = sensor_range;
  m.obs.normalised = normalised;
  m.obs.img_layers = img_layers;
  m.obs.img_n_layers = img_n_layers;
  m.obs.img_directional = img_directional;
  m.obs.img_self = img_self;
  m.smem_stacks = smem_stacks;
  if (threads > 128 || A > RW_MAX_A || E % RW_JB || Hg % RW_JB || n > RW_MAX_N ||
      msg_bits < 0 || msg_bits > RW_MAX_M || (n_stacks != 1 && n_stacks != n) ||
      (n_stacks > 1 && smem_stacks != 0 && smem_stacks != n_stacks) || img_n_layers < 0 ||
      img_n_layers > RW_MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  const GruCollectArgs a = {layout, state_in, state_out, we, be, wi, bi, wh, bhn, wc, bc,
                            hbuf, obs, action, bits, logp, value, reward, done, stream};
  if (img_n_layers > 0)
    return launch_collect_gru_image(d, m, T, B, threads, smem_bytes, n_stacks > 1, a);
  return launch_collect_gru<false>(d, m, T, B, threads, smem_bytes, n_stacks > 1, a);
}
