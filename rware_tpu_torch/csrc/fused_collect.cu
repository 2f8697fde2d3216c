// K2a and K2d: the fused MLP-policy collector — per step: FLATTENED or image
// observation, ActorCritic forward, Gumbel-argmax sample, env step, autoreset;
// the trajectory (obs bf16, action, logp, value, reward, done) is streamed out.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_collect in modes
// policy="mlp" (K2a: one network shared by all agents; _policy_forward) and
// policy="mlp_per_agent" (K2d: agent i runs its own network i;
// _policy_forward_per_agent), FLATTENED observations (kernel body
// _make_collect_kernel; _build_obs_feats, _sample_gumbel).  K2a carries the
// message mode K2b (msg_bits M > 0, pallas_rollout.py:1537-1562, 1689-1734):
// a float32 message head (M, H2) beside the policy and value heads, summed in
// the same hidden order; M Bernoulli bits per agent-step (sample_bernoulli)
// whose log-probability joins the Gumbel move's; the bits stream out as a
// (T, B, N, M) trajectory tensor and become the agents' messages, cleared
// where an episode ends.  K2d carries it too (SEAC-PPO with message bits,
// pallas_rollout.py:1944-1947): agent i's (M, H2) message head is stack i's,
// in shared memory or, where the stacks do not fit, in device memory with
// the dense layers.  The message mode is its own instantiation (kMsg), so
// K2a and K2d without message bits compile to the code they had before it.
// Image observations (K2e, IMAGE and IMAGE_DICT; _build_image_feats,
// pallas_rollout.py:1109) are an instantiation of their own too (kImage):
// collect_core.cuh::build_image_obs writes the rotated C x w x w window (+ 6
// self rows) into the same shared-memory column the policy reads, so the
// observation never leaves the chip before its one store to the trajectory;
// the layer table, the directional flag and the self rows are run-time
// arguments of that instantiation only.
// The two modes are one kernel: `n_stacks` weight stacks (1 or N) and agent i
// runs stack n_stacks > 1 ? i : 0.  The TPU kernel feeds a whole (L, N*1024) feature tile
// to the MXU (N small matmuls per agent in K2d); here one thread owns one env
// and runs its agents' MLPs with scalar loops.  The weights sit in dynamic
// shared memory (dense_0 and dense_1 in bf16 as (out, in), the heads in f32 —
// about 53 KB a stack at hidden (128, 128), above the 48 KB static limit)
// where all stacks fit beside the tiles (K2a; K2d with up to 3 agents at
// L=71).  Where they do not (kGlobal: K2d with more agents or longer
// observations), dense_0 and dense_1 are bf16 (in, out) matrices read from
// device memory through the read-only cache, 16 bytes (eight outputs of one
// input row) a load, every thread of a warp at the same address, as the
// recurrent collector (collect_gru.cuh) reads its cell; the f32 heads and
// biases likewise.  Each thread keeps its observation and first hidden layer
// as bf16 columns of shared-memory tiles, so no thread reads another's data
// and the only barrier is after the weight load.
//
// Numerics follow the Pallas recipe: bf16 inputs and weights, f32 sums, the
// f32 bias added, rounded to bf16, tanh of that value rounded to bf16; the
// f32 heads read the bf16 hidden.  Sums run over the input features in
// ascending order with separately rounded multiplies and adds (no FMA), the
// order of rware_tpu_torch/models/networks.py::ordered_linear, so the plain
// version reproduces the kernel bit for bit on the card, in both routes.
//
// Bound on the card: the MLP's FP32 multiply/add issue (about 52k
// multiply-adds per env-step at 2 agents, hidden (128, 128), whichever
// network each agent runs) and the shared-memory or L1 reads feeding it;
// eight outputs share each input read.  The trajectory writes (about 300
// bytes per env-step at tiny-2ag) are the device-memory traffic.
#include "collect_core.cuh"
#include "gru_core.cuh"  // gru_load8

struct MlpDims {
  int L, H1, H2, A;
  int deterministic;
  int n_stacks;  // weight stacks: 1 (K2a, shared) or N (K2d, agent i runs stack i)
  int M;         // message bits per agent (K2b), 0 without the message head
  ObsDims obs;
};

// Eight weights of outputs j0 .. j0 + 7 at input k: from (out, in) bf16 rows
// in shared memory, or (kGlobal) from an (in, out) bf16 matrix in device
// memory, one 16-byte load.
template <bool kGlobal>
static __device__ __forceinline__ void load_w8(const __nv_bfloat16* w, int n_in, int n_out, int k,
                                               int j0, float* out) {
  if (kGlobal) {
    gru_load8(w + (size_t)k * n_out + j0, out);
  } else {
#pragma unroll
    for (int jj = 0; jj < RW_JB; ++jj) out[jj] = __bfloat162float(w[(size_t)(j0 + jj) * n_in + k]);
  }
}

template <bool kGlobal>
static __device__ __forceinline__ float load_f(const float* p) {
  return kGlobal ? __ldg(p) : *p;
}

template <bool kGlobal, bool kMsg, bool kImage>
__global__ void fused_collect_kernel(EnvDims d, MlpDims m, int T, int B,
                                     const int* __restrict__ layout,
                                     const int* __restrict__ state_in, int* __restrict__ state_out,
                                     const __nv_bfloat16* __restrict__ w0,
                                     const float* __restrict__ b0,
                                     const __nv_bfloat16* __restrict__ w1,
                                     const float* __restrict__ b1, const float* __restrict__ wp,
                                     const float* __restrict__ bp, const float* __restrict__ wv,
                                     const float* __restrict__ bv, const float* __restrict__ wm,
                                     const float* __restrict__ bm, __nv_bfloat16* __restrict__ obs,
                                     int* __restrict__ action, int* __restrict__ bits_out,
                                     float* __restrict__ logp,
                                     float* __restrict__ value, float* __restrict__ reward,
                                     uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = m.L, H1 = m.H1, H2 = m.H2, A = m.A, M = kMsg ? m.M : 0, N = d.n;
  const int TB = blockDim.x, tid = threadIdx.x;
  const int WS = kGlobal ? 0 : m.n_stacks;  // stacks held in shared memory

  // Shared memory: f32 [b0 WS*H1 | b1 WS*H2 | wp WS*A*H2 | bp WS*A | wv WS*H2 |
  // bv WS | wm WS*M*H2 | bm WS*M], padded to 16 bytes, then bf16 [w0 WS*H1*L |
  // w1 WS*H2*H1 | xs L*TB | hs H1*TB].  Each input array is its stacks back to
  // back.
  float* sb0 = (float*)smem;
  float* sb1 = sb0 + WS * H1;
  float* swp = sb1 + WS * H2;
  float* sbp = swp + WS * A * H2;
  float* swv = sbp + WS * A;
  float* sbv = swv + WS * H2;
  float* swm = sbv + WS;
  float* sbm = swm + WS * M * H2;
  const size_t fbytes =
      ((size_t)WS * (H1 + H2 + A * H2 + A + H2 + 1 + M * H2 + M) * 4 + 15) & ~(size_t)15;
  __nv_bfloat16* sw0 = (__nv_bfloat16*)(smem + fbytes);
  __nv_bfloat16* sw1 = sw0 + (size_t)WS * H1 * L;
  __nv_bfloat16* xs = sw1 + (size_t)WS * H2 * H1;
  __nv_bfloat16* hs = xs + (size_t)L * TB;
  for (int k = tid; k < WS * H1 * L; k += TB) sw0[k] = w0[k];
  for (int k = tid; k < WS * H2 * H1; k += TB) sw1[k] = w1[k];
  for (int k = tid; k < WS * A * H2; k += TB) swp[k] = wp[k];
  for (int k = tid; k < WS * H1; k += TB) sb0[k] = b0[k];
  for (int k = tid; k < WS * H2; k += TB) {
    sb1[k] = b1[k];
    swv[k] = wv[k];
  }
  for (int k = tid; k < WS * A; k += TB) sbp[k] = bp[k];
  for (int k = tid; k < WS; k += TB) sbv[k] = bv[k];
  for (int k = tid; k < WS * M * H2; k += TB) swm[k] = wm[k];
  for (int k = tid; k < WS * M; k += TB) sbm[k] = bm[k];
  __syncthreads();

  const int e = blockIdx.x * TB + tid;
  if (e >= B) return;
  const EnvLayout lay = make_layout(d, layout);
  EnvState st;
  load_state(st, d, state_in, e, B);
  int acts[RW_MAX_N];
  float rew[RW_MAX_N];
  int nmsg[RW_MAX_N * RW_MAX_M];  // this step's sampled bits, agent-major

  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < N; ++i) {
      const size_t row = ((size_t)t * B + e) * N + i;
      build_agent_obs<kMsg, kImage>(st, d, lay, m.obs, i, xs, TB, tid);
      for (int k = 0; k < L; ++k) obs[row * L + k] = xs[(size_t)k * TB + tid];

      // this agent's network: its stack in shared or device memory
      const int st_i = m.n_stacks > 1 ? i : 0;
      const __nv_bfloat16* W0 = (kGlobal ? w0 : sw0) + (size_t)st_i * H1 * L;
      const __nv_bfloat16* W1 = (kGlobal ? w1 : sw1) + (size_t)st_i * H2 * H1;
      const float* B0 = (kGlobal ? b0 : sb0) + st_i * H1;
      const float* B1 = (kGlobal ? b1 : sb1) + st_i * H2;
      const float* WP = (kGlobal ? wp : swp) + st_i * A * H2;
      const float* BP = (kGlobal ? bp : sbp) + st_i * A;
      const float* WV = (kGlobal ? wv : swv) + st_i * H2;
      const float* BV = (kGlobal ? bv : sbv) + st_i;
      const float* WM = (kGlobal ? wm : swm) + st_i * M * H2;
      const float* BM = (kGlobal ? bm : sbm) + st_i * M;

      // dense_0 + tanh -> hs (bf16)
      for (int j0 = 0; j0 < H1; j0 += RW_JB) {
        float acc[RW_JB];
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < L; ++k) {
          const float xv = __bfloat162float(xs[(size_t)k * TB + tid]);
          float w[RW_JB];
          load_w8<kGlobal>(W0, L, H1, k, j0, w);
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = __fadd_rn(acc[jj], __fmul_rn(xv, w[jj]));
        }
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) {
          const float v = bf16_round(__fadd_rn(acc[jj], load_f<kGlobal>(B0 + j0 + jj)));
          hs[(size_t)(j0 + jj) * TB + tid] = __float2bfloat16_rn(tanhf(v));
        }
      }
      // dense_1 + tanh, folded into the f32 heads in hidden order
      float lg[RW_MAX_A], ml[RW_MAX_M];
      for (int a = 0; a < A; ++a) lg[a] = 0.f;
      for (int k = 0; k < M; ++k) ml[k] = 0.f;
      float val = 0.f;
      for (int j0 = 0; j0 < H2; j0 += RW_JB) {
        float acc[RW_JB];
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < H1; ++k) {
          const float hv = __bfloat162float(hs[(size_t)k * TB + tid]);
          float w[RW_JB];
          load_w8<kGlobal>(W1, H1, H2, k, j0, w);
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = __fadd_rn(acc[jj], __fmul_rn(hv, w[jj]));
        }
        for (int jj = 0; jj < RW_JB; ++jj) {
          const int j = j0 + jj;
          const float h2 = bf16_round(tanhf(bf16_round(__fadd_rn(acc[jj], load_f<kGlobal>(B1 + j)))));
          for (int a = 0; a < A; ++a)
            lg[a] = __fadd_rn(lg[a], __fmul_rn(h2, load_f<kGlobal>(WP + a * H2 + j)));
          val = __fadd_rn(val, __fmul_rn(h2, load_f<kGlobal>(WV + j)));
          for (int k = 0; k < M; ++k)
            ml[k] = __fadd_rn(ml[k], __fmul_rn(h2, load_f<kGlobal>(WM + k * H2 + j)));
        }
      }
      for (int a = 0; a < A; ++a) lg[a] = __fadd_rn(lg[a], load_f<kGlobal>(BP + a));
      val = __fadd_rn(val, load_f<kGlobal>(BV));
      for (int k = 0; k < M; ++k) ml[k] = __fadd_rn(ml[k], load_f<kGlobal>(BM + k));

      float lp;
      const int act = sample_gumbel(lg, A, m.deterministic, d, e, t, i, &lp);
      if (kMsg) {
        lp = __fadd_rn(lp, sample_bernoulli(ml, M, m.deterministic, d, e, t, i, nmsg + i * M));
        for (int k = 0; k < M; ++k) bits_out[row * M + k] = nmsg[i * M + k];
      }
      acts[i] = act;
      action[row] = act;
      logp[row] = lp;
      value[row] = val;
    }
    if (kMsg)
      for (int k = 0; k < N * M; ++k) st.msg[k] = nmsg[k];  // env_step clears them on done
    const bool done = env_step(st, acts, rew, d, lay, e, t);
    for (int i = 0; i < N; ++i) reward[((size_t)t * B + e) * N + i] = rew[i];
    done_out[(size_t)t * B + e] = done ? 1 : 0;
  }
  store_state(st, d, state_out, e, B);
}

// img_*: the image mode (K2e; ObsDims), img_n_layers = 0 for FLATTENED.
// weights_global: dense_0 and dense_1 arrive as (in, out) stacks and are read
// from device memory (kGlobal); else as (out, in) stacks, held in shared memory.
extern "C" int rw_fused_collect(int n, int s, int r, int g, int h, int w, int reward_type,
                                int max_steps, int max_inactive, int msg_bits,
                                unsigned long long seed,
                                int deterministic, int T, int B, int sensor_range, int normalised,
                                int img_layers, int img_n_layers, int img_directional,
                                int img_self, int L, int H1, int H2, int A, int threads,
                                int smem_bytes, int n_stacks, int weights_global,
                                const void* layout, const void* state_in, void* state_out,
                                const void* w0, const void* b0, const void* w1, const void* b1,
                                const void* wp, const void* bp, const void* wv, const void* bv,
                                const void* wm, const void* bm, void* obs, void* action,
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
  if (A > RW_MAX_A || H1 % RW_JB || H2 % RW_JB || (n_stacks != 1 && n_stacks != n) ||
      n > RW_MAX_N || msg_bits > RW_MAX_M || img_n_layers < 0 || img_n_layers > RW_MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  // [image][message][weights in device memory]
  decltype(&fused_collect_kernel<false, false, false>) const kernels[2][2][2] = {
      {{fused_collect_kernel<false, false, false>, fused_collect_kernel<true, false, false>},
       {fused_collect_kernel<false, true, false>, fused_collect_kernel<true, true, false>}},
      {{fused_collect_kernel<false, false, true>, fused_collect_kernel<true, false, true>},
       {fused_collect_kernel<false, true, true>, fused_collect_kernel<true, true, true>}}};
  const auto kernel = kernels[img_n_layers > 0][msg_bits > 0][weights_global != 0];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + threads - 1) / threads;
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      d, m, T, B, (const int*)layout, (const int*)state_in, (int*)state_out,
      (const __nv_bfloat16*)w0, (const float*)b0, (const __nv_bfloat16*)w1, (const float*)b1,
      (const float*)wp, (const float*)bp, (const float*)wv, (const float*)bv, (const float*)wm,
      (const float*)bm, (__nv_bfloat16*)obs, (int*)action, (int*)bits, (float*)logp,
      (float*)value, (float*)reward, (uint8_t*)done);
  return (int)cudaGetLastError();
}
