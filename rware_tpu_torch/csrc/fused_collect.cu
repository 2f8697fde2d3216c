// K2a: the fused MLP-policy collector — per step: FLATTENED observation,
// shared ActorCritic forward, Gumbel-argmax sample, env step, autoreset; the
// trajectory (obs bf16, action, logp, value, reward, done) is streamed out.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_collect in mode
// policy="mlp", FLATTENED observations, msg_bits=0 (kernel body
// _make_collect_kernel; _build_obs_feats, _policy_forward, _sample_gumbel).
// The TPU kernel feeds a whole (L, N*1024) feature tile to the MXU; here one
// thread owns one env and runs its agents' MLPs with scalar loops over
// weights held in dynamic shared memory (dense_0 and dense_1 in bf16, the
// heads in f32 — about 53 KB at hidden (128, 128), above the 48 KB static
// limit).  Each thread keeps its observation and first hidden layer as bf16
// columns of shared-memory tiles, so no thread reads another's data and the
// only barrier is after the weight load.
//
// Numerics follow the Pallas recipe: bf16 inputs and weights, f32 sums, the
// f32 bias added, rounded to bf16, tanh of that value rounded to bf16; the
// f32 heads read the bf16 hidden.  Sums run over the input features in
// ascending order with separately rounded multiplies and adds (no FMA), the
// order of rware_tpu_torch/models/networks.py::ordered_linear, so the plain
// version reproduces the kernel bit for bit on the card.
//
// Bound on the card: the MLP's FP32 multiply/add issue (about 52k
// multiply-adds per env-step at 2 agents, hidden (128, 128)) and the
// shared-memory reads feeding it; eight outputs share each input read.
// The trajectory writes (about 300 bytes per env-step at tiny-2ag) are the
// device-memory traffic.
#include <cuda_bf16.h>

#include "env_core.cuh"

#define RW_MAX_A 8
#define RW_JB 8  // hidden outputs computed together per input read

struct MlpDims {
  int L, H1, H2, A;
  int sensor_range, normalised, deterministic;
};

// FLATTENED observation of agent i into this thread's column of `xs`
// (rware_tpu_torch/core/observations.py; empty cells read dir [1,0,0,0]).
static __device__ void build_obs(const EnvState& st, const EnvDims& d, const EnvLayout& lay,
                                 const MlpDims& m, int i, __nv_bfloat16* xs, int TB, int tid) {
  const int N = d.n, S = d.s, R = d.r, W = d.w, sr = m.sensor_range;
  const int side = 2 * sr + 1, w2 = side * side;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#define X(k) xs[(size_t)(k) * TB + tid]
  float fx = (float)st.ax[i], fy = (float)st.ay[i];
  if (m.normalised) {
    fx = __fdiv_rn(fx, (float)(W - 1));
    fy = __fdiv_rn(fy, (float)(d.h - 1));
  }
  X(0) = __float2bfloat16_rn(fx);
  X(1) = __float2bfloat16_rn(fy);
  X(2) = st.carry[i] >= 0 ? one : zero;
  for (int k = 0; k < 4; ++k) X(3 + k) = st.ad[i] == k ? one : zero;
  X(7) = lay.highway[st.ay[i] * W + st.ax[i]] ? one : zero;
  for (int c = 0; c < w2; ++c) {
    const int b = 8 + 7 * c;
    X(b) = zero;
    X(b + 1) = one;
    X(b + 2) = zero;
    X(b + 3) = zero;
    X(b + 4) = zero;
    X(b + 5) = zero;
    X(b + 6) = zero;
  }
  for (int j = 0; j < N; ++j) {
    const int rx = st.ax[j] - st.ax[i] + sr, ry = st.ay[j] - st.ay[i] + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + 7 * (ry * side + rx);
    X(b) = one;
    X(b + 1) = zero;
    X(b + 1 + st.ad[j]) = one;
  }
  for (int s = 0; s < S; ++s) {
    const int rx = st.scell[s] % W - st.ax[i] + sr, ry = st.scell[s] / W - st.ay[i] + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + 7 * (ry * side + rx);
    X(b + 5) = one;
    bool inq = false;
    for (int r = 0; r < R; ++r) inq |= st.q[r] == s;
    if (inq) X(b + 6) = one;
  }
#undef X
}

static __device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void fused_collect_kernel(EnvDims d, MlpDims m, int T, int B,
                                     const int* __restrict__ layout,
                                     const int* __restrict__ state_in, int* __restrict__ state_out,
                                     const __nv_bfloat16* __restrict__ w0,
                                     const float* __restrict__ b0,
                                     const __nv_bfloat16* __restrict__ w1,
                                     const float* __restrict__ b1, const float* __restrict__ wp,
                                     const float* __restrict__ bp, const float* __restrict__ wv,
                                     const float* __restrict__ bv, __nv_bfloat16* __restrict__ obs,
                                     int* __restrict__ action, float* __restrict__ logp,
                                     float* __restrict__ value, float* __restrict__ reward,
                                     uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = m.L, H1 = m.H1, H2 = m.H2, A = m.A, N = d.n;
  const int TB = blockDim.x, tid = threadIdx.x;

  // Shared memory: f32 [b0 H1 | b1 H2 | wp A*H2 | bp A | wv H2 | bv 1], padded
  // to 16 bytes, then bf16 [w0 H1*L | w1 H2*H1 | xs L*TB | hs H1*TB].
  float* sb0 = (float*)smem;
  float* sb1 = sb0 + H1;
  float* swp = sb1 + H2;
  float* sbp = swp + A * H2;
  float* swv = sbp + A;
  float* sbv = swv + H2;
  const size_t fbytes = ((size_t)(H1 + H2 + A * H2 + A + H2 + 1) * 4 + 15) & ~(size_t)15;
  __nv_bfloat16* sw0 = (__nv_bfloat16*)(smem + fbytes);
  __nv_bfloat16* sw1 = sw0 + (size_t)H1 * L;
  __nv_bfloat16* xs = sw1 + (size_t)H2 * H1;
  __nv_bfloat16* hs = xs + (size_t)L * TB;
  for (int k = tid; k < H1 * L; k += TB) sw0[k] = w0[k];
  for (int k = tid; k < H2 * H1; k += TB) sw1[k] = w1[k];
  for (int k = tid; k < A * H2; k += TB) swp[k] = wp[k];
  for (int k = tid; k < H1; k += TB) sb0[k] = b0[k];
  for (int k = tid; k < H2; k += TB) {
    sb1[k] = b1[k];
    swv[k] = wv[k];
  }
  for (int k = tid; k < A; k += TB) sbp[k] = bp[k];
  if (tid == 0) sbv[0] = bv[0];
  __syncthreads();

  const int e = blockIdx.x * TB + tid;
  if (e >= B) return;
  const EnvLayout lay = make_layout(d, layout);
  EnvState st;
  load_state(st, d, state_in, e, B);
  int acts[RW_MAX_N];
  float rew[RW_MAX_N];

  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < N; ++i) {
      const size_t row = ((size_t)t * B + e) * N + i;
      build_obs(st, d, lay, m, i, xs, TB, tid);
      for (int k = 0; k < L; ++k) obs[row * L + k] = xs[(size_t)k * TB + tid];

      // dense_0 + tanh -> hs (bf16)
      for (int j0 = 0; j0 < H1; j0 += RW_JB) {
        float acc[RW_JB];
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < L; ++k) {
          const float xv = __bfloat162float(xs[(size_t)k * TB + tid]);
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj)
            acc[jj] = __fadd_rn(acc[jj], __fmul_rn(xv, __bfloat162float(sw0[(size_t)(j0 + jj) * L + k])));
        }
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) {
          const float v = bf16_round(__fadd_rn(acc[jj], sb0[j0 + jj]));
          hs[(size_t)(j0 + jj) * TB + tid] = __float2bfloat16_rn(tanhf(v));
        }
      }
      // dense_1 + tanh, folded into the f32 heads in hidden order
      float lg[RW_MAX_A];
      for (int a = 0; a < A; ++a) lg[a] = 0.f;
      float val = 0.f;
      for (int j0 = 0; j0 < H2; j0 += RW_JB) {
        float acc[RW_JB];
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < H1; ++k) {
          const float hv = __bfloat162float(hs[(size_t)k * TB + tid]);
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj)
            acc[jj] = __fadd_rn(acc[jj], __fmul_rn(hv, __bfloat162float(sw1[(size_t)(j0 + jj) * H1 + k])));
        }
        for (int jj = 0; jj < RW_JB; ++jj) {
          const int j = j0 + jj;
          const float h2 = bf16_round(tanhf(bf16_round(__fadd_rn(acc[jj], sb1[j]))));
          for (int a = 0; a < A; ++a) lg[a] = __fadd_rn(lg[a], __fmul_rn(h2, swp[a * H2 + j]));
          val = __fadd_rn(val, __fmul_rn(h2, swv[j]));
        }
      }
      for (int a = 0; a < A; ++a) lg[a] = __fadd_rn(lg[a], sbp[a]);
      val = __fadd_rn(val, sbv[0]);

      // Gumbel-argmax over 23-bit uniforms (argmax in deterministic mode);
      // ties go to the lowest action.
      int act = 0;
      float best = 0.f;
      for (int a = 0; a < A; ++a) {
        float score = lg[a];
        if (!m.deterministic) {
          const uint32_t bits = draw_bits(d, e, t, RW_ACTION, i * A + a);
          const float u = (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f);
          score = __fsub_rn(lg[a], logf(__fadd_rn(-logf(__fadd_rn(u, 1e-10f)), 1e-10f)));
        }
        if (a == 0 || score > best) {
          best = score;
          act = a;
        }
      }
      float mx = lg[0];
      for (int a = 1; a < A; ++a) mx = fmaxf(mx, lg[a]);
      float ssum = 0.f;
      for (int a = 0; a < A; ++a) ssum += expf(lg[a] - mx);
      acts[i] = act;
      action[row] = act;
      logp[row] = lg[act] - (mx + logf(ssum));
      value[row] = val;
    }
    const bool done = env_step(st, acts, rew, d, lay, e, t);
    for (int i = 0; i < N; ++i) reward[((size_t)t * B + e) * N + i] = rew[i];
    done_out[(size_t)t * B + e] = done ? 1 : 0;
  }
  store_state(st, d, state_out, e, B);
}

extern "C" int rw_fused_collect(int n, int s, int r, int g, int h, int w, int reward_type,
                                int max_steps, int max_inactive, unsigned long long seed,
                                int deterministic, int T, int B, int sensor_range, int normalised,
                                int L, int H1, int H2, int A, int threads, int smem_bytes,
                                const void* layout, const void* state_in, void* state_out,
                                const void* w0, const void* b0, const void* w1, const void* b1,
                                const void* wp, const void* bp, const void* wv, const void* bv,
                                void* obs, void* action, void* logp, void* value, void* reward,
                                void* done, void* stream) {
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
  d.scripted = deterministic;
  d.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  d.seed_hi = (uint32_t)(seed >> 32);
  MlpDims m;
  m.L = L;
  m.H1 = H1;
  m.H2 = H2;
  m.A = A;
  m.sensor_range = sensor_range;
  m.normalised = normalised;
  m.deterministic = deterministic;
  cudaError_t err = cudaFuncSetAttribute(
      fused_collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + threads - 1) / threads;
  fused_collect_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      d, m, T, B, (const int*)layout, (const int*)state_in, (int*)state_out,
      (const __nv_bfloat16*)w0, (const float*)b0, (const __nv_bfloat16*)w1, (const float*)b1,
      (const float*)wp, (const float*)bp, (const float*)wv, (const float*)bv,
      (__nv_bfloat16*)obs, (int*)action, (float*)logp, (float*)value, (float*)reward,
      (uint8_t*)done);
  return (int)cudaGetLastError();
}
