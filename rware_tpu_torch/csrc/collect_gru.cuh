// K2c and K2d′: the fused recurrent collector kernel — per step: FLATTENED
// or image observation, embed + GRU cell + f32 heads of a RecurrentActorCritic,
// Gumbel-argmax sample, env step, autoreset; the hidden carry stays on the
// card for the whole rollout and is zeroed where an episode ends.  The
// trajectory (obs bf16, action, logp, value, reward, done) is streamed out.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_collect in modes
// policy="gru" (K2c: one RecurrentActorCritic shared by all agents;
// _gru_forward, and the carry handling of _make_collect_kernel) and
// policy="gru_per_agent" (K2d′: agent i runs its own GRU i on its own carry;
// _gru_forward_per_agent, pallas_rollout.py:1376), FLATTENED observations.
// Both take image observations (K2e, IMAGE and IMAGE_DICT;
// pallas_rollout.py:1109) in an instantiation of their own (kImage), the
// window built into the observation tile by collect_core.cuh::build_image_obs
// (see fused_collect.cu); composed with every message width, whose bits are
// sampled and fed back but not observed, as in the TPU kernel.  Its 18
// instantiations are built in fused_collect_gru_image.cu, a translation unit
// of their own, so that nvcc compiles them beside fused_collect_gru.cu's 18
// FLATTENED ones (one nvcc process per source, all started together).
// Both carry the message mode K2b (msg_bits M > 0): the head block becomes
// [policy | value | message] (Hg, A + 1 + M), the M message logits summed in
// hidden order beside the others, and the bits are sampled, streamed out and
// fed back as in K2a (fused_collect.cu, pallas_rollout.py:1487-1491,
// 1944-1947, 2017-2035).  M is a template argument (kM, one instantiation per
// width up to RW_MAX_M): the logits stay in registers and the collector
// without message bits (kM = 0) compiles as before it.  The per-agent mode is
// a template argument too (kPerAgent), so K2c's instantiations compile to the
// code they had before it.
// The TPU kernel feeds (L, N*1024) feature tiles to the MXU and keeps the (Hg, N, 8, 128) carry in VMEM
// scratch; here one thread owns one env (K2a's design) and runs its agents'
// cells with scalar loops.  The three weight matrices (We, Wi = [ir|iz|in],
// Wh = [hr|hz|hn], bf16, 210 KB at L=71, E=Hg=128) do not fit beside the
// per-thread tiles in a block's 227 KB of shared memory, so they are read
// from device memory through the read-only cache: every thread of a warp
// reads the same 16 bytes (eight outputs of one input row), one broadcast
// load per 8 x 32 multiply-adds, and the matrices stay in L1/L2.  K2d′ reads
// agent i's matrices from stack i of N stacks back to back (an agent stride);
// its N blocks of f32 biases and heads sit in shared memory where they fit
// beside the tiles (6.7 KB an agent at E=Hg=128, M=2), else they are read
// from device memory as well.  Each thread keeps its observation, embedding
// and previous hidden as bf16 columns of shared-memory tiles; the carry of
// all agents lives in a (N, Hg, B) bf16 buffer in device memory (coalesced
// over envs), one row block per agent, updated in place.
//
// Numerics follow _gru_forward (pallas_rollout.py:1472-1486), which
// _gru_forward_per_agent repeats per agent: bf16 inputs and
// weights, f32 sums; e = tanh(bf16(x We + be)); r, z = bf16(sigmoid(e Wi + h
// Wh + b)) with the two sums added in f32; n = tanh(bf16(e Win + bin) + r *
// bf16(h Whn + bhn)) in bf16 arithmetic; new_h = (1 - z) * n + z * h in bf16
// arithmetic; f32 heads on f32 weights.  Sums run over the input features in
// ascending order with separately rounded multiplies and adds (no FMA) and
// the sigmoid is 1 / (1 + expf(-x)) with one rounded add and one rounded
// division: the order and formulas of
// rware_tpu_torch/models/networks.py::gru_collect_step, so the plain version
// reproduces the kernel on the card and a rounding difference cannot feed
// back through the recurrence into later actions.
//
// Bound on the card: the cell's FP32 multiply/add throughput, about 108k
// multiply-adds per agent-step at L=71, E=Hg=128 (embed 9k, input gates 49k,
// hidden gates 49k, heads 0.8k), four times K2a's MLP, whichever GRU each
// agent runs; K2d′ also reads N stacks of weights, N times K2c's L1/L2 reuse
// footprint.
#pragma once

#include "collect_core.cuh"
#include "gru_core.cuh"  // gru_load8, gru_sigmoid

struct GruCollectDims {
  int L, E, Hg, A;
  int deterministic;
  ObsDims obs;
  int smem_stacks;  // K2d′: agents' f32 bias and head blocks in shared memory (N or 0)
};

// kM: message bits per agent, 0 without the message head; kPerAgent: agent i
// runs weight stack i (K2d′), else every agent runs the one stack (K2c);
// kImage: image observations (K2e), else FLATTENED
template <int kM, bool kPerAgent, bool kImage>
__global__ void __launch_bounds__(128)
    fused_collect_gru_kernel(EnvDims d, GruCollectDims m, int T, int B,
                             const int* __restrict__ layout, const int* __restrict__ state_in,
                             int* __restrict__ state_out, const __nv_bfloat16* __restrict__ we,
                             const float* __restrict__ be, const __nv_bfloat16* __restrict__ wi,
                             const float* __restrict__ bi, const __nv_bfloat16* __restrict__ wh,
                             const float* __restrict__ bhn, const float* __restrict__ wc,
                             const float* __restrict__ bc, __nv_bfloat16* __restrict__ hbuf,
                             __nv_bfloat16* __restrict__ obs, int* __restrict__ action,
                             int* __restrict__ bits_out, float* __restrict__ logp,
                             float* __restrict__ value,
                             float* __restrict__ reward, uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = m.L, E = m.E, Hg = m.Hg, A = m.A, AC = m.A + 1 + kM, N = d.n;
  const int TB = blockDim.x, tid = threadIdx.x;

  const int WS = kPerAgent ? m.smem_stacks : 1;  // bias and head blocks held in shared memory

  // Shared memory: f32 [be WS*E | bi WS*3Hg | bhn WS*Hg | wc WS*Hg*AC | bc
  // WS*AC], padded to 16 bytes, then bf16 tiles [xs L*TB | es E*TB | hs
  // Hg*TB].  Each input array is its stacks back to back.
  float* sbe = (float*)smem;
  float* sbi = sbe + WS * E;
  float* sbhn = sbi + WS * 3 * Hg;
  float* swc = sbhn + WS * Hg;
  float* sbc = swc + WS * Hg * AC;
  const size_t fbytes = ((size_t)WS * (E + 4 * Hg + Hg * AC + AC) * 4 + 15) & ~(size_t)15;
  __nv_bfloat16* xs = (__nv_bfloat16*)(smem + fbytes);
  __nv_bfloat16* es = xs + (size_t)L * TB;
  __nv_bfloat16* hs = es + (size_t)E * TB;
  for (int k = tid; k < WS * E; k += TB) sbe[k] = be[k];
  for (int k = tid; k < WS * 3 * Hg; k += TB) sbi[k] = bi[k];
  for (int k = tid; k < WS * Hg; k += TB) sbhn[k] = bhn[k];
  for (int k = tid; k < WS * Hg * AC; k += TB) swc[k] = wc[k];
  for (int k = tid; k < WS * AC; k += TB) sbc[k] = bc[k];
  __syncthreads();

  const int e = blockIdx.x * TB + tid;
  if (e >= B) return;
  const EnvLayout lay = make_layout(d, layout);
  EnvState st;
  load_state(st, d, state_in, e, B);
  int acts[RW_MAX_N];
  float rew[RW_MAX_N];
  int nmsg[RW_MAX_N * (kM > 0 ? kM : 1)];  // this step's sampled bits, agent-major

  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < N; ++i) {
      const size_t row = ((size_t)t * B + e) * N + i;
      build_agent_obs<(kM > 0), kImage>(st, d, lay, m.obs, i, xs, TB, tid);
      for (int k = 0; k < L; ++k) obs[row * L + k] = xs[(size_t)k * TB + tid];

      // this agent's GRU: stack i (K2d′), its biases and heads in shared or
      // device memory, or the one shared stack (K2c)
      const bool in_smem = !kPerAgent || m.smem_stacks > 0;
      const __nv_bfloat16* We = kPerAgent ? we + (size_t)i * L * E : we;
      const __nv_bfloat16* Wi = kPerAgent ? wi + (size_t)i * E * 3 * Hg : wi;
      const __nv_bfloat16* Wh = kPerAgent ? wh + (size_t)i * Hg * 3 * Hg : wh;
      const int si = kPerAgent ? i : 0;
      const float* Be = (in_smem ? sbe : be) + si * E;
      const float* Bi = (in_smem ? sbi : bi) + si * 3 * Hg;
      const float* Bhn = (in_smem ? sbhn : bhn) + si * Hg;
      const float* Wc = (in_smem ? swc : wc) + si * Hg * AC;
      const float* Bc = (in_smem ? sbc : bc) + si * AC;

      // embed: es = bf16(tanh(bf16(x We + be)))
      for (int j0 = 0; j0 < E; j0 += RW_JB) {
        float acc[RW_JB];
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < L; ++k) {
          const float xv = __bfloat162float(xs[(size_t)k * TB + tid]);
          float w[RW_JB];
          gru_load8(We + (size_t)k * E + j0, w);
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj) acc[jj] = __fadd_rn(acc[jj], __fmul_rn(xv, w[jj]));
        }
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) {
          const float v = bf16_round(__fadd_rn(acc[jj], Be[j0 + jj]));
          es[(size_t)(j0 + jj) * TB + tid] = __float2bfloat16_rn(tanhf(v));
        }
      }
      // this agent's carry -> hs
      __nv_bfloat16* hrow = hbuf + (size_t)i * Hg * B + e;
      for (int k = 0; k < Hg; ++k) hs[(size_t)k * TB + tid] = hrow[(size_t)k * B];

      // the cell, eight hidden units at a time, folded into the f32 heads in
      // hidden order
      float lg[RW_MAX_A], ml[kM > 0 ? kM : 1];
      for (int a = 0; a < A; ++a) lg[a] = 0.f;
#pragma unroll
      for (int k = 0; k < kM; ++k) ml[k] = 0.f;
      float val = 0.f;
      for (int j0 = 0; j0 < Hg; j0 += RW_JB) {
        float ai[3][RW_JB], ah[3][RW_JB];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int jj = 0; jj < RW_JB; ++jj) ai[g][jj] = ah[g][jj] = 0.f;
        for (int k = 0; k < E; ++k) {
          const float ev = __bfloat162float(es[(size_t)k * TB + tid]);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float w[RW_JB];
            gru_load8(Wi + (size_t)k * 3 * Hg + g * Hg + j0, w);
#pragma unroll
            for (int jj = 0; jj < RW_JB; ++jj)
              ai[g][jj] = __fadd_rn(ai[g][jj], __fmul_rn(ev, w[jj]));
          }
        }
        for (int k = 0; k < Hg; ++k) {
          const float hv = __bfloat162float(hs[(size_t)k * TB + tid]);
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float w[RW_JB];
            gru_load8(Wh + (size_t)k * 3 * Hg + g * Hg + j0, w);
#pragma unroll
            for (int jj = 0; jj < RW_JB; ++jj)
              ah[g][jj] = __fadd_rn(ah[g][jj], __fmul_rn(hv, w[jj]));
          }
        }
#pragma unroll
        for (int jj = 0; jj < RW_JB; ++jj) {
          const int j = j0 + jj;
          const float r =
              bf16_round(gru_sigmoid(__fadd_rn(__fadd_rn(ai[0][jj], ah[0][jj]), Bi[j])));
          const float z =
              bf16_round(gru_sigmoid(__fadd_rn(__fadd_rn(ai[1][jj], ah[1][jj]), Bi[Hg + j])));
          const float in_b = bf16_round(__fadd_rn(ai[2][jj], Bi[2 * Hg + j]));
          const float hn_b = bf16_round(__fadd_rn(ah[2][jj], Bhn[j]));
          const float nn =
              bf16_round(tanhf(bf16_round(__fadd_rn(in_b, bf16_round(__fmul_rn(r, hn_b))))));
          const float hp = __bfloat162float(hs[(size_t)j * TB + tid]);
          const float nh = bf16_round(__fadd_rn(bf16_round(__fmul_rn(bf16_round(__fsub_rn(1.f, z)), nn)),
                                                bf16_round(__fmul_rn(z, hp))));
          hrow[(size_t)j * B] = __float2bfloat16_rn(nh);
          for (int a = 0; a < A; ++a) lg[a] = __fadd_rn(lg[a], __fmul_rn(nh, Wc[j * AC + a]));
          val = __fadd_rn(val, __fmul_rn(nh, Wc[j * AC + A]));
#pragma unroll
          for (int k = 0; k < kM; ++k)
            ml[k] = __fadd_rn(ml[k], __fmul_rn(nh, Wc[j * AC + A + 1 + k]));
        }
      }
      for (int a = 0; a < A; ++a) lg[a] = __fadd_rn(lg[a], Bc[a]);
      val = __fadd_rn(val, Bc[A]);
#pragma unroll
      for (int k = 0; k < kM; ++k) ml[k] = __fadd_rn(ml[k], Bc[A + 1 + k]);

      float lp;
      const int act = sample_gumbel(lg, A, m.deterministic, d, e, t, i, &lp);
      if (kM > 0) {
        lp = __fadd_rn(lp, sample_bernoulli(ml, kM, m.deterministic, d, e, t, i, nmsg + i * kM));
        for (int k = 0; k < kM; ++k) bits_out[row * kM + k] = nmsg[i * kM + k];
      }
      acts[i] = act;
      action[row] = act;
      logp[row] = lp;
      value[row] = val;
    }
    if (kM > 0)
      for (int k = 0; k < N * kM; ++k) st.msg[k] = nmsg[k];  // env_step clears them on done
    const bool done = env_step(st, acts, rew, d, lay, e, t);
    for (int i = 0; i < N; ++i) reward[((size_t)t * B + e) * N + i] = rew[i];
    done_out[(size_t)t * B + e] = done ? 1 : 0;
    if (done) {  // the carry restarts with the episode
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int k = 0; k < N * Hg; ++k) hbuf[(size_t)k * B + e] = zero;
    }
  }
  store_state(st, d, state_out, e, B);
}

// The launch arguments of one collector call besides its dimensions.
struct GruCollectArgs {
  const void *layout, *state_in;
  void* state_out;
  const void *we, *be, *wi, *bi, *wh, *bhn, *wc, *bc;
  void *hbuf, *obs, *action, *bits, *logp, *value, *reward, *done, *stream;
};

// Launches the instantiation of (kImage, per agent, message width).
template <bool kImage>
static int launch_collect_gru(const EnvDims& d, const GruCollectDims& m, int T, int B,
                              int threads, int smem_bytes, bool per_agent,
                              const GruCollectArgs& a) {
  static_assert(RW_MAX_M == 8, "one instantiation per message width");
#define RW_WIDTHS(P)                                                                             \
  {fused_collect_gru_kernel<0, P, kImage>, fused_collect_gru_kernel<1, P, kImage>,               \
   fused_collect_gru_kernel<2, P, kImage>, fused_collect_gru_kernel<3, P, kImage>,               \
   fused_collect_gru_kernel<4, P, kImage>, fused_collect_gru_kernel<5, P, kImage>,               \
   fused_collect_gru_kernel<6, P, kImage>, fused_collect_gru_kernel<7, P, kImage>,               \
   fused_collect_gru_kernel<8, P, kImage>}
  // [per agent][message width]
  decltype(&fused_collect_gru_kernel<0, false, kImage>) const kernels[2][RW_MAX_M + 1] = {
      RW_WIDTHS(false), RW_WIDTHS(true)};
#undef RW_WIDTHS
  const auto kernel = kernels[per_agent ? 1 : 0][d.m];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + threads - 1) / threads;
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)a.stream>>>(
      d, m, T, B, (const int*)a.layout, (const int*)a.state_in, (int*)a.state_out,
      (const __nv_bfloat16*)a.we, (const float*)a.be, (const __nv_bfloat16*)a.wi,
      (const float*)a.bi, (const __nv_bfloat16*)a.wh, (const float*)a.bhn, (const float*)a.wc,
      (const float*)a.bc, (__nv_bfloat16*)a.hbuf, (__nv_bfloat16*)a.obs, (int*)a.action,
      (int*)a.bits, (float*)a.logp, (float*)a.value, (float*)a.reward, (uint8_t*)a.done);
  return (int)cudaGetLastError();
}

// The image instantiations' launcher (fused_collect_gru_image.cu).
int launch_collect_gru_image(const EnvDims& d, const GruCollectDims& m, int T, int B,
                             int threads, int smem_bytes, bool per_agent,
                             const GruCollectArgs& a);
