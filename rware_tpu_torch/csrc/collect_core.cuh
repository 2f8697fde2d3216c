// Pieces shared by the fused collector kernels (K2a fused_collect.cu, K2c
// fused_collect_gru.cu): the FLATTENED observation written into a thread's
// column of a shared-memory tile, bf16 rounding, and the Gumbel-argmax sample
// with its log-probability.
#pragma once

#include <cuda_bf16.h>

#include "env_core.cuh"

#define RW_MAX_A 8
#define RW_JB 8  // hidden outputs computed together per input read

struct ObsDims {
  int L, sensor_range, normalised;
};

// FLATTENED observation of agent i into this thread's column of `xs`
// (rware_tpu_torch/core/observations.py; empty cells read dir [1,0,0,0]).
static __device__ void build_obs(const EnvState& st, const EnvDims& d, const EnvLayout& lay,
                                 const ObsDims& m, int i, __nv_bfloat16* xs, int TB, int tid) {
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

// Gumbel-argmax over 23-bit uniforms (argmax in deterministic mode; ties go
// to the lowest action) from the A logits `lg` of agent i of env e at step t,
// and the log-probability of the action taken.
static __device__ __forceinline__ int sample_gumbel(const float* lg, int A, int deterministic,
                                                    const EnvDims& d, int e, int t, int i,
                                                    float* logp) {
  int act = 0;
  float best = 0.f;
  for (int a = 0; a < A; ++a) {
    float score = lg[a];
    if (!deterministic) {
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
  *logp = lg[act] - (mx + logf(ssum));
  return act;
}
