// The per-sample kernel of the PPO gradient kernels, as a template of five
// modes, each instantiated in one source file:
//
//  PPO_ACTOR  (fused_ppo_grads.cu): the shared-parameter policy on samples
//             (t, b, n): forward, clipped-PPO loss pieces, backward to dz1.
//             d.value_head = 0 is MAPPO's actor: no value term, and the local
//             value head's dcat row exactly zero.
//  PPO_MSG    (fused_ppo_grads.cu): PPO_ACTOR with K4's message head,
//             d.msg_bits = M > 0 Bernoulli logits after the value: the joint
//             move + bits log-probability and entropy, and M more dcat rows
//             (pallas_update.py:185-224).  A mode of its own, so that the
//             other modes compile to the code they had before it.
//  PPO_CRITIC (fused_mappo_grads.cu): MAPPO's central critic on samples
//             (t, b) with one value per agent: forward, clipped value loss,
//             backward to dz1 (pallas_update.py:1350-1388).
//  PPO_VALUES (fused_critic_values.cu): the critic's forward alone, values
//             written to ws.values (pallas_update.py:1786-1804).
//  PPO_SEAC   (fused_seac_grads.cu): agent d.agent's network on samples
//             (t, b, j) of every agent j: PPO_ACTOR's pieces with the pair
//             weight w = 1 (j == i) or seac_lambda on the policy and value
//             terms, and the entropy term and KL sum on the diagonal j == i
//             only (pallas_update.py:592-599, 641-714).
//
// A block holds the weights in shared memory (dense_0 and dense_1 in bf16,
// heads in f32) and walks tiles of samples with register tiles of 4 x 4
// products on the FP32 pipes.  It writes the per-sample activations the
// weight gradients need (h1, h2, dz1, dz2 bf16; dcat f32) and its partial
// metric sums (fixed order).
#pragma once

#include "ppo_core.cuh"

#define PPO_ACTOR 0
#define PPO_CRITIC 1
#define PPO_VALUES 2
#define PPO_SEAC 3
#define PPO_MSG 4

static __device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

static __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// out[j][s] = bf16(tanh(bf16(sum_k in[k][s] * w[k][j] + bias[j]))) for one
// tile; also written to out_g (S, J) bf16 unless that is null.  Warps span j, so a warp reads
// one broadcast input value and 32 consecutive weight pairs per k.  The
// weights are bf16 in shared memory, or (kGlobal) float32 in device memory,
// rounded to bf16 as they are read.
template <bool kGlobal>
static __device__ void dense_tanh(const float* in, int K, const __nv_bfloat16* w,
                                  const float* wg, const float* bias, int J, int TS, int LD,
                                  float* out, __nv_bfloat16* out_g, long long s0, long long S) {
  const int SQ = TS / 4, JQ = J / 4;
  for (int sb = threadIdx.x; sb < SQ * JQ; sb += PPO_THREADS) {
    const int sq = sb / JQ, jq = sb - sq * JQ;
    const int sl = sq * 4, j0 = jq * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4 xv = *(const float4*)(in + (size_t)k * LD + sl);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      float wv[4];
      if (kGlobal) {
        const float4 g = __ldg((const float4*)(wg + (size_t)k * J + j0));
        wv[0] = bf16r(g.x);
        wv[1] = bf16r(g.y);
        wv[2] = bf16r(g.z);
        wv[3] = bf16r(g.w);
      } else {
        const __nv_bfloat162* wp = (const __nv_bfloat162*)(w + (size_t)k * J + j0);
        const float2 wa = __bfloat1622float2(wp[0]), wb = __bfloat1622float2(wp[1]);
        wv[0] = wa.x;
        wv[1] = wa.y;
        wv[2] = wb.x;
        wv[3] = wb.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xa[r], wv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long g = s0 + sl + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float h = bf16r(tanhf(bf16r(acc[r][c] + bias[j0 + c])));
        out[(size_t)(j0 + c) * LD + sl + r] = h;
        if (out_g != nullptr && g < S) out_g[(size_t)g * J + j0 + c] = __float2bfloat16_rn(h);
      }
    }
  }
}

// out[i][s] = bf16(bf16(sum_j dz[j][s] * w[i][j]) * bf16(1 - bf16(h[i][s]^2)))
// for i < I: the backward through a bf16 dense + tanh layer.  Warps span s,
// so the weight loads are broadcasts.
static __device__ void dense_back(const float* dz, int J, const __nv_bfloat16* w, int I,
                                  const float* h, int TS, int LD, float* out) {
  const int SQ = TS / 4, IQ = I / 4;
  for (int sb = threadIdx.x; sb < SQ * IQ; sb += PPO_THREADS) {
    const int iq = sb / SQ, sq = sb - iq * SQ;
    const int i0 = iq * 4, sl = sq * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < J; ++j) {
      const float4 dv = *(const float4*)(dz + (size_t)j * LD + sl);
      const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float wv = __bfloat162float(w[(size_t)(i0 + r) * J + j]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv, da[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const size_t k = (size_t)(i0 + r) * LD + sl + c;
        const float hv = h[k];
        out[k] = bf16r(bf16r(acc[r][c]) * bf16r(1.f - bf16r(hv * hv)));
      }
  }
}

template <int kMode>
__global__ void __launch_bounds__(PPO_THREADS)
    ppo_sample_kernel(PpoDims d, const int* __restrict__ start_p, const float* __restrict__ stats,
                      PpoData data, const float* __restrict__ params, PpoScratch ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = d.L, H1 = d.H1, H2 = d.H2, A = d.A, AC = d.heads, HC = d.hc;
  const int TS = d.tile, LD = d.tile + 4, HM = H1 > H2 ? H1 : H2;
  const int tid = threadIdx.x;
  const PpoOffsets o = ppo_offsets(d);

  // Shared memory: f32 [b0 H1 | b1 H2 | wc H2*AC | bc AC], bf16 [w0 L*H1
  // (if w0_smem) | w1 H1*H2], f32 [xs L | h1 H1 | h2 HM | dz2 H2 | hc HC]
  // * LD and red 4*TS, then int64 rows TS (each region 16-byte aligned).
  float* sb0 = (float*)smem;
  float* sb1 = sb0 + H1;
  float* swc = sb1 + H2;
  float* sbc = swc + H2 * AC;
  const size_t fbytes = align16((size_t)(H1 + H2 + H2 * AC + AC) * 4);
  __nv_bfloat16* sw0 = (__nv_bfloat16*)(smem + fbytes);
  const size_t w0_len = d.w0_smem ? (size_t)L * H1 : 0;
  __nv_bfloat16* sw1 = sw0 + w0_len;
  const size_t wbytes = align16((w0_len + (size_t)H1 * H2) * 2);
  float* xs = (float*)(smem + fbytes + wbytes);
  float* h1 = xs + (size_t)L * LD;
  float* h2 = h1 + (size_t)H1 * LD;
  float* dz2 = h2 + (size_t)HM * LD;
  float* hc = dz2 + (size_t)H2 * LD;
  float* red = hc + (size_t)HC * LD;
  long long* rows = (long long*)(red + 4 * TS);

  for (int k = tid; k < (int)w0_len; k += PPO_THREADS) sw0[k] = __float2bfloat16_rn(params[k]);
  for (int k = tid; k < H1 * H2; k += PPO_THREADS) sw1[k] = __float2bfloat16_rn(params[o.w1 + k]);
  for (int k = tid; k < H2 * AC; k += PPO_THREADS) swc[k] = params[o.wc + k];
  for (int k = tid; k < H1; k += PPO_THREADS) sb0[k] = params[o.b0 + k];
  for (int k = tid; k < H2; k += PPO_THREADS) sb1[k] = params[o.b1 + k];
  if (tid < AC) sbc[tid] = params[o.bc + tid];

  const int start = kMode == PPO_VALUES ? 0 : start_p[0];
  const bool kPolicy = kMode == PPO_ACTOR || kMode == PPO_SEAC || kMode == PPO_MSG;
  const float adv_mean = kPolicy ? stats[0] : 0.f;
  const float adv_inv_std = kPolicy ? stats[1] : 0.f;
  const float eps = d.clip_eps, inv_n = d.inv_n;
  const long long S = (long long)d.T_mb * d.B * d.N;
  const long long n_tiles = (S + TS - 1) / TS;
  float msum = 0.f;  // thread m < 4: this block's sum of metric m
  __nv_bfloat16* g_h1 = kMode == PPO_VALUES ? nullptr : ws.h1;
  __nv_bfloat16* g_h2 = kMode == PPO_VALUES ? nullptr : ws.h2;
  __syncthreads();

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long s0 = tile * TS;
    if (tid < TS) rows[tid] = s0 + tid < S ? ppo_row(d, start, s0 + tid) : -1;
    __syncthreads();
    for (int idx = tid; idx < TS * L; idx += PPO_THREADS) {
      const int s = idx / L, k = idx - s * L;
      const long long r = rows[s];
      xs[(size_t)k * LD + s] = r >= 0 ? __bfloat162float(data.obs[r * L + k]) : 0.f;
    }
    __syncthreads();
    if (d.w0_smem)
      dense_tanh<false>(xs, L, sw0, nullptr, sb0, H1, TS, LD, h1, g_h1, s0, S);
    else
      dense_tanh<true>(xs, L, nullptr, params, sb0, H1, TS, LD, h1, g_h1, s0, S);
    __syncthreads();
    dense_tanh<false>(h1, H1, sw1, nullptr, sb1, H2, TS, LD, h2, g_h2, s0, S);
    __syncthreads();
    for (int idx = tid; idx < AC * TS; idx += PPO_THREADS) {
      const int a = idx / TS, s = idx - a * TS;
      float acc = 0.f;
      for (int k = 0; k < H2; ++k) acc = fmaf(h2[(size_t)k * LD + s], swc[k * AC + a], acc);
      hc[(size_t)a * LD + s] = acc + sbc[a];
      if (kMode == PPO_VALUES && rows[s] >= 0) ws.values[rows[s] * AC + a] = acc + sbc[a];
    }
    __syncthreads();

    if (kMode == PPO_VALUES) continue;  // the forward alone

    // Loss pieces, one thread per sample: hc's column becomes the head's
    // gradient, [dlogits | dvalue] (actor) or dvalue per agent (critic).
    if (tid < TS) {
      const int s = tid;
      const long long r = rows[s];
      float terms[4] = {0.f, 0.f, 0.f, 0.f};
      if (kMode == PPO_CRITIC) {
        // pallas_update.py:1368-1378, per agent n: values and targets at [r * AC + n]
        for (int n = 0; n < AC; ++n) {
          float dv = 0.f;
          if (r >= 0) {
            const float value = hc[(size_t)n * LD + s];
            const float old_value = data.value[r * AC + n], target = data.target[r * AC + n];
            const float vdiff = value - old_value;
            const float v_clip = old_value + fminf(fmaxf(vdiff, -eps), eps);
            const float e1 = value - target, e2 = v_clip - target;
            const bool inside_v = vdiff > -eps && vdiff < eps;
            dv = d.vf_coef * inv_n * (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.f));
            terms[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
            ws.dcat[(size_t)(s0 + s) * HC + n] = dv;
          }
          hc[(size_t)n * LD + s] = dv;
        }
      } else {
        constexpr int kHC = kMode == PPO_MSG ? PPO_HC_MAX : PPO_HC;  // local head rows
        float dcat[kHC];
#pragma unroll
        for (int a = 0; a < kHC; ++a) dcat[a] = 0.f;
        if (r >= 0) {
          // pair weight and diagonal mask: 1 and 1 but in SEAC mode
          float w = 1.f, diag = 1.f;
          if (kMode == PPO_SEAC) {
            diag = (int)(r % d.N) == d.agent ? 1.f : 0.f;
            w = diag + d.seac_lambda * (1.f - diag);
          }
          const int act = data.action[r];
          const float old_logp = data.logp[r], adv = data.adv[r];
          float lg[kHC], p[kHC];
          for (int a = 0; a < A; ++a) lg[a] = hc[(size_t)a * LD + s];
          float mx = lg[0];
          for (int a = 1; a < A; ++a) mx = fmaxf(mx, lg[a]);
          float z = 0.f;
          for (int a = 0; a < A; ++a) {
            p[a] = expf(lg[a] - mx);
            z += p[a];
          }
          const float lz = logf(z);
          float ent = 0.f, logp = 0.f;
          for (int a = 0; a < A; ++a) {
            lg[a] = lg[a] - mx - lz;  // log-softmax
            p[a] = p[a] / z;
            ent -= p[a] * lg[a];
            if (a == act) logp = lg[a];
          }
          // message bits: log sigmoid(+-l) = min(+-l, 0) - log(1 + exp(-|l|))
          // share the log term; the bits' log-probability joins the move's,
          // their entropy the metric's (the move's gradient keeps its own).
          const int MB = kMode == PPO_MSG ? d.msg_bits : 0;
          float sig[kHC], bitf[kHC];
          float ent_msg = 0.f;
          if (kMode == PPO_MSG) {
            float logp_msg = 0.f;
            for (int k = 0; k < MB; ++k) {
              const float l = hc[(size_t)(A + 1 + k) * LD + s];
              const float log1pe = logf(1.f + expf(-fabsf(l)));
              const float ls_p = fminf(l, 0.f) - log1pe, ls_n = fminf(-l, 0.f) - log1pe;
              bitf[k] = (float)data.bits[r * MB + k];
              sig[k] = 1.f / (1.f + expf(-l));
              logp_msg += bitf[k] * ls_p + (1.f - bitf[k]) * ls_n;
              ent_msg -= sig[k] * ls_p + (1.f - sig[k]) * ls_n;
            }
            logp += logp_msg;
          }
          const float ratio = expf(logp - old_logp);
          const float advn = (adv - adv_mean) * adv_inv_std;
          const float ratio_c = fminf(fmaxf(ratio, 1.f - eps), 1.f + eps);
          const float pg1 = ratio * advn, pg2 = ratio_c * advn;
          const bool inside = ratio > 1.f - eps && ratio < 1.f + eps;
          const float dobj = pg1 <= pg2 ? advn : (inside ? advn : 0.f);
          const float dlogp = -(w * inv_n) * dobj * ratio;
          const float ent_scale = d.ent_coef * inv_n * diag;
          for (int a = 0; a < A; ++a)
            dcat[a] = dlogp * ((a == act ? 1.f : 0.f) - p[a]) + ent_scale * p[a] * (lg[a] + ent);
          // d(pg)/dl = dlogp (bit - sigma); d(-ent_coef H)/dl = ent_coef l sigma (1 - sigma)
          for (int k = 0; k < MB; ++k) {
            const float l = hc[(size_t)(A + 1 + k) * LD + s];
            dcat[A + 1 + k] = dlogp * (bitf[k] - sig[k]) + ent_scale * l * sig[k] * (1.f - sig[k]);
          }
          if (d.value_head) {
            const float value = hc[(size_t)A * LD + s];
            const float old_value = data.value[r], target = data.target[r];
            const float vdiff = value - old_value;
            const float v_clip = old_value + fminf(fmaxf(vdiff, -eps), eps);
            const float e1 = value - target, e2 = v_clip - target;
            const bool inside_v = vdiff > -eps && vdiff < eps;
            dcat[A] = d.vf_coef * inv_n * w * (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.f));
            terms[1] = w * (0.5f * fmaxf(e1 * e1, e2 * e2));
          }
          terms[0] = w * fminf(pg1, pg2);
          terms[2] = diag * (kMode == PPO_MSG ? ent + ent_msg : ent);
          terms[3] = diag * ((ratio - 1.f) - (logp - old_logp));
          if (kMode == PPO_MSG) {
            float* dg = ws.dcat + (size_t)(s0 + s) * HC;
            for (int a = 0; a < HC; ++a) dg[a] = dcat[a];
          } else {
            float* dg = ws.dcat + (size_t)(s0 + s) * PPO_HC;
#pragma unroll
            for (int a = 0; a < PPO_HC; ++a) dg[a] = dcat[a];
          }
        }
        for (int a = 0; a < AC; ++a) hc[(size_t)a * LD + s] = dcat[a];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) red[m * TS + s] = terms[m];
    }
    __syncthreads();
    if (tid < 4)
      for (int s = 0; s < TS; ++s) msum += red[tid * TS + s];

    // dz2 = bf16(bf16(dcat Wc^T) * bf16(1 - bf16(h2^2))), to shared and global.
    for (int idx = tid; idx < TS * H2; idx += PPO_THREADS) {
      const int s = idx / H2, j = idx - s * H2;
      float acc = 0.f;
      for (int a = 0; a < AC; ++a) acc = fmaf(hc[(size_t)a * LD + s], swc[j * AC + a], acc);
      const float hv = h2[(size_t)j * LD + s];
      const float v = bf16r(bf16r(acc) * bf16r(1.f - bf16r(hv * hv)));
      dz2[(size_t)j * LD + s] = v;
      if (s0 + s < S) ws.dz2[(size_t)(s0 + s) * H2 + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // dz1 through dense_1, staged in the h2 buffer, then written out.
    dense_back(dz2, H2, sw1, H1, h1, TS, LD, h2);
    __syncthreads();
    for (int idx = tid; idx < TS * H1; idx += PPO_THREADS) {
      const int s = idx / H1, i = idx - s * H1;
      if (s0 + s < S) ws.dz1[(size_t)(s0 + s) * H1 + i] = __float2bfloat16_rn(h2[(size_t)i * LD + s]);
    }
    __syncthreads();
  }
  if (kMode != PPO_VALUES && tid < 4) ws.part_mets[(size_t)blockIdx.x * 4 + tid] = msum;
}

