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
//             other modes compile without it.
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
// A block of eight warps keeps W1 (and W0 where it fits, ppo_smem) in shared
// memory as bf16, the f32 head block beside them, and walks tiles of PPO_TM =
// 64 samples, persistent over the window.  Activations are sample-major bf16
// tiles with rows padded as gru_mma.cuh pads them; the three bf16 products
// of a tile run on the tensor cores (mma.sync m16n8k16, f32 sums):
//
//   z1 = x W0      the obs tile staged through registers in 64-feature chunks
//                  (rows of odd length, read element by element as
//                  gru_wgrad.cuh's GruObsSrc reads them); W0 resident, or
//                  streamed in 64-row chunks rounded to bf16 as staged;
//   z2 = h1 W1;    dz1 = dz2 W1^T (W1 read as [n][k] by a plain ldmatrix).
//
// The bias, bf16(tanh(bf16(z + b))) and bf16(bf16(dh) bf16(1 - bf16(h^2)))
// run in the accumulator layout.  The f32 head stays on the FP32 pipes as in
// JAX (hcat = h2 Wc + bc, dh2 = dcat Wc^T, pallas_update.py:1076-1082,
// 1130-1133), spread over every warp: a thread to each (sample, head column)
// for the head's forward, summed over k in order; one lane of four for the
// loss pieces; 8 columns a thread for dh2.  The
// head's weight gradient h2^T dcat (and dbc) is summed in f32 in the block
// across its tiles (JAX's gacc[4]) and written once per block to
// ws.part_head, so dcat never leaves the block.
//
// One activation tile serves the whole step: the obs chunks, then h1 (copied
// out), h2 (copied out, then overwritten in place by dz2), then dz1 (copied
// out); the dz1 step reads h1 back from the scratch it was written to.  Every
// copy out is a 16-byte row store.  Hidden widths are padded to 16 with
// zeros in shared memory; stores are masked to the rows of the window and to
// the ppo_r8(H) columns of the scratch rows.  The block's partial metric
// sums are taken in a fixed order.
#pragma once

#include "gru_wgrad.cuh"
#include "ppo_core.cuh"

#define PPO_ACTOR 0
#define PPO_CRITIC 1
#define PPO_VALUES 2
#define PPO_SEAC 3
#define PPO_MSG 4

static __device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kMode>
__global__ void __launch_bounds__(PPO_THREADS, 2)
    ppo_sample_kernel(PpoDims d, const int* __restrict__ start_p, const float* __restrict__ stats,
                      PpoData data, const float* __restrict__ params, PpoScratch ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBack = kMode != PPO_VALUES;
  constexpr bool kPolicy = kMode == PPO_ACTOR || kMode == PPO_SEAC || kMode == PPO_MSG;
  const int L = d.L, H1 = d.H1, H2 = d.H2, A = d.A, AC = d.heads, HC = d.hc;
  const int H1p = ppo_r16(H1), H2p = ppo_r16(H2), HCP = ppo_r4(HC), K0p = ppo_r16(L);
  const int H1s = ppo_r8(H1), H2s = ppo_r8(H2);  // scratch row strides
  const int ldw1 = H2p + PPO_PAD, ldw0 = H1p + PPO_PAD, ldx = PPO_KC + PPO_PAD;
  const int ld1 = H1p + PPO_PAD, ld2 = H2p + PPO_PAD;
  const int NT1 = H1p / 8, NT2 = H2p / 8;  // n-tiles of the two layers
  const PpoSmem m = ppo_smem(L, H1, H2, HC, d.w0_smem);
  float* sb0 = (float*)(smem + m.b0);
  float* sb1 = (float*)(smem + m.b1);
  float* swc = (float*)(smem + m.wc);    // (H2, HCP): Wc, zero columns past AC
  float* swt = (float*)(smem + m.wct);   // (HCP, H2p): Wc^T, zeros past AC and H2
  float* sbc = (float*)(smem + m.bc);    // (HCP)
  float* hcs = (float*)(smem + m.hcs);   // (TM, HCP): the head, then dcat
  float* acch = (float*)(smem + m.acch);  // (H2, HCP): the block's dWc
  float* dbcs = (float*)(smem + m.dbcs);  // (TM, HCP): its dbc, by sample slot
  long long* xrow = (long long*)(smem + m.rows);  // (TM): trajectory row, -1 past the window
  gm_bf16* sw1 = (gm_bf16*)(smem + m.w1);  // (H1p, ldw1)
  gm_bf16* sw0 = (gm_bf16*)(smem + m.w0);  // (K0p or KC, ldw0)
  gm_bf16* act = (gm_bf16*)(smem + m.act);  // (TM, ...): x chunk, h1, h2 / dz2, dz1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // mma layout: rows 16 wm.., n-tiles wn + 2i
  const int hs = tid >> 2, hq = tid & 3;    // loss layout: lane hq == 0 takes sample hs
  const PpoOffsets o = ppo_offsets(d);
  const gm_bf16 zero = __float2bfloat16_rn(0.f);

  for (int idx = tid; idx < H1p * ldw1; idx += PPO_THREADS) {
    const int i = idx / ldw1, j = idx - i * ldw1;
    sw1[idx] = i < H1 && j < H2 ? __float2bfloat16_rn(params[o.w1 + (size_t)i * H2 + j]) : zero;
  }
  if (d.w0_smem)
    for (int idx = tid; idx < K0p * ldw0; idx += PPO_THREADS) {
      const int k = idx / ldw0, j = idx - k * ldw0;
      sw0[idx] = k < L && j < H1 ? __float2bfloat16_rn(params[(size_t)k * H1 + j]) : zero;
    }
  for (int idx = tid; idx < H2 * HCP; idx += PPO_THREADS) {
    const int j = idx / HCP, a = idx - j * HCP;
    swc[idx] = a < AC ? params[o.wc + (size_t)j * AC + a] : 0.f;
  }
  for (int idx = tid; idx < HCP * H2p; idx += PPO_THREADS) {
    const int a = idx / H2p, j = idx - a * H2p;
    swt[idx] = a < AC && j < H2 ? params[o.wc + (size_t)j * AC + a] : 0.f;
  }
  for (int k = tid; k < H1p; k += PPO_THREADS) sb0[k] = k < H1 ? params[o.b0 + k] : 0.f;
  for (int k = tid; k < H2p; k += PPO_THREADS) sb1[k] = k < H2 ? params[o.b1 + k] : 0.f;
  for (int a = tid; a < HCP; a += PPO_THREADS) sbc[a] = a < AC ? params[o.bc + a] : 0.f;
  for (int k = tid; k < H2 * HCP; k += PPO_THREADS) acch[k] = 0.f;
  for (int k = tid; k < PPO_TM * HCP; k += PPO_THREADS) dbcs[k] = 0.f;

  const int start = kMode == PPO_VALUES ? 0 : start_p[0];
  const float adv_mean = kPolicy ? stats[0] : 0.f;
  const float adv_inv_std = kPolicy ? stats[1] : 0.f;
  const float eps = d.clip_eps, inv_n = d.inv_n;
  const long long S = (long long)d.T_mb * d.B * d.N;
  const long long n_tiles = (S + PPO_TM - 1) / PPO_TM;
  float msum[4] = {0.f, 0.f, 0.f, 0.f};  // lane hq == 0: its samples' metric terms

  // the obs chunk kc: thread (xk, xs0) holds features kc KC + xk of samples xs0 + 4u
  constexpr int XPT = PPO_TM * PPO_KC / PPO_THREADS;
  constexpr int XROWS = PPO_THREADS / PPO_KC;
  const int xk = tid % PPO_KC, xs0 = tid / PPO_KC;
  gm_bf16 xv[XPT];
  auto fetch_x = [&](int kc) {
    const int k = kc * PPO_KC + xk;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const long long r = xrow[xs0 + u * XROWS];
      xv[u] = r >= 0 && k < L ? __ldg(data.obs + r * L + k) : zero;
    }
  };
  // W0's rows kc KC.. rounded to bf16 into the stream buffer (w0 not resident);
  // scalar loads: a SEAC agent's parameters need not be 16-byte aligned
  auto stage_w0 = [&](int kc) {
    const int k0 = kc * PPO_KC, G = H1p / 4;
    for (int idx = tid; idx < PPO_KC * G; idx += PPO_THREADS) {
      const int k = idx / G, col = (idx - k * G) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + k < L && col < H1) {
        const float* src = params + (size_t)(k0 + k) * H1 + col;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldg(src + u);
      }
      __align__(8) __nv_bfloat162 p[2] = {gm_pack(v[0], v[1]), gm_pack(v[2], v[3])};
      *(uint2*)(sw0 + k * ldw0 + col) = *(const uint2*)p;
    }
  };
  // the tile's rows of width Hs (a multiple of 8) to the scratch, 16 bytes a store
  auto store_rows = [&](gm_bf16* dst, int Hs, int ld, long long s0) {
    const int G = Hs / 8;
    for (int idx = tid; idx < PPO_TM * G; idx += PPO_THREADS) {
      const int s = idx / G, col = (idx - s * G) * 8;
      if (s0 + s < S)
        *(uint4*)(dst + (size_t)(s0 + s) * Hs + col) = *(const uint4*)(act + s * ld + col);
    }
  };
  auto zero_acc = [](float (&acc)[8][4]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  };
  // bf16(tanh(bf16(acc + b))) in the accumulator layout, into act (row stride ld)
  auto tanh_out = [&](const float (&acc)[8][4], const float* bias, int NT, int ld) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nt = wn + 2 * i;
      if (nt >= NT) continue;
      const int col = nt * 8 + 2 * c;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = wm * 16 + g + 8 * h;
        *(__nv_bfloat162*)(act + s * ld + col) = gm_pack(tanhf(bf16r(acc[i][2 * h] + b0)),
                                                         tanhf(bf16r(acc[i][2 * h + 1] + b1)));
      }
    }
  };
  __syncthreads();

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long s0 = tile * PPO_TM;
    if (tid < PPO_TM) xrow[tid] = s0 + tid < S ? ppo_row(d, start, s0 + tid) : -1;
    __syncthreads();
    float acc[8][4];

    // ---- z1 = x W0, 64 features a chunk; h1 = bf16(tanh(bf16(z1 + b0)))
    zero_acc(acc);
    const int n_kc = (L + PPO_KC - 1) / PPO_KC;
    fetch_x(0);
    for (int kc = 0; kc < n_kc; ++kc) {
#pragma unroll
      for (int u = 0; u < XPT; ++u) act[(xs0 + u * XROWS) * ldx + xk] = xv[u];
      if (!d.w0_smem) stage_w0(kc);
      if (kc + 1 < n_kc) fetch_x(kc + 1);  // in flight during this chunk's products
      __syncthreads();
      const gm_bf16* wk = d.w0_smem ? sw0 + (size_t)kc * PPO_KC * ldw0 : sw0;
      const int kext = K0p - kc * PPO_KC < PPO_KC ? K0p - kc * PPO_KC : PPO_KC;
      for (int kk = 0; kk < kext; kk += 16) {
        uint32_t a[4];
        gm_frag_a(a, act, ldx, wm * 16, kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int nt = wn + 2 * i;
          if (nt < NT1) {
            uint32_t b[2];
            gm_frag_b_kn(b, wk, ldw0, nt * 8, kk);
            gm_mma(acc[i], a, b[0], b[1]);
          }
        }
      }
      __syncthreads();
    }
    tanh_out(acc, sb0, NT1, ld1);
    __syncthreads();
    if (kBack) store_rows(ws.h1, H1s, ld1, s0);

    // ---- z2 = h1 W1; h2 = bf16(tanh(bf16(z2 + b1)))
    zero_acc(acc);
    for (int kk = 0; kk < H1p; kk += 16) {
      uint32_t a[4];
      gm_frag_a(a, act, ld1, wm * 16, kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nt = wn + 2 * i;
        if (nt < NT2) {
          uint32_t b[2];
          gm_frag_b_kn(b, sw1, ldw1, nt * 8, kk);
          gm_mma(acc[i], a, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with h1
    tanh_out(acc, sb1, NT2, ld2);
    __syncthreads();

    // ---- the f32 head hcat = h2 Wc + bc, a thread to (sample, column), summed
    // over k in order, as the plain version and JAX's kernel sum it
    for (int e = tid; e < PPO_TM * HCP; e += PPO_THREADS) {
      const int s = e / HCP, a = e - s * HCP;
      float p = 0.f;
      for (int k = 0; k < H2; ++k) p = fmaf(__bfloat162float(act[s * ld2 + k]), swc[k * HCP + a], p);
      const float v = p + sbc[a];
      hcs[s * HCP + a] = v;
      if (kMode == PPO_VALUES && a < AC && xrow[s] >= 0) ws.values[xrow[s] * AC + a] = v;
    }
    __syncthreads();
    if (kMode == PPO_VALUES) continue;  // the forward alone

    // ---- loss pieces, lane hq == 0 of each sample: its head row becomes the
    // head's gradient dcat, [dlogits | dvalue | dmessage] (actor) or dvalue
    // per agent (critic); zeros past the window and past AC.
    if (hq == 0) {
      const int s = hs;
      const long long r = xrow[s];
      float* hrow = hcs + s * HCP;
      float terms[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kMode == PPO_CRITIC) {
        // pallas_update.py:1368-1378, per agent n: values and targets at [r * AC + n]
        for (int n = 0; n < AC; ++n) {
          float dv = 0.f;
          if (r >= 0) {
            const float value = hrow[n];
            const float old_value = data.value[r * AC + n], target = data.target[r * AC + n];
            const float vdiff = value - old_value;
            const float v_clip = old_value + fminf(fmaxf(vdiff, -eps), eps);
            const float e1 = value - target, e2 = v_clip - target;
            const bool inside_v = vdiff > -eps && vdiff < eps;
            dv = d.vf_coef * inv_n * (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.f));
            terms[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
          }
          hrow[n] = dv;
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
          const int act_r = data.action[r];
          const float old_logp = data.logp[r], adv = data.adv[r];
          float lg[kHC], p[kHC];
          for (int a = 0; a < A; ++a) lg[a] = hrow[a];
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
            if (a == act_r) logp = lg[a];
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
              const float l = hrow[A + 1 + k];
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
            dcat[a] = dlogp * ((a == act_r ? 1.f : 0.f) - p[a]) + ent_scale * p[a] * (lg[a] + ent);
          // d(pg)/dl = dlogp (bit - sigma); d(-ent_coef H)/dl = ent_coef l sigma (1 - sigma)
          for (int k = 0; k < MB; ++k) {
            const float l = hrow[A + 1 + k];
            dcat[A + 1 + k] = dlogp * (bitf[k] - sig[k]) + ent_scale * l * sig[k] * (1.f - sig[k]);
          }
          if (d.value_head) {
            const float value = hrow[A];
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
        }
#pragma unroll
        for (int a = 0; a < kHC; ++a)
          if (a < HCP) hrow[a] = dcat[a];  // HCP = 8, or 8 or 16 with the message head
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) msum[k] += terms[k];
      for (int a = 0; a < HCP; ++a) dbcs[s * HCP + a] += hrow[a];  // dbc, this slot's share
    }
    __syncthreads();

    // ---- the head's weight gradient, f32: dWc += h2^T dcat, item (j, 4 head
    // columns) a thread, the tile's samples in order (dbc went to the slots)
    {
      const int NQ = HCP / 4;
      for (int e = tid; e < H2 * NQ; e += PPO_THREADS) {
        const int j = e / NQ, a0 = (e - j * NQ) * 4;
        float4 s4 = *(const float4*)(acch + j * HCP + a0);
        for (int s = 0; s < PPO_TM; ++s) {
          const float hv = __bfloat162float(act[s * ld2 + j]);
          const float4 dv = *(const float4*)(hcs + s * HCP + a0);
          s4.x = fmaf(hv, dv.x, s4.x);
          s4.y = fmaf(hv, dv.y, s4.y);
          s4.z = fmaf(hv, dv.z, s4.z);
          s4.w = fmaf(hv, dv.w, s4.w);
        }
        *(float4*)(acch + j * HCP + a0) = s4;
      }
    }
    __syncthreads();

    // ---- dz2 = bf16(bf16(dcat Wc^T) bf16(1 - bf16(h2^2))), 8 columns a thread
    // (Wc^T rows, so that neighbouring lanes read neighbouring columns): h2's
    // row out to the scratch, then dz2 in its place and out
    {
      const int G2 = H2p / 8;
      for (int idx = tid; idx < PPO_TM * G2; idx += PPO_THREADS) {
        const int s = idx / G2, j0 = (idx - s * G2) * 8;
        gm_bf16* hp = act + s * ld2 + j0;
        const uint4 hraw = *(const uint4*)hp;
        const bool out = s0 + s < S && j0 < H2s;
        if (out) *(uint4*)(ws.h2 + (size_t)(s0 + s) * H2s + j0) = hraw;
        float dh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int a = 0; a < HCP; ++a) {
          const float dv = hcs[s * HCP + a];
          const float4 wa = *(const float4*)(swt + a * H2p + j0);
          const float4 wb = *(const float4*)(swt + a * H2p + j0 + 4);
          const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) dh[u] = fmaf(dv, w[u], dh[u]);
        }
        const __nv_bfloat162* hv2 = (const __nv_bfloat162*)&hraw;
        __align__(16) __nv_bfloat162 dz[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 hv = __bfloat1622float2(hv2[q]);
          const float v0 = bf16r(dh[2 * q]) * bf16r(1.f - bf16r(hv.x * hv.x));
          const float v1 = bf16r(dh[2 * q + 1]) * bf16r(1.f - bf16r(hv.y * hv.y));
          dz[q] = gm_pack(j0 + 2 * q < H2 ? v0 : 0.f, j0 + 2 * q + 1 < H2 ? v1 : 0.f);
        }
        *(uint4*)hp = *(const uint4*)dz;
        if (out) *(uint4*)(ws.dz2 + (size_t)(s0 + s) * H2s + j0) = *(const uint4*)dz;
      }
    }
    __syncthreads();

    // ---- dz1 = bf16(bf16(dz2 W1^T) bf16(1 - bf16(h1^2))), h1 read back from the
    // scratch (loads in flight during the products)
    __nv_bfloat162 dz1v[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (wn + 2 * i) * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long smp = s0 + wm * 16 + g + 8 * h;
        dz1v[i][h] = wn + 2 * i < NT1 && col < H1s && smp < S
                         ? *(const __nv_bfloat162*)(ws.h1 + (size_t)smp * H1s + col)
                         : gm_pack(0.f, 0.f);
      }
    }
    zero_acc(acc);
    for (int kk = 0; kk < H2p; kk += 16) {
      uint32_t a[4];
      gm_frag_a(a, act, ld2, wm * 16, kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nt = wn + 2 * i;
        if (nt < NT1) {
          uint32_t b[2];
          gm_frag_b_nk(b, sw1, ldw1, nt * 8, kk);
          gm_mma(acc[i], a, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = (wn + 2 * i) * 8 + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 hv = __bfloat1622float2(dz1v[i][h]);
        const float v0 = bf16r(acc[i][2 * h]) * bf16r(1.f - bf16r(hv.x * hv.x));
        const float v1 = bf16r(acc[i][2 * h + 1]) * bf16r(1.f - bf16r(hv.y * hv.y));
        dz1v[i][h] = gm_pack(col < H1 ? v0 : 0.f, col + 1 < H1 ? v1 : 0.f);
      }
    }
    __syncthreads();  // every warp is done with dz2
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nt = wn + 2 * i;
      if (nt >= NT1) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(__nv_bfloat162*)(act + (wm * 16 + g + 8 * h) * ld1 + nt * 8 + 2 * c) = dz1v[i][h];
    }
    __syncthreads();
    store_rows(ws.dz1, H1s, ld1, s0);
    __syncthreads();
  }

  if (kBack) {
    // the block's metric sums over its sample slots in order (hcs is free now)
    float* red = hcs;
    if (hq == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[hs * 4 + k] = msum[k];
    __syncthreads();
    if (tid < 4) {
      float v = 0.f;
      for (int s = 0; s < PPO_TM; ++s) v += red[s * 4 + tid];
      ws.part_mets[(size_t)blockIdx.x * 4 + tid] = v;
    }
    const int n_blk = (H2 + 1) * AC;
    float* part = ws.part_head + (size_t)blockIdx.x * n_blk;
    for (int e = tid; e < n_blk; e += PPO_THREADS) {
      const int j = e / AC, a = e - j * AC;
      if (j < H2) {
        part[e] = acch[j * HCP + a];
      } else {  // dbc: the slots' sums in order
        float v = 0.f;
        for (int s = 0; s < PPO_TM; ++s) v += dbcs[s * HCP + a];
        part[e] = v;
      }
    }
  }
}
