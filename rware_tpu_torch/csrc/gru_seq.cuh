// Shared pieces of the iall-fed GRU sequence kernels: the forward (K11
// fused_gru_seq_fwd.cu), its backward (K12 fused_gru_seq_bwd.cu) and the
// loss-fused backward (K13 fused_gru_loss_bwd.cu).
//
// Unlike K9/K10 (gru_core.cuh) these take the fused input gates iall =
// bf16(e Wi + bi) as a band-local tensor (T, n_env, N, 3Hg) [r | z | n] that
// the caller computed; the kernels run only the time recurrence.  done (T, B),
// h0 (B, N, Hg) and K13's per-sample streams (T, B, N) are the whole
// trajectory's, read in place through the band (envs (start_env + i) % B);
// hseq, dhseq, d_iall (T, n_env, N, .) and dh0 (n_env, N, Hg) are band-local,
// row t * Q + q for sequence q < Q = n_env * N (agent q % N of band env q / N).
//
// Thread layout as gru_core.cuh: a block of 256 threads owns S = 16 * RT
// sequences for all T; thread (ty, tx) takes rows ty * RT .. + RT and the
// eight hidden units tx * 8 .. + 8 of all three gates.
//
// The backward (K12, K13) is three kernels per launch, as K10's:
//  1. gsq_bwd_sweep_kernel walks time backwards, carries the hidden adjoint in
//     f32 registers, recomputes the gates from iall and the previous hidden
//     (h0, or hseq[t-1] zeroed where done[t-1]), writes d_iall = bf16([dr | dz
//     | dn]) and the dhhn third of Wh's cotangent (bf16 scratch; d_iall holds
//     dr and dz already), and keeps per-block partials of dbhn (unrounded f32
//     dhhn) and, for K13, of the head gradients and the four metric sums.  K13
//     first takes the heads of hseq[t] in f32 against the f32 [W_policy |
//     W_value], the clipped-PPO loss and its backward for the step's rows, and
//     adds dheads W_head^T to the carried adjoint (pallas_gru.py:886-951; the
//     TPU kernel batches this over a time chunk and feeds chunk boundaries
//     through precomputed hboundary rows, both Mosaic workarounds: a block
//     here reads hseq[t-1] and done[t-1] directly).
//  2. gru_wgrad_kernel (gru_wgrad.cuh, shared with K10, on the tensor
//     cores): dWh = sum over samples of hprev^T [dr | dz | dhhn], hprev
//     rebuilt from h0 / hseq / done on the fly (GruHprevSrc); one 64 x 128
//     output tile per block over one chunk of samples, written to its own
//     partial.
//  3. gru_reduce_kernel (gru_wgrad.cuh): the chunk and block partials summed
//     in a fixed order.  No float atomics, so two launches give the same bits.
#pragma once

#include "gru_wgrad.cuh"

#define GSQ_HEADS 8  // K13: head columns A + 1 at most
#define GSQ_KPT 4    // K13: head-gradient outputs per thread, (Hg + 1) (A + 1) <= 1024

namespace {

// K13's loss inputs; K12 passes a zeroed one.
struct GsqLoss {
  const float* stats;  // [adv_mean, 1 / (adv_std + 1e-8)] of the band
  const int* action;   // (T, B, N) int32, through the band
  const float *logp, *value, *adv, *target;  // (T, B, N) f32, through the band
  const float* head;   // (Hg + 1, A1) f32: [W_policy | W_value], then the bias row
  int A1;              // A + 1
  float clip_eps, vf_coef, ent_coef, inv_n;
};

// K11's cell (pallas_gru.py:100-123) for the eight hidden units of one row: ia
// the bf16 input gates [r | z | n] x 8, hh the f32 hidden products [r | z |
// n] x 8, hp the previous hidden (bf16 values).  r and z are sigmoids of f32
// sums rounded to bf16; the candidate and new_h are bf16 arithmetic.
__device__ __forceinline__ void gsq_cell_fwd(const float* ia, const float* hh,
                                             const float* __restrict__ bhn, const float* hp,
                                             float* nh) {
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) {
    const float rg = gru_bf16r(gru_sigmoid(ia[jj] + hh[jj]));
    const float zg = gru_bf16r(gru_sigmoid(ia[GRU_CW + jj] + hh[GRU_CW + jj]));
    const float hn = gru_bf16r(hh[2 * GRU_CW + jj] + bhn[jj]);
    const float nn = gru_bf16r(tanhf(gru_bf16r(ia[2 * GRU_CW + jj] + gru_bf16r(rg * hn))));
    nh[jj] = gru_bf16r(gru_bf16r(gru_bf16r(1.f - zg) * nn) + gru_bf16r(zg * hp[jj]));
  }
}

// The step backward shared by K12 and K13 (pallas_gru.py:224-268 = :955-1003)
// for eight hidden units of one row, from dnh, the adjoint of new_h: r and z
// stay f32, the candidate is recomputed in bf16 arithmetic.  Out: the
// unrounded f32 dr, dz, dhhn, dn and dhz = dnh z.
__device__ __forceinline__ void gsq_step_bwd(const float* ia, const float* hh,
                                             const float* __restrict__ bhn, const float* hp,
                                             const float* dnh, float* dr, float* dz, float* dhhn,
                                             float* dn, float* dhz) {
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) {
    const float rg = gru_sigmoid(ia[jj] + hh[jj]);
    const float zg = gru_sigmoid(ia[GRU_CW + jj] + hh[GRU_CW + jj]);
    const float hhn = gru_bf16r(hh[2 * GRU_CW + jj] + bhn[jj]);
    const float nn =
        gru_bf16r(tanhf(gru_bf16r(ia[2 * GRU_CW + jj] + gru_bf16r(gru_bf16r(rg) * hhn))));
    const float dz_pre = dnh[jj] * (hp[jj] - nn) * zg * (1.f - zg);
    const float dn_pre = dnh[jj] * (1.f - zg) * (1.f - nn * nn);
    dhhn[jj] = dn_pre * rg;
    dr[jj] = dn_pre * hhn * rg * (1.f - rg);
    dz[jj] = dz_pre;
    dn[jj] = dn_pre;
    dhz[jj] = dnh[jj] * zg;
  }
}

// The eight bf16 input gates of each gate [r | z | n] of band row `row`.
__device__ __forceinline__ void gsq_load_gates(const __nv_bfloat16* __restrict__ iall,
                                               size_t row, int Hg, int j0, float* ia) {
  const __nv_bfloat16* p = iall + row * 3 * Hg + j0;
  gru_load8(p, ia);
  gru_load8(p + Hg, ia + GRU_CW);
  gru_load8(p + 2 * Hg, ia + 2 * GRU_CW);
}

// K13: the clipped-PPO loss of one sample from its f32 heads hd[0 .. A1) (A
// logits, then the value) and its backward (pallas_gru.py:904-947): hd is
// overwritten with d(loss)/d(heads), met[4] gets [min(pg1, pg2), 0.5 max(e1^2,
// e2^2), entropy, (ratio - 1) - log ratio] added.
__device__ __forceinline__ void gsq_loss_bwd(const GsqLoss& ls, size_t smp, float* hd,
                                             float* met) {
  const int A = ls.A1 - 1;
  const float eps = ls.clip_eps;
  float mx = hd[0];
  for (int a = 1; a < A; ++a) mx = fmaxf(mx, hd[a]);
  float zs = 0.f;
  for (int a = 0; a < A; ++a) zs += expf(hd[a] - mx);
  const float lz = logf(zs);
  const int act = ls.action[smp];
  float lsm[GSQ_HEADS], pr[GSQ_HEADS], ent = 0.f, logp = 0.f;
  for (int a = 0; a < A; ++a) {
    lsm[a] = hd[a] - mx - lz;
    pr[a] = expf(hd[a] - mx) / zs;
    ent -= pr[a] * lsm[a];
    if (a == act) logp = lsm[a];
  }
  const float old_logp = ls.logp[smp];
  const float ratio = expf(logp - old_logp);
  const float advn = (ls.adv[smp] - ls.stats[0]) * ls.stats[1];
  const float ratio_c = fminf(fmaxf(ratio, 1.f - eps), 1.f + eps);
  const float pg1 = ratio * advn, pg2 = ratio_c * advn;
  const bool inside = ratio > 1.f - eps && ratio < 1.f + eps;
  const float dobj = pg1 <= pg2 ? advn : (inside ? advn : 0.f);
  const float dlogp = -ls.inv_n * dobj * ratio;
  const float ent_w = ls.ent_coef * ls.inv_n;
  const float value = hd[A], old_value = ls.value[smp], target = ls.target[smp];
  const float vdiff = value - old_value;
  const float v_clip = old_value + fminf(fmaxf(vdiff, -eps), eps);
  const float e1 = value - target, e2 = v_clip - target;
  const bool inside_v = vdiff > -eps && vdiff < eps;
  const float dv = e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.f);
  for (int a = 0; a < A; ++a)
    hd[a] = dlogp * ((a == act ? 1.f : 0.f) - pr[a]) + ent_w * pr[a] * (lsm[a] + ent);
  hd[A] = ls.vf_coef * ls.inv_n * dv;
  met[0] += fminf(pg1, pg2);
  met[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
  met[2] += ent;
  met[3] += (ratio - 1.f) - (logp - old_logp);
}

// The reverse sweep of K12 (kLoss false: the hidden cotangent dhseq read in)
// and K13 (kLoss true: the cotangent from the heads' loss).  part_blk row
// blockIdx.x gets [dbhn (Hg)] and for K13 [dW_head (Hg, A1) | db_head (A1) |
// the four metric sums].
template <int RT, bool kLoss>
__global__ void __launch_bounds__(GRU_THREADS)
    gsq_bwd_sweep_kernel(GruSeqDims d, const __nv_bfloat16* __restrict__ iall,
                         const uint8_t* __restrict__ done, const __nv_bfloat16* __restrict__ h0,
                         const __nv_bfloat16* __restrict__ hseq,
                         const __nv_bfloat16* __restrict__ dhseq,
                         const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bhn,
                         const __nv_bfloat16* __restrict__ whT, GsqLoss ls,
                         __nv_bfloat16* __restrict__ d_iall, __nv_bfloat16* __restrict__ dhhn_s,
                         float* __restrict__ part_blk, int n_blk, float* __restrict__ dh0) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = 16 * RT;
  const int Hg = d.Hg, G3 = 3 * d.Hg, A1 = ls.A1;
  __nv_bfloat16* hs = (__nv_bfloat16*)smem;     // (S, Hg): the hidden before step t
  __nv_bfloat16* dg3 = hs + (size_t)S * Hg;     // (S, 3Hg): [dr | dz | dhhn]
  float* red = (float*)(dg3 + (size_t)S * G3);  // (16, 128): the dbhn reduction
  __nv_bfloat16* hc = (__nv_bfloat16*)(red + 16 * 128);  // K13 (S, Hg): hseq[t]
  float* hd = (float*)(hc + (size_t)S * Hg);    // K13 (S, 8): heads, then their cotangents
  float* hw = hd + S * GSQ_HEADS;               // K13 (Hg + 1, A1): head weights and bias
  float* met = hw + (Hg + 1) * A1;              // K13 (S, 4): the metric reduction
  const int Q = d.n_env * d.N, q0 = blockIdx.x * S;
  const int tid = threadIdx.x, ty = tid / 16, row0 = ty * RT, j0 = (tid % 16) * GRU_CW;
  const bool active = j0 < Hg;
  const int n_head = (Hg + 1) * A1;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  float dc[RT][GRU_CW], dbhn_acc[GRU_CW], bh[GRU_CW];
  float hacc[GSQ_KPT], macc[4];
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) {
    dbhn_acc[jj] = 0.f;
    bh[jj] = active ? bhn[j0 + jj] : 0.f;
#pragma unroll
    for (int r = 0; r < RT; ++r) dc[r][jj] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < GSQ_KPT; ++i) hacc[i] = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) macc[m] = 0.f;
  if (kLoss)
    for (int idx = tid; idx < n_head; idx += GRU_THREADS) hw[idx] = ls.head[idx];

  for (int t = d.T - 1; t >= 0; --t) {
    for (int idx = tid; idx < S * Hg; idx += GRU_THREADS) {
      const int s = idx / Hg, j = idx - s * Hg, q = q0 + s;
      __nv_bfloat16 v = zero, c = zero;
      if (q < Q) {
        if (t == 0) {
          v = h0[((size_t)gru_env(d, q) * d.N + q % d.N) * Hg + j];
        } else if (!done[(size_t)(t - 1) * d.B + gru_env(d, q)]) {
          v = hseq[((size_t)(t - 1) * Q + q) * Hg + j];
        }
        if (kLoss) c = hseq[((size_t)t * Q + q) * Hg + j];
      }
      hs[idx] = v;
      if (kLoss) hc[idx] = c;
    }
    __syncthreads();
    if (kLoss) {
      // the heads of hseq[t]: one thread per (row, column)
      if (tid < S * A1) {
        const int s = tid / A1, a = tid - s * A1;
        float acc = 0.f;
        for (int k = 0; k < Hg; ++k)
          acc = fmaf(__bfloat162float(hc[s * Hg + k]), hw[k * A1 + a], acc);
        hd[s * GSQ_HEADS + a] = acc + hw[Hg * A1 + a];
      }
      __syncthreads();
      // the loss and its backward: one thread per row
      if (tid < S) {
        const int q = q0 + tid;
        if (q < Q) {
          const size_t smp = ((size_t)t * d.B + gru_env(d, q)) * d.N + q % d.N;
          gsq_loss_bwd(ls, smp, hd + tid * GSQ_HEADS, macc);
        } else {
          for (int a = 0; a < A1; ++a) hd[tid * GSQ_HEADS + a] = 0.f;
        }
      }
      __syncthreads();
      // the head gradients: hseq[t]^T dheads (the bias as a row of ones)
#pragma unroll
      for (int i = 0; i < GSQ_KPT; ++i) {
        const int o = tid + i * GRU_THREADS;
        if (o < n_head) {
          const int k = o / A1, a = o - k * A1;
          float acc = 0.f;
          for (int s = 0; s < S; ++s) {
            const float hv = k < Hg ? __bfloat162float(hc[s * Hg + k]) : 1.f;
            acc = fmaf(hv, hd[s * GSQ_HEADS + a], acc);
          }
          hacc[i] += acc;
        }
      }
    }

    float dhz[RT][GRU_CW];
    if (active) {
      float hh[RT][3 * GRU_CW];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 3 * GRU_CW; ++c) hh[r][c] = 0.f;
      const int col[3] = {j0, Hg + j0, 2 * Hg + j0};
      gru_tile_gemm<RT, 3>(hh, hs, Hg, row0, Hg, wh, G3, col);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int q = q0 + row0 + r;
        const bool valid = q < Q;
        const size_t row = (size_t)t * Q + q;
        float ia[3 * GRU_CW], dn_in[GRU_CW], hp[GRU_CW], dnh[GRU_CW];
#pragma unroll
        for (int c = 0; c < 3 * GRU_CW; ++c) ia[c] = 0.f;
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) dn_in[jj] = 0.f;
        bool cut = true;
        if (valid) {
          gsq_load_gates(iall, row, Hg, j0, ia);
          cut = done[(size_t)t * d.B + gru_env(d, q)] != 0;
          if (!kLoss) gru_load8(dhseq + row * Hg + j0, dn_in);
        }
        if (kLoss) {
          // dheads W_head^T (zero on rows past Q)
          const float* g = hd + (row0 + r) * GSQ_HEADS;
#pragma unroll
          for (int jj = 0; jj < GRU_CW; ++jj) {
            float acc = 0.f;
            for (int a = 0; a < A1; ++a) acc = fmaf(g[a], hw[(j0 + jj) * A1 + a], acc);
            dn_in[jj] = acc;
          }
        }
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) {
          hp[jj] = __bfloat162float(hs[(size_t)(row0 + r) * Hg + j0 + jj]);
          dnh[jj] = dn_in[jj] + (cut ? 0.f : dc[r][jj]);
        }
        float v_dr[GRU_CW], v_dz[GRU_CW], v_dhhn[GRU_CW], v_dn[GRU_CW];
        gsq_step_bwd(ia, hh[r], bh, hp, dnh, v_dr, v_dz, v_dhhn, v_dn, dhz[r]);
        __nv_bfloat16* g3 = dg3 + (size_t)(row0 + r) * G3 + j0;
        gru_store8(g3, v_dr);
        gru_store8(g3 + Hg, v_dz);
        gru_store8(g3 + 2 * Hg, v_dhhn);
        if (valid) {
#pragma unroll
          for (int jj = 0; jj < GRU_CW; ++jj) dbhn_acc[jj] += v_dhhn[jj];
          __nv_bfloat16* gi = d_iall + row * G3 + j0;
          gru_store8(gi, v_dr);
          gru_store8(gi + Hg, v_dz);
          gru_store8(gi + 2 * Hg, v_dn);
          gru_store8(dhhn_s + row * Hg + j0, v_dhhn);
        }
      }
    }
    __syncthreads();  // the cotangent tile is complete
    if (active) {
      // dh_prev = dnh z + [dr | dz | dhhn] Wh^T
      float acc[RT][GRU_CW];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) acc[r][jj] = 0.f;
      const int col[1] = {j0};
      gru_tile_gemm<RT, 1>(acc, dg3, G3, row0, G3, whT, Hg, col);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) dc[r][jj] = dhz[r][jj] + acc[r][jj];
    }
    __syncthreads();  // before the next step overwrites the tiles
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int q = q0 + row0 + r;
      if (q >= Q) continue;
#pragma unroll
      for (int jj = 0; jj < GRU_CW; ++jj) dh0[(size_t)q * Hg + j0 + jj] = dc[r][jj];
    }
#pragma unroll
    for (int jj = 0; jj < GRU_CW; ++jj) red[ty * 128 + j0 + jj] = dbhn_acc[jj];
  }
  if (kLoss && tid < S) {
#pragma unroll
    for (int m = 0; m < 4; ++m) met[tid * 4 + m] = macc[m];
  }
  __syncthreads();
  float* out = part_blk + (size_t)blockIdx.x * n_blk;
  if (tid < Hg) {
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += red[y * 128 + tid];
    out[tid] = acc;
  }
  if (kLoss) {
#pragma unroll
    for (int i = 0; i < GSQ_KPT; ++i) {
      const int o = tid + i * GRU_THREADS;
      if (o < n_head) out[Hg + o] = hacc[i];
    }
    if (tid < 4) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += met[s * 4 + tid];
      out[Hg + n_head + tid] = acc;
    }
  }
}

// Entries of a sweep block's partial row: dbhn, and for K13 the head
// gradients and the metric sums.
inline int gsq_blk_cols(int Hg, int A1, bool loss) {
  return Hg + (loss ? (Hg + 1) * A1 + 4 : 0);
}

template <int RT, bool kLoss>
int gsq_sweep_launch(const GruSeqDims& d, const void* iall, const void* done, const void* h0,
                     const void* hseq, const void* dhseq, const void* wh, const void* bhn,
                     const void* whT, const GsqLoss& ls, void* d_iall, void* dhhn_s,
                     void* part_blk, int n_blk, void* dh0, cudaStream_t stream) {
  const int S = 16 * RT, Q = d.n_env * d.N;
  size_t smem = (size_t)S * 4 * d.Hg * sizeof(__nv_bfloat16) + 16 * 128 * sizeof(float);
  if (kLoss)
    smem += (size_t)S * d.Hg * sizeof(__nv_bfloat16)
            + ((size_t)S * GSQ_HEADS + (size_t)(d.Hg + 1) * ls.A1 + (size_t)S * 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gsq_bwd_sweep_kernel<RT, kLoss>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gsq_bwd_sweep_kernel<RT, kLoss><<<(Q + S - 1) / S, GRU_THREADS, smem, stream>>>(
      d, (const __nv_bfloat16*)iall, (const uint8_t*)done, (const __nv_bfloat16*)h0,
      (const __nv_bfloat16*)hseq, (const __nv_bfloat16*)dhseq, (const __nv_bfloat16*)wh,
      (const float*)bhn, (const __nv_bfloat16*)whT, ls, (__nv_bfloat16*)d_iall,
      (__nv_bfloat16*)dhhn_s, (float*)part_blk, n_blk, (float*)dh0);
  return (int)cudaGetLastError();
}

// The three kernels of one backward launch (K12 or K13).  rows_per_thread: 1
// or 2 (16 or 32 sequences a sweep block); chunk * n_chunks >= T * n_env * N;
// partial holds n_chunks * Hg * 3Hg floats, part_blk (sweep blocks) *
// gsq_blk_cols floats, dhhn_s T * n_env * N * Hg bf16; grads gets Hg * 3Hg +
// gsq_blk_cols floats: [dWh | dbhn] and for K13 [| dW_head | db_head | mets].
template <bool kLoss>
int gsq_bwd_launch(const GruSeqDims& d, int rows_per_thread, int chunk, int n_chunks,
                   const void* iall, const void* done, const void* h0, const void* hseq,
                   const void* dhseq, const void* wh, const void* bhn, const void* whT,
                   const GsqLoss& ls, void* dhhn_s, void* part_blk, void* partial, void* d_iall,
                   void* grads, void* dh0, cudaStream_t stream) {
  const int Q = d.n_env * d.N;
  const int n_blk = gsq_blk_cols(d.Hg, ls.A1, kLoss);
  int err, sweep_blocks;
  if (rows_per_thread == 2) {
    sweep_blocks = (Q + 31) / 32;
    err = gsq_sweep_launch<2, kLoss>(d, iall, done, h0, hseq, dhseq, wh, bhn, whT, ls, d_iall,
                                     dhhn_s, part_blk, n_blk, dh0, stream);
  } else if (rows_per_thread == 1) {
    sweep_blocks = (Q + 15) / 16;
    err = gsq_sweep_launch<1, kLoss>(d, iall, done, h0, hseq, dhseq, wh, bhn, whT, ls, d_iall,
                                     dhhn_s, part_blk, n_blk, dh0, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const long long n_samples = (long long)d.T * Q;
  const long long n_w = (long long)d.Hg * 3 * d.Hg;
  // dWh: A = hprev rebuilt in place, G = [dr | dz] from d_iall, dhhn from its scratch
  const GruCols g = {(const __nv_bfloat16*)d_iall, 3 * d.Hg, 2 * d.Hg,
                     (const __nv_bfloat16*)dhhn_s, d.Hg, 0};
  const GruHprevSrc src = {(const __nv_bfloat16*)h0, (const __nv_bfloat16*)hseq,
                           (const uint8_t*)done, d.Hg, 0, 3 * d.Hg, g};
  err = gru_wgrad_launch(d, src, n_samples, chunk, n_chunks, (float*)partial, 0, n_w, stream);
  if (err != 0) return err;
  gru_reduce_kernel<<<(unsigned)((n_w + n_blk + 255) / 256), 256, 0, stream>>>(
      (const float*)partial, n_chunks, n_w, (const float*)part_blk, sweep_blocks, n_blk,
      (float*)grads);
  return (int)cudaGetLastError();
}

inline bool gsq_widths_ok(int Hg, int T, int B, int n_env) {
  return Hg % GRU_CW == 0 && Hg <= 128 && Hg > 0 && T > 0 && n_env >= 1 && n_env <= B;
}

}  // namespace
