// The backward of the iall-fed GRU sequence kernels: K12 (fused_gru_seq_bwd.cu,
// the hidden cotangent dhseq read in) and K13 (fused_gru_loss_bwd.cu, the
// cotangent from the heads' clipped-PPO loss).  One launch is a chain of four
// kernels on one stream, on K10's parts:
//
//  1. gsq_bwd_prologue_kernel, time-parallel: a block takes a run of tiles of
//     64 samples (t, q) and, per tile, computes hh = hprev Wh on the tensor
//     cores (bf16 mma.sync, f32 sums) in slices of 16 hidden units, Wh's and
//     iall's [r | z | n] columns of the slice brought in by cp.async (two
//     buffers), and the gates from iall in the plain version's rounding,
//     stored as K10's prologue stores them (gru_bwd.cuh: r, z f32, hhn, n
//     bf16).  K13 also takes, on the FP32 pipes, the f32 heads of hseq[t]
//     against the f32 [W_policy | W_value] (a thread a row and two columns,
//     the slice's 16 k each step of the slice loop, in the shadow of its
//     loads), the loss and its backward (a thread a row), stores dheads
//     (GB_HEADS f32 a sample, zero past A + 1: two 16-byte loads a row for
//     the sweep) and sums the head gradients hseq[t]^T dheads (a thread a row
//     of [dW_head; db_head] and four columns), db_head and the four metric
//     sums over its tiles into its own partial row.  These are f32 products
//     of unrounded f32 values in the plain version: on the bf16 tensor cores
//     dheads would be rounded, on TF32 the head weights; at A + 1 <= 8
//     columns they are a few GFMA a launch.
//  2. gru_bwd_sweep_kernel (gru_bwd.cuh, K10's), sequential in t: the step's
//     direct cotangent is K12's dhseq (GbCotSeq) or K13's dheads W_head^T in
//     f32 (GbCotHeads, W_head in shared memory); the one product on the
//     sequential path, [dr | dz | dhhn] Wh^T, on the tensor cores with Wh
//     resident in shared memory; out d_iall = bf16([dr | dz | dn]) and the
//     bf16 dhhn scratch (GbOutSeq), per-block dbhn partials of the unrounded
//     f32 dhhn.
//  3. gru_wgrad_kernel (gru_wgrad.cuh, K10's): dWh = sum over samples of
//     hprev^T [dr | dz | dhhn], hprev rebuilt from h0 / hseq / done on the
//     fly, one partial a chunk of samples.
//  4. gsq_reduce_kernel: the dWh chunks, the sweep's dbhn partials and the
//     prologue's head and metric partials (those split over eight warps),
//     each summed in a fixed order.  No float atomics, so two launches give
//     the same bits.
//
// The TPU kernels keep the head algebra off Mosaic's sequential loop by
// batching it over a time chunk (pallas_gru.py:886-951) and read their chunk
// boundaries from precomputed hboundary rows; here the whole band's heads and
// gates are computed before the sweep, which reads hseq[t-1] and done[t-1]
// directly.
#pragma once

#include "gru_bwd.cuh"
#include "gru_seq.cuh"

// K13: (Hg + 1) (A + 1) head-gradient outputs at most (A + 1 <= 8 up to Hg =
// 120, <= 7 at Hg = 128), the widths its wrapper has always taken
#define GSQ_HEAD_OUTS 1024

// K13's loss inputs; K12 passes a zeroed one.
struct GsqLoss {
  const float* stats;  // [adv_mean, 1 / (adv_std + 1e-8)] of the band
  const int* action;   // (T, B, N) int32, through the band
  const float *logp, *value, *adv, *target;  // (T, B, N) f32, through the band
  const float* head;   // (Hg + 1, A1) f32: [W_policy | W_value], then the bias row
  int A1;              // A + 1
  float clip_eps, vf_coef, ent_coef, inv_n;
};

// K13: the clipped-PPO loss of one sample from its f32 heads hd[0 .. A1) (A
// logits, then the value) and its backward (pallas_gru.py:904-947): hd is
// overwritten with d(loss)/d(heads), met[4] gets [min(pg1, pg2), 0.5 max(e1^2,
// e2^2), entropy, (ratio - 1) - log ratio] added.
static __device__ __forceinline__ void gsq_loss_bwd(const GsqLoss& ls, size_t smp, float* hd,
                                             float* met) {
  const int A = ls.A1 - 1;
  const float eps = ls.clip_eps;
  float mx = hd[0];
  for (int a = 1; a < A; ++a) mx = fmaxf(mx, hd[a]);
  float zs = 0.f;
  for (int a = 0; a < A; ++a) zs += expf(hd[a] - mx);
  const float lz = logf(zs);
  const int act = ls.action[smp];
  float lsm[GB_HEADS], pr[GB_HEADS], ent = 0.f, logp = 0.f;
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

// Dynamic shared memory of the prologue, bytes (the wrappers' plans must agree).
template <bool kLoss>
static int gsq_prologue_smem(int Hg) {
  const int H16 = gm_r16(Hg), ldh = H16 + GM_PAD, ldg = 3 * GB_SLICE + GM_PAD;
  const int tiles = (kLoss ? 2 : 1) * GB_TILE * ldh + 2 * (H16 + GB_TILE) * ldg;
  const int loss = kLoss ? (Hg + 1) * GB_HEADS + GB_TILE * GB_HEADS + GB_TILE * 4 : 0;
  // and per row: hprev's offset (8 bytes) and source (4)
  return tiles * (int)sizeof(gm_bf16) + loss * (int)sizeof(float) + GB_TILE * 12;
}

// Block b takes the tiles b * tiles_per_block .. + tiles_per_block.  Warp w
// computes rows 16 (w % 4).. of a tile and the columns 8 (w / 4).. of each
// gate of a 16-unit slice.  K13's part_head row blockIdx.x gets [dW_head (Hg,
// A1) | db_head (A1) | the four metric sums] over the block's tiles.
template <bool kLoss>
__global__ void __launch_bounds__(GM_THREADS, 2)
    gsq_bwd_prologue_kernel(GruSeqDims d, long long n_samples, int tiles_per_block,
                            const gm_bf16* __restrict__ iall, const uint8_t* __restrict__ done,
                            const gm_bf16* __restrict__ h0, const gm_bf16* __restrict__ hseq,
                            const gm_bf16* __restrict__ wh, const float* __restrict__ bhn,
                            GsqLoss ls, GruBwdScratch ws, float* __restrict__ dheads,
                            float* __restrict__ part_head) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldg = 3 * GB_SLICE + GM_PAD;
  const int Hg = d.Hg, G3 = 3 * Hg, H16 = gm_r16(Hg), ldh = H16 + GM_PAD;
  const int stage_buf = (H16 + GB_TILE) * ldg;
  gm_bf16* hs = (gm_bf16*)smem;                        // (64, ldh): hprev
  gm_bf16* hc = hs + GB_TILE * ldh;                    // K13 (64, ldh): hseq[t]
  gm_bf16* stage = hc + (kLoss ? GB_TILE * ldh : 0);   // two buffers: rows Wh (H16), iall (64)
  float* hw = (float*)(stage + 2 * stage_buf);         // K13 (Hg + 1, 8): W_head, bias row last
  float* hd = hw + (kLoss ? (Hg + 1) * GB_HEADS : 0);  // K13 (64, 8): heads, then dheads
  float* met = hd + (kLoss ? GB_TILE * GB_HEADS : 0);  // K13 (64, 4): the metric reduction
  long long* hoff = (long long*)(met + (kLoss ? GB_TILE * 4 : 0));  // (64,): hprev's row offset
  int* hsrc = (int*)(hoff + GB_TILE);  // (64,): 0 none (done, or past the band), 1 h0, 2 hseq
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int A1 = ls.A1, n_head = (Hg + 1) * A1, n_slices = H16 / GB_SLICE;
  const long long n_tiles = (n_samples + GB_TILE - 1) / GB_TILE;
  const int hrow = tid >> 2, hcol = 2 * (tid & 3);  // K13: the heads (hrow, hcol .. + 2)

  // K13's head gradients: rows k = tid / 2 and k + 128 (the bias row at k =
  // Hg) of [dW_head; db_head], columns 4 (tid % 2) .. + 4
  const int gk = tid >> 1, gc = 4 * (tid & 1);
  float hacc[2][4], macc[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hacc[i][c] = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) macc[m] = 0.f;
  if (kLoss)
    for (int idx = tid; idx < (Hg + 1) * GB_HEADS; idx += GM_THREADS) {
      const int k = idx / GB_HEADS, a = idx % GB_HEADS;
      hw[idx] = a < A1 ? ls.head[k * A1 + a] : 0.f;
    }

  // slice sl of the [r | z | n] columns into buffer b: Wh's rows, then the
  // tile's iall rows (zeros past Hg, past the samples)
  auto load_slice = [&](long long s0, int sl, int b) {
    gm_bf16* w = stage + b * stage_buf;
    for (int idx = tid; idx < (H16 + GB_TILE) * 6; idx += GM_THREADS) {
      const int r = idx / 6, part = idx % 6, gate = part >> 1;
      const int col = sl * GB_SLICE + (part & 1) * 8;
      gm_bf16* dst = w + r * ldg + gate * GB_SLICE + (part & 1) * 8;
      if (r < H16) {
        const bool ok = r < Hg && col < Hg;
        gm_cp16(dst, ok ? wh + (size_t)r * G3 + gate * Hg + col : wh, ok);
      } else {
        const long long smp = s0 + (r - H16);
        const bool ok = smp < n_samples && col < Hg;
        gm_cp16(dst, ok ? iall + (size_t)smp * G3 + gate * Hg + col : iall, ok);
      }
    }
    gm_cp_commit();
  };

  for (int it = 0; it < tiles_per_block; ++it) {
    const long long tile = (long long)blockIdx.x * tiles_per_block + it;
    if (tile >= n_tiles) break;
    const long long s0 = tile * GB_TILE;
    if (tid < GB_TILE) {
      const long long smp = s0 + tid;
      const gm_bf16* row = smp < n_samples ? gru_hprev_row(d, h0, hseq, done, smp) : nullptr;
      hsrc[tid] = row == nullptr ? 0 : smp < (long long)d.n_env * d.N ? 1 : 2;
      hoff[tid] = row == nullptr ? 0 : hsrc[tid] == 1 ? row - h0 : row - hseq;
    }
    __syncthreads();  // the rows' sources; the last tile's readers are done
    // hprev (zeros where done, past the band or past Hg) and K13's hseq[t]
    for (int idx = tid; idx < GB_TILE * (H16 / 8); idx += GM_THREADS) {
      const int s = idx / (H16 / 8), col = (idx % (H16 / 8)) * 8, src = hsrc[s];
      const bool ok = src != 0 && col < Hg;
      gm_cp16(hs + s * ldh + col, ok ? (src == 1 ? h0 : hseq) + hoff[s] + col : hseq, ok);
      if (kLoss) {
        const bool in = s0 + s < n_samples && col < Hg;
        gm_cp16(hc + s * ldh + col, in ? hseq + (size_t)(s0 + s) * Hg + col : hseq, in);
      }
    }
    gm_cp_commit();

    // ---- hh = hprev Wh and the gates, 16 hidden units a slice; K13's heads
    // of hseq[t] in f32 (k ascending), the slice's 16 k a step
    float head[2] = {0.f, 0.f};
    load_slice(s0, 0, 0);
    for (int sl = 0; sl < n_slices; ++sl) {
      if (sl + 1 < n_slices) {
        load_slice(s0, sl + 1, (sl + 1) & 1);
        gm_cp_wait<1>();
      } else {
        gm_cp_wait<0>();
      }
      __syncthreads();  // also: hprev (and hseq[t]) in
      const gm_bf16* whs = stage + (sl & 1) * stage_buf;
      const gm_bf16* ias = whs + H16 * ldg;
      float hh[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k) hh[q][k] = 0.f;
      for (int kk = 0; kk < H16; kk += 16) {
        uint32_t a[4];
        gm_frag_a(a, hs, ldh, wm * 16, kk);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t b[2];
          gm_frag_b_kn(b, whs, ldg, q * GB_SLICE + wn * 8, kk);
          gm_mma(hh[q], a, b[0], b[1]);
        }
      }
      const int jl = wn * 8 + 2 * c, j = sl * GB_SLICE + jl;
      if (j < Hg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sr = wm * 16 + g + 8 * h;
          const long long smp = s0 + sr;
          if (smp >= n_samples) continue;
          const gm_bf16* x = ias + sr * ldg + jl;
          const float2 ir = __bfloat1622float2(*(const __nv_bfloat162*)x);
          const float2 iz = __bfloat1622float2(*(const __nv_bfloat162*)(x + GB_SLICE));
          const float2 in = __bfloat1622float2(*(const __nv_bfloat162*)(x + 2 * GB_SLICE));
          GbGate gt[2];
          gt[0] = gb_gate(ir.x, iz.x, in.x, hh[0][2 * h], hh[1][2 * h], hh[2][2 * h], bhn[j]);
          gt[1] = gb_gate(ir.y, iz.y, in.y, hh[0][2 * h + 1], hh[1][2 * h + 1],
                          hh[2][2 * h + 1], bhn[j + 1]);
          gb_store_gates(ws, smp, Hg, j, gt);
        }
      }
      if (kLoss) {
        const int k1 = Hg < (sl + 1) * GB_SLICE ? Hg : (sl + 1) * GB_SLICE;
        for (int k = sl * GB_SLICE; k < k1; ++k) {
          const float h = __bfloat162float(hc[hrow * ldh + k]);
          const float2 w = *(const float2*)(hw + k * GB_HEADS + hcol);
          head[0] = fmaf(h, w.x, head[0]);
          head[1] = fmaf(h, w.y, head[1]);
        }
      }
      __syncthreads();  // before the next load overwrites this buffer
    }

    if (kLoss) {
      // the heads with their bias (zero past A + 1: so are W_head's columns)
      *(float2*)(hd + hrow * GB_HEADS + hcol) =
          make_float2(head[0] + hw[Hg * GB_HEADS + hcol], head[1] + hw[Hg * GB_HEADS + hcol + 1]);
      __syncthreads();
      // ---- the loss and its backward: one thread a row
      if (tid < GB_TILE) {
        const long long smp = s0 + tid;
        float* row = hd + tid * GB_HEADS;
        if (smp < n_samples) {
          gsq_loss_bwd(ls, (size_t)gru_traj_row(d, smp), row, macc);
          float4* o = (float4*)(dheads + (size_t)smp * GB_HEADS);
          o[0] = *(const float4*)row;
          o[1] = *(const float4*)(row + 4);
        } else {
#pragma unroll
          for (int a = 0; a < GB_HEADS; ++a) row[a] = 0.f;
        }
      }
      __syncthreads();
      // ---- the head gradients: hseq[t]^T dheads (the bias as a row of ones)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = gk + i * (GM_THREADS / 2);
        if (k <= Hg) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int s = 0; s < GB_TILE; ++s) {
            const float hv = k < Hg ? __bfloat162float(hc[s * ldh + k]) : 1.f;
            const float4 g = *(const float4*)(hd + s * GB_HEADS + gc);
            acc[0] = fmaf(hv, g.x, acc[0]);
            acc[1] = fmaf(hv, g.y, acc[1]);
            acc[2] = fmaf(hv, g.z, acc[2]);
            acc[3] = fmaf(hv, g.w, acc[3]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) hacc[i][c] += acc[c];
        }
      }
    }
  }

  if (kLoss) {
    if (tid < GB_TILE) {
#pragma unroll
      for (int m = 0; m < 4; ++m) met[tid * 4 + m] = macc[m];
    }
    __syncthreads();
    float* out = part_head + (size_t)blockIdx.x * (n_head + 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = gk + i * (GM_THREADS / 2);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k <= Hg && gc + c < A1) out[k * A1 + gc + c] = hacc[i][c];
    }
    if (tid < 4) {
      float acc = 0.f;
      for (int s = 0; s < GB_TILE; ++s) acc += met[s * 4 + tid];
      out[n_head + tid] = acc;
    }
  }
}

// grads = [dWh | dbhn | K13: dW_head, db_head, the metric sums]: the chunk
// partials of dWh and the sweep blocks' dbhn rows, a thread an entry (the
// first red_blocks blocks); the prologue blocks' head rows (n_cols entries
// each, up to 1,024 rows), 32 entries a block after them, warp w summing rows
// w, w + 8, .. and the eight sums then added in order.  Each in a fixed order.
static __global__ void gsq_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                         long long n_w, const float* __restrict__ part_bhn,
                                         int sweep_blocks, int Hg, int red_blocks,
                                         const float* __restrict__ part_head, int pro_blocks,
                                         int n_cols, float* __restrict__ grads) {
  __shared__ float sums[8][32];
  if ((int)blockIdx.x >= red_blocks) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = ((int)blockIdx.x - red_blocks) * 32 + lane;
    float acc = 0.f;
    if (e < n_cols)
      for (int b = w; b < pro_blocks; b += 8) acc += part_head[(size_t)b * n_cols + e];
    sums[w][lane] = acc;
    __syncthreads();
    if (w == 0 && e < n_cols) {
      float v = 0.f;
      for (int i = 0; i < 8; ++i) v += sums[i][lane];
      grads[n_w + Hg + e] = v;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  if (e < n_w) {
    for (int c = 0; c < n_chunks; ++c) acc += partial[(size_t)c * n_w + e];
  } else if (e < n_w + Hg) {
    for (int b = 0; b < sweep_blocks; ++b) acc += part_bhn[(size_t)b * Hg + (e - n_w)];
  } else {
    return;
  }
  grads[e] = acc;
}

// The plan's numbers (rware_tpu_torch/ops/fused_gru.py::gru_seq_bwd_plan).
struct GsqPlan {
  int sweep_rows;       // sequences a sweep block: 16, 32 or 64
  int tiles_per_block;  // prologue tiles of 64 samples a block
  int prologue_smem, sweep_smem, wgrad_smem;  // bytes: must be what this file computes
  int chunk, n_chunks;  // dWh: samples a partial (a multiple of 64), partials
};

// One launch of K12 (kLoss false, Cot GbCotSeq) or K13 (kLoss true, Cot
// GbCotHeads).  Scratch, for n = T n_env N samples: ws.rz (n, 2Hg) f32,
// ws.hn (n, 2Hg) bf16, ws.part_bhn (sweep blocks, Hg) f32, dhhn (n, Hg) bf16,
// partial (n_chunks, Hg 3Hg) f32; K13 also dheads (n, GB_HEADS) f32 and
// part_head (prologue blocks, (Hg + 1) A1 + 4) f32.  grads gets Hg 3Hg + Hg
// floats [dWh | dbhn], for K13 [| dW_head | db_head | mets].  With split_ms
// (host memory) not null the call waits for its kernels and writes the
// milliseconds of the prologue, the sweep, dWh and the reduction there, by
// CUDA events.
template <bool kLoss, class Cot>
static int gsq_bwd_run(const GruSeqDims& d, const GsqPlan& p, const GsqLoss& ls, const Cot& cot,
                       const void* iall, const void* done, const void* h0, const void* hseq,
                       const void* wh, const void* bhn, const GruBwdScratch& ws, void* dhhn_s,
                       void* dheads_s, void* part_head, void* partial, void* d_iall, void* grads,
                       void* dh0, float* split_ms, cudaStream_t stream) {
  const int Q = d.n_env * d.N, Hg = d.Hg;
  const long long n_samples = (long long)d.T * Q;
  if (!gsq_widths_ok(Hg, d.T, d.B, d.n_env) || d.N < 1 || d.start_env < 0
      || d.start_env >= d.B || (p.sweep_rows != 16 && p.sweep_rows != 32 && p.sweep_rows != 64)
      || p.sweep_smem != gb_sweep_smem<Cot>(Hg, p.sweep_rows)
      || p.prologue_smem != gsq_prologue_smem<kLoss>(Hg) || p.wgrad_smem != gru_wgrad_smem()
      || p.tiles_per_block < 1 || p.chunk < GW_SK || p.chunk % GW_SK || p.n_chunks < 1
      || (long long)p.chunk * p.n_chunks < n_samples)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_samples + GB_TILE - 1) / GB_TILE;
  const int pro_blocks = (int)((n_tiles + p.tiles_per_block - 1) / p.tiles_per_block);
  const int sweep_blocks = (Q + p.sweep_rows - 1) / p.sweep_rows;
  const int n_cols = kLoss ? (Hg + 1) * ls.A1 + 4 : 0;
  const long long n_w = (long long)Hg * 3 * Hg;
  cudaEvent_t ev[5];
  if (split_ms != nullptr)
    for (int i = 0; i < 5; ++i) cudaEventCreate(&ev[i]);
  auto mark = [&](int i) {
    if (split_ms != nullptr) cudaEventRecord(ev[i], stream);
  };

  mark(0);
  int err = (int)cudaFuncSetAttribute(gsq_bwd_prologue_kernel<kLoss>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      p.prologue_smem);
  if (err == 0) {
    gsq_bwd_prologue_kernel<kLoss><<<pro_blocks, GM_THREADS, p.prologue_smem, stream>>>(
        d, n_samples, p.tiles_per_block, (const gm_bf16*)iall, (const uint8_t*)done,
        (const gm_bf16*)h0, (const gm_bf16*)hseq, (const gm_bf16*)wh, (const float*)bhn, ls, ws,
        (float*)dheads_s, (float*)part_head);
    err = (int)cudaGetLastError();
  }
  mark(1);
  if (err == 0) {
    const GbOutSeq out = {(gm_bf16*)d_iall, (gm_bf16*)dhhn_s};
    err = gb_sweep(d, p.sweep_rows, p.sweep_smem, done, h0, hseq, cot, wh, ws, out, dh0, stream);
  }
  mark(2);
  if (err == 0) {
    // dWh: A = hprev rebuilt in place, G = [dr | dz] from d_iall, dhhn from its scratch
    const GruCols g = {(const gm_bf16*)d_iall, 3 * Hg, 2 * Hg, (const gm_bf16*)dhhn_s, Hg, 0};
    const GruHprevSrc src = {(const gm_bf16*)h0, (const gm_bf16*)hseq, (const uint8_t*)done, Hg,
                             0, 3 * Hg, g};
    err = gru_wgrad_launch(d, src, n_samples, p.chunk, p.n_chunks, (float*)partial, 0, n_w,
                           stream);
  }
  mark(3);
  if (err == 0) {
    const int red_blocks = (int)((n_w + Hg + 255) / 256);
    gsq_reduce_kernel<<<red_blocks + (n_cols + 31) / 32, 256, 0, stream>>>(
        (const float*)partial, p.n_chunks, n_w, ws.part_bhn, sweep_blocks, Hg, red_blocks,
        (const float*)part_head, pro_blocks, n_cols, (float*)grads);
    err = (int)cudaGetLastError();
  }
  mark(4);
  if (split_ms != nullptr) {
    if (err == 0) err = (int)cudaEventSynchronize(ev[4]);
    for (int i = 0; i < 4 && err == 0; ++i)
      err = (int)cudaEventElapsedTime(&split_ms[i], ev[i], ev[i + 1]);
    for (int i = 0; i < 5; ++i) cudaEventDestroy(ev[i]);
  }
  return err;
}
