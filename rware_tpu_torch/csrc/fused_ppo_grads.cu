// K4: gradients of the clipped-PPO loss of one minibatch window, and the
// window's four metric sums.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_ppo_grads (kernel body
// _make_update_kernel) in zero-copy mode without the message head: the
// window is rows (start + t) % T_full of the (T_full, B, N, ...) trajectory,
// read in place (no rolled or sliced copy).  The TPU kernel walks a
// sequential grid and accumulates weight gradients in VMEM; Hopper blocks
// run in no order, so the work is split in three kernels per window:
//
//  1. ppo_sample_kernel: a block holds the weights in shared memory (dense_0
//     and dense_1 in bf16, heads in f32) and walks tiles of samples: the
//     forward, the loss pieces and the backward down to dz1, with register
//     tiles of 4 x 4 products on the FP32 pipes.  It writes the per-sample
//     activations the weight gradients need (h1, h2, dz1, dz2 bf16; dcat
//     f32) and its partial metric sums (fixed order).
//  2. ppo_wgrad_kernel, once per stacked block: x^T dz1, h1^T dz2, h2^T dcat
//     plus the bias rows, each block one 64 x 64 output tile over one chunk
//     of samples, written to its own partial.
//  3. ppo_reduce_kernel / ppo_metrics_kernel: the partials summed in a fixed
//     order.  No float atomics, so two launches give the same bits.
//
// Numerics follow pallas_update.py:1065-1160: bf16 inputs and hidden
// weights, f32 sums, bf16(z + b) then bf16(tanh), f32 heads;
// dz = bf16(bf16(dh) * bf16(1 - bf16(h * h))).  Sums run in another order
// than the plain version's torch.matmul, so the two agree to float32
// rounding, and to a bf16 step where a rounding boundary is crossed.
//
// Bound on the card: the FP32 multiply-adds, about 69k per sample at L=71,
// hidden (128, 128) (forward 26k, backward 17k, weight gradients 26k).  The
// device-memory traffic is the obs read (142 B per sample) and about 1 KB
// per sample of activations written and read back.
#include "ppo_core.cuh"

static __device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

static __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// out[j][s] = bf16(tanh(bf16(sum_k in[k][s] * w[k][j] + bias[j]))) for one
// tile; also written to out_g (S, J) bf16.  Warps span j, so a warp reads
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
        if (g < S) out_g[(size_t)g * J + j0 + c] = __float2bfloat16_rn(h);
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

__global__ void __launch_bounds__(PPO_THREADS)
    ppo_sample_kernel(PpoDims d, const int* __restrict__ start_p, const float* __restrict__ stats,
                      PpoData data, const float* __restrict__ params, PpoScratch ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = d.L, H1 = d.H1, H2 = d.H2, A = d.A, AC = d.A + 1;
  const int TS = d.tile, LD = d.tile + 4, HM = H1 > H2 ? H1 : H2;
  const int tid = threadIdx.x;
  const PpoOffsets o = ppo_offsets(d);

  // Shared memory: f32 [b0 H1 | b1 H2 | wc H2*AC | bc AC], bf16 [w0 L*H1
  // (if w0_smem) | w1 H1*H2], f32 [xs L | h1 H1 | h2 HM | dz2 H2 | hc PPO_HC]
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
  float* red = hc + (size_t)PPO_HC * LD;
  long long* rows = (long long*)(red + 4 * TS);

  for (int k = tid; k < (int)w0_len; k += PPO_THREADS) sw0[k] = __float2bfloat16_rn(params[k]);
  for (int k = tid; k < H1 * H2; k += PPO_THREADS) sw1[k] = __float2bfloat16_rn(params[o.w1 + k]);
  for (int k = tid; k < H2 * AC; k += PPO_THREADS) swc[k] = params[o.wc + k];
  for (int k = tid; k < H1; k += PPO_THREADS) sb0[k] = params[o.b0 + k];
  for (int k = tid; k < H2; k += PPO_THREADS) sb1[k] = params[o.b1 + k];
  if (tid < AC) sbc[tid] = params[o.bc + tid];

  const int start = start_p[0];
  const float adv_mean = stats[0], adv_inv_std = stats[1];
  const float eps = d.clip_eps, inv_n = d.inv_n;
  const long long S = (long long)d.T_mb * d.B * d.N;
  const long long n_tiles = (S + TS - 1) / TS;
  float msum = 0.f;  // thread m < 4: this block's sum of metric m
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
      dense_tanh<false>(xs, L, sw0, nullptr, sb0, H1, TS, LD, h1, ws.h1, s0, S);
    else
      dense_tanh<true>(xs, L, nullptr, params, sb0, H1, TS, LD, h1, ws.h1, s0, S);
    __syncthreads();
    dense_tanh<false>(h1, H1, sw1, nullptr, sb1, H2, TS, LD, h2, ws.h2, s0, S);
    __syncthreads();
    for (int idx = tid; idx < AC * TS; idx += PPO_THREADS) {
      const int a = idx / TS, s = idx - a * TS;
      float acc = 0.f;
      for (int k = 0; k < H2; ++k) acc = fmaf(h2[(size_t)k * LD + s], swc[k * AC + a], acc);
      hc[(size_t)a * LD + s] = acc + sbc[a];
    }
    __syncthreads();

    // Loss pieces, one thread per sample: hc's column becomes [dlogits | dvalue].
    if (tid < TS) {
      const int s = tid;
      const long long r = rows[s];
      float dcat[PPO_HC], terms[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < PPO_HC; ++a) dcat[a] = 0.f;
      if (r >= 0) {
        const int act = data.action[r];
        const float old_logp = data.logp[r], old_value = data.value[r];
        const float adv = data.adv[r], target = data.target[r];
        float lg[PPO_HC], p[PPO_HC];
        for (int a = 0; a < A; ++a) lg[a] = hc[(size_t)a * LD + s];
        float mx = lg[0];
        for (int a = 1; a < A; ++a) mx = fmaxf(mx, lg[a]);
        const float value = hc[(size_t)A * LD + s];
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
        const float ratio = expf(logp - old_logp);
        const float advn = (adv - adv_mean) * adv_inv_std;
        const float ratio_c = fminf(fmaxf(ratio, 1.f - eps), 1.f + eps);
        const float pg1 = ratio * advn, pg2 = ratio_c * advn;
        const bool inside = ratio > 1.f - eps && ratio < 1.f + eps;
        const float dobj = pg1 <= pg2 ? advn : (inside ? advn : 0.f);
        const float dlogp = -inv_n * dobj * ratio;
        const float ent_scale = d.ent_coef * inv_n;
        for (int a = 0; a < A; ++a)
          dcat[a] = dlogp * ((a == act ? 1.f : 0.f) - p[a]) + ent_scale * p[a] * (lg[a] + ent);
        const float vdiff = value - old_value;
        const float v_clip = old_value + fminf(fmaxf(vdiff, -eps), eps);
        const float e1 = value - target, e2 = v_clip - target;
        const bool inside_v = vdiff > -eps && vdiff < eps;
        dcat[A] = d.vf_coef * inv_n * (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.f));
        terms[0] = fminf(pg1, pg2);
        terms[1] = 0.5f * fmaxf(e1 * e1, e2 * e2);
        terms[2] = ent;
        terms[3] = (ratio - 1.f) - (logp - old_logp);
        float* dg = ws.dcat + (size_t)(s0 + s) * PPO_HC;
#pragma unroll
        for (int a = 0; a < PPO_HC; ++a) dg[a] = dcat[a];
      }
      for (int a = 0; a < AC; ++a) hc[(size_t)a * LD + s] = dcat[a];
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
  if (tid < 4) ws.part_mets[(size_t)blockIdx.x * 4 + tid] = msum;
}

struct PpoOperand {
  const void* p;
  int bf16;    // element type: bf16 or f32
  int ld;      // row stride, elements
  int window;  // rows addressed through the minibatch window (the obs)
};

// partial[chunk][out_off + i * jb + j] = sum over the chunk's samples of
// A(s, i) * B(s, j) for i <= ia, j < jb, where A's row ia is all ones.
__global__ void __launch_bounds__(PPO_THREADS)
    ppo_wgrad_kernel(PpoDims d, const int* __restrict__ start_p, PpoOperand a, int ia,
                     PpoOperand b, int jb, float* __restrict__ partial, long long out_off,
                     long long n_params) {
  __shared__ __align__(16) float As[PPO_SK][PPO_TW + 4];
  __shared__ __align__(16) float Bs[PPO_SK][PPO_TW + 4];
  __shared__ long long rows_a[PPO_SK], rows_b[PPO_SK];
  const int tid = threadIdx.x;
  const int tiles_j = (jb + PPO_TW - 1) / PPO_TW;
  const int ti0 = (blockIdx.x / tiles_j) * PPO_TW, tj0 = (blockIdx.x % tiles_j) * PPO_TW;
  const long long S = (long long)d.T_mb * d.B * d.N;
  const long long c0 = (long long)blockIdx.y * d.chunk;
  const long long c1 = c0 + d.chunk < S ? c0 + d.chunk : S;
  const int start = start_p[0];
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (long long s0 = c0; s0 < c1; s0 += PPO_SK) {
    if (tid < PPO_SK) {
      const long long g = s0 + tid;
      rows_a[tid] = g < c1 ? (a.window ? ppo_row(d, start, g) : g) : -1;
      rows_b[tid] = g < c1 ? (b.window ? ppo_row(d, start, g) : g) : -1;
    }
    __syncthreads();
    for (int idx = tid; idx < PPO_SK * PPO_TW; idx += PPO_THREADS) {
      const int ss = idx / PPO_TW, cc = idx - ss * PPO_TW;
      const long long ra = rows_a[ss], rb = rows_b[ss];
      const int i = ti0 + cc, j = tj0 + cc;
      float av = 0.f, bv = 0.f;
      if (ra >= 0) {
        if (i < ia) {
          const size_t k = (size_t)ra * a.ld + i;
          av = a.bf16 ? __bfloat162float(((const __nv_bfloat16*)a.p)[k]) : ((const float*)a.p)[k];
        } else if (i == ia) {
          av = 1.f;
        }
        if (j < jb) {
          const size_t k = (size_t)rb * b.ld + j;
          bv = b.bf16 ? __bfloat162float(((const __nv_bfloat16*)b.p)[k]) : ((const float*)b.p)[k];
        }
      }
      As[ss][cc] = av;
      Bs[ss][cc] = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < PPO_SK; ++ss) {
      const float4 av = *(const float4*)&As[ss][ty * 4];
      const float4 bv = *(const float4*)&Bs[ss][tx * 4];
      const float aa[4] = {av.x, av.y, av.z, av.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(aa[r], bb[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.y * n_params + out_off;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ti0 + ty * 4 + r, j = tj0 + tx * 4 + c;
      if (i <= ia && j < jb) out[(size_t)i * jb + j] = acc[r][c];
    }
}

// out[e] = sum over chunks c = 0, 1, ... of partial[c][e].
__global__ void ppo_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                  long long n, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += partial[(size_t)c * n + e];
  out[e] = acc;
}

__global__ void ppo_metrics_kernel(const float* __restrict__ part, int n_blocks,
                                   float* __restrict__ mets) {
  const int m = threadIdx.x;
  if (m >= 4) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += part[(size_t)b * 4 + m];
  mets[m] = acc;
}

static dim3 wgrad_grid(int rows, int cols, int n_chunks) {
  const int tiles = ((rows + PPO_TW - 1) / PPO_TW) * ((cols + PPO_TW - 1) / PPO_TW);
  return dim3(tiles, n_chunks);
}

int ppo_grads_enqueue(const PpoDims& d, const int* start, const float* stats,
                      const PpoData& data, const float* params, const PpoScratch& ws,
                      float* grads, float* mets, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ppo_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
  if (err != cudaSuccess) return (int)err;
  ppo_sample_kernel<<<d.grid, PPO_THREADS, d.smem, stream>>>(d, start, stats, data, params, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const PpoOffsets o = ppo_offsets(d);
  const int AC = d.A + 1;
  const PpoOperand x = {data.obs, 1, d.L, 1};
  const PpoOperand h1 = {ws.h1, 1, d.H1, 0}, h2 = {ws.h2, 1, d.H2, 0};
  const PpoOperand dz1 = {ws.dz1, 1, d.H1, 0}, dz2 = {ws.dz2, 1, d.H2, 0};
  const PpoOperand dcat = {ws.dcat, 0, PPO_HC, 0};
  ppo_wgrad_kernel<<<wgrad_grid(d.L + 1, d.H1, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, x, d.L, dz1, d.H1, ws.partial, 0, o.n);
  ppo_wgrad_kernel<<<wgrad_grid(d.H1 + 1, d.H2, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, h1, d.H1, dz2, d.H2, ws.partial, o.w1, o.n);
  ppo_wgrad_kernel<<<wgrad_grid(d.H2 + 1, AC, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, h2, d.H2, dcat, AC, ws.partial, o.wc, o.n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ppo_reduce_kernel<<<(unsigned)((o.n + 255) / 256), 256, 0, stream>>>(ws.partial, d.n_chunks,
                                                                        o.n, grads);
  ppo_metrics_kernel<<<1, 32, 0, stream>>>(ws.part_mets, d.grid, mets);
  return (int)cudaGetLastError();
}

extern "C" int rw_fused_ppo_grads(int L, int H1, int H2, int A, int T_full, int T_mb, int B,
                                  int N, float clip_eps, float vf_coef, float ent_coef,
                                  float inv_n, int tile, int grid, int smem, int w0_smem,
                                  int chunk, int n_chunks, const void* start,
                                  const void* stats,
                                  const void* obs, const void* action, const void* logp,
                                  const void* value, const void* adv, const void* target,
                                  const void* params, void* h1, void* h2, void* dz1, void* dz2,
                                  void* dcat, void* partial, void* part_mets, void* grads,
                                  void* mets, void* stream) {
  const PpoDims d = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef,
                             inv_n, tile, grid, smem, w0_smem, chunk, n_chunks);
  const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                        (const float*)value, (const float*)adv, (const float*)target};
  const PpoScratch ws = {(__nv_bfloat16*)h1, (__nv_bfloat16*)h2, (__nv_bfloat16*)dz1,
                         (__nv_bfloat16*)dz2, (float*)dcat, (float*)partial, (float*)part_mets};
  return ppo_grads_enqueue(d, (const int*)start, (const float*)stats, data,
                           (const float*)params, ws, (float*)grads, (float*)mets,
                           (cudaStream_t)stream);
}
