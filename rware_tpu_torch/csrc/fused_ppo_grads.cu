// K4: gradients of the clipped-PPO loss of one minibatch window, and the
// window's four metric sums.
//
// Replaces rware_tpu/ops/pallas_update.py::build_fused_ppo_grads (kernel body
// _make_update_kernel) in zero-copy mode, with or without the message head
// (msg_bits M > 0: the head block [policy | value | message] of A + 1 + M
// columns, the joint move + Bernoulli-bits log-probability and entropy, the
// message cotangent rows dlogp (bit - sigma) + ent_coef inv_n l sigma (1 -
// sigma) in dcat, so the weight-gradient products and bias sums cover them;
// pallas_update.py:185-244): the window is rows (start + t) % T_full of the
// (T_full, B, N, ...) trajectory, read in place (no rolled or sliced copy).  The TPU kernel walks a
// sequential grid and accumulates weight gradients in VMEM; Hopper blocks
// run in no order, so the work is split in three kernels per window:
//
//  1. ppo_sample_kernel (ppo_sample.cuh, mode PPO_ACTOR, or PPO_MSG with the
//     message head): a block holds the weights in shared memory (dense_0
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
#include "ppo_sample.cuh"

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

// mets[m] = the blocks' partials of buffer a in order, then those of b.
__global__ void ppo_metrics_kernel(const float* __restrict__ part_a, int n_a,
                                   const float* __restrict__ part_b, int n_b,
                                   float* __restrict__ mets) {
  const int m = threadIdx.x;
  if (m >= 4) return;
  float acc = 0.f;
  for (int b = 0; b < n_a; ++b) acc += part_a[(size_t)b * 4 + m];
  for (int b = 0; b < n_b; ++b) acc += part_b[(size_t)b * 4 + m];
  mets[m] = acc;
}

static dim3 wgrad_grid(int rows, int cols, int n_chunks) {
  const int tiles = ((rows + PPO_TW - 1) / PPO_TW) * ((cols + PPO_TW - 1) / PPO_TW);
  return dim3(tiles, n_chunks);
}

int ppo_actor_sample_launch(const PpoDims& d, const int* start, const float* stats,
                            const PpoData& data, const float* params, const PpoScratch& ws,
                            cudaStream_t stream) {
  const auto kernel = d.msg_bits > 0 ? ppo_sample_kernel<PPO_MSG> : ppo_sample_kernel<PPO_ACTOR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         d.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<d.grid, PPO_THREADS, d.smem, stream>>>(d, start, stats, data, params, ws);
  return (int)cudaGetLastError();
}

int ppo_wgrads_launch(const PpoDims& d, const int* start, const __nv_bfloat16* obs,
                      const PpoScratch& ws, float* grads, cudaStream_t stream) {
  const PpoOffsets o = ppo_offsets(d);
  const int AC = d.heads;
  const PpoOperand x = {obs, 1, d.L, 1};
  const PpoOperand h1 = {ws.h1, 1, d.H1, 0}, h2 = {ws.h2, 1, d.H2, 0};
  const PpoOperand dz1 = {ws.dz1, 1, d.H1, 0}, dz2 = {ws.dz2, 1, d.H2, 0};
  const PpoOperand dcat = {ws.dcat, 0, d.hc, 0};
  ppo_wgrad_kernel<<<wgrad_grid(d.L + 1, d.H1, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, x, d.L, dz1, d.H1, ws.partial, 0, o.n);
  ppo_wgrad_kernel<<<wgrad_grid(d.H1 + 1, d.H2, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, h1, d.H1, dz2, d.H2, ws.partial, o.w1, o.n);
  ppo_wgrad_kernel<<<wgrad_grid(d.H2 + 1, AC, d.n_chunks), PPO_THREADS, 0, stream>>>(
      d, start, h2, d.H2, dcat, AC, ws.partial, o.wc, o.n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ppo_reduce_kernel<<<(unsigned)((o.n + 255) / 256), 256, 0, stream>>>(ws.partial, d.n_chunks,
                                                                        o.n, grads);
  return (int)cudaGetLastError();
}

int ppo_metrics_launch(const float* part_a, int n_a, const float* part_b, int n_b, float* mets,
                       cudaStream_t stream) {
  ppo_metrics_kernel<<<1, 32, 0, stream>>>(part_a, n_a, part_b, n_b, mets);
  return (int)cudaGetLastError();
}

int ppo_grads_enqueue(const PpoDims& d, const int* start, const float* stats,
                      const PpoData& data, const float* params, const PpoScratch& ws,
                      float* grads, float* mets, cudaStream_t stream) {
  int err = ppo_actor_sample_launch(d, start, stats, data, params, ws, stream);
  if (err != 0) return err;
  err = ppo_wgrads_launch(d, start, data.obs, ws, grads, stream);
  if (err != 0) return err;
  return ppo_metrics_launch(ws.part_mets, d.grid, nullptr, 0, mets, stream);
}

extern "C" int rw_fused_ppo_grads(int L, int H1, int H2, int A, int T_full, int T_mb, int B,
                                  int N, float clip_eps, float vf_coef, float ent_coef,
                                  float inv_n, int tile, int grid, int smem, int w0_smem,
                                  int chunk, int n_chunks, int msg_bits, int hc,
                                  const void* start, const void* stats,
                                  const void* obs, const void* action, const void* logp,
                                  const void* value, const void* adv, const void* target,
                                  const void* bits, const void* params, void* h1, void* h2,
                                  void* dz1, void* dz2,
                                  void* dcat, void* partial, void* part_mets, void* grads,
                                  void* mets, void* stream) {
  PpoDims d = ppo_dims(L, H1, H2, A, T_full, T_mb, B, N, clip_eps, vf_coef, ent_coef, inv_n,
                       tile, grid, smem, w0_smem, chunk, n_chunks);
  d.msg_bits = msg_bits;
  d.heads = A + 1 + msg_bits;
  d.hc = hc;
  if (d.heads > hc || hc > PPO_HC_MAX || (msg_bits > 0 && bits == nullptr))
    return (int)cudaErrorInvalidValue;
  const PpoData data = {(const __nv_bfloat16*)obs, (const int*)action, (const float*)logp,
                        (const float*)value, (const float*)adv, (const float*)target,
                        (const int*)bits};
  const PpoScratch ws = {(__nv_bfloat16*)h1, (__nv_bfloat16*)h2, (__nv_bfloat16*)dz1,
                         (__nv_bfloat16*)dz2, (float*)dcat, (float*)partial, (float*)part_mets,
                         nullptr};
  return ppo_grads_enqueue(d, (const int*)start, (const float*)stats, data,
                           (const float*)params, ws, (float*)grads, (float*)mets,
                           (cudaStream_t)stream);
}
