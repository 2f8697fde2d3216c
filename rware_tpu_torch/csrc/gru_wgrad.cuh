// The weight-gradient passes shared by the GRU backward kernels: K10
// (fused_gru_bwd.cu) and K12/K13 (gru_seq.cuh).  A product out = A^T G over
// every sample of a band launch runs without float atomics, in two kernels:
//
//  1. gru_wgrad_kernel: each block one 64 x 64 output tile over one chunk of
//     samples, written to its own partial;
//  2. gru_reduce_kernel: the chunk partials, and after them the sweep
//     blocks' partial rows, summed in a fixed order.
//
// So two launches give the same bits.
#pragma once

#include "gru_core.cuh"

#define GRU_SK 32  // samples per step of the weight-gradient kernel
#define GRU_TW 64  // weight-gradient output tile, rows and columns

// Src names the operands of one product: ia columns of A (with bias, a
// column of ones after them) and jb columns of G, through
//   Src::Row: what the kernel keeps in shared memory per sample to find its
//     A row;
//   Row a_row(const GruSeqDims&, long long smp): that of sample smp;
//   float a_at(Row, int i): A's entry, i < ia;
//   float g_at(const GruSeqDims&, long long smp, int j): G's entry, j < jb.
// partial[chunk][out_off + i * jb + j] = sum over the chunk's samples s of
// A(s, i) G(s, j), i < ia + bias; each chunk's partial holds n_out floats.
template <class Src>
__global__ void __launch_bounds__(GRU_THREADS)
    gru_wgrad_kernel(GruSeqDims d, Src src, long long n_samples, int chunk,
                     float* __restrict__ partial, long long out_off, long long n_out) {
  __shared__ __align__(16) float As[GRU_SK][GRU_TW + 4];
  __shared__ __align__(16) float Gs[GRU_SK][GRU_TW + 4];
  __shared__ typename Src::Row rows_a[GRU_SK];
  const int tid = threadIdx.x;
  const int tiles_j = (src.jb + GRU_TW - 1) / GRU_TW;
  const int ti0 = (blockIdx.x / tiles_j) * GRU_TW, tj0 = (blockIdx.x % tiles_j) * GRU_TW;
  const long long c0 = (long long)blockIdx.y * chunk;
  const long long c1 = c0 + chunk < n_samples ? c0 + chunk : n_samples;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (long long s0 = c0; s0 < c1; s0 += GRU_SK) {
    if (tid < GRU_SK && s0 + tid < c1) rows_a[tid] = src.a_row(d, s0 + tid);
    __syncthreads();
    for (int idx = tid; idx < GRU_SK * GRU_TW; idx += GRU_THREADS) {
      const int ss = idx / GRU_TW, cc = idx - ss * GRU_TW;
      const long long smp = s0 + ss;
      const int i = ti0 + cc, j = tj0 + cc;
      float av = 0.f, gv = 0.f;
      if (smp < c1) {
        if (i < src.ia) {
          av = src.a_at(rows_a[ss], i);
        } else if (i == src.ia && src.bias) {
          av = 1.f;
        }
        if (j < src.jb) gv = src.g_at(d, smp, j);
      }
      As[ss][cc] = av;
      Gs[ss][cc] = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < GRU_SK; ++ss) {
      const float4 av = *(const float4*)&As[ss][ty * 4];
      const float4 gv = *(const float4*)&Gs[ss][tx * 4];
      const float aa[4] = {av.x, av.y, av.z, av.w};
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(aa[r], gg[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.y * n_out + out_off;
  const int rows = src.ia + (src.bias ? 1 : 0);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ti0 + ty * 4 + r, j = tj0 + tx * 4 + c;
      if (i < rows && j < src.jb) out[(size_t)i * src.jb + j] = acc[r][c];
    }
}

// The grid of one gru_wgrad_kernel launch: an (rows, cols) output in 64 x 64
// tiles, by n_chunks chunks of samples.
static inline dim3 gru_wgrad_grid(int rows, int cols, int n_chunks) {
  return dim3(((rows + GRU_TW - 1) / GRU_TW) * ((cols + GRU_TW - 1) / GRU_TW), n_chunks);
}

// grads[e] = sum over chunks of partial[c][e] for e < n_w, and for the n_blk
// entries after them the sum over the sweep's blocks of part_blk[b][e - n_w].
static __global__ void gru_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                         long long n_w, const float* __restrict__ part_blk,
                                         int n_blocks, int n_blk, float* __restrict__ grads) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w + n_blk) return;
  float acc = 0.f;
  if (e < n_w) {
    for (int c = 0; c < n_chunks; ++c) acc += partial[(size_t)c * n_w + e];
  } else {
    for (int b = 0; b < n_blocks; ++b) acc += part_blk[(size_t)b * n_blk + (e - n_w)];
  }
  grads[e] = acc;
}
