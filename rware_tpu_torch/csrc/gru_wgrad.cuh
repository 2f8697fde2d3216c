// The weight-gradient pass shared by the GRU backward kernels: K10
// (fused_gru_bwd.cu) and K12/K13 (gru_seq_bwd.cuh).  A product out = A^T G over
// every sample of a band launch runs without float atomics, in two kernels:
//
//  1. gru_wgrad_kernel: each block one 128 x 128 output tile over one chunk of
//     samples, on the tensor cores (gru_mma.cuh): 64 samples a step, the A
//     and G rows staged as bf16 in shared memory by cp.async, three buffers
//     so that the next two steps' rows arrive while this step's products run;
//     the sums stay in registers and are written to the block's own partial;
//  2. gru_reduce_kernel: the chunk partials, and after them the sweep
//     blocks' partial rows, summed in a fixed order.
//
// So two launches give the same bits.
#pragma once

#include <limits.h>

#include "gru_mma.cuh"

#define GW_THREADS 512  // sixteen warps a block
#define GW_SK 64        // samples a step
#define GW_NS 3         // shared-memory buffers: steps in flight
#define GW_TI 128       // output rows a block (columns of A)
#define GW_TJ 128       // output columns a block (columns of G)

// G's columns j < split come from p at row smp, column j; from split on,
// from p2 (when it is not null) at column j - split, else from p at column
// j + skip.  Column groups of 8 never straddle split.
struct GruCols {
  const gm_bf16* p;
  int ld;
  int split;
  const gm_bf16* p2;
  int ld2, skip;

  __device__ const gm_bf16* at(long long smp, int j) const {
    if (j < split) return p + (size_t)smp * ld + j;
    if (p2 != nullptr) return p2 + (size_t)smp * ld2 + (j - split);
    return p + (size_t)smp * ld + j + skip;
  }
};

static inline GruCols gru_cols(const void* p, int ld) {
  return GruCols{(const gm_bf16*)p, ld, INT_MAX, nullptr, 0, 0};
}

// The operand sources.  Each names ia columns of A (with bias, a row of G's
// column sums after them), jb columns of G (cols), and how a thread finds its
// A row: kVec sources give a row pointer and a flag (a loaded byte, nonzero:
// the row is zeros) and are read 16 bytes at a time; the obs rows (odd
// lengths, so any alignment) are read element by element through a row
// index.  The row is found by the thread that loads it, never read from
// shared memory.

// A = the trajectory's obs rows through the band.
struct GruObsSrc {
  static constexpr bool kVec = false;
  const gm_bf16* obs;
  int ia, bias, jb;
  GruCols cols;

  __device__ long long a_row(const GruSeqDims& d, long long smp) const {
    return gru_traj_row(d, smp);
  }
  __device__ gm_bf16 a_at(long long row, int i) const { return obs[(size_t)row * ia + i]; }
};

// A rows stored per sample (ld columns).
struct GruRowSrc {
  static constexpr bool kVec = true;
  const gm_bf16* p;
  int ld, ia, bias, jb;
  GruCols cols;

  __device__ const gm_bf16* a_ptr(const GruSeqDims&, long long smp, uint8_t& masked) const {
    masked = 0;
    return p + (size_t)smp * ld;
  }
};

// A = hprev: h0 at t = 0, else hseq[t-1], zeros where done[t-1] (rebuilt in
// place, no copy).  The row is copied whatever done[t-1] says and zeroed
// once it has arrived, so that the copy does not wait on the flag's load.
struct GruHprevSrc {
  static constexpr bool kVec = true;
  const gm_bf16 *h0, *hseq;
  const uint8_t* done;
  int ia, bias, jb;
  GruCols cols;

  __device__ const gm_bf16* a_ptr(const GruSeqDims& d, long long smp, uint8_t& masked) const {
    const int Q = d.n_env * d.N;
    const long long t = smp / Q;
    const int q = (int)(smp - t * Q), env = gru_env(d, q);
    if (t == 0) {
      masked = 0;
      return h0 + ((size_t)env * d.N + q % d.N) * d.Hg;
    }
    masked = __ldg(done + (size_t)(t - 1) * d.B + env);
    return hseq + (size_t)(smp - Q) * d.Hg;
  }
};

static inline int gru_wgrad_smem() {
  return GW_NS * GW_SK * ((GW_TI + GM_PAD) + (GW_TJ + GM_PAD)) * (int)sizeof(gm_bf16)
         + (GW_THREADS / GW_TJ) * GW_TJ * (int)sizeof(float);
}

// partial[chunk][out_off + i * jb + j] = sum over the chunk's samples s of
// A(s, i) G(s, j) for i < ia, and with bias the row i = ia of G's column sums
// (added from the staged G rows by the first row of tiles, not by a product
// with a column of ones, so that a 128-wide A takes one tile); each chunk's
// partial holds n_out floats.  Warp w computes rows 16 (w % 8).. of the tile
// and columns 64 (w / 8)...  With kStepSums each mma sums its 16 samples from
// zero and the sum joins the running total by a rounded f32 add, so that the
// tensor cores' rounding of their f32 sums does not build up over a long
// chunk (the PPO pass, csrc/fused_ppo_grads.cu); the GRU kernels keep the
// chained sums.
template <class Src, bool kStepSums = false>
__global__ void __launch_bounds__(GW_THREADS)
    gru_wgrad_kernel(GruSeqDims d, Src src, long long n_samples, int chunk,
                     float* __restrict__ partial, long long out_off, long long n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = GW_TI + GM_PAD, ldg = GW_TJ + GM_PAD;
  constexpr int A_GROUPS = GW_SK * GW_TI / 8 / GW_THREADS;  // groups of 8 A columns a thread
  constexpr int QS = GW_THREADS / GW_TJ, SQ = GW_SK / QS;   // column sums: quarters of a step
  gm_bf16* as = (gm_bf16*)smem;            // GW_NS x (GW_SK, lda): A's rows, sample-major
  gm_bf16* gs = as + GW_NS * GW_SK * lda;  // GW_NS x (GW_SK, ldg): G's rows
  float* red = (float*)(gs + GW_NS * GW_SK * ldg);  // (QS, GW_TJ): the column sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wi = warp & 7, wj = warp >> 3;
  const int tiles_j = (src.jb + GW_TJ - 1) / GW_TJ;
  const int ti0 = (blockIdx.x / tiles_j) * GW_TI, tj0 = (blockIdx.x % tiles_j) * GW_TJ;
  const long long c0 = (long long)blockIdx.y * chunk;
  const long long c1 = c0 + chunk < n_samples ? c0 + chunk : n_samples;
  const bool m_on = ti0 + wi * 16 < src.ia;
  const bool sums = src.bias && ti0 == 0;
  const gm_bf16 zero = __float2bfloat16_rn(0.f);
  __align__(16) gm_bf16 pend[A_GROUPS][8];  // element-wise A rows, stored after the products
  uint8_t masked[GW_NS][A_GROUPS];           // kVec rows to zero once they have arrived

  // A's group a of this thread: sample s, columns ic .. ic + 8 of the tile
  auto a_group = [&](int a, int& s, int& ic) {
    const int idx = tid + a * GW_THREADS;
    s = idx / (GW_TI / 8);
    ic = (idx % (GW_TI / 8)) * 8;
  };
  auto load = [&](long long s0, int b) {
#pragma unroll
    for (int a = 0; a < A_GROUPS; ++a) {
      int s, ic;
      a_group(a, s, ic);
      const int i = ti0 + ic;
      const long long smp = s0 + s;
      const bool in = smp < c1 && i < src.ia;
      if constexpr (Src::kVec) {
        masked[b][a] = 0;
        const gm_bf16* row = in ? src.a_ptr(d, smp, masked[b][a]) : nullptr;
        gm_cp16(as + (b * GW_SK + s) * lda + ic, row != nullptr ? row + i : src.cols.p,
                row != nullptr);
      } else {
        const long long row = in ? src.a_row(d, smp) : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) pend[a][u] = in && i + u < src.ia ? src.a_at(row, i + u) : zero;
      }
    }
    for (int idx = tid; idx < GW_SK * (GW_TJ / 8); idx += GW_THREADS) {
      const int s = idx / (GW_TJ / 8), jc = (idx % (GW_TJ / 8)) * 8, j = tj0 + jc;
      const long long smp = s0 + s;
      const bool ok = smp < c1 && j < src.jb;
      gm_cp16(gs + (b * GW_SK + s) * ldg + jc, ok ? src.cols.at(smp, j) : src.cols.p, ok);
    }
  };
  // after the loads of buffer b arrived: element-wise rows stored, masked rows zeroed
  auto put_a = [&](int b) {
#pragma unroll
    for (int a = 0; a < A_GROUPS; ++a) {
      int s, ic;
      a_group(a, s, ic);
      uint4* dst = (uint4*)(as + (b * GW_SK + s) * lda + ic);
      if constexpr (Src::kVec) {
        if (masked[b][a]) *dst = make_uint4(0, 0, 0, 0);
      } else {
        *dst = *(const uint4*)pend[a];
      }
    }
  };

  float acc[8][4], bsum = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;

  // GW_NS buffers: the loads of the next GW_NS - 1 steps in flight during a
  // step's products.  Step st takes buffer st % GW_NS; the loop is unrolled
  // by GW_NS so that every buffer index is known at compile time.
  const long long n_steps = c1 > c0 ? (c1 - c0 + GW_SK - 1) / GW_SK : 0;
#pragma unroll
  for (int p = 0; p < GW_NS - 1; ++p) {
    if (p < n_steps) {
      load(c0 + p * GW_SK, p);
      if constexpr (!Src::kVec) put_a(p);
    }
    gm_cp_commit();
  }
  for (long long base = 0; base < n_steps; base += GW_NS) {
#pragma unroll
    for (int k = 0; k < GW_NS; ++k) {
      const long long st = base + k;
      if (st < n_steps) {
        gm_cp_wait<GW_NS - 2>();
        if constexpr (Src::kVec) put_a(k);  // this thread's copies of step st have arrived
        __syncthreads();  // step st's rows are in; step st - 1's buffer is free
        const int nb = (k + GW_NS - 1) % GW_NS;
        const bool more = st + GW_NS - 1 < n_steps;
        if (more) load(c0 + (st + GW_NS - 1) * GW_SK, nb);
        gm_cp_commit();
        const gm_bf16* a = as + k * GW_SK * lda;
        const gm_bf16* gg = gs + k * GW_SK * ldg;
        if (m_on) {
#pragma unroll
          for (int kk = 0; kk < GW_SK; kk += 16) {
            uint32_t af[4];
            gm_frag_at(af, a, lda, wi * 16, kk);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int n0 = wj * 64 + p * 16;
              if (tj0 + n0 < src.jb) {
                uint32_t bf[4];
                gm_frag_b2_kn(bf, gg, ldg, n0, kk);
                if constexpr (kStepSums) {
                  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
                  gm_mma(t0, af, bf[0], bf[1]);
                  gm_mma(t1, af, bf[2], bf[3]);
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    acc[2 * p][q] += t0[q];
                    acc[2 * p + 1][q] += t1[q];
                  }
                } else {
                  gm_mma(acc[2 * p], af, bf[0], bf[1]);
                  gm_mma(acc[2 * p + 1], af, bf[2], bf[3]);
                }
              }
            }
          }
        }
        if (sums) {
          const int j = tid % GW_TJ, s0 = (tid / GW_TJ) * SQ;
#pragma unroll 4
          for (int s = 0; s < SQ; ++s) bsum += __bfloat162float(gg[(s0 + s) * ldg + j]);
        }
        if constexpr (!Src::kVec)
          if (more) put_a(nb);
      }
    }
  }

  float* out = partial + (size_t)blockIdx.y * n_out + out_off;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ti0 + wi * 16 + g + 8 * h, j = tj0 + wj * 64 + n * 8 + 2 * c;
      if (i < src.ia && j < src.jb) {
        out[(size_t)i * src.jb + j] = acc[n][2 * h];
        out[(size_t)i * src.jb + j + 1] = acc[n][2 * h + 1];
      }
    }
  if (sums) {
    red[tid] = bsum;  // (QS, GW_TJ)
    __syncthreads();
    if (tid < GW_TJ && tj0 + tid < src.jb) {
      float v = 0.f;
      for (int q = 0; q < QS; ++q) v += red[q * GW_TJ + tid];
      out[(size_t)src.ia * src.jb + tj0 + tid] = v;
    }
  }
}

// One gru_wgrad_kernel launch: an (ia + bias, jb) output in 128 x 128 tiles,
// by n_chunks chunks of samples.
template <class Src, bool kStepSums = false>
static int gru_wgrad_launch(const GruSeqDims& d, const Src& src, long long n_samples, int chunk,
                            int n_chunks, float* partial, long long out_off, long long n_out,
                            cudaStream_t stream) {
  const int smem = gru_wgrad_smem();
  cudaError_t err = cudaFuncSetAttribute(gru_wgrad_kernel<Src, kStepSums>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((src.ia + GW_TI - 1) / GW_TI) * ((src.jb + GW_TJ - 1) / GW_TJ), n_chunks);
  gru_wgrad_kernel<Src, kStepSums><<<grid, GW_THREADS, smem, stream>>>(d, src, n_samples, chunk,
                                                                        partial, out_off, n_out);
  return (int)cudaGetLastError();
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
