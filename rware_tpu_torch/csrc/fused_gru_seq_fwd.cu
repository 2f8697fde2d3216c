// K11: the GRU sequence forward from precomputed input gates — the hidden
// sequence hseq (T, n_env, N, Hg) bf16 of an env band, each step's hidden
// BEFORE the episode-boundary reset, from the band-local fused input gates
// iall (T, n_env, N, 3Hg) bf16 [r | z | n], done (T, B) and h0 (B, N, Hg)
// read through the band (gru_seq.cuh).
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_seq_fwd (kernel lines
// 93-123).  The TPU kernel walks a sequential (env rows, time chunks) grid and
// carries the hidden in VMEM scratch; here a block owns 16 or 32 sequences
// for all T steps and loops over time itself, the hidden in shared memory.
// Per step each thread computes its eight columns of the three hidden gate
// products h Wh for its rows, reads the same columns of iall, and finishes
// those hidden units alone (gsq_cell_fwd):
//   r, z = bf16(sigmoid(f32(iall) + h Wh)),
//   n = tanh(iall_n + r * bf16(h Whn + bhn))   (bf16 arithmetic),
//   new_h = (1 - z) * n + z * h                 (bf16 arithmetic),
//   h <- 0 where done[t].
// Products are on bf16 values with f32 sums (fmaf, k ascending); the plain
// version sums with torch.matmul in another order, so the two agree to f32
// rounding and to one bf16 step where a rounding boundary is crossed.  Each
// sum has one fixed order, so two launches give the same bits.
//
// Bound on the card: bytes (iall in, hseq out, 6 Hg + 2 Hg bytes per
// sequence-step against Hg * 3Hg multiply-adds, 49k at Hg = 128); this
// version runs the products on the FP32 pipes, so operations limit it.
#include "gru_seq.cuh"

namespace {

template <int RT>
__global__ void __launch_bounds__(GRU_THREADS)
    gru_seq_fwd_kernel(GruSeqDims d, const __nv_bfloat16* __restrict__ iall,
                       const uint8_t* __restrict__ done, const __nv_bfloat16* __restrict__ h0,
                       const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bhn,
                       __nv_bfloat16* __restrict__ hseq) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = 16 * RT;
  __nv_bfloat16* hs = (__nv_bfloat16*)smem;  // (S, Hg)
  const int Q = d.n_env * d.N, q0 = blockIdx.x * S;
  const int tid = threadIdx.x, row0 = (tid / 16) * RT, j0 = (tid % 16) * GRU_CW;
  const int Hg = d.Hg;
  const bool active = j0 < Hg;
  float bh[GRU_CW];
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) bh[jj] = active ? bhn[j0 + jj] : 0.f;

  for (int idx = tid; idx < S * Hg; idx += GRU_THREADS) {
    const int s = idx / Hg, j = idx - s * Hg, q = q0 + s;
    hs[idx] = q < Q ? h0[((size_t)gru_env(d, q) * d.N + q % d.N) * Hg + j]
                    : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    float nh[RT][GRU_CW];
    if (active) {
      float hh[RT][3 * GRU_CW];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 3 * GRU_CW; ++c) hh[r][c] = 0.f;
      const int col[3] = {j0, Hg + j0, 2 * Hg + j0};
      gru_tile_gemm<RT, 3>(hh, hs, Hg, row0, Hg, wh, 3 * Hg, col);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int q = q0 + row0 + r;
        float ia[3 * GRU_CW], hp[GRU_CW];
#pragma unroll
        for (int c = 0; c < 3 * GRU_CW; ++c) ia[c] = 0.f;
        if (q < Q) gsq_load_gates(iall, (size_t)t * Q + q, Hg, j0, ia);
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj)
          hp[jj] = __bfloat162float(hs[(size_t)(row0 + r) * Hg + j0 + jj]);
        gsq_cell_fwd(ia, hh[r], bh, hp, nh[r]);
      }
    }
    __syncthreads();  // every thread has read the old hidden
    if (active) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int q = q0 + row0 + r;
        if (q >= Q) continue;
        gru_store8(hseq + ((size_t)t * Q + q) * Hg + j0, nh[r]);
        if (done[(size_t)t * d.B + gru_env(d, q)]) {
#pragma unroll
          for (int jj = 0; jj < GRU_CW; ++jj) nh[r][jj] = 0.f;
        }
        gru_store8(hs + (size_t)(row0 + r) * Hg + j0, nh[r]);
      }
    }
    __syncthreads();
  }
}

template <int RT>
int seq_fwd_launch(const GruSeqDims& d, const void* iall, const void* done, const void* h0,
                   const void* wh, const void* bhn, void* hseq, cudaStream_t stream) {
  const int S = 16 * RT, Q = d.n_env * d.N;
  const size_t smem = (size_t)S * d.Hg * sizeof(__nv_bfloat16);
  gru_seq_fwd_kernel<RT><<<(Q + S - 1) / S, GRU_THREADS, smem, stream>>>(
      d, (const __nv_bfloat16*)iall, (const uint8_t*)done, (const __nv_bfloat16*)h0,
      (const __nv_bfloat16*)wh, (const float*)bhn, (__nv_bfloat16*)hseq);
  return (int)cudaGetLastError();
}

}  // namespace

// rows_per_thread: 1 (16 sequences a block) or 2 (32).
extern "C" int rw_fused_gru_seq_fwd(int Hg, int T, int B, int N, int start_env, int n_env,
                                    int rows_per_thread, const void* iall, const void* done,
                                    const void* h0, const void* wh, const void* bhn, void* hseq,
                                    void* stream) {
  if (!gsq_widths_ok(Hg, T, B, n_env)) return (int)cudaErrorInvalidValue;
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_thread == 2) return seq_fwd_launch<2>(d, iall, done, h0, wh, bhn, hseq, s);
  if (rows_per_thread == 1) return seq_fwd_launch<1>(d, iall, done, h0, wh, bhn, hseq, s);
  return (int)cudaErrorInvalidValue;
}
