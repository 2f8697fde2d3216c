// K10: the obs-fused GRU backward over a stored trajectory — from the
// cotangent dhseq of K9's hidden sequence to the gradients of We, be, Wi, bi,
// Wh, bhn (one flat f32 vector, the first six blocks of
// rware_tpu_torch/models/networks.py::GruDims) and dh0.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_obs_bwd (kernel lines
// 604-726).  The TPU kernel walks a sequential grid in reverse time and adds
// every chunk's weight-gradient products into VMEM-resident blocks; Hopper
// blocks run in no order, so the work is split in three kernels per launch:
//
//  1. gru_obs_bwd_sweep_kernel: a block owns 16 or 32 sequences (gru_core.cuh)
//     and walks time backwards.  Per step it recomputes e, iall and the gates
//     from the obs rows and the previous hidden (h0, or hseq[t-1] zeroed
//     where done[t-1]), carries the hidden adjoint in f32 registers (cut
//     where done[t]), and writes what the weight gradients need to scratch:
//     the previous hidden, e, the gate cotangents [dr | dz | dhhn] (for Wh)
//     and [dr | dz | dn] (for Wi), and dpre = bf16(de (1 - e^2)), all bf16.
//     dh_prev = dnh z + [dr | dz | dhhn] Wh^T and de = [dr | dz | dn] Wi^T use
//     transposed weight copies, so they are the same tile product as the
//     forward's.  dbhn sums the unrounded f32 dhhn: per-block partials.
//  2. gru_wgrad_kernel (gru_wgrad.cuh), once per stacked block: obs^T dpre
//     (+ the bias row dbe), e^T [dr | dz | dn] (+ dbi), hprev^T [dr | dz |
//     dhhn]; each block one 64 x 64 output tile over one chunk of samples,
//     written to its own partial; the obs rows are read in place through the
//     band.
//  3. gru_reduce_kernel (gru_wgrad.cuh): the partials summed in a fixed
//     order.  No float atomics, so two launches give the same bits.
//
// Numerics follow the TPU kernel: r and z stay f32 in the derivatives, the
// candidate is recomputed in bf16 arithmetic, the cotangents are rounded to
// bf16 before every product, dbhn is not.
//
// Bound on the card: operations, about 313k multiply-adds per sequence-step
// at L=71, E=Hg=128 (recomputed forward 107k, dh 49k, de 49k, weight
// gradients 107k), on the FP32 pipes in this version; the scratch adds about
// 2.3 KB per sequence-step written and read once.
#include "gru_wgrad.cuh"

struct GruBwdScratch {
  __nv_bfloat16 *hp, *e, *dg3, *dgi, *dpre;  // (T * Q, Hg | E | 3Hg | 3Hg | E)
  float* part_bhn;                           // (sweep blocks, Hg)
};

template <int RT>
__global__ void __launch_bounds__(GRU_THREADS)
    gru_obs_bwd_sweep_kernel(GruSeqDims d, const __nv_bfloat16* __restrict__ obs,
                             const uint8_t* __restrict__ done,
                             const __nv_bfloat16* __restrict__ h0,
                             const __nv_bfloat16* __restrict__ hseq,
                             const __nv_bfloat16* __restrict__ dhseq,
                             const __nv_bfloat16* __restrict__ we, const float* __restrict__ be,
                             const __nv_bfloat16* __restrict__ wi, const float* __restrict__ bi,
                             const __nv_bfloat16* __restrict__ wh, const float* __restrict__ bhn,
                             const __nv_bfloat16* __restrict__ wiT,
                             const __nv_bfloat16* __restrict__ whT, GruBwdScratch ws,
                             float* __restrict__ dh0) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = 16 * RT;
  const int Hg = d.Hg, E = d.E, G3 = 3 * d.Hg;
  __nv_bfloat16* xs = (__nv_bfloat16*)smem;    // (S, Lp)
  __nv_bfloat16* es = xs + (size_t)S * d.Lp;   // (S, E)
  __nv_bfloat16* hs = es + (size_t)S * E;      // (S, Hg): the hidden before step t
  __nv_bfloat16* dg3 = hs + (size_t)S * Hg;    // (S, 3Hg): [dr | dz | dhhn]
  __nv_bfloat16* dgi = dg3 + (size_t)S * G3;   // (S, 3Hg): [dr | dz | dn]
  float* red = (float*)(dgi + (size_t)S * G3); // (16, 128): the dbhn reduction
  const int Q = d.n_env * d.N, q0 = blockIdx.x * S;
  const int tid = threadIdx.x, ty = tid / 16, row0 = ty * RT, j0 = (tid % 16) * GRU_CW;
  const bool active = j0 < Hg;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  float dc[RT][GRU_CW], dbhn_acc[GRU_CW];
#pragma unroll
  for (int jj = 0; jj < GRU_CW; ++jj) {
    dbhn_acc[jj] = 0.f;
#pragma unroll
    for (int r = 0; r < RT; ++r) dc[r][jj] = 0.f;
  }

  for (int t = d.T - 1; t >= 0; --t) {
    gru_load_obs(d, S, q0, Q, t, obs, xs);
    for (int idx = tid; idx < S * Hg; idx += GRU_THREADS) {
      const int s = idx / Hg, j = idx - s * Hg, q = q0 + s;
      __nv_bfloat16 v = zero;
      if (q < Q) {
        if (t == 0) {
          v = h0[((size_t)gru_env(d, q) * d.N + q % d.N) * Hg + j];
        } else if (!done[(size_t)(t - 1) * d.B + gru_env(d, q)]) {
          v = hseq[(((size_t)(t - 1) * d.n_env + q / d.N) * d.N + q % d.N) * Hg + j];
        }
      }
      hs[idx] = v;
    }
    __syncthreads();
    gru_embed<RT>(d, row0, j0, xs, we, be, es);
    __syncthreads();

    float dhz[RT][GRU_CW];  // dnh * z, the direct path to the previous hidden
    if (active) {
      float ia[RT][3 * GRU_CW], hh[RT][3 * GRU_CW];
      gru_gates<RT>(d, row0, j0, es, hs, wi, bi, wh, ia, hh);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int q = q0 + row0 + r;
        const bool valid = q < Q;
        const size_t smp = (size_t)t * Q + q;
        float dn_in[GRU_CW];
        bool cut = true;
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) dn_in[jj] = 0.f;
        if (valid) {
          gru_load8(dhseq + (((size_t)t * d.n_env + q / d.N) * d.N + q % d.N) * Hg + j0, dn_in);
          cut = done[(size_t)t * d.B + gru_env(d, q)] != 0;
        }
        float v_dr[GRU_CW], v_dz[GRU_CW], v_dhhn[GRU_CW], v_dn[GRU_CW], v_hp[GRU_CW];
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) {
          const float rg = gru_sigmoid(ia[r][jj] + hh[r][jj]);
          const float zg = gru_sigmoid(ia[r][GRU_CW + jj] + hh[r][GRU_CW + jj]);
          const float hhn = gru_bf16r(hh[r][2 * GRU_CW + jj] + bhn[j0 + jj]);
          const float nn = gru_bf16r(
              tanhf(gru_bf16r(ia[r][2 * GRU_CW + jj] + gru_bf16r(gru_bf16r(rg) * hhn))));
          const float hp = __bfloat162float(hs[(size_t)(row0 + r) * Hg + j0 + jj]);
          const float dnh = dn_in[jj] + (cut ? 0.f : dc[r][jj]);
          const float dz_pre = dnh * (hp - nn) * zg * (1.f - zg);
          const float dn_pre = dnh * (1.f - zg) * (1.f - nn * nn);
          const float dhhn = dn_pre * rg;
          v_dr[jj] = dn_pre * hhn * rg * (1.f - rg);
          v_dz[jj] = dz_pre;
          v_dhhn[jj] = dhhn;
          v_dn[jj] = dn_pre;
          v_hp[jj] = hp;
          dhz[r][jj] = dnh * zg;
          if (valid) dbhn_acc[jj] += dhhn;
        }
        __nv_bfloat16* g3 = dg3 + (size_t)(row0 + r) * G3 + j0;
        __nv_bfloat16* gi = dgi + (size_t)(row0 + r) * G3 + j0;
        gru_store8(g3, v_dr);
        gru_store8(g3 + Hg, v_dz);
        gru_store8(g3 + 2 * Hg, v_dhhn);
        gru_store8(gi, v_dr);
        gru_store8(gi + Hg, v_dz);
        gru_store8(gi + 2 * Hg, v_dn);
        if (valid) {
          gru_store8(ws.hp + smp * Hg + j0, v_hp);
          gru_store8(ws.dg3 + smp * G3 + j0, v_dr);
          gru_store8(ws.dg3 + smp * G3 + Hg + j0, v_dz);
          gru_store8(ws.dg3 + smp * G3 + 2 * Hg + j0, v_dhhn);
          gru_store8(ws.dgi + smp * G3 + j0, v_dr);
          gru_store8(ws.dgi + smp * G3 + Hg + j0, v_dz);
          gru_store8(ws.dgi + smp * G3 + 2 * Hg + j0, v_dn);
        }
      }
    }
    __syncthreads();  // the cotangent tiles are complete
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
    if (j0 < E) {
      // de = [dr | dz | dn] Wi^T, dpre = bf16(de (1 - e^2))
      float acc[RT][GRU_CW];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) acc[r][jj] = 0.f;
      const int col[1] = {j0};
      gru_tile_gemm<RT, 1>(acc, dgi, G3, row0, G3, wiT, E, col);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int q = q0 + row0 + r;
        if (q >= Q) continue;
        const size_t smp = (size_t)t * Q + q;
        float ev[GRU_CW], dp[GRU_CW];
#pragma unroll
        for (int jj = 0; jj < GRU_CW; ++jj) {
          ev[jj] = __bfloat162float(es[(size_t)(row0 + r) * E + j0 + jj]);
          dp[jj] = acc[r][jj] * (1.f - ev[jj] * ev[jj]);
        }
        gru_store8(ws.e + smp * E + j0, ev);
        gru_store8(ws.dpre + smp * E + j0, dp);
      }
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
  __syncthreads();
  if (tid < Hg) {
    float acc = 0.f;
    for (int y = 0; y < 16; ++y) acc += red[y * 128 + tid];
    ws.part_bhn[(size_t)blockIdx.x * Hg + tid] = acc;
  }
}

struct GruOperand {
  const __nv_bfloat16* p;
  int ld;   // row stride, elements
  int obs;  // rows addressed through the band (the trajectory's obs)
};

// One weight-gradient product's operands (gru_wgrad.cuh): A rows stored per
// sample, or with a.obs the trajectory's obs rows read through the band, kept
// as row indices; G rows stored per sample.
struct GruBwdSrc {
  using Row = long long;
  GruOperand a, g;
  int ia, bias, jb;

  __device__ Row a_row(const GruSeqDims& d, long long smp) const {
    if (!a.obs) return smp;
    const int Q = d.n_env * d.N;
    const long long t = smp / Q;
    const int q = (int)(smp - t * Q);
    return (t * d.B + gru_env(d, q)) * d.N + q % d.N;
  }
  __device__ float a_at(Row r, int i) const {
    return __bfloat162float(a.p[(size_t)r * a.ld + i]);
  }
  __device__ float g_at(const GruSeqDims&, long long smp, int j) const {
    return __bfloat162float(g.p[(size_t)smp * g.ld + j]);
  }
};

template <int RT>
static int sweep_launch(const GruSeqDims& d, const void* obs, const void* done, const void* h0,
                        const void* hseq, const void* dhseq, const void* we, const void* be,
                        const void* wi, const void* bi, const void* wh, const void* bhn,
                        const void* wiT, const void* whT, const GruBwdScratch& ws, void* dh0,
                        cudaStream_t stream) {
  const int S = 16 * RT, Q = d.n_env * d.N;
  const size_t smem = (size_t)S * (d.Lp + d.E + 7 * d.Hg) * sizeof(__nv_bfloat16)
                      + 16 * 128 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_obs_bwd_sweep_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gru_obs_bwd_sweep_kernel<RT><<<(Q + S - 1) / S, GRU_THREADS, smem, stream>>>(
      d, (const __nv_bfloat16*)obs, (const uint8_t*)done, (const __nv_bfloat16*)h0,
      (const __nv_bfloat16*)hseq, (const __nv_bfloat16*)dhseq, (const __nv_bfloat16*)we,
      (const float*)be, (const __nv_bfloat16*)wi, (const float*)bi, (const __nv_bfloat16*)wh,
      (const float*)bhn, (const __nv_bfloat16*)wiT, (const __nv_bfloat16*)whT, ws, (float*)dh0);
  return (int)cudaGetLastError();
}

// rows_per_thread: 1 or 2 (16 or 32 sequences a sweep block); chunk * n_chunks
// >= T * n_env * N samples; partial holds n_chunks * ((L+1) E + (E+1) 3Hg +
// Hg 3Hg) floats, part_bhn (sweep blocks) * Hg; grads gets those plus Hg.
extern "C" int rw_fused_gru_bwd(int L, int E, int Hg, int T, int B, int N, int start_env,
                                int n_env, int rows_per_thread, int chunk, int n_chunks,
                                const void* obs, const void* done, const void* h0,
                                const void* hseq, const void* dhseq, const void* we,
                                const void* be, const void* wi, const void* bi, const void* wh,
                                const void* bhn, const void* wiT, const void* whT, void* hp_s,
                                void* e_s, void* dg3_s, void* dgi_s, void* dpre_s,
                                void* part_bhn, void* partial, void* grads, void* dh0,
                                void* stream_p) {
  if (E % GRU_CW || Hg % GRU_CW || E > 128 || Hg > 128 || n_env < 1 || n_env > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_p;
  const GruSeqDims d = {L, E, Hg, T, B, N, start_env, n_env, (L + 7) / 8 * 8};
  const GruBwdScratch ws = {(__nv_bfloat16*)hp_s, (__nv_bfloat16*)e_s, (__nv_bfloat16*)dg3_s,
                            (__nv_bfloat16*)dgi_s, (__nv_bfloat16*)dpre_s, (float*)part_bhn};
  const int Q = n_env * N;
  int err, sweep_blocks;
  if (rows_per_thread == 2) {
    sweep_blocks = (Q + 31) / 32;
    err = sweep_launch<2>(d, obs, done, h0, hseq, dhseq, we, be, wi, bi, wh, bhn, wiT, whT, ws,
                          dh0, stream);
  } else if (rows_per_thread == 1) {
    sweep_blocks = (Q + 15) / 16;
    err = sweep_launch<1>(d, obs, done, h0, hseq, dhseq, we, be, wi, bi, wh, bhn, wiT, whT, ws,
                          dh0, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const long long n_samples = (long long)T * Q;
  const long long off_wi = (long long)(L + 1) * E, off_wh = off_wi + (long long)(E + 1) * 3 * Hg;
  const long long n_w = off_wh + (long long)Hg * 3 * Hg;
  const GruOperand a_obs = {(const __nv_bfloat16*)obs, L, 1}, a_e = {ws.e, E, 0},
                   a_hp = {ws.hp, Hg, 0};
  const GruOperand g_dpre = {ws.dpre, E, 0}, g_dgi = {ws.dgi, 3 * Hg, 0},
                   g_dg3 = {ws.dg3, 3 * Hg, 0};
  float* part = (float*)partial;
  gru_wgrad_kernel<<<gru_wgrad_grid(L + 1, E, n_chunks), GRU_THREADS, 0, stream>>>(
      d, GruBwdSrc{a_obs, g_dpre, L, 1, E}, n_samples, chunk, part, 0, n_w);
  gru_wgrad_kernel<<<gru_wgrad_grid(E + 1, 3 * Hg, n_chunks), GRU_THREADS, 0, stream>>>(
      d, GruBwdSrc{a_e, g_dgi, E, 1, 3 * Hg}, n_samples, chunk, part, off_wi, n_w);
  gru_wgrad_kernel<<<gru_wgrad_grid(Hg, 3 * Hg, n_chunks), GRU_THREADS, 0, stream>>>(
      d, GruBwdSrc{a_hp, g_dg3, Hg, 0, 3 * Hg}, n_samples, chunk, part, off_wh, n_w);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  gru_reduce_kernel<<<(unsigned)((n_w + Hg + 255) / 256), 256, 0, stream>>>(
      part, n_chunks, n_w, ws.part_bhn, sweep_blocks, Hg, (float*)grads);
  return (int)cudaGetLastError();
}
