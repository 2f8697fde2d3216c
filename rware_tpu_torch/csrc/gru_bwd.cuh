// The reverse sweep that the GRU backward kernels share: K10
// (fused_gru_bwd.cu) and K12 / K13 (gru_seq_bwd.cuh), with the gate scratch
// their prologues write for it.
//
// A prologue runs time-parallel, off the sequential path: hh = hprev Wh on
// the tensor cores and the gates, stored in as few bytes as the rounding
// allows (gb_store_gates): r and z f32, hhn and n bf16, 12 Hg bytes a sample.
// hprev is h0 at t = 0, else hseq[t-1] zeroed where done[t-1] (gru_hprev_row).
//
// gru_bwd_sweep_kernel then walks t backwards with the hidden adjoint in f32,
// cut where done[t].  A block owns 16, 32 or 64 sequences (the lowest tile
// whose blocks fit the card's SMs in one wave).  Per step it forms [dr | dz |
// dhhn | dn] from the stored gates with the plain version's formulas, a warp to
// a row so that its loads and stores are contiguous, writes them once (bf16),
// and runs the one product on the sequential path, [dr | dz | dhhn] Wh^T, on
// the tensor cores with Wh resident in shared memory for the whole sweep (one
// copy, 96 KB at Hg = 128, read as Wh^T by a non-transposing ldmatrix); the
// product's f32 sums come back to the rows through shared memory, where
// dh_prev = dnh z + that.  dbhn sums the unrounded f32 dhhn: per-block
// partials.  Two template parameters, types chosen by each caller, say where
// a step's direct cotangent comes from (Cot) and where the cotangents go
// (Out); both are read in registers, never through a pointer in shared
// memory.
#pragma once

#include "gru_wgrad.cuh"

#define GB_TILE 64   // samples a prologue / epilogue block
#define GB_SLICE 16  // hidden units a gate slice of a prologue
#define GB_HEADS 8   // K13: head columns A + 1 at most

struct GruBwdScratch {
  gm_bf16* e;        // K10 (n, E): the embedding
  float* rz;         // (n, Hg / 2, 4): [r_j, r_j+1, z_j, z_j+1] per pair of hidden units
  gm_bf16* hn;       // (n, Hg / 2, 4): [hhn_j, hhn_j+1, n_j, n_j+1]
  gm_bf16* dg4;      // K10 (n, 4 Hg): [dr | dz | dhhn | dn]
  gm_bf16* dpre;     // K10 (n, E)
  float* part_bhn;   // (sweep blocks, Hg)
};

// The hidden before step t of band sample smp = t * Q + q: h0 at t = 0, else
// hseq[t-1] (band-local), none (a null row: zeros) where done[t-1].
static __device__ __forceinline__ const gm_bf16* gru_hprev_row(const GruSeqDims& d,
                                                               const gm_bf16* h0,
                                                               const gm_bf16* hseq,
                                                               const uint8_t* done,
                                                               long long smp) {
  const int Q = d.n_env * d.N;
  const long long t = smp / Q;
  const int q = (int)(smp - t * Q);
  if (t == 0) return h0 + ((size_t)gru_env(d, q) * d.N + q % d.N) * d.Hg;
  if (done[(size_t)(t - 1) * d.B + gru_env(d, q)]) return nullptr;
  return hseq + (size_t)(smp - Q) * d.Hg;
}

// The gates of one hidden unit from its input gates (bf16 values) and hidden
// products (f32 sums), in the plain version's rounding.
struct GbGate {
  float r, z, hhn, n;
};

static __device__ __forceinline__ GbGate gb_gate(float ir, float iz, float in, float hr, float hz,
                                                 float hn, float bh) {
  GbGate o;
  o.r = gru_sigmoid(ir + hr);
  o.z = gru_sigmoid(iz + hz);
  o.hhn = gru_bf16r(hn + bh);
  o.n = gru_bf16r(tanhf(gru_bf16r(in + gru_bf16r(gru_bf16r(o.r) * o.hhn))));
  return o;
}

// Hidden units j, j + 1 of sample smp, as the sweep reads them.
static __device__ __forceinline__ void gb_store_gates(const GruBwdScratch& ws, long long smp,
                                                      int Hg, int j, const GbGate (&g)[2]) {
  const size_t o = ((size_t)smp * Hg + j) * 2;
  *(float4*)(ws.rz + o) = make_float4(g[0].r, g[1].r, g[0].z, g[1].z);
  __nv_bfloat162 p[2] = {gm_pack(g[0].hhn, g[1].hhn), gm_pack(g[0].n, g[1].n)};
  *(uint2*)(ws.hn + o) = *(const uint2*)p;
}

// ---- the step's direct cotangent (Cot): load() in the row layout's batch of
// loads, unpack() to the lane's four hidden units.

// dhseq (n, Hg) bf16 read in: K10, K12.
struct GbCotSeq {
  static constexpr int kSmemFloats = 0;
  typedef uint2 Reg;
  const gm_bf16* dhseq;

  __device__ void init(float*, int) const {}
  __device__ Reg load(size_t row, int Hg, int j4, bool on) const {
    return on ? __ldg((const uint2*)(dhseq + row * Hg + j4)) : make_uint2(0, 0);
  }
  __device__ void unpack(const Reg& r, const float*, int, float (&iv)[4]) const {
    const __nv_bfloat162* p = (const __nv_bfloat162*)&r;
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    iv[0] = a.x;
    iv[1] = a.y;
    iv[2] = b.x;
    iv[3] = b.y;
  }
};

// K13: dheads (n, GB_HEADS) f32 (zero past A + 1) times W_head^T, in f32:
// W_head transposed in shared memory, (GB_HEADS, 128), zero past A + 1 and
// past Hg, so that a lane reads its four units as one float4 a head.
struct GbCotHeads {
  static constexpr int kSmemFloats = GB_HEADS * 128;
  struct Reg {
    float4 v[GB_HEADS / 4];
  };
  const float* dheads;
  const float* head;  // (Hg + 1, A1): [W_policy | W_value], then the bias row
  int A1;

  __device__ void init(float* w, int Hg) const {
    for (int idx = threadIdx.x; idx < kSmemFloats; idx += GM_THREADS) {
      const int a = idx / 128, j = idx % 128;
      w[idx] = a < A1 && j < Hg ? head[j * A1 + a] : 0.f;
    }
  }
  __device__ Reg load(size_t row, int, int, bool on) const {
    Reg r;
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int h = 0; h < GB_HEADS / 4; ++h)
      r.v[h] = on ? __ldg((const float4*)(dheads + row * GB_HEADS) + h) : z4;
    return r;
  }
  __device__ void unpack(const Reg& r, const float* w, int j4, float (&iv)[4]) const {
    const float* g = (const float*)r.v;
#pragma unroll
    for (int u = 0; u < 4; ++u) iv[u] = 0.f;
#pragma unroll
    for (int a = 0; a < GB_HEADS; ++a) {
      const float4 w4 = *(const float4*)(w + a * 128 + j4);
      iv[0] = fmaf(g[a], w4.x, iv[0]);
      iv[1] = fmaf(g[a], w4.y, iv[1]);
      iv[2] = fmaf(g[a], w4.z, iv[2]);
      iv[3] = fmaf(g[a], w4.w, iv[3]);
    }
  }
};

// ---- where a step's cotangents go (Out): p[q] holds the lane's four units
// of [dr, dz, dhhn, dn][q] as bf16 pairs.

// K10: dg4 (n, 4Hg) = [dr | dz | dhhn | dn].
struct GbOutDg4 {
  gm_bf16* dg4;

  __device__ void store(size_t row, int Hg, int j4, const __nv_bfloat162 (&p)[4][2]) const {
    gm_bf16* o4 = dg4 + row * 4 * Hg + j4;
#pragma unroll
    for (int q = 0; q < 4; ++q) *(uint2*)(o4 + q * Hg) = *(const uint2*)p[q];
  }
};

// K12, K13: d_iall (n, 3Hg) = [dr | dz | dn] and dhhn (n, Hg).
struct GbOutSeq {
  gm_bf16* d_iall;
  gm_bf16* dhhn;

  __device__ void store(size_t row, int Hg, int j4, const __nv_bfloat162 (&p)[4][2]) const {
    gm_bf16* gi = d_iall + row * 3 * Hg + j4;
    *(uint2*)gi = *(const uint2*)p[0];
    *(uint2*)(gi + Hg) = *(const uint2*)p[1];
    *(uint2*)(gi + 2 * Hg) = *(const uint2*)p[3];
    *(uint2*)(dhhn + row * Hg + j4) = *(const uint2*)p[2];
  }
};

// Dynamic shared memory of the sweep, bytes (the wrappers' plans must agree).
template <class Cot>
static int gb_sweep_smem(int Hg, int rows) {
  const int ldw = gm_r16(3 * Hg) + GM_PAD;
  return (Hg + rows) * ldw * (int)sizeof(gm_bf16)
         + (rows * (Hg + 4) + 8 * Hg) * (int)sizeof(float) + 2 * rows * (int)sizeof(int)
         + Cot::kSmemFloats * (int)sizeof(float);
}

// Two thread layouts.  The elementwise step works on rows: warp w takes rows
// w, w + 8, ... of the block's S = 16 MT sequences, lane l the hidden units
// 4l .. 4l + 4, so that every load and store of the step is one contiguous
// run a warp.  The product takes the mma layout: warp w rows 16 (w % MT)..
// and the hidden n-tiles w / MT + k (8 / MT) of Hg / 8; its sums reach the
// row layout through shared memory (acc_s, f32).
template <int MT, class Cot, class Out>
__global__ void __launch_bounds__(GM_THREADS, 1)
    gru_bwd_sweep_kernel(GruSeqDims d, const uint8_t* __restrict__ done,
                         const gm_bf16* __restrict__ h0, const gm_bf16* __restrict__ hseq,
                         Cot cot, const gm_bf16* __restrict__ wh, GruBwdScratch ws, Out out,
                         float* __restrict__ dh0) {
  constexpr int S = 16 * MT, WN = 8 / MT, NTW = 16 / WN, RW = S / 8;  // RW rows a warp
  constexpr int RB = RW < 4 ? RW : 4;  // rows a batch: all their loads in flight together
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hg = d.Hg, G3 = 3 * Hg, K16 = gm_r16(G3), ldw = K16 + GM_PAD, lda = Hg + 4;
  gm_bf16* whs = (gm_bf16*)smem;                // (Hg, ldw): Wh, row = hidden unit
  gm_bf16* gs = whs + Hg * ldw;                 // (S, ldw): [dr | dz | dhhn] of a step
  float* acc_s = (float*)(gs + S * ldw);        // (S, lda): [dr | dz | dhhn] Wh^T of a step
  float* red = acc_s + S * lda;                 // (8, Hg): the dbhn reduction
  int* row_env = (int*)(red + 8 * Hg);          // (S,): band env of each row, -1 past Q
  int* row_h0 = row_env + S;                    // (S,): its row of h0
  float* cot_s = (float*)(row_h0 + S);          // (Cot::kSmemFloats,): the cotangent's own
  const int Q = d.n_env * d.N, q0 = blockIdx.x * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp % MT, wn = warp / MT, n_ht = Hg / 8;
  const int j4 = 4 * lane;  // the row layout's hidden units
  const bool lane_on = j4 < Hg;

  for (int idx = tid; idx < Hg * (K16 / 8); idx += GM_THREADS) {
    const int n = idx / (K16 / 8), col = (idx % (K16 / 8)) * 8;
    const bool ok = col < G3;
    gm_cp16(whs + n * ldw + col, ok ? wh + (size_t)n * G3 + col : wh, ok);
  }
  gm_cp_commit();
  for (int idx = tid; idx < S * ldw / 8; idx += GM_THREADS)
    ((uint4*)gs)[idx] = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < S * lda; idx += GM_THREADS) acc_s[idx] = 0.f;
  if (tid < S) {
    const int q = q0 + tid;
    row_env[tid] = q < Q ? gru_env(d, q) : -1;
    row_h0[tid] = q < Q ? gru_env(d, q) * d.N + q % d.N : 0;
  }
  cot.init(cot_s, Hg);
  gm_cp_wait<0>();
  __syncthreads();

  float dhz[RW][4], dbhn[4];  // dnh z of the thread's rows; dbhn of its units
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    dbhn[u] = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) dhz[r][u] = 0.f;
  }

  for (int t = d.T - 1; t >= 0; --t) {
#pragma unroll
    for (int r0 = 0; r0 < RW; r0 += RB) {
      float4 rz[RB][2], acc[RB];
      uint4 hn[RB];
      uint2 hp[RB];
      typename Cot::Reg din[RB];
      bool cut[RB], on[RB];
      uint8_t reset[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int s = warp + 8 * (r0 + rr), env = row_env[s];
        const size_t row = (size_t)t * Q + q0 + s;
        on[rr] = env >= 0 && lane_on;
        // hprev's row is loaded whatever done[t-1] says, and zeroed after: no load waits on another
        const gm_bf16* hrow = t == 0 ? h0 + (size_t)row_h0[s] * Hg : hseq + (row - Q) * Hg;
        reset[rr] = on[rr] && t > 0 ? __ldg(done + (size_t)(t - 1) * d.B + env) : 0;
        cut[rr] = !on[rr] || __ldg(done + (size_t)t * d.B + env) != 0;
        const size_t o = (row * Hg + j4) * 2;
        const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
        rz[rr][0] = on[rr] ? __ldg((const float4*)(ws.rz + o)) : z4;
        rz[rr][1] = on[rr] ? __ldg((const float4*)(ws.rz + o + 4)) : z4;
        hn[rr] = on[rr] ? __ldg((const uint4*)(ws.hn + o)) : make_uint4(0, 0, 0, 0);
        hp[rr] = on[rr] ? __ldg((const uint2*)(hrow + j4)) : make_uint2(0, 0);
        din[rr] = cot.load(row, Hg, j4, on[rr]);
        acc[rr] = lane_on ? *(const float4*)(acc_s + s * lda + j4) : z4;
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int r = r0 + rr, s = warp + 8 * r;
        const __nv_bfloat162* hnp = (const __nv_bfloat162*)&hn[rr];
        const __nv_bfloat162* hpp = (const __nv_bfloat162*)&hp[rr];
        // units 4l + u: r, z from rz's two pairs, hhn and n from hn's, hp and the cotangent
        const float2 hh01 = __bfloat1622float2(hnp[0]), nn01 = __bfloat1622float2(hnp[1]);
        const float2 hh23 = __bfloat1622float2(hnp[2]), nn23 = __bfloat1622float2(hnp[3]);
        const float2 hp01 = reset[rr] ? make_float2(0.f, 0.f) : __bfloat1622float2(hpp[0]);
        const float2 hp23 = reset[rr] ? make_float2(0.f, 0.f) : __bfloat1622float2(hpp[1]);
        float iv[4];
        cot.unpack(din[rr], cot_s, j4, iv);
        const float rv[4] = {rz[rr][0].x, rz[rr][0].y, rz[rr][1].x, rz[rr][1].y};
        const float zv[4] = {rz[rr][0].z, rz[rr][0].w, rz[rr][1].z, rz[rr][1].w};
        const float hv[4] = {hh01.x, hh01.y, hh23.x, hh23.y};
        const float nv[4] = {nn01.x, nn01.y, nn23.x, nn23.y};
        const float pv[4] = {hp01.x, hp01.y, hp23.x, hp23.y};
        const float av[4] = {acc[rr].x, acc[rr].y, acc[rr].z, acc[rr].w};
        float dr[4], dz[4], dhhn[4], dn[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float rg = rv[u], zg = zv[u];
          const float dc = dhz[r][u] + av[u];  // dh_prev of the step after: dnh z + g3 Wh^T
          const float dnh = on[rr] ? iv[u] + (cut[rr] ? 0.f : dc) : 0.f;
          const float dz_pre = dnh * (pv[u] - nv[u]) * zg * (1.f - zg);
          const float dn_pre = dnh * (1.f - zg) * (1.f - nv[u] * nv[u]);
          dhhn[u] = dn_pre * rg;
          dr[u] = dn_pre * hv[u] * rg * (1.f - rg);
          dz[u] = dz_pre;
          dn[u] = dn_pre;
          dhz[r][u] = dnh * zg;
          dbhn[u] += dhhn[u];
        }
        if (lane_on) {
          __nv_bfloat162 p[4][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            p[0][h] = gm_pack(dr[2 * h], dr[2 * h + 1]);
            p[1][h] = gm_pack(dz[2 * h], dz[2 * h + 1]);
            p[2][h] = gm_pack(dhhn[2 * h], dhhn[2 * h + 1]);
            p[3][h] = gm_pack(dn[2 * h], dn[2 * h + 1]);
          }
          gm_bf16* gr = gs + s * ldw + j4;
#pragma unroll
          for (int q = 0; q < 3; ++q) *(uint2*)(gr + q * Hg) = *(const uint2*)p[q];
          if (on[rr]) out.store((size_t)t * Q + q0 + s, Hg, j4, p);
        }
      }
    }
    __syncthreads();  // the step's cotangent tile is complete; acc_s is read
    float acc[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    for (int kk = 0; kk < K16; kk += 16) {
      uint32_t a[4];
      gm_frag_a(a, gs, ldw, wm * 16, kk);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int nt = wn + WN * i;
        if (nt < n_ht) {
          uint32_t b[2];
          gm_frag_b_nk(b, whs, ldw, nt * 8, kk);
          gm_mma(acc[i], a, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int nt = wn + WN * i;
      if (nt >= n_ht) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(float2*)(acc_s + (wm * 16 + g + 8 * h) * lda + nt * 8 + 2 * c) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
    __syncthreads();  // acc_s is complete; the tile is read
  }

  // dh0 = the adjoint of the hidden before step 0; dbhn over the block's rows
  if (lane_on) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int s = warp + 8 * r, q = q0 + s;
      if (q >= Q) continue;
      const float4 a = *(const float4*)(acc_s + s * lda + j4);
      *(float4*)(dh0 + (size_t)q * Hg + j4) =
          make_float4(dhz[r][0] + a.x, dhz[r][1] + a.y, dhz[r][2] + a.z, dhz[r][3] + a.w);
    }
    *(float4*)(red + warp * Hg + j4) = make_float4(dbhn[0], dbhn[1], dbhn[2], dbhn[3]);
  }
  __syncthreads();
  for (int j = tid; j < Hg; j += GM_THREADS) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[w * Hg + j];
    ws.part_bhn[(size_t)blockIdx.x * Hg + j] = v;
  }
}

template <int MT, class Cot, class Out>
static int gb_sweep_launch(const GruSeqDims& d, int smem, const void* done, const void* h0,
                           const void* hseq, const Cot& cot, const void* wh,
                           const GruBwdScratch& ws, const Out& out, void* dh0,
                           cudaStream_t stream) {
  const int Q = d.n_env * d.N;
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_sweep_kernel<MT, Cot, Out>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gru_bwd_sweep_kernel<MT, Cot, Out><<<(Q + 16 * MT - 1) / (16 * MT), GM_THREADS, smem, stream>>>(
      d, (const uint8_t*)done, (const gm_bf16*)h0, (const gm_bf16*)hseq, cot, (const gm_bf16*)wh,
      ws, out, (float*)dh0);
  return (int)cudaGetLastError();
}

// The sweep of sweep_rows (16, 32 or 64) sequences a block.
template <class Cot, class Out>
static int gb_sweep(const GruSeqDims& d, int sweep_rows, int smem, const void* done,
                    const void* h0, const void* hseq, const Cot& cot, const void* wh,
                    const GruBwdScratch& ws, const Out& out, void* dh0, cudaStream_t stream) {
  if (sweep_rows == 64)
    return gb_sweep_launch<4>(d, smem, done, h0, hseq, cot, wh, ws, out, dh0, stream);
  if (sweep_rows == 32)
    return gb_sweep_launch<2>(d, smem, done, h0, hseq, cot, wh, ws, out, dh0, stream);
  return gb_sweep_launch<1>(d, smem, done, h0, hseq, cot, wh, ws, out, dh0, stream);
}
