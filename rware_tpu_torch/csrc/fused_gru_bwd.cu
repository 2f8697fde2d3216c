// K10: the obs-fused GRU backward over a stored trajectory — from the
// cotangent dhseq of K9's hidden sequence to the gradients of We, be, Wi, bi,
// Wh, bhn (one flat f32 vector, the first six blocks of
// rware_tpu_torch/models/networks.py::GruDims) and dh0.
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_obs_bwd (kernel lines
// 604-726).  The TPU kernel recomputes e and iall batched, off its sequential
// path, runs the reverse gate sweep carrying only the hidden adjoint, and
// folds the input side into batched MXU dots.  Here one launch is a chain of
// five kernels on one stream, every product on the tensor cores (bf16
// mma.sync with f32 sums, gru_mma.cuh):
//
//  1. gru_bwd_prologue_kernel, time-parallel: 64 samples (t, q) a block
//     recompute e = bf16(tanh(bf16(obs We + be))) (obs read through the band,
//     We streamed through shared memory in 64-row chunks, two buffers), then
//     iall = bf16(e Wi + bi) and hh = hprev Wh in slices of 16 hidden units
//     (the [r | z | n] columns of Wi and Wh, two buffers), and the gates.  It
//     stores what the sweep needs, in as few bytes as the rounding allows:
//     r and z f32, hhn and n bf16 (12 Hg bytes a sample; iall bf16 with hh
//     f32 would be 18 Hg), and e (2 E bytes) for the epilogue and dWi.
//     hprev is h0 at t = 0, else hseq[t-1] zeroed where done[t-1], read in
//     place.
//  2. gru_bwd_sweep_kernel, sequential in t: a block owns 16, 32 or 64
//     sequences (the lowest tile whose blocks fit the card's SMs in one
//     wave) and walks t backwards with the hidden adjoint in f32 (cut where
//     done[t]).  Per step it forms [dr | dz | dhhn | dn] with the plain
//     version's formulas, a warp to a row so that its loads and stores are
//     contiguous, writes them once (bf16, 4 Hg a sample), and runs the one
//     product on the sequential path, [dr | dz | dhhn] Wh^T, with Wh resident
//     in shared memory for the whole sweep (one copy, 96 KB at Hg = 128, read
//     as Wh^T by a non-transposing ldmatrix); the product's f32 sums come
//     back to the rows through shared memory, where dh_prev = dnh z + that.
//     dbhn sums the unrounded f32 dhhn: per-block partials.
//  3. gru_bwd_epilogue_kernel, time-parallel: de = [dr | dz | dn] Wi^T, then
//     dpre = bf16(de (1 - e^2)).
//  4. gru_wgrad_kernel (gru_wgrad.cuh, shared with K12 and K13), once per
//     product: obs^T dpre (and dbe, dpre's column sums), e^T [dr | dz | dn]
//     (and dbi), hprev^T [dr | dz | dhhn]; fixed-order partials per chunk of
//     samples.
//  5. gru_reduce_kernel (gru_wgrad.cuh): the partials summed in a fixed
//     order.  No float atomics, so two launches give the same bits.
//
// Numerics follow the TPU kernel: r and z stay f32 in the derivatives, the
// candidate is recomputed in bf16 arithmetic, the cotangents are rounded to
// bf16 before every product, dbhn is not.  Every product's operands are bf16
// values, so the tensor cores change only the order of the sums.
//
// Bound on the card: operations, about 313k multiply-adds per sequence-step
// at L=71, E=Hg=128 (recomputed forward 107k, dh 49k, de 49k, weight
// gradients 108k), all on the tensor cores.  In this version the kernels sit
// well above that: the scratch, 4 E + 20 Hg bytes a sequence-step (3 KB at
// 128) written once and read once or twice, and the prologue's and the
// sweep's latencies take most of the time (PERF.md).
#include "gru_wgrad.cuh"

#define GB_TILE 64   // samples a prologue / epilogue block
#define GB_KC 64     // k chunk of the embed and the epilogue
#define GB_SLICE 16  // hidden units a gate slice of the prologue

struct GruBwdScratch {
  gm_bf16* e;        // (n, E): the embedding
  float* rz;         // (n, Hg / 2, 4): [r_j, r_j+1, z_j, z_j+1] per pair of hidden units
  gm_bf16* hn;       // (n, Hg / 2, 4): [hhn_j, hhn_j+1, n_j, n_j+1]
  gm_bf16* dg4;      // (n, 4 Hg): [dr | dz | dhhn | dn]
  gm_bf16* dpre;     // (n, E)
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

// Dynamic shared memory of each kernel, bytes (the wrapper's plan must agree).
static int gb_prologue_smem(int E, int Hg) {
  const int E16 = gm_r16(E), H16 = gm_r16(Hg);
  const int tiles = GB_TILE * (E16 + GM_PAD) + GB_TILE * (H16 + GM_PAD);
  const int embed = 2 * (GB_TILE * (GB_KC + GM_PAD) + GB_KC * (E16 + GM_PAD));
  const int gates = 2 * (E16 + H16) * (3 * GB_SLICE + GM_PAD);
  // and per row: the obs row offset (8 bytes), hprev's offset (8) and source (4)
  return (tiles + (embed > gates ? embed : gates)) * (int)sizeof(gm_bf16) + GB_TILE * 20;
}

static int gb_sweep_smem(int Hg, int rows) {
  const int ldw = gm_r16(3 * Hg) + GM_PAD;
  return (Hg + rows) * ldw * (int)sizeof(gm_bf16)
         + (rows * (Hg + 4) + 8 * Hg) * (int)sizeof(float) + 2 * rows * (int)sizeof(int);
}

static int gb_epilogue_smem(int E) {
  return 2 * (GB_TILE + E) * (GB_KC + GM_PAD) * (int)sizeof(gm_bf16);
}

__global__ void __launch_bounds__(GM_THREADS, 2)
    gru_bwd_prologue_kernel(GruSeqDims d, long long n_samples,
                            const gm_bf16* __restrict__ obs, const uint8_t* __restrict__ done,
                            const gm_bf16* __restrict__ h0, const gm_bf16* __restrict__ hseq,
                            const gm_bf16* __restrict__ we, const float* __restrict__ be,
                            const gm_bf16* __restrict__ wi, const float* __restrict__ bi,
                            const gm_bf16* __restrict__ wh, const float* __restrict__ bhn,
                            GruBwdScratch ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = d.E, Hg = d.Hg, E16 = gm_r16(E), H16 = gm_r16(Hg);
  const int lde = E16 + GM_PAD, ldh = H16 + GM_PAD, ldx = GB_KC + GM_PAD;
  const int ldg = 3 * GB_SLICE + GM_PAD;
  gm_bf16* es = (gm_bf16*)smem;            // (64, lde): e
  gm_bf16* hs = es + GB_TILE * lde;        // (64, ldh): hprev
  gm_bf16* stage = hs + GB_TILE * ldh;     // two buffers: embed [xs | We rows], gates [Wi | Wh]
  const int embed_buf = GB_TILE * ldx + GB_KC * lde, gates_buf = (E16 + H16) * ldg;
  const int embed_sz = 2 * embed_buf, gates_sz = 2 * gates_buf;
  long long* xrow = (long long*)(stage + (embed_sz > gates_sz ? embed_sz : gates_sz));  // (64,)
  long long* hoff = xrow + GB_TILE;      // (64,): hprev's row offset in h0 or hseq
  int* hsrc = (int*)(hoff + GB_TILE);    // (64,): 0 none (done, or past the band), 1 h0, 2 hseq
  const long long s0 = (long long)blockIdx.x * GB_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const gm_bf16 zero = __float2bfloat16_rn(0.f);

  if (tid < GB_TILE) {
    const long long smp = s0 + tid;
    const gm_bf16* row = smp < n_samples ? gru_hprev_row(d, h0, hseq, done, smp) : nullptr;
    xrow[tid] = smp < n_samples ? gru_traj_row(d, smp) * d.L : -1;
    hsrc[tid] = row == nullptr ? 0 : smp < (long long)d.n_env * d.N ? 1 : 2;
    hoff[tid] = row == nullptr ? 0 : hsrc[tid] == 1 ? row - h0 : row - hseq;
  }
  __syncthreads();
  // e's k padding read by the gate product
  for (int idx = tid; idx < GB_TILE * (E16 - E); idx += GM_THREADS)
    es[(idx / (E16 - E)) * lde + E + idx % (E16 - E)] = zero;
  // hprev, in flight during the embed (zeros where done, past the band or past Hg)
  for (int idx = tid; idx < GB_TILE * (H16 / 8); idx += GM_THREADS) {
    const int s = idx / (H16 / 8), col = (idx % (H16 / 8)) * 8, src = hsrc[s];
    const bool ok = src != 0 && col < Hg;
    gm_cp16(hs + s * ldh + col, ok ? (src == 1 ? h0 : hseq) + hoff[s] + col : hseq, ok);
  }
  gm_cp_commit();

  // ---- e = bf16(tanh(bf16(obs We + be))): n-tiles wn, wn + 2, ... of E / 8
  auto load_we = [&](int kc, int b) {
    const int k0 = kc * GB_KC;
    gm_bf16* wsm = stage + b * embed_buf + GB_TILE * ldx;
    for (int idx = tid; idx < GB_KC * (E16 / 8); idx += GM_THREADS) {
      const int k = idx / (E16 / 8), col = (idx % (E16 / 8)) * 8;
      const bool ok = k0 + k < d.L && col < E;
      gm_cp16(wsm + k * lde + col, ok ? we + (size_t)(k0 + k) * E + col : we, ok);
    }
    gm_cp_commit();
  };
  // obs rows have odd lengths: element by element, through registers, so that
  // the next chunk's loads are in flight during this chunk's products
  constexpr int XPT = GB_TILE * GB_KC / GM_THREADS;
  const int xk = tid % GB_KC, xs0 = tid / GB_KC;
  gm_bf16 xv[XPT];
  auto fetch_x = [&](int kc) {
    const int k = kc * GB_KC + xk;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const long long r = xrow[xs0 + u * (GM_THREADS / GB_KC)];
      xv[u] = r >= 0 && k < d.L ? __ldg(obs + r + k) : zero;
    }
  };
  auto put_x = [&](int b) {
    gm_bf16* xs = stage + b * embed_buf;
#pragma unroll
    for (int u = 0; u < XPT; ++u) xs[(xs0 + u * (GM_THREADS / GB_KC)) * ldx + xk] = xv[u];
  };
  const int n_et = E / 8, n_kc = (d.L + GB_KC - 1) / GB_KC;
  {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
    load_we(0, 0);
    fetch_x(0);
    put_x(0);
    for (int kc = 0; kc < n_kc; ++kc) {
      if (kc + 1 < n_kc) {
        load_we(kc + 1, (kc + 1) & 1);
        fetch_x(kc + 1);
        gm_cp_wait<1>();
      } else {
        gm_cp_wait<0>();
      }
      __syncthreads();
      const gm_bf16* xs = stage + (kc & 1) * embed_buf;
      const gm_bf16* wsm = xs + GB_TILE * ldx;
#pragma unroll
      for (int kk = 0; kk < GB_KC; kk += 16) {
        uint32_t a[4];
        gm_frag_a(a, xs, ldx, wm * 16, kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int nt = wn + 2 * i;
          if (nt < n_et) {
            uint32_t b[2];
            gm_frag_b_kn(b, wsm, lde, nt * 8, kk);
            gm_mma(acc[i], a, b[0], b[1]);
          }
        }
      }
      if (kc + 1 < n_kc) put_x((kc + 1) & 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nt = wn + 2 * i;
      if (nt >= n_et) continue;
      const int col = nt * 8 + 2 * c;
      const float b0 = be[col], b1 = be[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = wm * 16 + g + 8 * h;
        const __nv_bfloat162 v = gm_pack(tanhf(gru_bf16r(acc[i][2 * h] + b0)),
                                         tanhf(gru_bf16r(acc[i][2 * h + 1] + b1)));
        *(__nv_bfloat162*)(es + s * lde + col) = v;
        if (s0 + s < n_samples) *(__nv_bfloat162*)(ws.e + (s0 + s) * E + col) = v;
      }
    }
  }

  // ---- iall = bf16(e Wi + bi), hh = hprev Wh and the gates, 16 hidden units a slice
  auto load_gates = [&](int sl, int b) {
    const int j0 = sl * GB_SLICE;
    gm_bf16* w = stage + b * gates_buf;  // rows: Wi's E16, then Wh's H16
    for (int idx = tid; idx < (E16 + H16) * 6; idx += GM_THREADS) {
      const int k = idx / 6, part = idx % 6, gate = part >> 1, col = j0 + (part & 1) * 8;
      const bool from_wi = k < E16;
      const int kr = from_wi ? k : k - E16;
      const gm_bf16* src = from_wi ? wi : wh;
      const bool ok = kr < (from_wi ? E : Hg) && col < Hg;
      gm_cp16(w + k * ldg + gate * GB_SLICE + (part & 1) * 8,
              ok ? src + (size_t)kr * 3 * Hg + gate * Hg + col : src, ok);
    }
    gm_cp_commit();
  };
  const int n_slices = H16 / GB_SLICE;
  load_gates(0, 0);  // the embed's last barrier freed the stage
  for (int sl = 0; sl < n_slices; ++sl) {
    if (sl + 1 < n_slices) {
      load_gates(sl + 1, (sl + 1) & 1);
      gm_cp_wait<1>();
    } else {
      gm_cp_wait<0>();
    }
    __syncthreads();  // also: e complete in es, hprev in hs
    const gm_bf16* wis = stage + (sl & 1) * gates_buf;
    const gm_bf16* whs = wis + E16 * ldg;
    float ia[3][4], hh[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) ia[q][k] = hh[q][k] = 0.f;
    for (int kk = 0; kk < E16; kk += 16) {
      uint32_t a[4];
      gm_frag_a(a, es, lde, wm * 16, kk);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t b[2];
        gm_frag_b_kn(b, wis, ldg, q * GB_SLICE + wn * 8, kk);
        gm_mma(ia[q], a, b[0], b[1]);
      }
    }
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
    const int j = sl * GB_SLICE + wn * 8 + 2 * c;
    if (j < Hg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long smp = s0 + wm * 16 + g + 8 * h;
        if (smp >= n_samples) continue;
        float rg[2], zg[2], hn[2], nn[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = j + u, k = 2 * h + u;
          const float ir = gru_bf16r(ia[0][k] + bi[jj]);
          const float iz = gru_bf16r(ia[1][k] + bi[Hg + jj]);
          const float in = gru_bf16r(ia[2][k] + bi[2 * Hg + jj]);
          rg[u] = gru_sigmoid(ir + hh[0][k]);
          zg[u] = gru_sigmoid(iz + hh[1][k]);
          hn[u] = gru_bf16r(hh[2][k] + bhn[jj]);
          nn[u] = gru_bf16r(tanhf(gru_bf16r(in + gru_bf16r(gru_bf16r(rg[u]) * hn[u]))));
        }
        const size_t o = ((size_t)smp * Hg + j) * 2;
        *(float4*)(ws.rz + o) = make_float4(rg[0], rg[1], zg[0], zg[1]);
        __nv_bfloat162 p[2] = {gm_pack(hn[0], hn[1]), gm_pack(nn[0], nn[1])};
        *(uint2*)(ws.hn + o) = *(const uint2*)p;
      }
    }
    __syncthreads();  // before the next load overwrites this buffer
  }
}

// Two thread layouts.  The elementwise step works on rows: warp w takes rows
// w, w + 8, ... of the block's S = 16 MT sequences, lane l the hidden units
// 4l .. 4l + 4, so that every load and store of the step is one contiguous
// run a warp.  The product takes the mma layout: warp w rows 16 (w % MT)..
// and the hidden n-tiles w / MT + k (8 / MT) of Hg / 8; its sums reach the
// row layout through shared memory (acc_s, f32).
template <int MT>
__global__ void __launch_bounds__(GM_THREADS, 1)
    gru_bwd_sweep_kernel(GruSeqDims d, const uint8_t* __restrict__ done,
                         const gm_bf16* __restrict__ h0, const gm_bf16* __restrict__ hseq,
                         const gm_bf16* __restrict__ dhseq, const gm_bf16* __restrict__ wh,
                         GruBwdScratch ws, float* __restrict__ dh0) {
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
      uint2 hp[RB], din[RB];
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
        din[rr] = on[rr] ? __ldg((const uint2*)(dhseq + row * Hg + j4)) : make_uint2(0, 0);
        acc[rr] = lane_on ? *(const float4*)(acc_s + s * lda + j4) : z4;
      }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int r = r0 + rr, s = warp + 8 * r;
        const __nv_bfloat162* hnp = (const __nv_bfloat162*)&hn[rr];
        const __nv_bfloat162* hpp = (const __nv_bfloat162*)&hp[rr];
        const __nv_bfloat162* dip = (const __nv_bfloat162*)&din[rr];
        // units 4l + u: r, z from rz's two pairs, hhn and n from hn's, hp and dhseq
        const float2 hh01 = __bfloat1622float2(hnp[0]), nn01 = __bfloat1622float2(hnp[1]);
        const float2 hh23 = __bfloat1622float2(hnp[2]), nn23 = __bfloat1622float2(hnp[3]);
        const float2 hp01 = reset[rr] ? make_float2(0.f, 0.f) : __bfloat1622float2(hpp[0]);
        const float2 hp23 = reset[rr] ? make_float2(0.f, 0.f) : __bfloat1622float2(hpp[1]);
        const float2 di01 = __bfloat1622float2(dip[0]), di23 = __bfloat1622float2(dip[1]);
        const float rv[4] = {rz[rr][0].x, rz[rr][0].y, rz[rr][1].x, rz[rr][1].y};
        const float zv[4] = {rz[rr][0].z, rz[rr][0].w, rz[rr][1].z, rz[rr][1].w};
        const float hv[4] = {hh01.x, hh01.y, hh23.x, hh23.y};
        const float nv[4] = {nn01.x, nn01.y, nn23.x, nn23.y};
        const float pv[4] = {hp01.x, hp01.y, hp23.x, hp23.y};
        const float iv[4] = {di01.x, di01.y, di23.x, di23.y};
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
          if (on[rr]) {
            gm_bf16* o4 = ws.dg4 + ((size_t)t * Q + q0 + s) * 4 * Hg + j4;
#pragma unroll
            for (int q = 0; q < 4; ++q) *(uint2*)(o4 + q * Hg) = *(const uint2*)p[q];
          }
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

// 64 samples a block, all E columns: warp w takes rows 16 (w % 4).. and the
// n-tiles w / 4 + 2k of E / 8.
__global__ void __launch_bounds__(GM_THREADS)
    gru_bwd_epilogue_kernel(GruSeqDims d, long long n_samples, const gm_bf16* __restrict__ wi,
                            GruBwdScratch ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = d.E, Hg = d.Hg, G3 = 3 * Hg, ldk = GB_KC + GM_PAD;
  gm_bf16* as = (gm_bf16*)smem;              // 2 x (64, ldk): [dr | dz | dn] chunks
  gm_bf16* bs = as + 2 * GB_TILE * ldk;      // 2 x (E, ldk): Wi rows, [r | z | n] chunks
  const long long s0 = (long long)blockIdx.x * GB_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp & 3, wn = warp >> 2, n_et = E / 8;

  auto load = [&](int kc, int b) {
    const int k0 = kc * GB_KC;
    gm_bf16* a = as + b * GB_TILE * ldk;
    gm_bf16* w = bs + b * E * ldk;
    for (int idx = tid; idx < GB_TILE * (GB_KC / 8); idx += GM_THREADS) {
      const int s = idx / (GB_KC / 8), kc8 = (idx % (GB_KC / 8)) * 8, k = k0 + kc8;
      const long long smp = s0 + s;
      const bool ok = smp < n_samples && k < G3;
      gm_cp16(a + s * ldk + kc8,
              ok ? ws.dg4 + (size_t)smp * 4 * Hg + (k < 2 * Hg ? k : k + Hg) : ws.dg4, ok);
    }
    for (int idx = tid; idx < E * (GB_KC / 8); idx += GM_THREADS) {
      const int n = idx / (GB_KC / 8), kc8 = (idx % (GB_KC / 8)) * 8, k = k0 + kc8;
      const bool ok = k < G3;
      gm_cp16(w + n * ldk + kc8, ok ? wi + (size_t)n * G3 + k : wi, ok);
    }
    gm_cp_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  const int n_kc = (G3 + GB_KC - 1) / GB_KC;
  load(0, 0);
  for (int kc = 0; kc < n_kc; ++kc) {
    if (kc + 1 < n_kc) {
      load(kc + 1, (kc + 1) & 1);
      gm_cp_wait<1>();
    } else {
      gm_cp_wait<0>();
    }
    __syncthreads();
    const gm_bf16* a = as + (kc & 1) * GB_TILE * ldk;
    const gm_bf16* w = bs + (kc & 1) * E * ldk;
#pragma unroll
    for (int kk = 0; kk < GB_KC; kk += 16) {
      uint32_t af[4];
      gm_frag_a(af, a, ldk, wm * 16, kk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nt = wn + 2 * i;
        if (nt < n_et) {
          uint32_t b[2];
          gm_frag_b_nk(b, w, ldk, nt * 8, kk);
          gm_mma(acc[i], af, b[0], b[1]);
        }
      }
    }
    __syncthreads();
  }
  __nv_bfloat162 ev[8][2];  // all of e's loads in flight before the first store
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long smp = s0 + wm * 16 + g + 8 * h;
      const int nt = wn + 2 * i;
      ev[i][h] = nt < n_et && smp < n_samples
                     ? __ldg((const __nv_bfloat162*)(ws.e + (size_t)smp * E + nt * 8 + 2 * c))
                     : gm_pack(0.f, 0.f);
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int nt = wn + 2 * i;
    if (nt >= n_et) continue;
    const int col = nt * 8 + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long smp = s0 + wm * 16 + g + 8 * h;
      if (smp >= n_samples) continue;
      const float2 e = __bfloat1622float2(ev[i][h]);
      *(__nv_bfloat162*)(ws.dpre + (size_t)smp * E + col) =
          gm_pack(acc[i][2 * h] * (1.f - e.x * e.x), acc[i][2 * h + 1] * (1.f - e.y * e.y));
    }
  }
}

template <int MT>
static int sweep_launch(const GruSeqDims& d, int smem, const void* done, const void* h0,
                        const void* hseq, const void* dhseq, const void* wh,
                        const GruBwdScratch& ws, void* dh0, cudaStream_t stream) {
  const int Q = d.n_env * d.N;
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_sweep_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gru_bwd_sweep_kernel<MT><<<(Q + 16 * MT - 1) / (16 * MT), GM_THREADS, smem, stream>>>(
      d, (const uint8_t*)done, (const gm_bf16*)h0, (const gm_bf16*)hseq, (const gm_bf16*)dhseq,
      (const gm_bf16*)wh, ws, (float*)dh0);
  return (int)cudaGetLastError();
}

// The plan's numbers (rware_tpu_torch/ops/fused_gru.py::gru_obs_bwd_plan):
// sweep_rows 16, 32 or 64 sequences a sweep block; each kernel's dynamic
// shared memory, bytes, which must be what this file computes; chunk *
// n_chunks >= T * n_env * N samples for the weight gradients.  Scratch:
// e_s, dpre_s (n, E) bf16, rz_s (n, 2Hg) f32, hn_s (n, 2Hg) bf16, dg4_s (n,
// 4Hg) bf16, part_bhn (sweep blocks, Hg) f32, partial n_chunks * ((L+1) E +
// (E+1) 3Hg + Hg 3Hg) floats, for n = T * n_env * N samples.  grads gets
// those weights' gradients and dbhn.  With split_ms (host memory) not null
// the call waits for its kernels and writes the milliseconds of the
// prologue, the sweep, the epilogue and the weight gradients (with their
// reduction) there, timed by CUDA events.
extern "C" int rw_fused_gru_bwd(int L, int E, int Hg, int T, int B, int N, int start_env,
                                int n_env, int sweep_rows, int prologue_smem, int sweep_smem,
                                int epilogue_smem, int wgrad_smem, int chunk, int n_chunks,
                                const void* obs, const void* done, const void* h0,
                                const void* hseq, const void* dhseq, const void* we,
                                const void* be, const void* wi, const void* bi, const void* wh,
                                const void* bhn, void* e_s, void* rz_s, void* hn_s, void* dg4_s,
                                void* dpre_s, void* part_bhn, void* partial, void* grads,
                                void* dh0, float* split_ms, void* stream_p) {
  if (E % 8 || Hg % 8 || E < 8 || Hg < 8 || E > 128 || Hg > 128 || L < 1 || T < 1
      || n_env < 1 || n_env > B || start_env < 0 || start_env >= B || chunk % GW_SK
      || n_chunks < 1 || (long long)chunk * n_chunks < (long long)T * n_env * N
      || prologue_smem != gb_prologue_smem(E, Hg) || epilogue_smem != gb_epilogue_smem(E)
      || wgrad_smem != gru_wgrad_smem()
      || (sweep_rows != 16 && sweep_rows != 32 && sweep_rows != 64)
      || sweep_smem != gb_sweep_smem(Hg, sweep_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_p;
  const GruSeqDims d = {L, E, Hg, T, B, N, start_env, n_env, 0};
  const GruBwdScratch ws = {(gm_bf16*)e_s, (float*)rz_s, (gm_bf16*)hn_s, (gm_bf16*)dg4_s,
                            (gm_bf16*)dpre_s, (float*)part_bhn};
  const int Q = n_env * N, sweep_blocks = (Q + sweep_rows - 1) / sweep_rows;
  const long long n_samples = (long long)T * Q;
  const unsigned tile_blocks = (unsigned)((n_samples + GB_TILE - 1) / GB_TILE);
  cudaEvent_t ev[5];
  if (split_ms != nullptr)
    for (int i = 0; i < 5; ++i) cudaEventCreate(&ev[i]);
  auto mark = [&](int i) {
    if (split_ms != nullptr) cudaEventRecord(ev[i], stream);
  };

  mark(0);
  cudaError_t cerr = cudaFuncSetAttribute(gru_bwd_prologue_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          prologue_smem);
  int err = (int)cerr;
  if (err == 0) {
    gru_bwd_prologue_kernel<<<tile_blocks, GM_THREADS, prologue_smem, stream>>>(
        d, n_samples, (const gm_bf16*)obs, (const uint8_t*)done, (const gm_bf16*)h0,
        (const gm_bf16*)hseq, (const gm_bf16*)we, (const float*)be, (const gm_bf16*)wi,
        (const float*)bi, (const gm_bf16*)wh, (const float*)bhn, ws);
    err = (int)cudaGetLastError();
  }
  mark(1);
  if (err == 0) {
    if (sweep_rows == 64)
      err = sweep_launch<4>(d, sweep_smem, done, h0, hseq, dhseq, wh, ws, dh0, stream);
    else if (sweep_rows == 32)
      err = sweep_launch<2>(d, sweep_smem, done, h0, hseq, dhseq, wh, ws, dh0, stream);
    else
      err = sweep_launch<1>(d, sweep_smem, done, h0, hseq, dhseq, wh, ws, dh0, stream);
  }
  mark(2);
  if (err == 0) {
    cerr = cudaFuncSetAttribute(gru_bwd_epilogue_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, epilogue_smem);
    err = (int)cerr;
  }
  if (err == 0) {
    gru_bwd_epilogue_kernel<<<tile_blocks, GM_THREADS, epilogue_smem, stream>>>(
        d, n_samples, (const gm_bf16*)wi, ws);
    err = (int)cudaGetLastError();
  }
  mark(3);
  const long long off_wi = (long long)(L + 1) * E, off_wh = off_wi + (long long)(E + 1) * 3 * Hg;
  const long long n_w = off_wh + (long long)Hg * 3 * Hg;
  float* part = (float*)partial;
  if (err == 0) {
    const GruObsSrc src = {(const gm_bf16*)obs, L, 1, E, gru_cols(dpre_s, E)};
    err = gru_wgrad_launch(d, src, n_samples, chunk, n_chunks, part, 0, n_w, stream);
  }
  if (err == 0) {
    // [dr | dz | dn]: dg4's columns without dhhn
    const GruCols g = {ws.dg4, 4 * Hg, 2 * Hg, nullptr, 0, Hg};
    const GruRowSrc src = {ws.e, E, E, 1, 3 * Hg, g};
    err = gru_wgrad_launch(d, src, n_samples, chunk, n_chunks, part, off_wi, n_w, stream);
  }
  if (err == 0) {
    const GruHprevSrc src = {(const gm_bf16*)h0, (const gm_bf16*)hseq, (const uint8_t*)done, Hg,
                             0, 3 * Hg, gru_cols(dg4_s, 4 * Hg)};
    err = gru_wgrad_launch(d, src, n_samples, chunk, n_chunks, part, off_wh, n_w, stream);
  }
  if (err == 0) {
    gru_reduce_kernel<<<(unsigned)((n_w + Hg + 255) / 256), 256, 0, stream>>>(
        part, n_chunks, n_w, ws.part_bhn, sweep_blocks, Hg, (float*)grads);
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
