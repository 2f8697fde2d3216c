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
//  2. gru_bwd_sweep_kernel (gru_bwd.cuh, shared with K12 and K13),
//     sequential in t: a block owns 16, 32 or 64 sequences and walks t
//     backwards with the hidden adjoint in f32, fed dhseq (GbCotSeq), writes
//     [dr | dz | dhhn | dn] once (bf16, 4 Hg a sample: GbOutDg4), and runs the
//     one product on the sequential path, [dr | dz | dhhn] Wh^T, on the
//     tensor cores with Wh resident in shared memory.  dbhn sums the
//     unrounded f32 dhhn: per-block partials.
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
#include "gru_bwd.cuh"

#define GB_KC 64  // k chunk of the embed and the epilogue

// Dynamic shared memory of each kernel, bytes (the wrapper's plan must agree).
static int gb_prologue_smem(int E, int Hg) {
  const int E16 = gm_r16(E), H16 = gm_r16(Hg);
  const int tiles = GB_TILE * (E16 + GM_PAD) + GB_TILE * (H16 + GM_PAD);
  const int embed = 2 * (GB_TILE * (GB_KC + GM_PAD) + GB_KC * (E16 + GM_PAD));
  const int gates = 2 * (E16 + H16) * (3 * GB_SLICE + GM_PAD);
  // and per row: the obs row offset (8 bytes), hprev's offset (8) and source (4)
  return (tiles + (embed > gates ? embed : gates)) * (int)sizeof(gm_bf16) + GB_TILE * 20;
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
        GbGate gt[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jj = j + u, k = 2 * h + u;
          gt[u] = gb_gate(gru_bf16r(ia[0][k] + bi[jj]), gru_bf16r(ia[1][k] + bi[Hg + jj]),
                          gru_bf16r(ia[2][k] + bi[2 * Hg + jj]), hh[0][k], hh[1][k], hh[2][k],
                          bhn[jj]);
        }
        gb_store_gates(ws, smp, Hg, j, gt);
      }
    }
    __syncthreads();  // before the next load overwrites this buffer
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
      || sweep_smem != gb_sweep_smem<GbCotSeq>(Hg, sweep_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_p;
  const GruSeqDims d = {L, E, Hg, T, B, N, start_env, n_env};
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
    const GbCotSeq cot = {(const gm_bf16*)dhseq};
    const GbOutDg4 out = {ws.dg4};
    err = gb_sweep(d, sweep_rows, sweep_smem, done, h0, hseq, cot, wh, ws, out, dh0, stream);
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
