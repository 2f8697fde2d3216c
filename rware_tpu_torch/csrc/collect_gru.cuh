// K2c and K2d′: the fused recurrent collector kernel — per step: FLATTENED
// or image observation, embed + GRU cell + f32 heads of a RecurrentActorCritic,
// Gumbel-argmax sample, env step, autoreset; the hidden carry stays on the
// card for the whole rollout and is zeroed where an episode ends.  The
// trajectory (obs bf16, action, logp, value, reward, done) is streamed out.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_collect in modes
// policy="gru" (K2c: one RecurrentActorCritic shared by all agents;
// _gru_forward, pallas_rollout.py:1446, and the carry handling of
// _make_collect_kernel) and policy="gru_per_agent" (K2d′: agent i runs its
// own GRU i on its own carry; _gru_forward_per_agent, :1376).  Both take
// image observations (K2e, IMAGE and IMAGE_DICT; pallas_rollout.py:1109) in
// an instantiation of their own (kImage).  The instantiations are spread
// over translation units of about equal build time, so that nvcc compiles
// them side by side (one nvcc process per source, all started together):
// K2d′'s FLATTENED ones in fused_collect_gru.cu, K2c's in
// fused_collect_gru_one_stack.cu, the image ones in fused_collect_gru_image.cu
// (K2d′) and fused_collect_gru_image_one_stack.cu (K2c).  Both carry the message mode
// K2b (msg_bits M > 0): the head block becomes [policy | value | message]
// (Hg, A + 1 + M), and the bits are sampled, streamed out and fed back as in
// K2a (pallas_rollout.py:1487-1491, 1944-1947, 2017-2035); images do not
// observe them.  M is a template argument (kM, one instantiation per width
// up to RW_MAX_M) and so is the per-agent mode (kPerAgent).
//
// Design.  The TPU kernel feeds the (L, N * 1024) feature block to the MXU,
// one product for the embed and for each gate matrix, and keeps the (Hg, N,
// 8, 128) carry in VMEM scratch for the whole rollout.  Here a block holds a
// tile of TE envs (ops/fused_rollout.py::collect_gru_plan: 64 at tiny-2ag
// and B=16,384, 256 blocks, two an SM; 32 at B=4,096, 128 blocks) on more
// threads than rows, and its N * TE (env, agent) rows run as one batch,
// agent-major (row i * TE + e), as in K2a (fused_collect.cu):
//  - the carry is a feature-major bf16 tile (Hg, RS) in shared memory for
//    the whole launch, loaded from h0 (B, N, Hg) once and stored to new_h
//    once, 16 bytes a thread, coalesced; a row's column is zeroed where its
//    env's episode ended, before the next step's products;
//  - the env step stays one thread per env (threads 0 .. TE-1), integer
//    work on the env's EnvState in local memory; after each step the env
//    thread writes a compact view of the env (collect_core.cuh::
//    write_obs_view), and one thread a row builds its observation from it
//    (build_row_obs) into a feature-major bf16 tile;
//  - the embed x We and the gates e Wi and h Wh are block products on the
//    FP32 pipes, k ascending, an FMA a term.  A thread owns a register tile
//    of 4 rows x 8 outputs and reads 4 rows of the tile (8 bytes) and 8
//    outputs of weight row k (16 bytes) for 32 FMAs.  The weights (We, Wi,
//    Wh: 214,784 bytes at L=71, E=Hg=128, more than a block's shared memory
//    beside the tiles) pass through a ring of three chunks of kc rows in
//    shared memory, brought by cp.async two chunks ahead, one barrier a
//    chunk: every warp of the set reads the same weight rows, so a row
//    crosses L2 once a set and the warps read it at shared-memory latency
//    (read through L1 instead, the kernel was slower on the card; PERF.md).
//    The lanes of a warp take neighbouring output groups of the same rows.
//    For the gates a thread owns the same 8 hidden units of all three gates
//    on both sides (as a warp in K9 and K11), gate by gate: gi_g and gh_g
//    are two sums from zero, held together in registers (64 floats) and
//    joined in f32 as the plain version joins them; r, z and bf16(gi_n +
//    bin) are then kept as bf16 pairs (16 registers each), so a hidden
//    unit's gate arithmetic needs no other thread and no f32 staging in
//    shared memory.  All of it fits the 128 registers a thread has at two
//    blocks of 256 threads an SM.  Register tiles of 8 x 8 (K2a's) hold 128
//    floats for gi_r and gh_r together; on 128 threads a block with up to
//    255 registers they ran no faster, and K2d′ slower (PERF.md);
//  - a product walks the tile's rows in sets: as many whole 4-row groups as
//    give every job (4 rows x 8 outputs) a thread.  A row's product reads
//    only that row, so once a set's sums are in registers and the block has
//    passed a barrier its results are written over the rows it read: e over
//    the observations (after the step's observations are stored), new h over
//    the carry.  Two bf16 tiles, (max(L, E), RS) and (Hg, RS), are all the
//    rows need: 64 KB at 128 rows;
//  - the heads (A policy rows, the value row, M message rows: f32 Wc) are
//    jobs of 4 rows x 1 head row spread over the threads, reading new h from
//    the carry tile; sampling runs one thread a row (sample_gumbel,
//    sample_bernoulli, the same Philox purposes and slots);
//  - the step's rows of obs (in the embed, before e goes over them), action,
//    bits, logp and value (while the env threads step), reward and done
//    (while the next observations are built) are each contiguous in (T, B,
//    N, ...) for the tile and are written as 16-byte vectors, neighbouring
//    threads on neighbouring addresses, the ragged last tile masked.
// K2d′ reads agent i's We, Wi and Wh from stack i (N stacks back to back;
// TE is a multiple of 8, so a 4-row group runs one agent's stack); the f32
// biases and head blocks of every stack sit in shared memory where the plan
// finds room for them without losing a block an SM, else they are read from
// device memory (heads_global).  The launch plan (tile, threads, route,
// carve-out, every shared-memory offset) comes from collect_gru_plan;
// collect_gru_plan_ok refuses a plan whose regions do not hold what the
// kernel keeps there.
// Where a tile of 8 envs cannot hold its rows' whole observations (K2d′ at 16
// agents and sensor range 5: 128 rows x 855 features), the chunked route
// (kChunk, per agent only, built in fused_collect_gru_chunked.cu and
// fused_collect_gru_chunked_image.cu) keeps kx features of the tile and the
// embedding in a region of its own (embed_rows_chunked): for each set of rows
// the rows build each chunk from their env's view (collect_core.cuh::
// build_row_chunk), the block stores it to the trajectory, and the set's
// sums carry from chunk to chunk through tile_fma_acc, the chunk's rows of We
// brought through the ring from a multiple of kc, so each sum is the same FMA
// chain as the whole tile's.
//
// Numerics follow _gru_forward (pallas_rollout.py:1472-1486), which
// _gru_forward_per_agent repeats per agent, in the order and formulas of
// rware_tpu_torch/models/networks.py::gru_collect_step: bf16 inputs and
// weights, f32 sums over the inputs in ascending order; e = tanh(bf16(x We +
// be)); r, z = bf16(sigmoid((gi + gh) + b)) with gi = e Wi and gh = h Wh
// each summed from zero; n = tanh(bf16(gi_n + bin) + r * bf16(gh_n + bhn))
// in bf16 arithmetic; new_h = (1 - z) * n + z * h in bf16 arithmetic; the
// sigmoid 1 / (1 + expf(-x)) with one rounded add and one rounded division.
// In the embed and both gate products every operand is a bf16 value, so
// each product has at most 16 significant bits and is exact in f32: one
// rounding of __fmaf_rn(x, w, acc) equals ordered_matmul's separately rounded
// __fadd_rn(acc, __fmul_rn(x, w)) (tests/test_torch_collect_gru_plan.py).
// The heads multiply bf16 new h by f32 Wc, whose products are not exact:
// they keep separate __fmul_rn / __fadd_rn in ascending hidden order, the
// bias added after.  No product goes to the tensor cores: mma sums 16
// products in one step with its own rounding, and a last-bit difference in a
// gate moves a bf16 r, z, n or h, which the recurrence carries into every
// later logit of that agent.  No float atomics: two launches are bit-equal.
//
// Bound on the card: the cell's products on the FP32 pipes, about 107k FMAs
// an agent-step at L=71, E=Hg=128 (embed 9k, input gates 49k, hidden gates
// 49k) and 0.8k head multiply-adds (more with messages); 4.5e11 FMAs at
// tiny-2ag, B=16,384, T=128, 13.4 ms at 67 TFLOP/s.  The bound chip_smoke.py
// reports counts them at the tensor-core rate (the cell's operations), which
// the bit-exact contract keeps out of reach.
#pragma once

#include <cstring>

#include "collect_core.cuh"
#include "gru_core.cuh"  // gru_sigmoid
#include "gru_mma.cuh"   // gm_cp16, gm_cp_commit, gm_cp_wait

#define RW_GRU_MAX_THREADS 512
#define RW_GRU_SMEM_LIMIT 232448
#define RW_GRU_RT 4  // rows of a thread's register tile

// Phase counters for tools/collect_phase_profile.py, which defines these in a
// patched copy: start, the end of phase i of a step (after its barrier), the
// kernel's end.  Compiled to nothing here.
#ifndef RW_COLLECT_GRU_MARK
#define RW_COLLECT_GRU_MARK_INIT
#define RW_COLLECT_GRU_MARK(i)
#define RW_COLLECT_GRU_MARK_END
#endif

struct GruCollectDims {
  int L, E, Hg, A;
  int deterministic;
  int n_stacks;  // weight stacks: 1 (K2c) or N (K2d′, agent i runs stack i)
  ObsDims obs;
};

// One block's launch plan, in the order of ops/fused_rollout.py::
// GruCollectPlan.args: te envs a block, threads, rows (N * te padded to 8),
// rs (row stride of the feature-major tiles), hrs (words of a row's record),
// vs (words of an env's view), heads_global (the f32 biases and head blocks
// read from device memory), the shared-memory carve-out (percent) to ask
// for, kc (weight rows a chunk of the ring), ring_stacks (stacks a chunk
// holds: the most one set of rows runs) and kx (observation features a chunk
// of the tile holds; 0: the whole row), then the byte offsets of the
// shared-memory regions and their end: the f32 be, bi, bhn, Wc, bc of the
// stacks held there, the observation tile (e written over it, unless chunked),
// the embedding (chunked only), the carry tile, the weight ring (three
// chunks), a record a row, a view an env, done an env.
struct GruCollectPlan {
  int te, threads, rows, rs, hrs, vs, heads_global, carveout, kc, ring_stacks, kx;
  int be, bi, bhn, wc, bc, x, e, h, ring, out, view, done, end;
};
#define RW_GRU_REGIONS 12

// Stacks the rows of one set span, for sets of `rgs` 4-row groups starting
// at multiples of rgs (K2d′: row r runs stack r / te).
static int set_stacks(int rows, int cols, int threads, int te) {
  const int nrg = rows / RW_GRU_RT, ncg = cols / 8;
  const int rgs = nrg < threads / ncg ? nrg : threads / ncg;
  int most = 0;
  for (int rg0 = 0; rg0 < nrg; rg0 += rgs) {
    const int last = (rg0 + rgs < nrg ? rg0 + rgs : nrg) * RW_GRU_RT - 1;
    const int n = last / te - rg0 * RW_GRU_RT / te + 1;
    most = n > most ? n : most;
  }
  return most;
}

// True when every region of `p` holds what the kernel keeps there and the
// tile is one the kernel takes.
static bool collect_gru_plan_ok(const GruCollectPlan& p, const GruCollectDims& m,
                                const EnvDims& d) {
  const int N = d.n;
  const long ws = p.heads_global ? 0 : m.n_stacks, E = m.E, Hg = m.Hg, AC = m.A + 1 + d.m,
             rs = p.rs, rows = p.rows, xr = m.L > E ? m.L : E;
  const long wc_ = E > Hg ? E : Hg;
  const long need[RW_GRU_REGIONS] = {ws * E * 4,  ws * 3 * Hg * 4, ws * Hg * 4,
                                     ws * Hg * AC * 4, ws * AC * 4,
                                     (p.kx ? p.kx : xr) * rs * 2, p.kx ? E * rs * 2 : 0,
                                     Hg * rs * 2, 3L * p.ring_stacks * p.kc * wc_ * 2,
                                     rows * p.hrs * 4, (long)p.te * p.vs * 4, p.te};
  // a thread for each output group of a row set, and whole row groups
  if (p.te < 1 || p.threads < 1 || E < 8 || Hg < 8 || E % 8 || Hg % 8 || E / 8 > p.threads ||
      Hg / 8 > p.threads || rows % 8)
    return false;
  const int se = set_stacks(p.rows, E, p.threads, p.te);
  const int sh = set_stacks(p.rows, Hg, p.threads, p.te);
  const int spans = m.n_stacks == 1 ? 1 : (se > sh ? se : sh);
  const int* off = &p.be;
  if (off[0] != 0) return false;
  for (int k = 0; k < RW_GRU_REGIONS; ++k)
    if (off[k] % 16 || (long)off[k + 1] - off[k] < need[k]) return false;
  return rows >= (long)N * p.te && rs >= rows && rs % 8 == 0 && m.A >= 3 && p.hrs >= AC &&
         p.vs >= 2 * N + N * d.m + d.r + d.s && (long)d.h * d.w <= 65536 &&
         p.threads % 32 == 0 && p.threads <= RW_GRU_MAX_THREADS && p.threads >= rows + 32 &&
         (m.n_stacks == 1 || (p.te % 8 == 0 && rows == N * p.te)) && p.kc >= 1 &&
         p.ring_stacks >= spans && p.carveout >= 0 && p.carveout <= 100 &&
         p.end <= RW_GRU_SMEM_LIMIT &&
         // a chunk: whole 16-byte runs of features and of the ring's chunks,
         // per agent (the chunked instantiations)
         (p.kx == 0 ||
          (p.kx > 0 && p.kx % 8 == 0 && p.kx % p.kc == 0 && m.n_stacks > 1));
}

// Four bf16 values (8 bytes, element 0 in the low half of x) as floats.
static __device__ __forceinline__ void unpack4(const uint2 v, float* f) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xFFFF0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

// Element `b` (0 low, 1 high) of a bf16 pair as a float.
static __device__ __forceinline__ float pair_elem(unsigned w, int b) {
  return __uint_as_float(b ? w & 0xFFFF0000u : w << 16);
}

// The weight rows a product reads: rows [0, K) of columns col0 .. col0 + C
// (C a multiple of 8) of a bf16 (K, ldw) matrix in device memory, the stacks
// `sstride` elements apart.
struct WSlice {
  const __nv_bfloat16* w;
  int K, ldw, col0, C;
  size_t sstride;
};

// The weight ring: three chunks of kc rows x C columns for each of the
// stacks s0 .. s0 + ns - 1 of a set, brought from device memory by cp.async
// two chunks ahead of the product, so that the block's warps read each
// weight row from shared memory (16 bytes a load) and the L2 latency is
// paid once a chunk, in the shadow of the products.
struct Ring {
  __nv_bfloat16* buf;
  int kc, s0, ns;
};

// acc[a][c] += sum over k < K of src[k][a] * W[k][c0 + c], k ascending, an
// FMA a term: src the 4 rows of a feature-major bf16 tile (row stride rs),
// W stack `stack`'s weight rows of the slice, staged through the ring.
// Every thread of the block calls this together (the ring's barriers);
// inactive threads only stage.
static __device__ __forceinline__ void tile_fma_acc(float (&acc)[4][8],
                                                    const __nv_bfloat16* src, int rs,
                                                    bool active, int stack, int c0,
                                                    const WSlice& ws, const Ring& ring, int tid,
                                                    int nt) {
  const int K = ws.K, C = ws.C, kc = ring.kc, nch = (K + kc - 1) / kc, vr = C / 8;
  const size_t chunk = (size_t)ring.ns * kc * C;  // elements a chunk
  auto issue = [&](int ch) {  // chunk ch into buffer ch % 3, one commit group
    if (ch < nch) {
      const int k0 = ch * kc, kn = min(kc, K - k0), per_stack = kn * vr;
      __nv_bfloat16* dst = ring.buf + (ch % 3) * chunk;
      for (int v = tid; v < ring.ns * per_stack; v += nt) {
        const int s = v / per_stack, kk = (v - s * per_stack) / vr, c8 = v % vr;
        gm_cp16(dst + ((size_t)s * kc + kk) * C + c8 * 8,
                ws.w + (ring.s0 + s) * ws.sstride + (size_t)(k0 + kk) * ws.ldw + ws.col0 + c8 * 8,
                true);
      }
    }
    gm_cp_commit();
  };
  __syncthreads();  // the ring's last readers are done with it
  issue(0);
  issue(1);
  for (int ch = 0; ch < nch; ++ch) {
    gm_cp_wait<1>();
    __syncthreads();  // chunk ch is in; chunk ch - 1's buffer is free
    issue(ch + 2);
    if (active) {
      const int k0 = ch * kc, kn = min(kc, K - k0);
      const __nv_bfloat16* wb =
          ring.buf + (ch % 3) * chunk + (size_t)(stack - ring.s0) * kc * C + c0;
      const __nv_bfloat16* xb = src + (size_t)k0 * rs;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const uint2 xv = *reinterpret_cast<const uint2*>(xb + (size_t)kk * rs);
        const uint4 wv = *reinterpret_cast<const uint4*>(wb + (size_t)kk * C);
        float x[4], wf[8];
        unpack4(xv, x);
        unpack8(wv, wf);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = __fmaf_rn(x[a], wf[c], acc[a][c]);
      }
    }
  }
}

// tile_fma_acc's sums from zero.
static __device__ __forceinline__ void tile_fma(float (&acc)[4][8], const __nv_bfloat16* src,
                                                int rs, bool active, int stack, int c0,
                                                const WSlice& ws, const Ring& ring, int tid,
                                                int nt) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  tile_fma_acc(acc, src, rs, active, stack, c0, ws, ring, tid, nt);
}

// The rows of a product, walked in sets of whole 4-row groups: job tid of a
// set is row group rg0 + tid / ncg, output group tid % ncg (a warp's lanes
// on neighbouring output groups).  A set has a thread for each of its jobs.
struct RowSet {
  int nrg, rgs, ncg;
  __device__ RowSet(int rows, int cols, int nt)
      : nrg(rows / RW_GRU_RT), rgs(min(rows / RW_GRU_RT, nt / (cols / 8))), ncg(cols / 8) {}
  // The ring of the set from row group rg0: K2d′'s rows run stack row / te,
  // so a set spans the stacks of its first to its last row.
  __device__ Ring ring(Ring r, int rg0, bool per_agent, int te) const {
    if (per_agent) {
      const int last = min(rg0 + rgs, nrg) * RW_GRU_RT - 1;
      r.s0 = rg0 * RW_GRU_RT / te;
      r.ns = last / te - r.s0 + 1;
    }
    return r;
  }
};

// The embed over the tile: for each row r, xs[j][r] = bf16(tanh(bf16(sum_k
// xs[k][r] We[k][j] + be[j]))), written over the observation rows once the
// set's sums are in registers and the block has passed a barrier; every
// thread calls before_write() first, once.  K2d′ runs a row group's agent's
// stack.
template <bool kPerAgent, typename Hook>
static __device__ __forceinline__ void embed_rows(__nv_bfloat16* xs, int L, int E,
                                                  const __nv_bfloat16* we, const float* be,
                                                  int R, int RS, int TE, const Ring& ring,
                                                  int tid, int nt, Hook before_write) {
  const RowSet s(R, E, nt);
  const WSlice w = {we, L, E, 0, E, (size_t)L * E};
  for (int rg0 = 0; rg0 < s.nrg; rg0 += s.rgs) {
    const int rg = rg0 + tid / s.ncg, c0 = (tid % s.ncg) * 8, r0 = rg * RW_GRU_RT;
    const bool active = tid < s.rgs * s.ncg && rg < s.nrg;
    const int stack = kPerAgent && active ? r0 / TE : 0;
    float acc[4][8];
    tile_fma(acc, xs + r0, RS, active, stack, c0, w, s.ring(ring, rg0, kPerAgent, TE), tid, nt);
    if (rg0 == 0) before_write();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float bj = be[stack * E + c0 + c];
        float v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) v[a] = tanhf(bf16_round(__fadd_rn(acc[a][c], bj)));
        *reinterpret_cast<uint2*>(xs + (size_t)(c0 + c) * RS + r0) =
            make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
      }
    }
  }
}

// The embed with the observation tile in chunks (the chunked route, kx > 0):
// for each set of rows, for each chunk of kx features in ascending k, the set's
// rows build their features of the chunk from their env's view
// (build_row_chunk), the block stores them to the trajectory's obs (obs_rows:
// the step's rows of the block's first env), and the set's jobs carry their
// sums in registers on to the next chunk (tile_fma_acc over the chunk's rows
// of We, which start at a multiple of the ring's kc); each sum stays one FMA
// chain from k = 0 to L - 1, as in embed_rows.  e goes to es, its own region.
template <bool kPerAgent, bool kMsg, bool kImage>
static __device__ __forceinline__ void embed_rows_chunked(
    const int* views, const EnvDims& d, const EnvLayout& lay, const GruCollectDims& m,
    const GruCollectPlan& p, int TEv, const __nv_bfloat16* we, const float* be,
    __nv_bfloat16* xs, __nv_bfloat16* es, unsigned short* obs_rows, const Ring& ring, int tid,
    int nt) {
  const int L = m.L, E = m.E, N = d.n, R = p.rows, RS = p.rs, TE = p.te, KX = p.kx;
  const RowSet s(R, E, nt);
  for (int rg0 = 0; rg0 < s.nrg; rg0 += s.rgs) {
    const int rg = rg0 + tid / s.ncg, c0 = (tid % s.ncg) * 8, r0 = rg * RW_GRU_RT;
    const bool active = tid < s.rgs * s.ncg && rg < s.nrg;
    const int stack = kPerAgent && active ? r0 / TE : 0;
    const int ra = rg0 * RW_GRU_RT, rb = min(rg0 + s.rgs, s.nrg) * RW_GRU_RT;
    const Ring sr = s.ring(ring, rg0, kPerAgent, TE);
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
    for (int k0 = 0; k0 < L; k0 += KX) {
      const int kn = min(KX, L - k0);
      __syncthreads();  // the last chunk's readers are done with the tile
      if (tid >= ra && tid < rb) {
        const int e = tid % TE, i = tid / TE;
        build_row_chunk<kMsg, kImage>(views + e * p.vs, d, lay, m.obs, i, i >= N || e >= TEv,
                                      xs, RS, tid, k0, kn);
      }
      __syncthreads();
      store_chunk_rows(obs_rows, L, k0, kn, reinterpret_cast<const unsigned short*>(xs), RS, ra,
                       rb, N, TE, TEv, tid, nt);
      tile_fma_acc(acc, xs + r0, RS, active, stack, c0,
                   WSlice{we + (size_t)k0 * E, kn, E, 0, E, (size_t)L * E}, sr, tid, nt);
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float bj = be[stack * E + c0 + c];
        float v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) v[a] = tanhf(bf16_round(__fadd_rn(acc[a][c], bj)));
        *reinterpret_cast<uint2*>(es + (size_t)(c0 + c) * RS + r0) =
            make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
      }
    }
  }
}

// The GRU cell over the tile: new h of every row from e (es) and the carry
// (hs), written over the carry once the set's sums are in registers and the
// block has passed a barrier.  A job is 4 rows x the hidden units c0 .. c0 +
// 7 of all three gates, gate by gate (gi and gh two sums from zero, joined
// in f32), with the formulas and roundings of gru_collect_step.
template <bool kPerAgent>
static __device__ __forceinline__ void cell_rows(const __nv_bfloat16* es,
                                                 __nv_bfloat16* hs, int E, int Hg,
                                                 const __nv_bfloat16* wi, const float* bi,
                                                 const __nv_bfloat16* wh, const float* bhn,
                                                 int R, int RS, int TE, const Ring& ring,
                                                 int tid, int nt) {
  const RowSet s(R, Hg, nt);
  const int H3 = 3 * Hg;
  for (int rg0 = 0; rg0 < s.nrg; rg0 += s.rgs) {
    const int rg = rg0 + tid / s.ncg, c0 = (tid % s.ncg) * 8, r0 = rg * RW_GRU_RT;
    const bool active = tid < s.rgs * s.ncg && rg < s.nrg;
    const int stack = kPerAgent && active ? r0 / TE : 0;
    const Ring sr = s.ring(ring, rg0, kPerAgent, TE);
    const float* Bi = bi + stack * H3 + c0;
    const float* Bhn = bhn + stack * Hg + c0;
    float gi[4][8], gh[4][8];
    unsigned rz[2][4][4], inb[4][4];  // r, z, bf16(gi_n + bin) as bf16 pairs
    uint2 nh[8];                      // new h of unit c0 + c, rows r0 .. r0 + 3
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      tile_fma(gi, es + r0, RS, active, stack, c0,
               WSlice{wi, E, H3, g * Hg, Hg, (size_t)E * H3}, sr, tid, nt);
      tile_fma(gh, hs + r0, RS, active, stack, c0,
               WSlice{wh, Hg, H3, g * Hg, Hg, (size_t)Hg * H3}, sr, tid, nt);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int c = 2 * q + b;
            v[b] = active ? gru_sigmoid(__fadd_rn(__fadd_rn(gi[a][c], gh[a][c]), Bi[g * Hg + c]))
                          : 0.f;
          }
          rz[g][a][q] = pack2(v[0], v[1]);
        }
    }
    tile_fma(gi, es + r0, RS, active, stack, c0,
             WSlice{wi, E, H3, 2 * Hg, Hg, (size_t)E * H3}, sr, tid, nt);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        inb[a][q] = active ? pack2(__fadd_rn(gi[a][2 * q], Bi[2 * Hg + 2 * q]),
                                   __fadd_rn(gi[a][2 * q + 1], Bi[2 * Hg + 2 * q + 1]))
                           : 0u;
    tile_fma(gh, hs + r0, RS, active, stack, c0,
             WSlice{wh, Hg, H3, 2 * Hg, Hg, (size_t)Hg * H3}, sr, tid, nt);
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float hp[4], v[4];
        unpack4(*reinterpret_cast<const uint2*>(hs + (size_t)(c0 + c) * RS + r0), hp);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float r = pair_elem(rz[0][a][c / 2], c % 2);
          const float z = pair_elem(rz[1][a][c / 2], c % 2);
          const float in_b = pair_elem(inb[a][c / 2], c % 2);
          const float hn_b = bf16_round(__fadd_rn(gh[a][c], Bhn[c]));
          const float nn =
              bf16_round(tanhf(bf16_round(__fadd_rn(in_b, bf16_round(__fmul_rn(r, hn_b))))));
          v[a] = __fadd_rn(bf16_round(__fmul_rn(bf16_round(__fsub_rn(1.f, z)), nn)),
                           bf16_round(__fmul_rn(z, hp[a])));
        }
        nh[c] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint2*>(hs + (size_t)(c0 + c) * RS + r0) = nh[c];
    }
  }
}

// kM: message bits per agent, 0 without the message head; kPerAgent: agent i
// runs weight stack i (K2d′), else every agent runs the one stack (K2c);
// kImage: image observations (K2e), else FLATTENED; kChunk: the observation
// tile in chunks of kx features (K2d′ only), the embedding in a region of its
// own.  h0 and new_h are (B, N, Hg) bf16.
template <int kM, bool kPerAgent, bool kImage, bool kChunk>
__global__ void __launch_bounds__(RW_GRU_MAX_THREADS)
    fused_collect_gru_kernel(EnvDims d, GruCollectDims m, GruCollectPlan p, int T, int B,
                             const int* __restrict__ layout, const int* __restrict__ state_in,
                             int* __restrict__ state_out, const __nv_bfloat16* __restrict__ we,
                             const float* __restrict__ be, const __nv_bfloat16* __restrict__ wi,
                             const float* __restrict__ bi, const __nv_bfloat16* __restrict__ wh,
                             const float* __restrict__ bhn, const float* __restrict__ wc,
                             const float* __restrict__ bc, const __nv_bfloat16* __restrict__ h0,
                             __nv_bfloat16* __restrict__ new_h, __nv_bfloat16* __restrict__ obs,
                             int* __restrict__ action, int* __restrict__ bits_out,
                             float* __restrict__ logp, float* __restrict__ value,
                             float* __restrict__ reward, uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kMsg = kM > 0;
  const int L = m.L, E = m.E, Hg = m.Hg, A = m.A, N = d.n, AC = A + 1 + kM;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TE = p.te, R = p.rows, RS = p.rs, HRS = p.hrs, VS = p.vs;
  const int e0 = blockIdx.x * TE, TEv = min(TE, B - e0), HV = Hg / 8;
  const int WS = p.heads_global ? 0 : m.n_stacks;  // stacks whose f32 blocks are held here

  float* const sbe = (float*)(smem + p.be);
  float* const sbi = (float*)(smem + p.bi);
  float* const sbhn = (float*)(smem + p.bhn);
  float* const swc = (float*)(smem + p.wc);
  float* const sbc = (float*)(smem + p.bc);
  // The tiles, feature-major (., RS): the observations, e written over them
  // (chunked: a chunk of them, e in a tile of its own); the carry, new h
  // written over it.
  __nv_bfloat16* const xs = (__nv_bfloat16*)(smem + p.x);
  __nv_bfloat16* const es = kChunk ? (__nv_bfloat16*)(smem + p.e) : xs;
  __nv_bfloat16* const hs = (__nv_bfloat16*)(smem + p.h);
  // A row's record (HRS words): the A logits, the value at A, the M message
  // logits after it; once sampled, the action (int) at 0, logp at 1, after
  // the env step the reward at 2, and the bits (int) over the message logits.
  float* const outs = (float*)(smem + p.out);
  int* const outi = (int*)(smem + p.out);
  int* const views = (int*)(smem + p.view);  // env e0 + e's view at e * VS
  uint8_t* const dones = smem + p.done;
  const uint32_t wmagic = 0xFFFFFFFFu / (uint32_t)d.w + 1u;  // ceil(2^32 / W)
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const bool stepper = tid < TEv;  // this thread owns env e0 + tid
  const EnvLayout lay = make_layout(d, layout);
  EnvState st;
  if (stepper) {
    load_state(st, d, state_in, e0 + tid, B);
    write_obs_view<kMsg>(st, d, wmagic, views + tid * VS);
  }
  if (tid < TE) dones[tid] = 0;
  for (int k = tid; k < WS * E; k += nt) sbe[k] = be[k];
  for (int k = tid; k < WS * 3 * Hg; k += nt) sbi[k] = bi[k];
  for (int k = tid; k < WS * Hg; k += nt) sbhn[k] = bhn[k];
  for (int k = tid; k < WS * Hg * AC; k += nt) swc[k] = wc[k];
  for (int k = tid; k < WS * AC; k += nt) sbc[k] = bc[k];
  // the carry: (env, agent, 8 units) a thread, 16 bytes from h0; rows of no
  // env zero
  for (int q = tid; q < TEv * N * HV; q += nt) {
    const int v = q % HV, g = q / HV, e = g / N, i = g - e * N;
    const uint4 hv =
        __ldg(reinterpret_cast<const uint4*>(h0 + ((size_t)(e0 + e) * N + i) * Hg) + v);
    const unsigned short* u = reinterpret_cast<const unsigned short*>(&hv);
    unsigned short* col = reinterpret_cast<unsigned short*>(hs) + (size_t)v * 8 * RS + i * TE + e;
#pragma unroll
    for (int c = 0; c < 8; ++c) col[(size_t)c * RS] = u[c];
  }
  for (int q = tid; q < R * Hg; q += nt) {
    const int r = q % R;
    if (r / TE >= N || r % TE >= TEv) hs[(size_t)(q / R) * RS + r] = zero;
  }
  __syncthreads();

  const float* Be = WS ? sbe : be;
  const float* Bi = WS ? sbi : bi;
  const float* Bhn = WS ? sbhn : bhn;
  const float* Wc = WS ? swc : wc;
  const float* Bc = WS ? sbc : bc;
  const int NQ = R / 4;
  const Ring ring = {(__nv_bfloat16*)(smem + p.ring), p.kc, 0, 1};
  RW_COLLECT_GRU_MARK_INIT;

  // Rewards and done flags of step s, by the threads past the tile's rows.
  auto store_rewards = [&](int s) {
    const int lane = tid - R, lanes = nt - R;
    store_span(reward + ((size_t)s * B + e0) * N, TEv * N, lane, lanes,
               RowRun<float>{outs + 2, HRS, 1, N, TE});
    store_span(done_out + (size_t)s * B + e0, TEv, lane, lanes,
               [&](int q, int cnt, uint8_t* o) {
                 for (int c = 0; c < cnt; ++c) o[c] = dones[q + c];
               });
  };

  for (int t = 0; t < T; ++t) {
    // ---- observations of step t, one thread a row, from its env's view
    // (rows of no env zero; chunked: in the embed); the carry of an env whose
    // episode ended at t-1 restarts at zero | step t-1's rewards, done
    if (tid < R) {
      const int e = tid % TE, i = tid / TE;
      if (i < N && e < TEv) {
        if (!kChunk) build_row_obs<kMsg, kImage>(views + e * VS, d, lay, m.obs, i, xs, RS, tid);
        if (dones[e])
          for (int k = 0; k < Hg; ++k) hs[(size_t)k * RS + tid] = zero;
      } else if (!kChunk) {
        for (int c = 0; c < L; ++c) xs[(size_t)c * RS + tid] = zero;
      }
    } else if (t > 0) {
      store_rewards(t - 1);
    }
    __syncthreads();
    RW_COLLECT_GRU_MARK(0);
    // ---- embed -> e over the observations; before it goes over them, the
    // step's obs out
    if (kChunk) {
      embed_rows_chunked<kPerAgent, kMsg, kImage>(
          views, d, lay, m, p, TEv, we, Be, xs, es,
          reinterpret_cast<unsigned short*>(obs) + ((size_t)t * B + e0) * N * L, ring, tid, nt);
    } else {
      embed_rows<kPerAgent>(xs, L, E, we, Be, R, RS, TE, ring, tid, nt, [&] {
        store_span(reinterpret_cast<unsigned short*>(obs) + ((size_t)t * B + e0) * N * L,
                   TEv * N * L, tid, nt,
                   TileRowRun{reinterpret_cast<const unsigned short*>(xs), RS, L, N, TE});
      });
    }
    __syncthreads();
    RW_COLLECT_GRU_MARK(1);
    // ---- the cell -> new h over the carry
    cell_rows<kPerAgent>(es, hs, E, Hg, wi, Bi, wh, Bhn, R, RS, TE, ring, tid, nt);
    __syncthreads();
    RW_COLLECT_GRU_MARK(2);
    // ---- heads: 4 rows x 1 head row a job, f32, hidden ascending, then the
    // bias
    for (int job = tid; job < NQ * AC; job += nt) {
      const int r0 = (job % NQ) * 4, hr = job / NQ;
      const int s = kPerAgent ? r0 / TE : 0;
      const float* w = Wc + (size_t)s * Hg * AC + hr;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < Hg; ++c) {
        float h[4];
        unpack4(*reinterpret_cast<const uint2*>(hs + (size_t)c * RS + r0), h);
        const float wk = w[(size_t)c * AC];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] = __fadd_rn(acc[a], __fmul_rn(h[a], wk));
      }
      const float bias = Bc[s * AC + hr];
#pragma unroll
      for (int a = 0; a < 4; ++a) outs[(r0 + a) * HRS + hr] = __fadd_rn(acc[a], bias);
    }
    __syncthreads();
    RW_COLLECT_GRU_MARK(3);
    // ---- sampling, one thread a row
    if (tid < N * TE && tid % TE < TEv) {
      const int r = tid, e = r % TE, i = r / TE;
      float lg[RW_MAX_A], lp;
      for (int a = 0; a < A; ++a) lg[a] = outs[r * HRS + a];
      const int act = sample_gumbel(lg, A, m.deterministic, d, e0 + e, t, i, &lp);
      if (kMsg) {
        float ml[kMsg ? kM : 1];
        int bit[kMsg ? kM : 1];
#pragma unroll
        for (int c = 0; c < kM; ++c) ml[c] = outs[r * HRS + A + 1 + c];
        lp = __fadd_rn(lp, sample_bernoulli(ml, kM, m.deterministic, d, e0 + e, t, i, bit));
#pragma unroll
        for (int c = 0; c < kM; ++c) outi[r * HRS + A + 1 + c] = bit[c];
      }
      outi[r * HRS] = act;
      outs[r * HRS + 1] = lp;
    }
    __syncthreads();
    RW_COLLECT_GRU_MARK(4);
    // ---- env step (env threads) | step t's action, bits, logp, value
    if (tid < TE) {
      if (stepper) {
        int a_[RW_MAX_N];
        float rew[RW_MAX_N];
        for (int i = 0; i < N; ++i) a_[i] = outi[(i * TE + tid) * HRS];
        if (kMsg)
          for (int i = 0; i < N; ++i)
            for (int c = 0; c < kM; ++c)
              st.msg[i * kM + c] = outi[(i * TE + tid) * HRS + A + 1 + c];
        const bool done = env_step(st, a_, rew, d, lay, e0 + tid, t);  // clears msg on done
        for (int i = 0; i < N; ++i) outs[(i * TE + tid) * HRS + 2] = rew[i];
        dones[tid] = done ? 1 : 0;
        write_obs_view<kMsg>(st, d, wmagic, views + tid * VS);
      }
    } else {
      const int lane = tid - TE, lanes = nt - TE;
      const size_t row0 = ((size_t)t * B + e0) * N;
      store_span(action + row0, TEv * N, lane, lanes, RowRun<int>{outi, HRS, 1, N, TE});
      store_span(logp + row0, TEv * N, lane, lanes, RowRun<float>{outs + 1, HRS, 1, N, TE});
      store_span(value + row0, TEv * N, lane, lanes, RowRun<float>{outs + A, HRS, 1, N, TE});
      if (kMsg)
        store_span(bits_out + row0 * kM, TEv * N * kM, lane, lanes,
                   RowRun<int>{outi + A + 1, HRS, kM, N, TE});
    }
    __syncthreads();
    RW_COLLECT_GRU_MARK(5);
  }
  if (tid >= R) store_rewards(T - 1);
  // the new carry, zero where the last step ended an episode: 16 bytes a
  // thread to new_h
  for (int q = tid; q < TEv * N * HV; q += nt) {
    const int v = q % HV, g = q / HV, e = g / N, i = g - e * N;
    union {
      uint4 u;
      unsigned short s[8];
    } pk;
    const unsigned short* col =
        reinterpret_cast<const unsigned short*>(hs) + (size_t)v * 8 * RS + i * TE + e;
#pragma unroll
    for (int c = 0; c < 8; ++c) pk.s[c] = dones[e] ? 0 : col[(size_t)c * RS];
    reinterpret_cast<uint4*>(new_h + ((size_t)(e0 + e) * N + i) * Hg)[v] = pk.u;
  }
  if (stepper) store_state(st, d, state_out, e0 + tid, B);
  RW_COLLECT_GRU_MARK_END;
}

// The launch arguments of one collector call besides its dimensions.
struct GruCollectArgs {
  const void *layout, *state_in;
  void* state_out;
  const void *we, *be, *wi, *bi, *wh, *bhn, *wc, *bc, *h0;
  void *new_h, *obs, *action, *bits, *logp, *value, *reward, *done, *stream;
};

// Launches the instantiation of (per agent, kImage, kChunk, message width);
// the chunked instantiations are per agent only (the plan's rule).
template <bool kPerAgent, bool kImage, bool kChunk>
static int launch_collect_gru(const EnvDims& d, const GruCollectDims& m, const GruCollectPlan& p,
                              int T, int B, const GruCollectArgs& a) {
  static_assert(RW_MAX_M == 8, "one instantiation per message width");
  static_assert(kPerAgent || !kChunk, "the chunked route is per agent only");
  using Kernel = decltype(&fused_collect_gru_kernel<0, kPerAgent, kImage, kChunk>);
  const Kernel widths[RW_MAX_M + 1] = {
      fused_collect_gru_kernel<0, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<1, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<2, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<3, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<4, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<5, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<6, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<7, kPerAgent, kImage, kChunk>,
      fused_collect_gru_kernel<8, kPerAgent, kImage, kChunk>};
  const Kernel kernel = widths[d.m];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.end);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               p.carveout);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.te - 1) / p.te;
  kernel<<<blocks, p.threads, p.end, (cudaStream_t)a.stream>>>(
      d, m, p, T, B, (const int*)a.layout, (const int*)a.state_in, (int*)a.state_out,
      (const __nv_bfloat16*)a.we, (const float*)a.be, (const __nv_bfloat16*)a.wi,
      (const float*)a.bi, (const __nv_bfloat16*)a.wh, (const float*)a.bhn, (const float*)a.wc,
      (const float*)a.bc, (const __nv_bfloat16*)a.h0, (__nv_bfloat16*)a.new_h,
      (__nv_bfloat16*)a.obs, (int*)a.action, (int*)a.bits, (float*)a.logp, (float*)a.value,
      (float*)a.reward, (uint8_t*)a.done);
  return (int)cudaGetLastError();
}

// The launchers of the instantiations built in the other translation units:
// K2c FLATTENED (fused_collect_gru_one_stack.cu), K2d′ and K2c on images
// (fused_collect_gru_image.cu, fused_collect_gru_image_one_stack.cu), and the
// chunked ones (fused_collect_gru_chunked.cu, FLATTENED and image).
int launch_collect_gru_one_stack(const EnvDims& d, const GruCollectDims& m,
                                 const GruCollectPlan& p, int T, int B, const GruCollectArgs& a);
int launch_collect_gru_image_one_stack(const EnvDims& d, const GruCollectDims& m,
                                       const GruCollectPlan& p, int T, int B,
                                       const GruCollectArgs& a);
int launch_collect_gru_image(const EnvDims& d, const GruCollectDims& m, const GruCollectPlan& p,
                             int T, int B, const GruCollectArgs& a);
int launch_collect_gru_chunked(const EnvDims& d, const GruCollectDims& m,
                               const GruCollectPlan& p, int T, int B, const GruCollectArgs& a);
int launch_collect_gru_chunked_image(const EnvDims& d, const GruCollectDims& m,
                                     const GruCollectPlan& p, int T, int B,
                                     const GruCollectArgs& a);
