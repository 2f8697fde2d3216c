// K2a and K2d: the fused MLP-policy collector — per step: FLATTENED or image
// observation, ActorCritic forward, Gumbel-argmax sample, env step, autoreset;
// the trajectory (obs bf16, action, logp, value, reward, done) is streamed out.
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_collect in modes
// policy="mlp" (K2a: one network shared by all agents; _policy_forward) and
// policy="mlp_per_agent" (K2d: agent i runs its own network i;
// _policy_forward_per_agent), FLATTENED observations (kernel body
// _make_collect_kernel; _build_obs_feats, _sample_gumbel).  K2a carries the
// message mode K2b (msg_bits M > 0, pallas_rollout.py:1537-1562, 1689-1734):
// a float32 message head (M, H2) beside the policy and value heads; M
// Bernoulli bits per agent-step (sample_bernoulli) whose log-probability
// joins the Gumbel move's; the bits stream out as a (T, B, N, M) trajectory
// tensor and become the agents' messages, cleared where an episode ends.  K2d
// carries it too (SEAC-PPO with message bits, pallas_rollout.py:1944-1947):
// agent i's message head is stack i's.  Image observations (K2e, IMAGE and
// IMAGE_DICT; _build_image_feats, pallas_rollout.py:1109) write the rotated
// C x w x w window (+ 6 self rows) through collect_core.cuh::
// build_image_obs_from_view.
// Each mode is its own template instantiation (kGlobal, kMsg, kImage, kChunk), so the
// paths without it compile to code without it.
//
// Design.  A block holds a tile of TE envs (ops/fused_rollout.py::
// collect_plan: 64 at tiny-2ag, 256 blocks for B=16,384, two an SM) and has
// more threads than rows.  Its N * TE (env, agent) rows run as one batch,
// agent-major (row i * TE + e), as the TPU kernel feeds its whole feature
// tile to one MXU product (_policy_forward):
//  - the env step stays one thread per env (threads 0 .. TE-1), as integer
//    work on the env's EnvState in local memory, as in K1; after each step
//    the env thread writes a compact view of the state (agents, messages,
//    queue, shelf cells; collect_core.cuh::write_obs_view) to shared memory;
//  - one thread per (env, agent) row builds its observation from that view
//    (build_row_obs, the FLATTENED or image row bit for bit as the plain
//    version gives it) into a feature-major bf16 tile;
//  - the two hidden layers are a block product on the FP32 pipes: each
//    thread owns 8 rows x 8 outputs of one weight stack in registers and runs
//    k ascending, reading 8 rows of the tile and the 8 outputs of weight row
//    k as one 16-byte load each (64 FMAs a pair of loads).  dense_0 and
//    dense_1 are bf16 (in, out) matrices, resident in shared memory (copied
//    once a block with cp.async) where every stack fits, else (kGlobal: K2d
//    with 4 or more agents at hidden (128, 128), K2a at sensor range 4 and 5)
//    read through the read-only cache, 16 bytes a load shared by the
//    thread's 8 rows.  Each layer keeps its sums in registers over a
//    barrier, so h1 is written over the observation tile and h2 over h1
//    (where the plan gives one register tile a thread);
//  - the heads (A policy rows, the value row, M message rows: f32 weights)
//    are jobs of 4 rows x 1 head row spread over the threads, so the message
//    rows no longer run on one thread; each row's outputs go to a record of
//    its own, which sampling, the env step and the stores then reuse;
//  - sampling runs one thread per row (sample_gumbel, sample_bernoulli, with
//    the same Philox purposes and slots);
//  - the step's rows of obs (while dense_0 sums, before h1 goes over them),
//    action, bits, logp and value (while the env threads step), reward and
//    done (while the next observations are built) are each contiguous in
//    (T, B, N, ...) for the tile, and are written from shared memory as
//    16-byte vectors with neighbouring threads on neighbouring addresses, the
//    ragged last tile masked.
// Where a block cannot hold the tile's whole observation rows (K2d's smallest
// tile is 8 N rows: at 17 agents and sensor range 5, L = 855, the tile alone
// is 232,560 bytes), the chunked route (kChunk, its instantiations built in
// fused_collect_chunked.cu) keeps kx features of the tile (dense0_chunked):
// the rows build each chunk from their env's view (collect_core.cuh::
// build_row_chunk), the block stores it to the trajectory and sums it into
// registers that stay there from the first chunk to the last, so each sum is
// the same FMA chain.  Rebuilding a chunk from the view rescans the agents and
// shelves a chunk; reading the rows back from the trajectory, which the kernel
// writes anyway, would take a row's unaligned L * 2 bytes through L2 a chunk.
// The launch plan (tile, threads, route, chunk, every shared-memory offset)
// comes from collect_plan; collect_plan_ok refuses a plan whose regions do not
// hold what this kernel reads and writes there.
//
// Numerics follow the Pallas recipe: bf16 inputs and weights, f32 sums, the
// f32 bias added, rounded to bf16, tanh of that value rounded to bf16; the
// f32 heads read the bf16 hidden.  Sums run over the input features in
// ascending order, the order of rware_tpu_torch/models/networks.py::
// ordered_linear, so the plain version reproduces the kernel bit for bit on
// the card.  In the hidden layers both operands are bf16 values: their
// product has at most 16 significant bits and is exact in f32 (unless it
// falls below 2^-133), so __fmaf_rn(x, w, acc) equals ordered_linear's
// separately rounded __fadd_rn(acc, __fmul_rn(x, w)) bit for bit.  The heads
// multiply bf16 h2 by f32 weights, whose products are not exact: they keep
// separate __fmul_rn / __fadd_rn (nvcc would otherwise contract a * b + c).
// No product goes to the tensor cores: mma sums 16 products in one step with
// its own alignment and rounding, a last-bit difference in a pre-activation
// can move a bf16 hidden unit, flip a Gumbel argmax near a tie and, fed back,
// the env's trajectory.  No float atomics: two launches are bit-equal.
//
// Bound on the card: the policy's products.  At tiny-2ag, hidden (128, 128),
// 25,472 hidden FMAs and 768 head multiply-adds an agent-step, on the FP32
// pipes (the bit-exact contract keeps them off the tensor cores); the
// trajectory writes (about 300 bytes an env-step at tiny-2ag) are the
// device-memory traffic.
#pragma once

#include <cstring>

#include "collect_core.cuh"

#define RW_COLLECT_MAX_THREADS 512
#define RW_COLLECT_SMEM_LIMIT 232448

// Phase counters for tools/collect_phase_profile.py, which defines these in a
// patched copy: start, the end of phase i of a step (after its barrier), the
// kernel's end.  Compiled to nothing here.
#ifndef RW_COLLECT_MARK
#define RW_COLLECT_MARK_INIT
#define RW_COLLECT_MARK(i)
#define RW_COLLECT_MARK_END
#endif

struct MlpDims {
  int L, H1, H2, A;
  int deterministic;
  int n_stacks;  // weight stacks: 1 (K2a, shared) or N (K2d, agent i runs stack i)
  int M;         // message bits per agent (K2b), 0 without the message head
  ObsDims obs;
};

// One block's launch plan, in the order of ops/fused_rollout.py::CollectPlan.args:
// te envs a block, threads, rows (N * te padded to 8), rs (row stride of the
// feature-major tiles), hrs (words of a row's record), vs (words of an env's
// view, write_obs_view), the weight route, the shared-memory carve-out
// (percent) to ask for, kx (observation features a chunk of the tile holds; 0:
// the whole row), then the byte offsets of the shared-memory regions and their
// end.  An empty x region puts the observation tile at the start of h (h1 over
// it), an empty h2 region h2 over h1: each where every 8 x 8 job of that layer
// has a thread of its own.  With kx > 0 the x region holds a chunk of kx
// features beside h, and every job of dense_0 has a thread of its own.
struct CollectPlan {
  int te, threads, rows, rs, hrs, vs, weights_global, carveout, kx;
  int w0, w1, wp, wv, wm, b0, b1, bp, bv, bm, x, h, h2, out, view, done, end;
};
#define RW_COLLECT_REGIONS 16

// True when every region of `p` holds what the kernel keeps there and the
// tile is one the kernel takes.
static bool collect_plan_ok(const CollectPlan& p, const MlpDims& m, const EnvDims& d) {
  const int N = d.n;
  const long ws = p.weights_global ? 0 : m.n_stacks, L = m.L, H1 = m.H1, H2 = m.H2, A = m.A,
             M = m.M, rs = p.rs, rows = p.rows, jobs0 = rows / 8 * (H1 / 8),
             jobs1 = rows / 8 * (H2 / 8);
  const bool x_in_h = p.x == p.h, h2_in_h = p.h2 == p.out, chunked = p.kx != 0;
  long h_rows = H1;
  if (x_in_h && L > h_rows) h_rows = L;
  if (h2_in_h && H2 > h_rows) h_rows = H2;
  const long need[RW_COLLECT_REGIONS] = {
      ws * L * H1 * 2, ws * H1 * H2 * 2, ws * A * H2 * 4,  ws * H2 * 4, ws * M * H2 * 4,
      ws * H1 * 4,     ws * H2 * 4,      ws * A * 4,       ws * 4,      ws * M * 4,
      chunked ? p.kx * rs * 2 : x_in_h ? 0 : L * rs * 2, h_rows * rs * 2,
      h2_in_h ? 0 : H2 * rs * 2,
      rows * p.hrs * 4, (long)p.te * p.vs * 4, p.te};
  const int* off = &p.w0;
  if (off[0] != 0) return false;
  for (int k = 0; k < RW_COLLECT_REGIONS; ++k)
    if (off[k] % 16 || (long)off[k + 1] - off[k] < need[k]) return false;
  return p.te >= 1 && rows % 8 == 0 && rows >= (long)N * p.te && rs >= rows && rs % 8 == 0 &&
         A >= 3 && p.hrs >= A + 1 + M && p.vs >= 2 * N + N * M + d.r + d.s &&
         (long)d.h * d.w <= 65536 && p.threads % 32 == 0 &&
         p.threads <= RW_COLLECT_MAX_THREADS && p.threads >= rows + 32 &&
         (!x_in_h || p.threads >= jobs0) && (!h2_in_h || p.threads >= jobs1) &&
         (m.n_stacks == 1 || p.te % 8 == 0) && p.carveout >= 0 && p.carveout <= 100 &&
         p.end <= RW_COLLECT_SMEM_LIMIT &&
         // a chunk: whole 16-byte runs of features, the weights in device
         // memory (the chunked instantiations), a thread for every job of dense_0
         (!chunked || (p.kx > 0 && p.kx % 8 == 0 && !x_in_h && p.weights_global &&
                       p.threads >= jobs0));
}

static __device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory by cp.async; the caller waits with cp.async.wait_all.
static __device__ __forceinline__ void copy_async(void* dst, const void* src, size_t bytes,
                                                  int tid, int nt) {
  for (size_t o = (size_t)tid * 16; o < bytes; o += (size_t)nt * 16)
    cp_async16((char*)dst + o, (const char*)src + o);
}

template <bool kGlobal>
static __device__ __forceinline__ float load_f(const float* p) {
  return kGlobal ? __ldg(p) : *p;
}

// One hidden layer on the tile: dst[j][r] = bf16(tanh(bf16(sum_k src[k][r] *
// W[k][j] + bias[j]))) for the plan's rows r, k ascending, an FMA a term.
// src and dst are feature-major bf16 tiles of row stride rs; W is the
// stacks' (in, out) bf16 matrices back to back (K * H apart), bias their f32
// biases (H apart); the stack of an 8-row group is its agent's where there
// are several (te rows an agent).  Each job is 8 rows x 8 outputs in
// registers.  Every thread calls before_write() once the tile's products are
// summed, and the results are written after a barrier of the block, so dst
// may overlap src where the plan gives at most one job a thread.
template <bool kGlobal, typename Hook>
static __device__ __forceinline__ void dense_tanh(const __nv_bfloat16* src, int K,
                                                  const __nv_bfloat16* W, const float* bias,
                                                  int H, __nv_bfloat16* dst, int rows, int rs,
                                                  int te, int n_stacks, int tid, int nt,
                                                  Hook before_write) {
  const int NR = rows / 8, jobs = NR * (H / 8);
  for (int job0 = 0; job0 < jobs; job0 += nt) {
    const int job = job0 + tid;
    const bool active = job < jobs;
    const int rg = active ? job % NR : 0, jg = active ? job / NR : 0;
    const int stack = n_stacks > 1 ? rg * 8 / te : 0;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    if (active) {
      const __nv_bfloat16* xp = src + rg * 8;
      const __nv_bfloat16* wp = W + (size_t)stack * K * H + jg * 8;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xp + (size_t)k * rs);
        const uint4 wv = kGlobal ? __ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * H))
                                 : *reinterpret_cast<const uint4*>(wp + (size_t)k * H);
        float x[8], w[8];
        unpack8(xv, x);
        unpack8(wv, w);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = __fmaf_rn(x[a], w[b], acc[a][b]);
      }
    }
    if (job0 == 0) before_write();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = jg * 8 + b;
        const float bj = load_f<kGlobal>(bias + stack * H + j);
        float h[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) h[a] = tanhf(bf16_round(__fadd_rn(acc[a][b], bj)));
        *reinterpret_cast<uint4*>(dst + (size_t)j * rs + rg * 8) =
            make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]), pack2(h[6], h[7]));
      }
    }
  }
}

// dense_0 with the observation tile in chunks (the chunked route, kx > 0):
// for each chunk of kx features in ascending k, a thread a row builds its
// row's features of the chunk from its env's view (build_row_chunk), the
// block stores them to the trajectory's obs, and each job (8 rows x 8
// outputs; one a thread, the plan's rule) carries its sums in registers on
// to the next chunk.  Every sum stays one FMA chain from k = 0 to L - 1, as in
// dense_tanh, so the result is the same bit for bit.  h1 goes to hs, its own
// region.
template <bool kMsg, bool kImage>
static __device__ __forceinline__ void dense0_chunked(
    const int* views, const EnvDims& d, const EnvLayout& lay, const MlpDims& m,
    const CollectPlan& p, int TEv, const __nv_bfloat16* W, const float* bias,
    __nv_bfloat16* xs, __nv_bfloat16* hs, unsigned short* obs_rows, int tid, int nt) {
  const int L = m.L, H = m.H1, N = d.n, TE = p.te, R = p.rows, RS = p.rs, KX = p.kx;
  const int NR = R / 8, jobs = NR * (H / 8);
  const bool active = tid < jobs;
  const int rg = active ? tid % NR : 0, jg = active ? tid / NR : 0;
  const int stack = m.n_stacks > 1 ? rg * 8 / TE : 0;
  const __nv_bfloat16* xp = xs + rg * 8;
  const __nv_bfloat16* wp = W + (size_t)stack * L * H + jg * 8;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < L; k0 += KX) {
    const int kn = min(KX, L - k0);
    if (tid < R) {
      const int e = tid % TE, i = tid / TE;
      build_row_chunk<kMsg, kImage>(views + e * p.vs, d, lay, m.obs, i, i >= N || e >= TEv, xs,
                                    RS, tid, k0, kn);
    }
    __syncthreads();
    store_chunk_rows(obs_rows, L, k0, kn, reinterpret_cast<const unsigned short*>(xs), RS, 0, R,
                     N, TE, TEv, tid, nt);
    if (active) {
#pragma unroll 2
      for (int k = 0; k < kn; ++k) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xp + (size_t)k * RS);
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k0 + k) * H));
        float x[8], w[8];
        unpack8(xv, x);
        unpack8(wv, w);
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = __fmaf_rn(x[a], w[b], acc[a][b]);
      }
    }
    __syncthreads();  // the chunk's readers are done before the next is built
  }
  if (active) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = jg * 8 + b;
      const float bj = __ldg(bias + stack * H + j);
      float h[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) h[a] = tanhf(bf16_round(__fadd_rn(acc[a][b], bj)));
      *reinterpret_cast<uint4*>(hs + (size_t)j * RS + rg * 8) =
          make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]), pack2(h[6], h[7]));
    }
  }
}

// kChunk: the chunked route (kx > 0; the weights in device memory, kGlobal).
template <bool kGlobal, bool kMsg, bool kImage, bool kChunk>
__global__ void __launch_bounds__(RW_COLLECT_MAX_THREADS)
    fused_collect_kernel(EnvDims d, MlpDims m, CollectPlan p, int T, int B,
                         const int* __restrict__ layout, const int* __restrict__ state_in,
                         int* __restrict__ state_out, const __nv_bfloat16* __restrict__ w0,
                         const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ wp,
                         const float* __restrict__ bp, const float* __restrict__ wv,
                         const float* __restrict__ bv, const float* __restrict__ wm,
                         const float* __restrict__ bm, __nv_bfloat16* __restrict__ obs,
                         int* __restrict__ action, int* __restrict__ bits_out,
                         float* __restrict__ logp, float* __restrict__ value,
                         float* __restrict__ reward, uint8_t* __restrict__ done_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = m.L, H1 = m.H1, H2 = m.H2, A = m.A, M = kMsg ? m.M : 0, N = d.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TE = p.te, R = p.rows, RS = p.rs, HRS = p.hrs, VS = p.vs, NS = m.n_stacks;
  const int e0 = blockIdx.x * TE, TEv = min(TE, B - e0);
  const int WS = kGlobal ? 0 : NS;  // stacks held in shared memory

  __nv_bfloat16* const sw0 = (__nv_bfloat16*)(smem + p.w0);
  __nv_bfloat16* const sw1 = (__nv_bfloat16*)(smem + p.w1);
  float* const swp = (float*)(smem + p.wp);
  float* const swv = (float*)(smem + p.wv);
  float* const swm = (float*)(smem + p.wm);
  float* const sb0 = (float*)(smem + p.b0);
  float* const sb1 = (float*)(smem + p.b1);
  float* const sbp = (float*)(smem + p.bp);
  float* const sbv = (float*)(smem + p.bv);
  float* const sbm = (float*)(smem + p.bm);
  // The tiles, feature-major (., RS): the observations, h1 (over them where
  // the x region is empty), h2 (over h1 where h2 is empty).
  __nv_bfloat16* const hs = (__nv_bfloat16*)(smem + p.h);
  __nv_bfloat16* const xs = (__nv_bfloat16*)(smem + p.x);
  __nv_bfloat16* const h2s = p.h2 == p.out ? hs : (__nv_bfloat16*)(smem + p.h2);
  // A row's record (HRS words): the A logits, the value at A, the M message
  // logits after it; once sampled, the action (int) at 0, logp at 1, after
  // the env step the reward at 2, and the bits (int) over the message logits.
  float* const outs = (float*)(smem + p.out);
  int* const outi = (int*)(smem + p.out);
  int* const views = (int*)(smem + p.view);  // env e0 + e's view at e * VS
  uint8_t* const dones = smem + p.done;
  const uint32_t wmagic = 0xFFFFFFFFu / (uint32_t)d.w + 1u;  // ceil(2^32 / W)
  const bool stepper = tid < TEv;  // this thread owns env e0 + tid
  const EnvLayout lay = make_layout(d, layout);
  EnvState st;
  if (stepper) {
    load_state(st, d, state_in, e0 + tid, B);
    write_obs_view<kMsg>(st, d, wmagic, views + tid * VS);
  }

  if (!kGlobal) {
    copy_async(sw0, w0, (size_t)WS * L * H1 * 2, tid, nt);
    copy_async(sw1, w1, (size_t)WS * H1 * H2 * 2, tid, nt);
    for (int k = tid; k < WS * A * H2; k += nt) swp[k] = wp[k];
    for (int k = tid; k < WS * H2; k += nt) swv[k] = wv[k];
    for (int k = tid; k < WS * M * H2; k += nt) swm[k] = wm[k];
    for (int k = tid; k < WS * H1; k += nt) sb0[k] = b0[k];
    for (int k = tid; k < WS * H2; k += nt) sb1[k] = b1[k];
    for (int k = tid; k < WS * A; k += nt) sbp[k] = bp[k];
    for (int k = tid; k < WS; k += nt) sbv[k] = bv[k];
    for (int k = tid; k < WS * M; k += nt) sbm[k] = bm[k];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  const __nv_bfloat16* W0 = kGlobal ? w0 : sw0;
  const __nv_bfloat16* W1 = kGlobal ? w1 : sw1;
  const float* B0 = kGlobal ? b0 : sb0;
  const float* B1 = kGlobal ? b1 : sb1;
  const float* WP = kGlobal ? wp : swp;
  const float* BP = kGlobal ? bp : sbp;
  const float* WV = kGlobal ? wv : swv;
  const float* BV = kGlobal ? bv : sbv;
  const float* WM = kGlobal ? wm : swm;
  const float* BM = kGlobal ? bm : sbm;
  const int HR = A + 1 + M, NQ = R / 4;
  RW_COLLECT_MARK_INIT;

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
    // (rows of no env, past B or padding, zero; chunked: in dense_0) | step
    // t-1's rewards, done
    if (tid < R) {
      const int e = tid % TE, i = tid / TE;
      if (!kChunk && i < N && e < TEv)
        build_row_obs<kMsg, kImage>(views + e * VS, d, lay, m.obs, i, xs, RS, tid);
      else if (!kChunk)
        for (int c = 0; c < L; ++c) xs[(size_t)c * RS + tid] = __float2bfloat16_rn(0.f);
    } else if (t > 0) {
      store_rewards(t - 1);
    }
    __syncthreads();
    RW_COLLECT_MARK(0);
    // ---- dense_0 + tanh -> h1; before h1 goes over the tile, its obs out
    if (kChunk) {
      dense0_chunked<kMsg, kImage>(
          views, d, lay, m, p, TEv, W0, B0, xs, hs,
          reinterpret_cast<unsigned short*>(obs) + ((size_t)t * B + e0) * N * L, tid, nt);
    } else {
      dense_tanh<kGlobal>(xs, L, W0, B0, H1, hs, R, RS, TE, NS, tid, nt, [&] {
        const size_t row0 = ((size_t)t * B + e0) * N;
        store_span(reinterpret_cast<unsigned short*>(obs) + row0 * L, TEv * N * L, tid, nt,
                   TileRowRun{reinterpret_cast<const unsigned short*>(xs), RS, L, N, TE});
      });
    }
    __syncthreads();
    RW_COLLECT_MARK(1);
    // ---- dense_1 + tanh -> h2 (over h1, or beside it)
    dense_tanh<kGlobal>(hs, H1, W1, B1, H2, h2s, R, RS, TE, NS, tid, nt, [] {});
    __syncthreads();
    RW_COLLECT_MARK(2);
    // ---- heads: 4 rows x 1 head row a job, f32, h2 ascending, then the bias
    for (int job = tid; job < NQ * HR; job += nt) {
      const int r0 = (job % NQ) * 4, hr = job / NQ;
      const int s = NS > 1 ? r0 / TE : 0;
      const float* w;
      float bias;
      if (hr < A) {
        w = WP + (size_t)(s * A + hr) * H2;
        bias = load_f<kGlobal>(BP + s * A + hr);
      } else if (hr == A) {
        w = WV + (size_t)s * H2;
        bias = load_f<kGlobal>(BV + s);
      } else {
        w = WM + (size_t)(s * M + hr - A - 1) * H2;
        bias = load_f<kGlobal>(BM + s * M + hr - A - 1);
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < H2; ++c) {
        const uint2 hv = *reinterpret_cast<const uint2*>(h2s + (size_t)c * RS + r0);
        const float wk = load_f<kGlobal>(w + c);
        const float h[4] = {__uint_as_float(hv.x << 16), __uint_as_float(hv.x & 0xFFFF0000u),
                            __uint_as_float(hv.y << 16), __uint_as_float(hv.y & 0xFFFF0000u)};
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] = __fadd_rn(acc[a], __fmul_rn(h[a], wk));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) outs[(r0 + a) * HRS + hr] = __fadd_rn(acc[a], bias);
    }
    __syncthreads();
    RW_COLLECT_MARK(3);
    // ---- sampling, one thread a row
    if (tid < N * TE && tid % TE < TEv) {
      const int r = tid, e = r % TE, i = r / TE;
      float lg[RW_MAX_A], lp;
      for (int a = 0; a < A; ++a) lg[a] = outs[r * HRS + a];
      const int act = sample_gumbel(lg, A, m.deterministic, d, e0 + e, t, i, &lp);
      if (kMsg) {
        float ml[RW_MAX_M];
        int bit[RW_MAX_M];
        for (int c = 0; c < M; ++c) ml[c] = outs[r * HRS + A + 1 + c];
        lp = __fadd_rn(lp, sample_bernoulli(ml, M, m.deterministic, d, e0 + e, t, i, bit));
        for (int c = 0; c < M; ++c) outi[r * HRS + A + 1 + c] = bit[c];
      }
      outi[r * HRS] = act;
      outs[r * HRS + 1] = lp;
    }
    __syncthreads();
    RW_COLLECT_MARK(4);
    // ---- env step (env threads) | step t's action, bits, logp, value
    if (tid < TE) {
      if (stepper) {
        int a_[RW_MAX_N];
        float rew[RW_MAX_N];
        for (int i = 0; i < N; ++i) a_[i] = outi[(i * TE + tid) * HRS];
        if (kMsg)
          for (int i = 0; i < N; ++i)
            for (int c = 0; c < M; ++c) st.msg[i * M + c] = outi[(i * TE + tid) * HRS + A + 1 + c];
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
        store_span(bits_out + row0 * M, TEv * N * M, lane, lanes,
                   RowRun<int>{outi + A + 1, HRS, M, N, TE});
    }
    __syncthreads();
    RW_COLLECT_MARK(5);
  }
  if (tid >= R) store_rewards(T - 1);
  if (stepper) store_state(st, d, state_out, e0 + tid, B);
  RW_COLLECT_MARK_END;
}

// The launch arguments of one collector call besides its dimensions.
struct CollectArgs {
  const void *layout, *state_in;
  void* state_out;
  const void *w0, *b0, *w1, *b1, *wp, *bp, *wv, *bv, *wm, *bm;
  void *obs, *action, *bits, *logp, *value, *reward, *done, *stream;
};

// Launches `kernel` on the plan's grid.
template <typename Kernel>
static int launch_collect(Kernel kernel, const EnvDims& d, const MlpDims& m, const CollectPlan& p,
                          int T, int B, const CollectArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.end);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               p.carveout);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.te - 1) / p.te;
  kernel<<<blocks, p.threads, p.end, (cudaStream_t)a.stream>>>(
      d, m, p, T, B, (const int*)a.layout, (const int*)a.state_in, (int*)a.state_out,
      (const __nv_bfloat16*)a.w0, (const float*)a.b0, (const __nv_bfloat16*)a.w1,
      (const float*)a.b1, (const float*)a.wp, (const float*)a.bp, (const float*)a.wv,
      (const float*)a.bv, (const float*)a.wm, (const float*)a.bm, (__nv_bfloat16*)a.obs,
      (int*)a.action, (int*)a.bits, (float*)a.logp, (float*)a.value, (float*)a.reward,
      (uint8_t*)a.done);
  return (int)cudaGetLastError();
}

// The chunked instantiations' launcher (fused_collect_chunked.cu).
int launch_collect_chunked(const EnvDims& d, const MlpDims& m, const CollectPlan& p, int T,
                           int B, const CollectArgs& a);
