// K1: the fused rollout kernel — T env steps per launch, random or scripted
// actions, autoreset, per-agent reward sums and episode counts.  With message
// bits (M > 0) each step also sets every agent's M message bits: from the
// action columns 1..M in scripted mode, else rand_mod(draw, 2) of Philox
// purpose MESSAGE, slot i * M + m; they are cleared where an episode ends
// (pallas_rollout.py:531-642).
//
// Replaces rware_tpu/ops/pallas_rollout.py::build_pallas_rollout (kernel
// body _make_kernel, core _env_step_core).  One thread per env, a tile of
// envs a block, the env's state on the card for all T steps: device memory is
// read once (packed state, scripted actions) and written once per launch.
// The packed state is (ROWS, B) int32 with the env index minor, so a warp's
// loads and stores of one row are coalesced; the wrapper
// (rware_tpu_torch/ops/fused_rollout.py) transposes from and to the public
// (B, ...) layout.  B need not be a multiple of the block: the tail masks.
//
// Bound on the card: the env step's integer work and the latency of its
// chains of dependent loads, at one thread an env (B = 65,536 gives 15.5
// warps an SM); device memory is touched inside the time loop only for
// scripted actions.  The design keeps those chains short:
// - the map routes keep each env compact (RolloutEnv): an agent in two words
//   (x | y << 16; dir | delivered << 2 | (carried + 1) << 3), the reward sums,
//   the queue, the two counters and a map from cell to shelf id + 1 (uint8,
//   or uint16 from 255 shelves), so "the shelf at a cell" is one load, not an
//   O(S) scan.  Word k of env e sits at k * stride + e: in shared memory, a
//   tile of envs a block (the shared route; stride = the tile, so a warp's 32
//   envs fall on 32 banks, map lookups included), or in device memory for a
//   batch that would take more than two waves of tiles (the global route;
//   stride = B rounded up to 32).  No shelf-cell list is kept: a carried shelf stands on
//   its carrier's cell, and the store writes the shelves back from the map.
// - the collision resolver runs on bitmasks in registers up to 16 agents
//   (env_core.cuh, resolve_moves_masks): its local arrays' dependent loads
//   were 37-76% of a step once the scans were gone.
// - up to 8 agents (a uint8 map) a kernel is built for each count, so the
//   step's loops unroll and its per-agent arrays stay in registers.
// - the messages are not kept at all: every step sets every agent's bits and
//   nothing reads them, so the last step's bits (zero where it ended an
//   episode) are drawn, or read, once at the end.
// - one Philox call gives four draw slots (ceil(N / 4) calls for the moves).
// A grid whose compact env does not fit a tile of 32 in shared memory keeps
// the env in local memory with scans for lookups and the resolver on local
// arrays (the scan route, EnvState: the one-thread-an-env kernel before this
// one).  ops/fused_rollout.
// rollout_plan picks the route and tile; rollout_plan_ok refuses a plan whose
// regions do not hold what the kernel keeps there.  Scripted actions are
// (T, N, 1 + M, B): agent i's move in column 0, its bits after.
#include <cstring>

#include "env_core.cuh"

// Phase marks, empty here: tools/collect_phase_profile.py --rollout defines
// them in a copy (0 draws, 1-5 env_step's, 6 state load and store).
#ifndef RW_ROLLOUT_MARK
#define RW_ROLLOUT_MARK_INIT
#define RW_ROLLOUT_MARK(i)
#define RW_ROLLOUT_MARK_END
#endif

// ops/fused_rollout.ROLLOUT_ROUTES
enum { RW_ROUTE_SHARED = 0, RW_ROUTE_GLOBAL = 1, RW_ROUTE_SCAN = 2 };

// ops/fused_rollout.RolloutPlan.args: the route, envs (threads) a block, the
// bytes of a map entry, the words between two rows of an env, the carve-out,
// and the first row of each region of the compact env (agents 2N, reward
// sums N, queue R, counters 2, map), then the end.
struct RolloutPlan {
  int route, te, map_bytes, stride, carveout;
  int agents, reward, queue, count, map, end;
};

// Four draw slots of one Philox call: slots 4 * group .. 4 * group + 3.
static __device__ __forceinline__ uint4 draw4(const EnvDims& d, uint32_t env, uint32_t step,
                                              uint32_t purpose, uint32_t group) {
  if (d.scripted) return make_uint4(0u, 0u, 0u, 0u);
  return philox4x32_10(make_uint4(d.env_offset + env, step, purpose, group), d.seed_lo,
                       d.seed_hi);
}

// The compact env of the map routes (see the head of the file); kBig: more
// than 8 agents (a kernel of its own, so that the larger resolver's registers
// do not spill in the others); kN: the agents, where a kernel is built for
// that count (0: any), so that the step's loops unroll and its per-agent
// arrays stay in registers.
template <typename MapT, bool kShared, bool kBig, int kN = 0>
struct RolloutEnv {
  static constexpr int kPer = 4 / (int)sizeof(MapT);  // map entries a word
  static constexpr bool kOwnResolver = true;
  static __device__ __forceinline__ int n_agents(const EnvDims& d) { return kN ? kN : d.n; }
  // rew[aid] += r, by compare-selects where the count is known (a dynamic
  // index would put rew in local memory).
  static __device__ __forceinline__ void credit(float* rew, int, int aid, float r) {
    if constexpr (kN > 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) rew[i] = i == aid ? rew[i] + r : rew[i];
    } else {
      rew[aid] += r;
    }
  }
  int* w;      // this env's word of row 0; row k at w[k * ts]
  int ts;
  int ra, rr, rq, rc, rm, map_words;

  __device__ __forceinline__ RolloutEnv(const RolloutPlan& p, const EnvDims& d, int* smem,
                                        int* scratch, int e)
      : w(kShared ? smem + threadIdx.x : scratch + e), ts(p.stride), ra(p.agents),
        rr(p.reward), rq(p.queue), rc(p.count), rm(p.map),
        map_words((d.h * d.w + kPer - 1) / kPer) {}

  __device__ __forceinline__ int& row(int k) const { return w[k * ts]; }
  __device__ __forceinline__ MapT& cell(int c) const {
    return reinterpret_cast<MapT*>(&row(rm + c / kPer))[c % kPer];
  }

  __device__ __forceinline__ int agent_x(int i) const { return row(ra + 2 * i) & 0xFFFF; }
  __device__ __forceinline__ int agent_y(int i) const {
    return (int)((uint32_t)row(ra + 2 * i) >> 16);
  }
  __device__ __forceinline__ int agent_dir(int i) const { return row(ra + 2 * i + 1) & 3; }
  __device__ __forceinline__ int delivered(int i) const { return (row(ra + 2 * i + 1) >> 2) & 1; }
  __device__ __forceinline__ int carried(int i) const { return (row(ra + 2 * i + 1) >> 3) - 1; }
  __device__ __forceinline__ void move_to(int i, int x, int y) {
    row(ra + 2 * i) = (int)((uint32_t)x | ((uint32_t)y << 16));
  }
  __device__ __forceinline__ void turn(int i, int dir) {
    int& v = row(ra + 2 * i + 1);
    v = (v & ~3) | dir;
  }
  __device__ __forceinline__ void set_carried(int i, int s) {
    int& v = row(ra + 2 * i + 1);
    v = (v & 7) | ((s + 1) << 3);
  }
  __device__ __forceinline__ void set_delivered(int i, int h) {
    int& v = row(ra + 2 * i + 1);
    v = (v & ~4) | (h ? 4 : 0);
  }
  __device__ __forceinline__ void any_shelf_at(int, const int& c, bool& at) const {
    at |= cell(c) != 0;
  }
  __device__ __forceinline__ void shelf_at(int, const int& c, int& sid) const {
    const int s = (int)cell(c) - 1;
    if (s >= 0) sid = s;
  }
  // The moving carried shelves leave their carriers' old cells first, then
  // take the new ones: in a chain a shelf enters the cell another leaves.
  __device__ __forceinline__ void carry_shelves(int N, int W, const bool* moved,
                                                const int* acell) {
    for (int i = 0; i < N; ++i)
      if (moved[i] && carried(i) >= 0) cell(acell[i]) = 0;
    for (int i = 0; i < N; ++i)
      if (moved[i] && carried(i) >= 0) cell(agent_y(i) * W + agent_x(i)) = (MapT)(carried(i) + 1);
  }
  __device__ __forceinline__ int queued(int r) const { return row(rq + r); }
  __device__ __forceinline__ void set_queued(int r, int s) { row(rq + r) = s; }
  __device__ __forceinline__ int inactive() const { return row(rc); }
  __device__ __forceinline__ int step_count() const { return row(rc + 1); }
  __device__ __forceinline__ void set_inactive(int v) { row(rc) = v; }
  __device__ __forceinline__ void set_step_count(int v) { row(rc + 1) = v; }
  __device__ __forceinline__ void reset_shelves(const EnvLayout& lay, int S, int W) {
    for (int k = 0; k < map_words; ++k) row(rm + k) = 0;
    for (int s = 0; s < S; ++s) cell(lay.slot_y[s] * W + lay.slot_x[s]) = (MapT)(s + 1);
  }
  __device__ __forceinline__ void reset_queue(const EnvDims& d, uint32_t env, uint32_t step,
                                              int slot0, int R, int S) {
    int q[RW_MAX_R];
    draw_distinct(d, env, step, slot0, R, S, q);
    for (int r = 0; r < R; ++r) row(rq + r) = q[r];
  }
  __device__ __forceinline__ void clear_msg(int) {}  // the kernel writes the last step's bits
  // The resolver in registers up to 16 agents (resolve_moves_masks), else
  // resolve_moves on local arrays.
  __device__ __forceinline__ void resolve(int n, const int* acell, const int* tcell,
                                          bool* committed) const {
    if constexpr (!kBig) {
      if (n <= 2)
        resolve_moves_masks<2>(n, acell, tcell, committed);
      else if (n <= 4)
        resolve_moves_masks<4>(n, acell, tcell, committed);
      else
        resolve_moves_masks<8>(n, acell, tcell, committed);
    } else if (n <= 16) {
      resolve_moves_masks<16>(n, acell, tcell, committed);
    } else {
      resolve_moves(n, acell, tcell, committed);
    }
  }

  __device__ __forceinline__ void add_rewards(int N, const float* rew) {
    for (int i = 0; i < N; ++i) row(rr + i) = __float_as_int(__int_as_float(row(rr + i)) + rew[i]);
  }
  __device__ __forceinline__ float reward(int i) const { return __int_as_float(row(rr + i)); }

  // The packed (ROWS, B) state in; the shelves into the map, the lowest id
  // on a cell last so that it wins, as a scan's first hit would.
  __device__ void load(const EnvDims& d, const int* __restrict__ in, int e, int B) {
    const int N = n_agents(d), S = d.s, R = d.r, W = d.w, H = d.h;
    for (int i = 0; i < N; ++i) {
      const int x = in[(size_t)i * B + e], y = in[(size_t)(N + i) * B + e];
      const int dir = in[(size_t)(2 * N + i) * B + e], c = in[(size_t)(3 * N + i) * B + e];
      const int h = in[(size_t)(4 * N + i) * B + e];
      row(ra + 2 * i) = (int)((uint32_t)x | ((uint32_t)y << 16));
      row(ra + 2 * i + 1) = dir | (h ? 4 : 0) | ((c + 1) << 3);
      row(rr + i) = 0;
    }
    for (int k = 0; k < map_words; ++k) row(rm + k) = 0;
    for (int s = S - 1; s >= 0; --s) {
      const int x = in[(size_t)(5 * N + s) * B + e], y = in[(size_t)(5 * N + S + s) * B + e];
      if (x >= 0 && x < W && y >= 0 && y < H) cell(y * W + x) = (MapT)(s + 1);
    }
    for (int r = 0; r < R; ++r) row(rq + r) = in[(size_t)(5 * N + 2 * S + r) * B + e];
    row(rc) = in[(size_t)(5 * N + 2 * S + R) * B + e];
    row(rc + 1) = in[(size_t)(5 * N + 2 * S + R + 1) * B + e];
  }

  // The packed state out but for the message rows (the kernel's).  The
  // shelves are written back from the map, over a copy of the rows that came
  // in (which only a state with two shelves on one cell would leave showing).
  __device__ void store(const EnvDims& d, int* __restrict__ out, const int* __restrict__ in,
                        int e, int B) const {
    const int N = n_agents(d), S = d.s, R = d.r, W = d.w;
    for (int i = 0; i < N; ++i) {
      out[(size_t)i * B + e] = agent_x(i);
      out[(size_t)(N + i) * B + e] = agent_y(i);
      out[(size_t)(2 * N + i) * B + e] = agent_dir(i);
      out[(size_t)(3 * N + i) * B + e] = carried(i);
      out[(size_t)(4 * N + i) * B + e] = delivered(i);
    }
    for (int k = 5 * N; k < 5 * N + 2 * S; ++k) out[(size_t)k * B + e] = in[(size_t)k * B + e];
    for (int c = 0; c < d.h * W; ++c) {
      const int s = (int)cell(c) - 1;
      if (s < 0) continue;
      out[(size_t)(5 * N + s) * B + e] = c % W;
      out[(size_t)(5 * N + S + s) * B + e] = c / W;
    }
    for (int r = 0; r < R; ++r) out[(size_t)(5 * N + 2 * S + r) * B + e] = queued(r);
    out[(size_t)(5 * N + 2 * S + R) * B + e] = inactive();
    out[(size_t)(5 * N + 2 * S + R + 1) * B + e] = step_count();
  }
};

// The scan route: the one-thread-an-env kernel's state, EnvState in local
// memory (shelf lookups by O(S) scans), for grids no map tile holds.
struct ScanEnv : EnvState {
  float acc[RW_MAX_N];

  __device__ __forceinline__ ScanEnv(const RolloutPlan&, const EnvDims&, int*, int*, int) {}
  __device__ __forceinline__ void load(const EnvDims& d, const int* __restrict__ in, int e, int B) {
    load_state(*this, d, in, e, B);
    for (int i = 0; i < d.n; ++i) acc[i] = 0.f;
  }
  __device__ __forceinline__ void store(const EnvDims& d, int* __restrict__ out, const int*,
                                        int e, int B) const {
    store_state(*this, d, out, e, B);
  }
  __device__ __forceinline__ void add_rewards(int N, const float* rew) {
    for (int i = 0; i < N; ++i) acc[i] += rew[i];
  }
  __device__ __forceinline__ float reward(int i) const { return acc[i]; }
};

// At most 128 threads a block and 128 registers a thread: four tiles of 128
// envs an SM, one wave of B = 65,536.
template <class Env>
__global__ void __launch_bounds__(128, 4)
    fused_rollout_kernel(EnvDims d, RolloutPlan p, int T, int B, const int* __restrict__ layout,
                         const int* __restrict__ state_in, int* __restrict__ state_out,
                         const int* __restrict__ actions, float* __restrict__ rewards,
                         int* __restrict__ episodes, int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int e = blockIdx.x * p.te + threadIdx.x;
  if (e >= B) return;
  RW_ROLLOUT_MARK_INIT
  const EnvLayout lay = make_layout(d, layout);
  const int N = Env::n_agents(d), M = d.m, AW = 1 + M;
  Env st(p, d, smem, scratch, e);
  st.load(d, state_in, e, B);
  RW_ROLLOUT_MARK(6)
  auto mark = [&](int k) { RW_ROLLOUT_MARK(k) };
  int epis = 0;
  bool done = false;
  int acts[RW_MAX_N];
  float rew[RW_MAX_N];
  for (int t = 0; t < T; ++t) {
    if (actions) {
      for (int i = 0; i < N; ++i) acts[i] = actions[((size_t)t * N + i) * AW * B + e];
    } else {
      for (int i0 = 0; i0 < N; i0 += 4) {
        const uint4 o = draw4(d, e, t, RW_ACTION, i0 >> 2);
        const uint32_t u[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i0 + j < N) acts[i0 + j] = rand_mod(u[j], 5);
      }
    }
    RW_ROLLOUT_MARK(0)
    done = env_step(st, acts, rew, d, lay, e, t, mark);
    st.add_rewards(N, rew);
    epis += done ? 1 : 0;
  }
  st.store(d, state_out, state_in, e, B);
  // The messages: the last step's bits, zero where it ended an episode; a
  // launch of no steps hands them on as they came.
  const size_t mrow = 5 * N + 2 * d.s + d.r + 2;
  if (T == 0) {
    for (int k = 0; k < N * M; ++k)
      state_out[(mrow + k) * B + e] = state_in[(mrow + k) * B + e];
  } else if (done) {
    for (int k = 0; k < N * M; ++k) state_out[(mrow + k) * B + e] = 0;
  } else if (actions) {
    for (int i = 0; i < N; ++i)
      for (int k = 0; k < M; ++k)
        state_out[(mrow + i * M + k) * B + e] =
            actions[(((size_t)(T - 1) * N + i) * AW + 1 + k) * B + e];
  } else {
    for (int k0 = 0; k0 < N * M; k0 += 4) {
      const uint4 o = draw4(d, e, T - 1, RW_MESSAGE, k0 >> 2);
      const uint32_t u[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < N * M) state_out[(mrow + k0 + j) * B + e] = rand_mod(u[j], 2);
    }
  }
  for (int i = 0; i < N; ++i) rewards[(size_t)i * B + e] = st.reward(i);
  episodes[e] = epis;
  RW_ROLLOUT_MARK(6)
  RW_ROLLOUT_MARK_END
}

// The kernel built for n agents (a uint8 map), 1 <= n <= 8.
template <bool kShared, int kN>
static decltype(&fused_rollout_kernel<ScanEnv>) counted_kernel(int n) {
  if constexpr (kN == 8)
    return fused_rollout_kernel<RolloutEnv<uint8_t, kShared, false, 8>>;
  else
    return n == kN ? fused_rollout_kernel<RolloutEnv<uint8_t, kShared, false, kN>>
                   : counted_kernel<kShared, kN + 1>(n);
}

// The plan's regions hold what the kernel keeps there; the tile and the
// shared memory are the launch's own.
static bool rollout_plan_ok(const RolloutPlan& p, const EnvDims& d, int B, const void* scratch) {
  if (p.te < 32 || p.te > 128 || p.te % 32 || p.carveout < 0 || p.carveout > 100) return false;
  if (p.route == RW_ROUTE_SCAN) return p.map_bytes == 0;
  if (p.route != RW_ROUTE_SHARED && p.route != RW_ROUTE_GLOBAL) return false;
  if (p.map_bytes != (d.s < 255 ? 1 : 2) || d.w > 65535 || d.h > 65535) return false;
  const long long cells = (long long)d.h * d.w, per = 4 / p.map_bytes;
  if (p.agents < 0 || p.agents + 2 * d.n > p.reward || p.reward + d.n > p.queue ||
      p.queue + d.r > p.count || p.count + 2 > p.map || p.map + (cells + per - 1) / per > p.end ||
      p.stride % 32)
    return false;
  if (p.route == RW_ROUTE_SHARED) return p.stride >= p.te && 4LL * p.end * p.stride <= 232448;
  return p.stride >= B && scratch != nullptr;
}

extern "C" int rw_fused_rollout(int n, int s, int r, int g, int h, int w, int reward_type,
                                int max_steps, int max_inactive, int m, unsigned long long seed,
                                unsigned int env_offset, int scripted, int T, int B,
                                const int* plan, int n_plan, const void* layout,
                                const void* state_in, void* state_out, const void* actions,
                                void* rewards, void* episodes, void* scratch, void* stream) {
  EnvDims d;
  d.n = n;
  d.s = s;
  d.r = r;
  d.g = g;
  d.h = h;
  d.w = w;
  d.reward_type = reward_type;
  d.max_steps = max_steps;
  d.max_inactive = max_inactive;
  d.m = m;
  d.scripted = scripted;
  d.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  d.seed_hi = (uint32_t)(seed >> 32);
  d.env_offset = env_offset;
  RolloutPlan p;
  if (n_plan * sizeof(int) != sizeof(RolloutPlan)) return (int)cudaErrorInvalidValue;
  std::memcpy(&p, plan, sizeof(RolloutPlan));
  if (n > RW_MAX_N || s > RW_MAX_S || r > RW_MAX_R || m > RW_MAX_M ||
      !rollout_plan_ok(p, d, B, scratch))
    return (int)cudaErrorInvalidValue;
  // [global route][uint16 map][more than 8 agents]
  decltype(&fused_rollout_kernel<ScanEnv>) const kernels[2][2][2] = {
      {{fused_rollout_kernel<RolloutEnv<uint8_t, true, false>>,
        fused_rollout_kernel<RolloutEnv<uint8_t, true, true>>},
       {fused_rollout_kernel<RolloutEnv<uint16_t, true, false>>,
        fused_rollout_kernel<RolloutEnv<uint16_t, true, true>>}},
      {{fused_rollout_kernel<RolloutEnv<uint8_t, false, false>>,
        fused_rollout_kernel<RolloutEnv<uint8_t, false, true>>},
       {fused_rollout_kernel<RolloutEnv<uint16_t, false, false>>,
        fused_rollout_kernel<RolloutEnv<uint16_t, false, true>>}}};
  auto kernel = p.route == RW_ROUTE_SCAN
                    ? fused_rollout_kernel<ScanEnv>
                    : kernels[p.route == RW_ROUTE_GLOBAL][p.map_bytes == 2][n > 8];
  // a uint8 map with 1-8 agents has kernels built for that count
  if (p.route != RW_ROUTE_SCAN && p.map_bytes == 1 && n <= 8)
    kernel = p.route == RW_ROUTE_SHARED ? counted_kernel<true, 1>(n) : counted_kernel<false, 1>(n);
  const int smem = p.route == RW_ROUTE_SHARED ? 4 * p.end * p.stride : 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, p.carveout);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.te - 1) / p.te;
  kernel<<<blocks, p.te, smem, (cudaStream_t)stream>>>(
      d, p, T, B, (const int*)layout, (const int*)state_in, (int*)state_out, (const int*)actions,
      (float*)rewards, (int*)episodes, (int*)scratch);
  return (int)cudaGetLastError();
}

extern "C" const char* rw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
