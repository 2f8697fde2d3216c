// One warehouse transition for one env, shared by the fused rollout kernel
// (fused_rollout.cu) and the fused collector kernels (fused_collect.cu,
// collect_gru.cuh).
//
// Replaces the TPU kernels' shared core
// rware_tpu/ops/pallas_rollout.py::_env_step_core (and its draw helpers
// _rand_mod / _draw_distinct).  The TPU version works on (8, 128) tiles of
// 1024 envs with every per-agent loop unrolled at trace time and a
// pointer-doubling resolver built for the vector unit.  Here one thread owns
// one env: the env's state lives in registers and local memory for the
// whole launch, and the resolver is the plain per-env form of the rules in
// rware_tpu_torch/ops/resolver.py (functional graph: self-loops and cycles
// commit, a head-on swap poisons its component, else the longest chain into
// the sink wins, equal depths to the lowest agent index).
//
// Random draws are Philox4x32-10, counter (env, step, purpose, slot / 4),
// word slot % 4, key = the 64-bit seed — the same stream as
// rware_tpu_torch/ops/philox.py, so kernel and plain version agree bit for
// bit.  In scripted mode every draw is 0: lowest-index queue replacement,
// agent i respawns at cell i facing UP, the queue restarts as 0..R-1.
//
// Message bits (msg_bits = M > 0; rware/warehouse.py:809-814) ride as N * M
// more state rows: the caller sets them before each step (K1 from the action
// columns or from Philox purpose MESSAGE, the collectors from the sampled
// bits) and env_step clears them where the episode ends, as autoreset does.
//
// env_step is a template over the state's storage: a type per caller with
// the accessors it uses (agent fields, "the shelf at a cell", the carried
// shelves' moves, the queue, the counters, the reset).  The collectors keep
// EnvState, the whole env in the thread's local memory with the shelves as a
// list of cells, so every lookup is an O(S) scan; K1's map routes keep a
// compact env with a map from cell to shelf (fused_rollout.cu, RolloutEnv),
// so a lookup is one load.  The two agree while no two shelves share a cell,
// which the dynamics keep: a loaded agent is never let onto a standing
// shelf's cell, agents end a step on distinct cells and a reset puts the
// shelves on their distinct slots (tests/test_torch_rollout_plan.py).
//
// What bounds it on the card: integer work per env-step (O(N^2) resolver,
// and on EnvState the O(S) shelf scans) and the traffic of the per-env
// state; device memory is read once and written once per launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RW_MAX_N 32
#define RW_MAX_S 512
#define RW_MAX_R 64
#define RW_MAX_M 8  // message bits per agent

enum { RW_ACTION = 0, RW_QUEUE = 1, RW_RESPAWN = 2, RW_MESSAGE = 4 };
enum { RW_GLOBAL = 0, RW_INDIVIDUAL = 1, RW_TWO_STAGE = 2 };
enum { RW_NOOP = 0, RW_FORWARD = 1, RW_LEFT = 2, RW_RIGHT = 3, RW_TOGGLE = 4 };

struct EnvDims {
  int n, s, r, g, h, w;
  int reward_type;
  int max_steps;     // 0 = no limit
  int max_inactive;  // 0 = no limit
  int m;             // message bits per agent
  int scripted;      // every draw is 0
  uint32_t seed_lo, seed_hi;
  uint32_t env_offset;  // global index of the launch's env 0 (a shard's first row)
};

// Layout constants in one int32 buffer:
// [slot_x (S) | slot_y (S) | goal_x (G) | goal_y (G) | highway (H*W)].
struct EnvLayout {
  const int* slot_x;
  const int* slot_y;
  const int* goal_x;
  const int* goal_y;
  const int* highway;
};

static __device__ __forceinline__ EnvLayout make_layout(const EnvDims& d, const int* buf) {
  EnvLayout l;
  l.slot_x = buf;
  l.slot_y = buf + d.s;
  l.goal_x = buf + 2 * d.s;
  l.goal_y = buf + 2 * d.s + d.g;
  l.highway = buf + 2 * d.s + 2 * d.g;
  return l;
}

static __device__ void draw_distinct(const EnvDims& d, uint32_t env, uint32_t step, int slot0,
                                     int n, int m, int* out);

// Per-env state.  Shelves are kept as packed cells y * W + x.  The methods
// are env_step's view of it: shelf lookups are scans in ascending shelf order.
struct EnvState {
  int ax[RW_MAX_N], ay[RW_MAX_N], ad[RW_MAX_N], carry[RW_MAX_N], hd[RW_MAX_N];
  int scell[RW_MAX_S];
  int q[RW_MAX_R];
  int inact, steps;
  int msg[RW_MAX_N * RW_MAX_M];  // agent i's bit m at i * M + m

  __device__ __forceinline__ int agent_x(int i) const { return ax[i]; }
  __device__ __forceinline__ int agent_y(int i) const { return ay[i]; }
  __device__ __forceinline__ int agent_dir(int i) const { return ad[i]; }
  __device__ __forceinline__ int carried(int i) const { return carry[i]; }
  __device__ __forceinline__ int delivered(int i) const { return hd[i]; }
  __device__ __forceinline__ void move_to(int i, int x, int y) {
    ax[i] = x;
    ay[i] = y;
  }
  __device__ __forceinline__ void turn(int i, int dir) { ad[i] = dir; }
  __device__ __forceinline__ void set_carried(int i, int s) { carry[i] = s; }
  __device__ __forceinline__ void set_delivered(int i, int v) { hd[i] = v; }
  // at |= "a shelf stands on cell c" (a scan over all S shelves).
  __device__ __forceinline__ void any_shelf_at(int S, const int& c, bool& at) const {
    for (int s = 0; s < S; ++s) at |= scell[s] == c;
  }
  // sid = the lowest-index shelf on cell c; left as it is where none is.
  __device__ __forceinline__ void shelf_at(int S, const int& c, int& sid) const {
    for (int s = 0; s < S; ++s) {
      if (scell[s] == c) {
        sid = s;
        break;
      }
    }
  }
  // The shelves carried by the agents that moved ride along (their carriers
  // left the cells acell).
  __device__ __forceinline__ void carry_shelves(int N, int W, const bool* moved, const int*) {
    for (int i = 0; i < N; ++i)
      if (moved[i] && carry[i] >= 0) scell[carry[i]] = ay[i] * W + ax[i];
  }
  __device__ __forceinline__ int queued(int r) const { return q[r]; }
  __device__ __forceinline__ void set_queued(int r, int s) { q[r] = s; }
  __device__ __forceinline__ int inactive() const { return inact; }
  __device__ __forceinline__ int step_count() const { return steps; }
  __device__ __forceinline__ void set_inactive(int v) { inact = v; }
  __device__ __forceinline__ void set_step_count(int v) { steps = v; }
  __device__ __forceinline__ void reset_shelves(const EnvLayout& lay, int S, int W) {
    for (int s = 0; s < S; ++s) scell[s] = lay.slot_y[s] * W + lay.slot_x[s];
  }
  __device__ __forceinline__ void reset_queue(const EnvDims& d, uint32_t env, uint32_t step,
                                              int slot0, int R, int S) {
    draw_distinct(d, env, step, slot0, R, S, q);
  }
  __device__ __forceinline__ void clear_msg(int n) {
    for (int k = 0; k < n; ++k) msg[k] = 0;
  }
  static constexpr bool kOwnResolver = false;  // env_step calls resolve_moves
  static __device__ __forceinline__ int n_agents(const EnvDims& d) { return d.n; }
  static __device__ __forceinline__ void credit(float* rew, int, int aid, float r) {
    rew[aid] += r;
  }
};

// Rows of the packed (ROWS, B) int32 state tensor, env index minor:
// ax N | ay N | dir N | carrying N | has_delivered N | shelf_x S | shelf_y S |
// queue R | inactive 1 | steps 1 | message N * M (agent-major).
static __device__ void load_state(EnvState& st, const EnvDims& d, const int* __restrict__ in,
                                  int e, int B) {
  const int N = d.n, S = d.s, R = d.r;
  for (int i = 0; i < N; ++i) {
    st.ax[i] = in[(size_t)i * B + e];
    st.ay[i] = in[(size_t)(N + i) * B + e];
    st.ad[i] = in[(size_t)(2 * N + i) * B + e];
    st.carry[i] = in[(size_t)(3 * N + i) * B + e];
    st.hd[i] = in[(size_t)(4 * N + i) * B + e];
  }
  for (int s = 0; s < S; ++s) {
    int x = in[(size_t)(5 * N + s) * B + e];
    int y = in[(size_t)(5 * N + S + s) * B + e];
    st.scell[s] = y * d.w + x;
  }
  for (int r = 0; r < R; ++r) st.q[r] = in[(size_t)(5 * N + 2 * S + r) * B + e];
  st.inact = in[(size_t)(5 * N + 2 * S + R) * B + e];
  st.steps = in[(size_t)(5 * N + 2 * S + R + 1) * B + e];
  for (int k = 0; k < N * d.m; ++k) st.msg[k] = in[(size_t)(5 * N + 2 * S + R + 2 + k) * B + e];
}

static __device__ void store_state(const EnvState& st, const EnvDims& d, int* __restrict__ out,
                                   int e, int B) {
  const int N = d.n, S = d.s, R = d.r;
  for (int i = 0; i < N; ++i) {
    out[(size_t)i * B + e] = st.ax[i];
    out[(size_t)(N + i) * B + e] = st.ay[i];
    out[(size_t)(2 * N + i) * B + e] = st.ad[i];
    out[(size_t)(3 * N + i) * B + e] = st.carry[i];
    out[(size_t)(4 * N + i) * B + e] = st.hd[i];
  }
  for (int s = 0; s < S; ++s) {
    out[(size_t)(5 * N + s) * B + e] = st.scell[s] % d.w;
    out[(size_t)(5 * N + S + s) * B + e] = st.scell[s] / d.w;
  }
  for (int r = 0; r < R; ++r) out[(size_t)(5 * N + 2 * S + r) * B + e] = st.q[r];
  out[(size_t)(5 * N + 2 * S + R) * B + e] = st.inact;
  out[(size_t)(5 * N + 2 * S + R + 1) * B + e] = st.steps;
  for (int k = 0; k < N * d.m; ++k) out[(size_t)(5 * N + 2 * S + R + 2 + k) * B + e] = st.msg[k];
}

// ---- Philox4x32-10 ---------------------------------------------------------

static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Raw uint32 draw `slot` of `purpose` for the launch's env `env` at step
// `step`; the counter holds the env's global index env_offset + env.
static __device__ __forceinline__ uint32_t draw_bits(const EnvDims& d, uint32_t env, uint32_t step,
                                                     uint32_t purpose, uint32_t slot) {
  if (d.scripted) return 0u;
  uint4 o = philox4x32_10(make_uint4(d.env_offset + env, step, purpose, slot >> 2), d.seed_lo,
                          d.seed_hi);
  switch (slot & 3u) {
    case 0: return o.x;
    case 1: return o.y;
    case 2: return o.z;
    default: return o.w;
  }
}

// Uniform int in [0, m): mask to 31 bits, then mod.
static __device__ __forceinline__ int rand_mod(uint32_t bits, int m) {
  return (int)((bits & 0x7FFFFFFFu) % (uint32_t)m);
}

// n distinct values in [0, m) from draws slot0 .. slot0 + n - 1: sequential
// shifted draws, each shifted past the values already taken in ascending
// order (rware_tpu_torch/ops/philox.py::draw_distinct).
static __device__ void draw_distinct(const EnvDims& d, uint32_t env, uint32_t step, int slot0,
                                     int n, int m, int* out) {
  int sorted[RW_MAX_R > RW_MAX_N ? RW_MAX_R : RW_MAX_N];
  for (int i = 0; i < n; ++i) {
    int v = rand_mod(draw_bits(d, env, step, RW_RESPAWN, slot0 + i), m - i);
    for (int c = 0; c < i; ++c) v += (v >= sorted[c]) ? 1 : 0;
    out[i] = v;
    int pos = i;  // insertion keeps `sorted` ascending
    while (pos > 0 && sorted[pos - 1] > v) {
      sorted[pos] = sorted[pos - 1];
      --pos;
    }
    sorted[pos] = v;
  }
}

// ---- collision resolver ------------------------------------------------------

static __device__ __forceinline__ int uf_root(const int* parent, int x) {
  while (parent[x] != x) x = parent[x];
  return x;
}

// committed[i]: agent i's request (start -> target cell) commits.
static __device__ void resolve_moves(int n, const int* acell, const int* tcell, bool* committed) {
  int nxt[RW_MAX_N], depth[RW_MAX_N], nd[RW_MAX_N], parent[RW_MAX_N];
  bool on_cycle[RW_MAX_N], two_cycle[RW_MAX_N], chosen[RW_MAX_N];
  bool comp_poison[RW_MAX_N], comp_cycle[RW_MAX_N];

  for (int i = 0; i < n; ++i) {
    nxt[i] = -1;
    for (int j = 0; j < n; ++j) {
      if (tcell[i] == acell[j]) {
        nxt[i] = j;
        break;
      }
    }
  }
  for (int i = 0; i < n; ++i) {
    bool oc = false;
    int cur = nxt[i];
    for (int k = 0; k < n && cur >= 0; ++k) {
      if (cur == i) {
        oc = true;
        break;
      }
      cur = nxt[cur];
    }
    on_cycle[i] = oc;
    two_cycle[i] = nxt[i] >= 0 && nxt[i] != i && nxt[nxt[i]] == i;
  }

  // Weak components: adjacent iff the edges share a cell.
  for (int i = 0; i < n; ++i) parent[i] = i;
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      if (tcell[i] == tcell[j] || nxt[i] == j || nxt[j] == i) {
        int ri = uf_root(parent, i), rj = uf_root(parent, j);
        if (ri != rj) parent[max(ri, rj)] = min(ri, rj);
      }
    }
  }
  for (int i = 0; i < n; ++i) comp_poison[i] = comp_cycle[i] = false;
  for (int i = 0; i < n; ++i) {
    int r = uf_root(parent, i);
    comp_poison[r] |= two_cycle[i];
    comp_cycle[r] |= on_cycle[i];
  }

  // depth[i]: longest chain of agents ending at i (N Jacobi sweeps, stopping
  // early at the fixed point).
  for (int i = 0; i < n; ++i) depth[i] = 1;
  for (int it = 0; it < n; ++it) {
    for (int i = 0; i < n; ++i) nd[i] = 1;
    for (int j = 0; j < n; ++j)
      if (nxt[j] >= 0) nd[nxt[j]] = max(nd[nxt[j]], depth[j] + 1);
    bool changed = false;
    for (int i = 0; i < n; ++i) {
      changed |= nd[i] != depth[i];
      depth[i] = nd[i];
    }
    if (!changed) break;
  }
  // chosen[i]: the winner among agents sharing i's target cell.
  for (int i = 0; i < n; ++i) {
    bool ok = true;
    for (int j = 0; j < n; ++j) {
      if (j != i && tcell[j] == tcell[i])
        ok &= depth[j] < depth[i] || (depth[j] == depth[i] && j > i);
    }
    chosen[i] = ok;
  }
  for (int i = 0; i < n; ++i) {
    // chain rule: every agent on the path to the sink is chosen
    bool chain = chosen[i];
    int cur = i;
    for (int k = 0; k < n && nxt[cur] >= 0; ++k) {
      cur = nxt[cur];
      chain &= chosen[cur];
    }
    int r = uf_root(parent, i);
    committed[i] = (on_cycle[i] && !comp_poison[r]) || (chain && !comp_cycle[r]);
  }
}

// resolve_moves' rules for at most K agents with every per-agent set a bitmask
// in registers (K1's map routes; the arrays above live in local memory, and
// their dependent loads were most of K1's step).  Per agent: S, its
// successor (the agent on its target); P, its predecessors; T, the agents
// with its target.  Padded agents (n <= i < K) have targets no agent shares.
// - on a cycle: the agents left after peeling, n times, those whose
//   successor or every predecessor is gone (the tails and the chains into a
//   sink fall away; a cycle, a self-loop too, stays);
// - poisoned and cyclic components: the flags spread n times over the
//   adjacency T | S | P;
// - depth: 1 + the number of levels d >= 2 holding the agent, level d the
//   agents with a predecessor in level d - 1 (the longest chain ending there
//   wherever the component is acyclic, where alone depth is read);
// - the chain rule: an agent is bad if it is not chosen or its successor is
//   bad, spread n times.
template <int K>
static __device__ __forceinline__ void resolve_moves_masks(int n, const int* acell,
                                                           const int* tcell, bool* committed) {
  const uint32_t all = (uint32_t)((1ull << n) - 1ull);
  int ac[K], tc[K], depth[K];
  uint32_t S[K], P[K], T[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    ac[i] = i < n ? acell[i] : -1 - i;
    tc[i] = i < n ? tcell[i] : -1 - K - i;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint32_t hit = 0, same = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      hit |= (uint32_t)(tc[i] == ac[j]) << j;
      same |= (uint32_t)(tc[i] == tc[j]) << j;
    }
    S[i] = hit & (0u - hit);  // the lowest j, as the scan's first hit
    T[i] = same;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t p = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) p |= ((S[i] >> j) & 1u) << i;
    P[j] = p;
  }
  uint32_t on = all;
  for (int it = 0; it < n; ++it) {
    uint32_t keep = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) keep |= (uint32_t)((S[i] & on) != 0 && (P[i] & on) != 0) << i;
    on &= keep;
  }
  uint32_t poison = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) poison |= (uint32_t)((S[i] & P[i]) != 0 && S[i] != (1u << i)) << i;
  uint32_t cyc = on;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t adj = T[i] | S[i] | P[i];
      poison |= (uint32_t)((adj & poison) != 0) << i;
      cyc |= (uint32_t)((adj & cyc) != 0) << i;
    }
  }
  uint32_t level = all;
#pragma unroll
  for (int i = 0; i < K; ++i) depth[i] = 1;
  for (int d = 1; d < n; ++d) {
    uint32_t next = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) next |= (uint32_t)((P[i] & level) != 0) << i;
    level = next;
#pragma unroll
    for (int i = 0; i < K; ++i) depth[i] += (level >> i) & 1u;
  }
  uint32_t bad = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j != i && ((T[i] >> j) & 1u)) ok &= depth[j] < depth[i] || (depth[j] == depth[i] && j > i);
    bad |= (uint32_t)!ok << i;
  }
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < K; ++i) bad |= (uint32_t)((S[i] & bad) != 0) << i;
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < n)
      committed[i] = (((on >> i) & 1u) && !((poison >> i) & 1u)) ||
                     (!((bad >> i) & 1u) && !((cyc >> i) & 1u));
}

// ---- the transition ------------------------------------------------------------

static __constant__ int RW_DX[4] = {0, 0, -1, 1};
static __constant__ int RW_DY[4] = {-1, 1, 0, 0};
static __constant__ int RW_ROT_LEFT[4] = {2, 3, 1, 0};
static __constant__ int RW_ROT_RIGHT[4] = {3, 2, 0, 1};

// A phase mark that does nothing (K1 hands env_step one that reads the clock
// where tools/collect_phase_profile.py asks for it).
struct RwNoMark {
  __device__ __forceinline__ void operator()(int) const {}
};

// Advance `st` by one step under actions `acts` (modified: failed moves and
// pre-cancels become NOOP).  Writes per-agent rewards; returns done.  The
// env is reset in place when done.  `St` is the state's storage (EnvState,
// or K1's RolloutEnv); `mark(k)` closes phase k (1 pre-cancel, 2 resolver,
// 3 moves and toggles, 4 deliveries, 5 termination and reset).
template <class St, class Mark = RwNoMark>
static __device__ bool env_step(St& st, int* acts, float* rew, const EnvDims& d,
                                const EnvLayout& lay, uint32_t env, uint32_t step,
                                Mark mark = Mark()) {
  const int N = St::n_agents(d), S = d.s, R = d.r, W = d.w, H = d.h;
  int acell[RW_MAX_N], tcell[RW_MAX_N], tx[RW_MAX_N], ty[RW_MAX_N];
  bool committed[RW_MAX_N];

  for (int i = 0; i < N; ++i) {
    rew[i] = 0.f;
    int fwd = acts[i] == RW_FORWARD;
    tx[i] = min(max(st.agent_x(i) + (fwd ? RW_DX[st.agent_dir(i)] : 0), 0), W - 1);
    ty[i] = min(max(st.agent_y(i) + (fwd ? RW_DY[st.agent_dir(i)] : 0), 0), H - 1);
    acell[i] = st.agent_y(i) * W + st.agent_x(i);
    tcell[i] = ty[i] * W + tx[i];
  }
  // Pre-cancel: a loaded agent moving onto a standing shelf, unless that
  // shelf is held by a loaded agent at the target.
  bool cancel[RW_MAX_N];
  for (int i = 0; i < N; ++i) {
    cancel[i] = false;
    if (st.carried(i) < 0 || tcell[i] == acell[i]) continue;
    bool shelf_at = false;
    st.any_shelf_at(S, tcell[i], shelf_at);
    bool tgt_loaded = false;
    for (int j = 0; j < N; ++j) tgt_loaded |= acell[j] == tcell[i] && st.carried(j) >= 0;
    cancel[i] = shelf_at && !tgt_loaded;
  }
  for (int i = 0; i < N; ++i) {
    if (cancel[i]) {
      acts[i] = RW_NOOP;
      tx[i] = st.agent_x(i);
      ty[i] = st.agent_y(i);
      tcell[i] = acell[i];
    }
  }
  mark(1);

  if constexpr (St::kOwnResolver)
    st.resolve(N, acell, tcell, committed);
  else
    resolve_moves(N, acell, tcell, committed);
  mark(2);

  // Movement, rotation; toggles read the PRE-move shelf cells.
  int shelf_under[RW_MAX_N];
  bool moved[RW_MAX_N];
  for (int i = 0; i < N; ++i) {
    if (!committed[i]) acts[i] = RW_NOOP;
    moved[i] = acts[i] == RW_FORWARD;
    if (moved[i]) st.move_to(i, tx[i], ty[i]);
    if (acts[i] == RW_LEFT) st.turn(i, RW_ROT_LEFT[st.agent_dir(i)]);
    if (acts[i] == RW_RIGHT) st.turn(i, RW_ROT_RIGHT[st.agent_dir(i)]);
    shelf_under[i] = -1;
    if (acts[i] == RW_TOGGLE) {
      int c = st.agent_y(i) * W + st.agent_x(i);
      st.shelf_at(S, c, shelf_under[i]);
    }
  }
  st.carry_shelves(N, W, moved, acell);  // carried shelves ride along
  for (int i = 0; i < N; ++i) {
    if (acts[i] != RW_TOGGLE) continue;
    if (st.carried(i) < 0) {
      if (shelf_under[i] >= 0) st.set_carried(i, shelf_under[i]);
    } else if (!lay.highway[st.agent_y(i) * W + st.agent_x(i)]) {
      if (d.reward_type == RW_TWO_STAGE && st.delivered(i)) rew[i] += 0.5f;
      st.set_carried(i, -1);
      st.set_delivered(i, 0);
    }
  }
  mark(3);

  // Deliveries, queue resample and rewards, goal by goal.
  bool any_delivered = false;
  for (int g = 0; g < d.g && R > 0; ++g) {
    int gcell = lay.goal_y[g] * W + lay.goal_x[g];
    int sid = -1;
    st.shelf_at(S, gcell, sid);
    if (sid < 0) continue;
    int slot = -1;
    for (int r = 0; r < R; ++r) {
      if (st.queued(r) == sid) {
        slot = r;
        break;
      }
    }
    if (slot < 0) continue;
    // Replacement: the k-th non-queued shelf; the delivered shelf is still
    // queued here.  With every shelf queued (R == S) it stays requested.
    int count = 0;
    for (int s = 0; s < S; ++s) {
      bool inq = false;
      for (int r = 0; r < R; ++r) inq |= st.queued(r) == s;
      count += inq ? 0 : 1;
    }
    int repl = sid;
    if (count > 0) {
      int k = rand_mod(draw_bits(d, env, step, RW_QUEUE, g), count);
      for (int s = 0; s < S; ++s) {
        bool inq = false;
        for (int r = 0; r < R; ++r) inq |= st.queued(r) == s;
        if (inq) continue;
        if (k == 0) {
          repl = s;
          break;
        }
        --k;
      }
    }
    st.set_queued(slot, repl);
    // Credit the agent on the goal; nobody there credits the LAST agent
    // (the reference's rewards[-1] wraparound).
    int aid = N - 1;
    for (int i = 0; i < N; ++i) {
      if (st.agent_y(i) * W + st.agent_x(i) == gcell) {
        aid = i;
        break;
      }
    }
    if (d.reward_type == RW_GLOBAL) {
      for (int i = 0; i < N; ++i) rew[i] += 1.f;
    } else if (d.reward_type == RW_INDIVIDUAL) {
      St::credit(rew, N, aid, 1.f);
    } else {
      St::credit(rew, N, aid, 0.5f);
      st.set_delivered(aid, 1);
    }
    any_delivered = true;
  }
  mark(4);

  // Termination and autoreset.
  st.set_inactive(any_delivered ? 0 : st.inactive() + 1);
  st.set_step_count(st.step_count() + 1);
  bool done = (d.max_inactive > 0 && st.inactive() >= d.max_inactive) ||
              (d.max_steps > 0 && st.step_count() >= d.max_steps);
  if (done) {
    int cells[RW_MAX_N];
    draw_distinct(d, env, step, 0, N, H * W, cells);
    for (int i = 0; i < N; ++i) {
      st.move_to(i, cells[i] % W, cells[i] / W);
      st.turn(i, rand_mod(draw_bits(d, env, step, RW_RESPAWN, N + i), 4));
      st.set_carried(i, -1);
      st.set_delivered(i, 0);
    }
    st.reset_shelves(lay, S, W);
    st.reset_queue(d, env, step, 2 * N, R, S);
    st.set_inactive(0);
    st.set_step_count(0);
    st.clear_msg(N * d.m);
  }
  mark(5);
  return done;
}
