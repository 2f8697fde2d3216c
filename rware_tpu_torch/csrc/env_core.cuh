// One warehouse transition for one env, shared by the fused rollout kernel
// (fused_rollout.cu) and the fused collector kernel (fused_collect.cu).
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
// What bounds it on the card: integer work per env-step (O(N^2) resolver,
// O(S) shelf scans) and local-memory traffic of the per-env state; device
// memory is read once and written once per launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RW_MAX_N 32
#define RW_MAX_S 512
#define RW_MAX_R 64

enum { RW_ACTION = 0, RW_QUEUE = 1, RW_RESPAWN = 2 };
enum { RW_GLOBAL = 0, RW_INDIVIDUAL = 1, RW_TWO_STAGE = 2 };
enum { RW_NOOP = 0, RW_FORWARD = 1, RW_LEFT = 2, RW_RIGHT = 3, RW_TOGGLE = 4 };

struct EnvDims {
  int n, s, r, g, h, w;
  int reward_type;
  int max_steps;     // 0 = no limit
  int max_inactive;  // 0 = no limit
  int scripted;      // every draw is 0
  uint32_t seed_lo, seed_hi;
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

// Per-env state.  Shelves are kept as packed cells y * W + x.
struct EnvState {
  int ax[RW_MAX_N], ay[RW_MAX_N], ad[RW_MAX_N], carry[RW_MAX_N], hd[RW_MAX_N];
  int scell[RW_MAX_S];
  int q[RW_MAX_R];
  int inact, steps;
};

// Rows of the packed (ROWS, B) int32 state tensor, env index minor:
// ax N | ay N | dir N | carrying N | has_delivered N | shelf_x S | shelf_y S |
// queue R | inactive 1 | steps 1.
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

// Raw uint32 draw `slot` of `purpose` for env `env` at step `step`.
static __device__ __forceinline__ uint32_t draw_bits(const EnvDims& d, uint32_t env, uint32_t step,
                                                     uint32_t purpose, uint32_t slot) {
  if (d.scripted) return 0u;
  uint4 o = philox4x32_10(make_uint4(env, step, purpose, slot >> 2), d.seed_lo, d.seed_hi);
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

// ---- the transition ------------------------------------------------------------

static __constant__ int RW_DX[4] = {0, 0, -1, 1};
static __constant__ int RW_DY[4] = {-1, 1, 0, 0};
static __constant__ int RW_ROT_LEFT[4] = {2, 3, 1, 0};
static __constant__ int RW_ROT_RIGHT[4] = {3, 2, 0, 1};

// Advance `st` by one step under actions `acts` (modified: failed moves and
// pre-cancels become NOOP).  Writes per-agent rewards; returns done.  The
// env is reset in place when done.
static __device__ bool env_step(EnvState& st, int* acts, float* rew, const EnvDims& d,
                                const EnvLayout& lay, uint32_t env, uint32_t step) {
  const int N = d.n, S = d.s, R = d.r, W = d.w, H = d.h;
  int acell[RW_MAX_N], tcell[RW_MAX_N], tx[RW_MAX_N], ty[RW_MAX_N];
  bool committed[RW_MAX_N];

  for (int i = 0; i < N; ++i) {
    rew[i] = 0.f;
    int fwd = acts[i] == RW_FORWARD;
    tx[i] = min(max(st.ax[i] + (fwd ? RW_DX[st.ad[i]] : 0), 0), W - 1);
    ty[i] = min(max(st.ay[i] + (fwd ? RW_DY[st.ad[i]] : 0), 0), H - 1);
    acell[i] = st.ay[i] * W + st.ax[i];
    tcell[i] = ty[i] * W + tx[i];
  }
  // Pre-cancel: a loaded agent moving onto a standing shelf, unless that
  // shelf is held by a loaded agent at the target.
  bool cancel[RW_MAX_N];
  for (int i = 0; i < N; ++i) {
    cancel[i] = false;
    if (st.carry[i] < 0 || tcell[i] == acell[i]) continue;
    bool shelf_at = false;
    for (int s = 0; s < S; ++s) shelf_at |= st.scell[s] == tcell[i];
    bool tgt_loaded = false;
    for (int j = 0; j < N; ++j) tgt_loaded |= acell[j] == tcell[i] && st.carry[j] >= 0;
    cancel[i] = shelf_at && !tgt_loaded;
  }
  for (int i = 0; i < N; ++i) {
    if (cancel[i]) {
      acts[i] = RW_NOOP;
      tx[i] = st.ax[i];
      ty[i] = st.ay[i];
      tcell[i] = acell[i];
    }
  }

  resolve_moves(N, acell, tcell, committed);

  // Movement, rotation; toggles read the PRE-move shelf cells.
  int shelf_under[RW_MAX_N];
  bool moved[RW_MAX_N];
  for (int i = 0; i < N; ++i) {
    if (!committed[i]) acts[i] = RW_NOOP;
    moved[i] = acts[i] == RW_FORWARD;
    if (moved[i]) {
      st.ax[i] = tx[i];
      st.ay[i] = ty[i];
    }
    if (acts[i] == RW_LEFT) st.ad[i] = RW_ROT_LEFT[st.ad[i]];
    if (acts[i] == RW_RIGHT) st.ad[i] = RW_ROT_RIGHT[st.ad[i]];
    shelf_under[i] = -1;
    if (acts[i] == RW_TOGGLE) {
      int c = st.ay[i] * W + st.ax[i];
      for (int s = 0; s < S; ++s) {
        if (st.scell[s] == c) {
          shelf_under[i] = s;
          break;
        }
      }
    }
  }
  for (int i = 0; i < N; ++i)  // carried shelves ride along
    if (moved[i] && st.carry[i] >= 0) st.scell[st.carry[i]] = st.ay[i] * W + st.ax[i];
  for (int i = 0; i < N; ++i) {
    if (acts[i] != RW_TOGGLE) continue;
    if (st.carry[i] < 0) {
      if (shelf_under[i] >= 0) st.carry[i] = shelf_under[i];
    } else if (!lay.highway[st.ay[i] * W + st.ax[i]]) {
      if (d.reward_type == RW_TWO_STAGE && st.hd[i]) rew[i] += 0.5f;
      st.carry[i] = -1;
      st.hd[i] = 0;
    }
  }

  // Deliveries, queue resample and rewards, goal by goal.
  bool any_delivered = false;
  for (int g = 0; g < d.g && R > 0; ++g) {
    int gcell = lay.goal_y[g] * W + lay.goal_x[g];
    int sid = -1;
    for (int s = 0; s < S; ++s) {
      if (st.scell[s] == gcell) {
        sid = s;
        break;
      }
    }
    if (sid < 0) continue;
    int slot = -1;
    for (int r = 0; r < R; ++r) {
      if (st.q[r] == sid) {
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
      for (int r = 0; r < R; ++r) inq |= st.q[r] == s;
      count += inq ? 0 : 1;
    }
    int repl = sid;
    if (count > 0) {
      int k = rand_mod(draw_bits(d, env, step, RW_QUEUE, g), count);
      for (int s = 0; s < S; ++s) {
        bool inq = false;
        for (int r = 0; r < R; ++r) inq |= st.q[r] == s;
        if (inq) continue;
        if (k == 0) {
          repl = s;
          break;
        }
        --k;
      }
    }
    st.q[slot] = repl;
    // Credit the agent on the goal; nobody there credits the LAST agent
    // (the reference's rewards[-1] wraparound).
    int aid = N - 1;
    for (int i = 0; i < N; ++i) {
      if (st.ay[i] * W + st.ax[i] == gcell) {
        aid = i;
        break;
      }
    }
    if (d.reward_type == RW_GLOBAL) {
      for (int i = 0; i < N; ++i) rew[i] += 1.f;
    } else if (d.reward_type == RW_INDIVIDUAL) {
      rew[aid] += 1.f;
    } else {
      rew[aid] += 0.5f;
      st.hd[aid] = 1;
    }
    any_delivered = true;
  }

  // Termination and autoreset.
  st.inact = any_delivered ? 0 : st.inact + 1;
  st.steps += 1;
  bool done = (d.max_inactive > 0 && st.inact >= d.max_inactive) ||
              (d.max_steps > 0 && st.steps >= d.max_steps);
  if (done) {
    int cells[RW_MAX_N];
    draw_distinct(d, env, step, 0, N, H * W, cells);
    for (int i = 0; i < N; ++i) {
      st.ax[i] = cells[i] % W;
      st.ay[i] = cells[i] / W;
      st.ad[i] = rand_mod(draw_bits(d, env, step, RW_RESPAWN, N + i), 4);
      st.carry[i] = -1;
      st.hd[i] = 0;
    }
    for (int s = 0; s < S; ++s) st.scell[s] = lay.slot_y[s] * W + lay.slot_x[s];
    draw_distinct(d, env, step, 2 * N, R, S, st.q);
    st.inact = 0;
    st.steps = 0;
  }
  return done;
}
