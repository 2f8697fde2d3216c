// Pieces shared by the fused collector kernels (K2a and K2d fused_collect.cu,
// K2c and K2d′ collect_gru.cuh): the FLATTENED observation and the image
// window (K2e) of an agent written into a thread's column of a shared-memory
// tile from a compact view of its env, bf16 rounding, packing and unpacking
// bf16 values, the coalesced 16-byte stores of a tile's rows, the
// Gumbel-argmax sample with its log-probability, and the message mode (K2b):
// the Bernoulli message-bit sample with its log-probability.
#pragma once

#include <cuda_bf16.h>

#include "env_core.cuh"
#include "gru_core.cuh"  // gru_sigmoid

#define RW_MAX_A 8

#define RW_MAX_LAYERS 7

// img_*: read by the image instantiations only (K2e).  img_layers packs the
// ImageLayer id of channel c into bits 4c .. 4c + 3; img_self appends the six
// IMAGE_DICT self rows.
struct ObsDims {
  int L, sensor_range, normalised;
  int img_layers, img_n_layers, img_directional, img_self;
};

// K2e: the image window.  ImageLayer ids (rware_tpu_torch/types.py).
enum {
  RW_SHELVES = 0, RW_REQUESTS = 1, RW_AGENTS = 2, RW_AGENT_DIRECTION = 3, RW_AGENT_LOAD = 4,
  RW_GOALS = 5, RW_ACCESSIBLE = 6
};

// Output cell (u, v) of the world offset (oy, ox) from an agent heading
// `dir`, np.rot90's rotation folded in (pallas_rollout.py::_rot_window_rel):
// UP (oy+r, ox+r), DOWN (r-oy, r-ox), LEFT (ox+r, r-oy), RIGHT (r-ox, oy+r);
// unrotated when not directional.  False outside the window.
static __device__ __forceinline__ bool rot_window_cell(int oy, int ox, int dir, int directional,
                                                       int r, int* cell) {
  int u = oy + r, v = ox + r;
  if (directional && dir == 1) {
    u = r - oy;
    v = r - ox;
  } else if (directional && dir == 2) {
    u = ox + r;
    v = r - oy;
  } else if (directional && dir == 3) {
    u = r - ox;
    v = oy + r;
  }
  const int side = 2 * r + 1;
  *cell = u * side + v;
  return u >= 0 && u < side && v >= 0 && v < side;
}

// ---- observation rows from a compact view of the env (one thread a row) ----
//
// The view of one env in shared memory, written by its env thread after each
// step (write_obs_view) and read by the threads of its agents' rows: agent j's
// cell x | y << 16 at word j and dir | carrying << 2 at word N + j, its M
// message values at 2N + j * M, the queue at 2N + NM, each shelf's x | y << 16
// at 2N + NM + R + s.  The rows built from it (build_obs_from_view,
// build_image_obs_from_view) equal the plain versions' observations
// (rware_tpu_torch/core/observations.py) bit for bit.

// wmagic = ceil(2^32 / W): cell / W for cells below 2^16 without a division.
template <bool kMsg>
static __device__ __forceinline__ void write_obs_view(const EnvState& st, const EnvDims& d, uint32_t wmagic,
                                      int* v) {
  const int N = d.n, M = kMsg ? d.m : 0, R = d.r, W = d.w;
  for (int j = 0; j < N; ++j) {
    v[j] = st.ax[j] | st.ay[j] << 16;
    v[N + j] = st.ad[j] | (st.carry[j] >= 0 ? 4 : 0);
  }
  for (int k = 0; k < N * M; ++k) v[2 * N + k] = st.msg[k];
  int* q = v + 2 * N + N * M;
  for (int r = 0; r < R; ++r) q[r] = st.q[r];
  for (int s = 0; s < d.s; ++s) {
    const uint32_t c = (uint32_t)st.scell[s], y = __umulhi(c, wmagic);
    q[R + s] = (int)(c - y * W) | (int)y << 16;
  }
}

// FLATTENED observation of agent i from the view `v` (empty cells read dir
// [1,0,0,0]).  A window cell holds 7 + M features: [has_agent, dir(4),
// message(M), has_shelf, requested], the message that of the agent on the
// cell before this step's bits are sampled; kMsg = false compiles M = 0.
template <bool kMsg>
static __device__ __forceinline__ void build_obs_from_view(const int* v, const EnvDims& d, const EnvLayout& lay,
                                           const ObsDims& m, int i, __nv_bfloat16* xs, int TB,
                                           int tid) {
  const int N = d.n, R = d.r, W = d.w, M = kMsg ? d.m : 0, sr = m.sensor_range;
  const int side = 2 * sr + 1, w2 = side * side, CF = 7 + M;
  const int* q = v + 2 * N + N * M;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#define X(k) xs[(size_t)(k) * TB + tid]
  const int ax = v[i] & 0xFFFF, ay = v[i] >> 16, info = v[N + i];
  float fx = (float)ax, fy = (float)ay;
  if (m.normalised) {
    fx = __fdiv_rn(fx, (float)(W - 1));
    fy = __fdiv_rn(fy, (float)(d.h - 1));
  }
  X(0) = __float2bfloat16_rn(fx);
  X(1) = __float2bfloat16_rn(fy);
  X(2) = info & 4 ? one : zero;
  for (int k = 0; k < 4; ++k) X(3 + k) = (info & 3) == k ? one : zero;
  X(7) = lay.highway[ay * W + ax] ? one : zero;
  for (int c = 0; c < w2; ++c) {
    const int b = 8 + CF * c;
    for (int k = 0; k < CF; ++k) X(b + k) = k == 1 ? one : zero;
  }
  for (int j = 0; j < N; ++j) {
    const int rx = (v[j] & 0xFFFF) - ax + sr, ry = (v[j] >> 16) - ay + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + CF * (ry * side + rx);
    X(b) = one;
    X(b + 1) = zero;
    X(b + 1 + (v[N + j] & 3)) = one;
    for (int k = 0; k < M; ++k) X(b + 5 + k) = __float2bfloat16_rn((float)v[2 * N + j * M + k]);
  }
  for (int s = 0; s < d.s; ++s) {
    const int cs = q[R + s];
    const int rx = (cs & 0xFFFF) - ax + sr, ry = (cs >> 16) - ay + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + CF * (ry * side + rx) + M;
    X(b + 5) = one;
    bool inq = false;
    for (int r = 0; r < R; ++r) inq |= q[r] == s;
    if (inq) X(b + 6) = one;
  }
#undef X
}

// The image observation of agent i (pallas_rollout.py::_build_image_feats;
// rware_tpu_torch/core/observations.py::build_image_obs_fn) from the view
// `v`: C x w x w rows in (channel, row, column) order, then, for IMAGE_DICT,
// [dir-onehot(4), on_highway, carrying].  The column is zeroed, ACCESSIBLE
// set to the in-grid mask (out-of-grid cells are 0 in every layer: the zero
// pad), then every agent, shelf and goal inside the window is scattered to
// its rotated cell, one write per channel it shows in.  Messages are not
// observed.
static __device__ __forceinline__ void build_image_obs_from_view(const int* v, const EnvDims& d, int M,
                                                 const EnvLayout& lay, const ObsDims& m, int i,
                                                 __nv_bfloat16* xs, int TB, int tid) {
  const int N = d.n, R = d.r, r = m.sensor_range, side = 2 * r + 1, w2 = side * side;
  const int C = m.img_n_layers, dirl = m.img_directional;
  const int* q = v + 2 * N + N * M;
  const int ax = v[i] & 0xFFFF, ay = v[i] >> 16, dir = v[N + i] & 3;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#define X(k) xs[(size_t)(k) * TB + tid]
#define LAYER(c) ((m.img_layers >> (4 * (c))) & 15)
  for (int c = 0; c < C; ++c) {
    const bool acc = LAYER(c) == RW_ACCESSIBLE;
    for (int u = 0; u < side; ++u) {
      for (int w = 0; w < side; ++w) {
        bool in_grid = false;
        if (acc) {  // the world offset that lands on (u, w): the map's inverse
          int dy = u - r, dx = w - r;
          if (dirl && dir == 1) {
            dy = r - u;
            dx = r - w;
          } else if (dirl && dir == 2) {
            dy = r - w;
            dx = u - r;
          } else if (dirl && dir == 3) {
            dy = w - r;
            dx = r - u;
          }
          const int cx = ax + dx, cy = ay + dy;
          in_grid = cx >= 0 && cx < d.w && cy >= 0 && cy < d.h;
        }
        X(c * w2 + u * side + w) = in_grid ? one : zero;
      }
    }
  }
  for (int j = 0; j < N; ++j) {
    int cell;
    if (!rot_window_cell((v[j] >> 16) - ay, (v[j] & 0xFFFF) - ax, dir, dirl, r, &cell)) continue;
    const int info = v[N + j];
    for (int c = 0; c < C; ++c) {
      const int k = c * w2 + cell;
      switch (LAYER(c)) {
        case RW_AGENTS: X(k) = one; break;
        case RW_AGENT_DIRECTION: X(k) = __float2bfloat16_rn((float)((info & 3) + 1)); break;
        case RW_AGENT_LOAD: X(k) = info & 4 ? one : zero; break;
        case RW_ACCESSIBLE: X(k) = zero; break;
        default: break;
      }
    }
  }
  for (int s = 0; s < d.s; ++s) {
    int cell;
    const int cs = q[R + s];
    if (!rot_window_cell((cs >> 16) - ay, (cs & 0xFFFF) - ax, dir, dirl, r, &cell)) continue;
    bool inq = false;
    for (int k = 0; k < R; ++k) inq |= q[k] == s;
    for (int c = 0; c < C; ++c) {
      const int layer = LAYER(c);
      if (layer == RW_SHELVES || (layer == RW_REQUESTS && inq)) X(c * w2 + cell) = one;
    }
  }
  for (int g = 0; g < d.g; ++g) {
    int cell;
    if (!rot_window_cell(lay.goal_y[g] - ay, lay.goal_x[g] - ax, dir, dirl, r, &cell)) continue;
    for (int c = 0; c < C; ++c)
      if (LAYER(c) == RW_GOALS) X(c * w2 + cell) = one;
  }
  if (m.img_self) {
    const int b = C * w2;
    for (int k = 0; k < 4; ++k) X(b + k) = dir == k ? one : zero;
    X(b + 4) = lay.highway[ay * d.w + ax] ? one : zero;
    X(b + 5) = v[N + i] & 4 ? one : zero;
  }
#undef LAYER
#undef X
}

// The observation row of agent i from the view: the image window (kImage,
// K2e) or the FLATTENED vector.
template <bool kMsg, bool kImage>
static __device__ __forceinline__ void build_row_obs(const int* v, const EnvDims& d,
                                                     const EnvLayout& lay, const ObsDims& m,
                                                     int i, __nv_bfloat16* xs, int TB, int tid) {
  if (kImage)
    build_image_obs_from_view(v, d, kMsg ? d.m : 0, lay, m, i, xs, TB, tid);
  else
    build_obs_from_view<kMsg>(v, d, lay, m, i, xs, TB, tid);
}

// ---- observation chunks (the chunked route of K2d and K2d′) -----------------
//
// Features k0 .. k0 + kn - 1 of the row build_row_obs writes, written to
// xs[(k - k0) * TB + tid]: the same values, from the same view, in the same
// order of writes to a feature, each write kept where it lands in the chunk.
// The defaults of the chunk are set directly (a FLATTENED window cell reads
// [0, 1, 0, 0, 0, 0 ...]; an image window the in-grid mask in its ACCESSIBLE
// channels and 0 elsewhere), then the scatters of build_obs_from_view /
// build_image_obs_from_view run with every write outside the chunk dropped.

template <bool kMsg>
static __device__ __forceinline__ void build_obs_chunk_from_view(
    const int* v, const EnvDims& d, const EnvLayout& lay, const ObsDims& m, int i,
    __nv_bfloat16* xs, int TB, int tid, int k0, int kn) {
  const int N = d.n, R = d.r, W = d.w, M = kMsg ? d.m : 0, sr = m.sensor_range;
  const int side = 2 * sr + 1, CF = 7 + M, k1 = k0 + kn;
  const int* q = v + 2 * N + N * M;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#define X(k) xs[(size_t)((k) - k0) * TB + tid]
#define SET(k, val)                                   \
  do {                                                \
    const int k_ = (k);                               \
    if (k_ >= k0 && k_ < k1) X(k_) = (val);           \
  } while (0)
  for (int k = k0; k < k1; ++k) X(k) = zero;
  // the dir-0 one of every window cell (feature 8 + CF c + 1) in the chunk
  for (int k = k0 <= 9 ? 9 : 9 + (k0 - 9 + CF - 1) / CF * CF; k < k1; k += CF) X(k) = one;
  const int ax = v[i] & 0xFFFF, ay = v[i] >> 16, info = v[N + i];
  if (k0 < 8) {
    float fx = (float)ax, fy = (float)ay;
    if (m.normalised) {
      fx = __fdiv_rn(fx, (float)(W - 1));
      fy = __fdiv_rn(fy, (float)(d.h - 1));
    }
    SET(0, __float2bfloat16_rn(fx));
    SET(1, __float2bfloat16_rn(fy));
    SET(2, info & 4 ? one : zero);
    for (int k = 0; k < 4; ++k) SET(3 + k, (info & 3) == k ? one : zero);
    SET(7, lay.highway[ay * W + ax] ? one : zero);
  }
  for (int j = 0; j < N; ++j) {
    const int rx = (v[j] & 0xFFFF) - ax + sr, ry = (v[j] >> 16) - ay + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + CF * (ry * side + rx);
    if (b + CF <= k0 || b >= k1) continue;
    SET(b, one);
    SET(b + 1, zero);
    SET(b + 1 + (v[N + j] & 3), one);
    for (int k = 0; k < M; ++k) SET(b + 5 + k, __float2bfloat16_rn((float)v[2 * N + j * M + k]));
  }
  for (int s = 0; s < d.s; ++s) {
    const int cs = q[R + s];
    const int rx = (cs & 0xFFFF) - ax + sr, ry = (cs >> 16) - ay + sr;
    if (rx < 0 || rx >= side || ry < 0 || ry >= side) continue;
    const int b = 8 + CF * (ry * side + rx) + M;
    if (b + 7 <= k0 || b + 5 >= k1) continue;
    SET(b + 5, one);
    bool inq = false;
    for (int r = 0; r < R; ++r) inq |= q[r] == s;
    if (inq) SET(b + 6, one);
  }
#undef SET
#undef X
}

static __device__ __forceinline__ void build_image_obs_chunk_from_view(
    const int* v, const EnvDims& d, int M, const EnvLayout& lay, const ObsDims& m, int i,
    __nv_bfloat16* xs, int TB, int tid, int k0, int kn) {
  const int N = d.n, R = d.r, r = m.sensor_range, side = 2 * r + 1, w2 = side * side;
  const int C = m.img_n_layers, dirl = m.img_directional, k1 = k0 + kn;
  const int* q = v + 2 * N + N * M;
  const int ax = v[i] & 0xFFFF, ay = v[i] >> 16, dir = v[N + i] & 3;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f), zero = __float2bfloat16_rn(0.f);
#define X(k) xs[(size_t)((k) - k0) * TB + tid]
#define SET(k, val)                                   \
  do {                                                \
    const int k_ = (k);                               \
    if (k_ >= k0 && k_ < k1) X(k_) = (val);           \
  } while (0)
#define LAYER(c) ((m.img_layers >> (4 * (c))) & 15)
  for (int k = k0; k < k1; ++k) {
    const int c = k / w2;
    bool in_grid = false;
    if (c < C && LAYER(c) == RW_ACCESSIBLE) {  // the world offset that lands on (u, w)
      const int cell = k - c * w2, u = cell / side, w = cell - u * side;
      int dy = u - r, dx = w - r;
      if (dirl && dir == 1) {
        dy = r - u;
        dx = r - w;
      } else if (dirl && dir == 2) {
        dy = r - w;
        dx = u - r;
      } else if (dirl && dir == 3) {
        dy = w - r;
        dx = r - u;
      }
      const int cx = ax + dx, cy = ay + dy;
      in_grid = cx >= 0 && cx < d.w && cy >= 0 && cy < d.h;
    }
    X(k) = in_grid ? one : zero;
  }
  for (int j = 0; j < N; ++j) {
    int cell;
    if (!rot_window_cell((v[j] >> 16) - ay, (v[j] & 0xFFFF) - ax, dir, dirl, r, &cell)) continue;
    const int info = v[N + j];
    for (int c = 0; c < C; ++c) {
      const int k = c * w2 + cell;
      switch (LAYER(c)) {
        case RW_AGENTS: SET(k, one); break;
        case RW_AGENT_DIRECTION: SET(k, __float2bfloat16_rn((float)((info & 3) + 1))); break;
        case RW_AGENT_LOAD: SET(k, info & 4 ? one : zero); break;
        case RW_ACCESSIBLE: SET(k, zero); break;
        default: break;
      }
    }
  }
  for (int s = 0; s < d.s; ++s) {
    int cell;
    const int cs = q[R + s];
    if (!rot_window_cell((cs >> 16) - ay, (cs & 0xFFFF) - ax, dir, dirl, r, &cell)) continue;
    bool inq = false;
    for (int k = 0; k < R; ++k) inq |= q[k] == s;
    for (int c = 0; c < C; ++c) {
      const int layer = LAYER(c);
      if (layer == RW_SHELVES || (layer == RW_REQUESTS && inq)) SET(c * w2 + cell, one);
    }
  }
  for (int g = 0; g < d.g; ++g) {
    int cell;
    if (!rot_window_cell(lay.goal_y[g] - ay, lay.goal_x[g] - ax, dir, dirl, r, &cell)) continue;
    for (int c = 0; c < C; ++c)
      if (LAYER(c) == RW_GOALS) SET(c * w2 + cell, one);
  }
  if (m.img_self && C * w2 + 6 > k0) {
    const int b = C * w2;
    for (int k = 0; k < 4; ++k) SET(b + k, dir == k ? one : zero);
    SET(b + 4, lay.highway[ay * d.w + ax] ? one : zero);
    SET(b + 5, v[N + i] & 4 ? one : zero);
  }
#undef LAYER
#undef SET
#undef X
}

// Features k0 .. k0 + kn - 1 of agent i's observation row (build_row_obs's)
// into a thread's column of a chunk tile; a row of no env (pad) zero.
template <bool kMsg, bool kImage>
static __device__ __forceinline__ void build_row_chunk(const int* v, const EnvDims& d,
                                                       const EnvLayout& lay, const ObsDims& m,
                                                       int i, bool pad, __nv_bfloat16* xs,
                                                       int TB, int tid, int k0, int kn) {
  if (pad)
    for (int k = 0; k < kn; ++k) xs[(size_t)k * TB + tid] = __float2bfloat16_rn(0.f);
  else if (kImage)
    build_image_obs_chunk_from_view(v, d, kMsg ? d.m : 0, lay, m, i, xs, TB, tid, k0, kn);
  else
    build_obs_chunk_from_view<kMsg>(v, d, lay, m, i, xs, TB, tid, k0, kn);
}

// Features k0 .. k0 + kn - 1 of tile rows [r0, r1) (agent-major, row i * te +
// e; rows of no env, i >= N or e >= tev, skipped) from a feature-major chunk
// tile (row stride rs) to the trajectory's obs rows out + (e * N + i) * L:
// runs of 8 features of a row a thread, neighbouring threads on neighbouring
// runs.
static __device__ __forceinline__ void store_chunk_rows(unsigned short* out, int L, int k0,
                                                        int kn, const unsigned short* tile,
                                                        int rs, int r0, int r1, int N, int te,
                                                        int tev, int tid, int nt) {
  const int runs = (kn + 7) / 8, n = (r1 - r0) * runs;
  for (int q = tid; q < n; q += nt) {
    const int rr = q / runs, c0 = (q - rr * runs) * 8, r = r0 + rr, i = r / te, e = r - i * te;
    if (i >= N || e >= tev) continue;
    unsigned short* dst = out + ((size_t)e * N + i) * L + k0;
    const int c1 = min(c0 + 8, kn);
    for (int c = c0; c < c1; ++c) dst[c] = tile[(size_t)c * rs + r];
  }
}

static __device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- tiles and coalesced stores (K2a, K2c) ---------------------------------

// Eight bf16 values (16 bytes, element 0 in the low half of x) as floats.
static __device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
  }
}

static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// dst[0 .. n) as 16-byte vector stores where dst is aligned (scalar stores
// at the ragged ends), vector v by thread v of nt (lane `tid`).  run(q, cnt,
// out) fills out[0 .. cnt) with elements q .. q + cnt - 1.
template <typename T, typename Run>
static __device__ __forceinline__ void store_span(T* dst, int n, int tid, int nt, Run run) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (int)(((16 - ((size_t)dst & 15)) & 15) / sizeof(T)));
  const int nv = (n - head) / V, tail = head + nv * V;
  for (int q = tid; q < head; q += nt) run(q, 1, dst + q);
  for (int v = tid; v < nv; v += nt) {
    union {
      uint4 u;
      T e[V];
    } pk;
    run(head + v * V, V, pk.e);
    *reinterpret_cast<uint4*>(dst + head + v * V) = pk.u;
  }
  for (int q = tail + tid; q < n; q += nt) run(q, 1, dst + q);
}

// Elements (g, c) of a feature-major bf16 tile's rows in (env, agent) order,
// g = e * N + i, `width` features a row: feature c of row i * te + e of the
// tile (row stride rs), as 16-bit words.
struct TileRowRun {
  const unsigned short* tile;
  int rs, width, N, te;
  __device__ __forceinline__ void operator()(int q, int cnt, unsigned short* out) const {
    int g = q / width, c = q - g * width;
    int e = g / N, i = g - e * N;
    for (int s = 0; s < cnt; ++s) {
      out[s] = tile[(size_t)c * rs + i * te + e];
      if (++c == width) {
        c = 0;
        if (++i == N) {
          i = 0;
          ++e;
        }
      }
    }
  }
};

// Elements (g, c) of the tile's rows in (env, agent) order, g = e * N + i,
// `width` of them a row: row i * te + e of a per-row array (`stride`
// elements apart).  T is a 4-byte type.
template <typename T>
struct RowRun {
  const T* base;
  int stride, width, N, te;
  __device__ __forceinline__ void operator()(int q, int cnt, T* out) const {
    int g = q / width, c = q - g * width;
    int e = g / N, i = g - e * N;
    for (int s = 0; s < cnt; ++s) {
      out[s] = base[(i * te + e) * stride + c];
      if (++c == width) {
        c = 0;
        if (++i == N) {
          i = 0;
          ++e;
        }
      }
    }
  }
};

// Gumbel-argmax over 23-bit uniforms (argmax in deterministic mode; ties go
// to the lowest action) from the A logits `lg` of agent i of env e at step t,
// and the log-probability of the action taken.
static __device__ __forceinline__ int sample_gumbel(const float* lg, int A, int deterministic,
                                                    const EnvDims& d, int e, int t, int i,
                                                    float* logp) {
  int act = 0;
  float best = 0.f;
  for (int a = 0; a < A; ++a) {
    float score = lg[a];
    if (!deterministic) {
      const uint32_t bits = draw_bits(d, e, t, RW_ACTION, i * A + a);
      const float u = (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f);
      score = __fsub_rn(lg[a], logf(__fadd_rn(-logf(__fadd_rn(u, 1e-10f)), 1e-10f)));
    }
    if (a == 0 || score > best) {
      best = score;
      act = a;
    }
  }
  float mx = lg[0];
  for (int a = 1; a < A; ++a) mx = fmaxf(mx, lg[a]);
  float ssum = 0.f;
  for (int a = 0; a < A; ++a) ssum += expf(lg[a] - mx);
  *logp = lg[act] - (mx + logf(ssum));
  return act;
}

// K2b: agent i's M message bits from its message logits `ml`
// (pallas_rollout.py::_sample_bernoulli): bit k is u < sigmoid(l) for the
// 23-bit uniform u of Philox purpose MESSAGE, slot i * M + k, or l > 0 in
// deterministic mode.  Writes the bits and returns their summed
// log-probability, log sigmoid(+-l) = min(+-l, 0) - log(1 + exp(-|l|)).  The
// sigmoid is gru_sigmoid's correctly rounded formula: a bit feeds back into
// the next observation, so the plain version repeats it exactly
// (rware_tpu_torch/models/networks.py::sample_bernoulli).
static __device__ __forceinline__ float sample_bernoulli(const float* ml, int M, int deterministic,
                                                         const EnvDims& d, int e, int t, int i,
                                                         int* bits) {
  float lp = 0.f;
  for (int k = 0; k < M; ++k) {
    const float l = ml[k];
    bool bit;
    if (deterministic) {
      bit = l > 0.f;
    } else {
      const uint32_t r = draw_bits(d, e, t, RW_MESSAGE, i * M + k);
      bit = (float)(r & 0x7FFFFFu) * (1.0f / 8388608.0f) < gru_sigmoid(l);
    }
    bits[k] = bit ? 1 : 0;
    const float log1pe = logf(__fadd_rn(1.f, expf(-fabsf(l))));
    lp = __fadd_rn(lp, __fsub_rn(fminf(bit ? l : -l, 0.f), log1pe));
  }
  return lp;
}
