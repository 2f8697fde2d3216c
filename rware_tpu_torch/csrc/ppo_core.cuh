// Shared definitions of the clipped-PPO gradient kernels (K4,
// fused_ppo_grads.cu) and the whole-update-phase entry point (K3,
// fused_ppo_update.cu).
//
// Parameters, gradients and Adam moments are one flat float32 vector of the
// six kernel-layout blocks of rware_tpu_torch/models/networks.py::BlockDims:
//   [W0 (L, H1) | b0 (H1) | W1 (H1, H2) | b1 (H2) | Wc (H2, AC) | bc (AC)]
// with AC = A + 1 (policy logits then the value).  Each weight block
// followed by its bias is the stacked (fan_in + 1, fan_out) matrix, so the
// weight-gradient products write weight and bias gradients in one pass (the
// bias row is the product with a column of ones).
//
// A sample is one (t, b, n) of a minibatch window: rows (start + t) % T_full,
// t < T_mb, of the (T_full, B, N, ...) trajectory, read in place.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PPO_THREADS 256  // threads of the per-sample and weight-gradient kernels
#define PPO_HC 8         // head rows kept per sample (AC <= 8)
#define PPO_SK 32        // samples per step of the weight-gradient kernel
#define PPO_TW 64        // weight-gradient output tile, rows and columns

struct PpoDims {
  int L, H1, H2, A;        // obs length, hidden widths, actions
  int T_full, T_mb, B, N;  // trajectory length, window length, envs, agents
  float clip_eps, vf_coef, ent_coef, inv_n;  // inv_n = 1 / (T_mb * B * N)
  int tile;                // samples per tile of the per-sample kernel
  int grid;                // blocks of the per-sample kernel
  int smem;                // its dynamic shared memory, bytes
  int w0_smem;             // dense_0's weights in shared memory (else read from params)
  int chunk, n_chunks;     // samples per weight-gradient partial, and how many
};

struct PpoData {  // the (T_full, B, N, ...) trajectory
  const __nv_bfloat16* obs;  // (.., L) bf16
  const int* action;
  const float *logp, *value, *adv, *target;
};

struct PpoScratch {
  __nv_bfloat16 *h1, *h2, *dz1, *dz2;  // (S, H) per sample
  float* dcat;                         // (S, PPO_HC): [dlogits | dvalue | 0]
  float* partial;                      // (n_chunks, n_params)
  float* part_mets;                    // (grid, 4)
};

struct PpoOffsets {
  long long b0, w1, b1, wc, bc, n;
};

static inline __host__ __device__ PpoOffsets ppo_offsets(const PpoDims& d) {
  PpoOffsets o;
  const long long ac = d.A + 1;
  o.b0 = (long long)d.L * d.H1;
  o.w1 = o.b0 + d.H1;
  o.b1 = o.w1 + (long long)d.H1 * d.H2;
  o.wc = o.b1 + d.H2;
  o.bc = o.wc + (long long)d.H2 * ac;
  o.n = o.bc + ac;
  return o;
}

// Trajectory row (t * B + b) * N + n of minibatch sample s.
static inline __device__ long long ppo_row(const PpoDims& d, int start, long long s) {
  const long long bn = (long long)d.B * d.N;
  const long long t = s / bn;
  return ((start + t) % d.T_full) * bn + (s - t * bn);
}

// Enqueues on `stream` the gradient of the clipped-PPO loss of one window
// (start[0] on the device) with advantage stats stats[0..1] = [mean, 1/std]
// (on the device): `grads` (n_params) and `mets` (4) = sums over the window
// of [min(pg1, pg2), 0.5 max(e1^2, e2^2), entropy, (ratio - 1) - log ratio].
// Returns a CUDA error code (0 on success).
int ppo_grads_enqueue(const PpoDims& d, const int* start, const float* stats,
                      const PpoData& data, const float* params, const PpoScratch& ws,
                      float* grads, float* mets, cudaStream_t stream);

// PpoDims from the flat C arguments shared by both entry points.
static inline PpoDims ppo_dims(int L, int H1, int H2, int A, int T_full, int T_mb, int B, int N,
                               float clip_eps, float vf_coef, float ent_coef, float inv_n,
                               int tile, int grid, int smem, int w0_smem, int chunk,
                               int n_chunks) {
  PpoDims d;
  d.L = L;
  d.H1 = H1;
  d.H2 = H2;
  d.A = A;
  d.T_full = T_full;
  d.T_mb = T_mb;
  d.B = B;
  d.N = N;
  d.clip_eps = clip_eps;
  d.vf_coef = vf_coef;
  d.ent_coef = ent_coef;
  d.inv_n = inv_n;
  d.tile = tile;
  d.grid = grid;
  d.smem = smem;
  d.w0_smem = w0_smem;
  d.chunk = chunk;
  d.n_chunks = n_chunks;
  return d;
}
