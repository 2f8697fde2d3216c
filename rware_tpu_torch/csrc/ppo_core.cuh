// Shared definitions of the clipped-PPO gradient kernels (K4,
// fused_ppo_grads.cu), the whole-update-phase entry point (K3,
// fused_ppo_update.cu), their MAPPO counterparts (K5 fused_mappo_grads.cu,
// K6 fused_critic_values.cu, K7 fused_mappo_update.cu) and SEAC-PPO's per-agent
// gradient kernel (K8 fused_seac_grads.cu).
//
// Parameters, gradients and Adam moments are one flat float32 vector of the
// six kernel-layout blocks of rware_tpu_torch/models/networks.py::BlockDims:
//   [W0 (L, H1) | b0 (H1) | W1 (H1, H2) | b1 (H2) | Wc (H2, AC) | bc (AC)]
// with AC = A + 1 (policy logits then the value), or A + 1 + M with K4's
// message head (M Bernoulli logits after the value; pallas_update.py:109).  Each weight block
// followed by its bias is the stacked (fan_in + 1, fan_out) matrix, so a
// weight-gradient pass writes weight and bias gradients in one output (the
// bias row is the column sums of the cotangent).
//
// A sample is one (t, b, n) of a minibatch window: rows (start + t) % T_full,
// t < T_mb, of the (T_full, B, N, ...) trajectory, read in place.
//
// MAPPO's central critic has the same six blocks with other sizes,
//   [C0 (N*L, CH1) | cb0 | C1 (CH1, CH2) | cb1 | Cv (CH2, N) | cbv (N)],
// and a sample of it is one (t, b): the joint observation obs[t, b] is the
// contiguous (N, L) rows of that env, which is the agent-major feature order
// n * L + l of C0's rows.  So the critic is described by a PpoDims with
// L = N*L, N = 1 and `heads` = the number of agents; its per-agent old values
// and targets sit at [row * heads + n].
//
// SEAC-PPO (K8) runs the actor's layout once per agent i: agent i's own
// parameters, a sample (t, b, j) of the window is row (t * B + b) * N + j of the
// trajectory as above (agent j's observation, action and behaviour log-prob),
// and its old value, advantage and target are agent i's critic on agent j's
// experience, at the same row of the (N_i, T_full, B, N_j) cross arrays' slab i.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PPO_THREADS 256  // threads of the per-sample kernel: eight warps
#define PPO_HC 8         // head rows kept per sample (AC <= 8)
#define PPO_HC_MAX 16    // the same with K4's message head (AC <= 16)
#define PPO_TM 64        // samples a tile of the per-sample kernel
#define PPO_KC 64        // dense_0's k chunk: obs features (and streamed W0 rows) a step
#define PPO_PAD 8        // bf16 columns added to each shared-memory row (GM_PAD of gru_mma.cuh)
#define PPO_HMAX 128     // widest hidden layer the tensor-core tiles take

struct PpoDims {
  int L, H1, H2, A;        // input length, hidden widths, actions (actor)
  int heads;               // head columns: A + 1 (actor) or the agents (critic)
  int hc;                  // head rows kept per sample (>= heads)
  int value_head;          // actor: the local value head takes part in the loss
  int msg_bits;            // actor (K4): M message bits, heads = A + 1 + M
  int T_full, T_mb, B, N;  // trajectory length, window length, envs, agents per row
  float clip_eps, vf_coef, ent_coef, inv_n;  // inv_n = 1 / (T_mb * B * agents)
  int tile;                // samples per tile of the per-sample kernel (PPO_TM)
  int grid;                // blocks of the per-sample kernel
  int smem;                // its dynamic shared memory, bytes (ppo_smem(...).total)
  int w0_smem;             // dense_0's weights resident in shared memory (else streamed)
  int chunk, n_chunks;     // samples per weight-gradient partial, and how many
  int wgrad_smem;          // the weight-gradient kernel's shared memory (gru_wgrad_smem())
  int agent;               // SEAC: the agent i whose network runs; sample row r holds j = r % N
  float seac_lambda;       // SEAC: the weight of pairs i != j
};

struct PpoData {  // the (T_full, B, N, ...) trajectory
  const __nv_bfloat16* obs;  // (.., L) bf16
  const int* action;
  const float *logp, *value, *adv, *target;
  const int* bits;  // (.., M) message bits, with msg_bits
};

// Per-sample rows are bf16 with a row stride of ppo_r8(H) (16-byte rows;
// the columns past H are zeros).
struct PpoScratch {
  __nv_bfloat16 *h1, *h2, *dz1, *dz2;  // (S, ppo_r8(H)) per sample
  float* part_head;                    // (grid, (H2 + 1) * heads): each block's [dWc | dbc]
  float* partial;                      // (n_chunks, offsets.wc): [dW0 | db0 | dW1 | db1]
  float* part_mets;                    // (grid, 4)
  float* values;                       // K6 only: (T_full, B, agents) output
};

static inline __host__ __device__ int ppo_r4(int x) { return (x + 3) / 4 * 4; }
static inline __host__ __device__ int ppo_r8(int x) { return (x + 7) / 8 * 8; }
static inline __host__ __device__ int ppo_r16(int x) { return (x + 15) / 16 * 16; }

// Byte offsets of the per-sample kernel's dynamic shared memory, and its
// size (rware_tpu_torch/ops/fused_update.py::ppo_plan computes the same
// numbers on its own; a launch whose numbers differ is refused).  Widths are
// padded: H to 16 (the mma tiles), the head columns to 4 (float4 steps).
//   f32:  b0 (H1p) | b1 (H2p) | Wc (H2, HCP) | Wc^T (HCP, H2p) | bc (HCP)
//         | head tile (TM, HCP) | dWc sums (H2, HCP) | dbc sums by sample slot (TM, HCP)
//   i64:  the tile's trajectory rows (TM)
//   bf16: W1 (H1p, H2p + PAD) | W0 resident (K0p, H1p + PAD) or one streamed
//         k chunk (KC, H1p + PAD) | the activation tile (TM, max(H1p, H2p, KC) + PAD)
struct PpoSmem {
  int b0, b1, wc, wct, bc, hcs, acch, dbcs, rows, w1, w0, act, total;
};

static inline __host__ __device__ PpoSmem ppo_smem(int K0, int H1, int H2, int hc, int w0_smem) {
  const int H1p = ppo_r16(H1), H2p = ppo_r16(H2), HCP = ppo_r4(hc), K0p = ppo_r16(K0);
  int wide = H1p > H2p ? H1p : H2p;
  wide = wide > PPO_KC ? wide : PPO_KC;
  PpoSmem m;
  int o = 0;
  m.b0 = o;
  o += 4 * H1p;
  m.b1 = o;
  o += 4 * H2p;
  m.wc = o;
  o += 4 * H2 * HCP;
  m.wct = o;
  o += 4 * HCP * H2p;
  m.bc = o;
  o += 4 * HCP;
  m.hcs = o;
  o += 4 * PPO_TM * HCP;
  m.acch = o;
  o += 4 * H2 * HCP;
  m.dbcs = o;
  o += 4 * PPO_TM * HCP;
  m.rows = o;
  o += 8 * PPO_TM;
  m.w1 = o;
  o += 2 * H1p * (H2p + PPO_PAD);
  m.w0 = o;
  o += 2 * (w0_smem ? K0p : PPO_KC) * (H1p + PPO_PAD);
  m.act = o;
  o += 2 * PPO_TM * (wide + PPO_PAD);
  m.total = o;
  return m;
}

struct PpoOffsets {
  long long b0, w1, b1, wc, bc, n;
};

static inline __host__ __device__ PpoOffsets ppo_offsets(const PpoDims& d) {
  PpoOffsets o;
  const long long ac = d.heads;
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

// Whether the launch numbers in `d` are the kernels' own: the tile, the
// per-sample kernel's shared memory (ppo_smem), the widths the tensor-core
// tiles take (multiples of 4 up to PPO_HMAX), and with `backward` the
// weight-gradient chunks (multiples of 64 samples covering the window) and
// that kernel's shared memory (gru_wgrad_smem).  0 if they are, else
// cudaErrorInvalidValue.
int ppo_plan_check(const PpoDims& d, int backward);

// Enqueues on `stream` the gradient of the clipped-PPO loss of one window
// (start[0] on the device) with advantage stats stats[0..1] = [mean, 1/std]
// (on the device): `grads` (n_params) and `mets` (4) = sums over the window
// of [min(pg1, pg2), 0.5 max(e1^2, e2^2), entropy, (ratio - 1) - log ratio].
// With `marks` (four events) not null, records marks[0] before the
// per-sample kernel, marks[1] before the weight-gradient products, marks[2]
// before their reduction and marks[3] after the metric sums.
// Returns a CUDA error code (0 on success).
int ppo_grads_enqueue(const PpoDims& d, const int* start, const float* stats,
                      const PpoData& data, const float* params, const PpoScratch& ws,
                      float* grads, float* mets, cudaStream_t stream,
                      const cudaEvent_t* marks = nullptr);

// The pieces of that gradient, for callers that combine two networks (K5):
// the actor's per-sample kernel (d.value_head = 0 leaves the local value
// head out of loss and gradient: its dcat row is exactly zero), which also
// leaves each block's head gradient [dWc | dbc] in ws.part_head; the two
// bf16 weight-gradient products, and the fixed-order reduction of their
// chunk partials and the blocks' head partials into `grads` (marks: events
// recorded before the products and before the reduction, or null); and the
// metric sums of one or two per-block partial buffers (b may be null).
int ppo_actor_sample_launch(const PpoDims& d, const int* start, const float* stats,
                            const PpoData& data, const float* params, const PpoScratch& ws,
                            cudaStream_t stream);
int ppo_wgrads_launch(const PpoDims& d, const int* start, const __nv_bfloat16* obs,
                      const PpoScratch& ws, float* grads, cudaStream_t stream,
                      const cudaEvent_t* marks = nullptr);
int ppo_metrics_launch(const float* part_a, int n_a, const float* part_b, int n_b, float* mets,
                       cudaStream_t stream);

// One clip + Adam step of up to two parameter vectors, each with its own
// global norm, from the hyper row [lr_t, 1/(1-b1^t), 1/(1-b2^t)] on the device.
struct AdamPart {
  float *params, *mu, *nu;
  const float* grads;
  long long n;
};
struct AdamParts {
  AdamPart part[2];
};
int ppo_clip_adam_launch(const AdamParts& parts, int n_parts, const float* hyper,
                         float max_grad_norm, cudaStream_t stream);

// Enqueues the MAPPO gradients of one window (K5): the actor's (policy and
// entropy terms, `da`) unless with_actor is 0, and the central critic's
// (clipped value loss, `dc`), and mets = [sum obj, sum 0.5 max(e1^2, e2^2),
// sum entropy, sum (ratio - 1) - log ratio] (critic only: [0, v, 0, 0]).
int mappo_grads_enqueue(const PpoDims& da, const PpoDims& dc, int with_actor, const int* start,
                        const float* stats, const PpoData& data, const float* aparams,
                        const float* cparams, const PpoScratch& wsa, const PpoScratch& wsc,
                        float* agrads, float* cgrads, float* mets, cudaStream_t stream);

// PpoDims of the actor from the flat C arguments shared by the entry points.
static inline PpoDims ppo_dims(int L, int H1, int H2, int A, int T_full, int T_mb, int B, int N,
                               float clip_eps, float vf_coef, float ent_coef, float inv_n,
                               int tile, int grid, int smem, int w0_smem, int chunk,
                               int n_chunks, int wgrad_smem) {
  PpoDims d;
  d.L = L;
  d.H1 = H1;
  d.H2 = H2;
  d.A = A;
  d.heads = A + 1;
  d.hc = PPO_HC;
  d.value_head = 1;
  d.msg_bits = 0;
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
  d.wgrad_smem = wgrad_smem;
  d.agent = 0;
  d.seac_lambda = 1.f;
  return d;
}

// PpoDims of the central critic (see the top of this file) from flat C
// arguments: K0 = agents * obs length.
static inline PpoDims critic_dims(int K0, int CH1, int CH2, int agents, int T_full, int T_mb,
                                  int B, float clip_eps, float vf_coef, float inv_n, int tile,
                                  int grid, int smem, int w0_smem, int chunk, int n_chunks,
                                  int wgrad_smem) {
  PpoDims d = ppo_dims(K0, CH1, CH2, 0, T_full, T_mb, B, 1, clip_eps, vf_coef, 0.f, inv_n, tile,
                       grid, smem, w0_smem, chunk, n_chunks, wgrad_smem);
  d.heads = agents;
  d.hc = agents;
  return d;
}
