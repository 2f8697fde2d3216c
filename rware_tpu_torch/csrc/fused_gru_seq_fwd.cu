// K11: the GRU sequence forward from precomputed input gates — the hidden
// sequence hseq (T, n_env, N, Hg) bf16 of an env band, each step's hidden
// BEFORE the episode-boundary reset, from the band-local fused input gates
// iall (T, n_env, N, 3Hg) bf16 [r | z | n], done (T, B) and h0 (B, N, Hg)
// read through the band (gru_seq.cuh).
//
// Replaces rware_tpu/ops/pallas_gru.py::build_gru_seq_fwd (kernel lines
// 93-123).  The TPU kernel walks a sequential (env rows, time chunks) grid and
// carries the hidden in VMEM scratch.  Here a block of sixteen warps owns S =
// 16, 32 or 64 sequences for all T steps (ops/fused_gru.py::gru_seq_fwd_plan:
// the smallest S whose blocks fit the card's SMs in one wave, else 64) and
// runs the forward sweep it shares with K9 (gru_fwd_sweep.cuh): Wh and the
// hidden resident in shared memory, h Wh on the tensor cores (bf16 mma.sync,
// f32 sums), warp w owning hidden units 8w .. 8w + 8 of all three gates, the
// cell in the plain version's rounding:
//   r, z = bf16(sigmoid(f32(iall) + h Wh)),
//   n = bf16(tanh(bf16(iall_n + bf16(r * bf16(h Whn + bhn))))),
//   new_h = bf16(bf16((1 - z) n) + bf16(z h)),
//   h <- 0 where done[t].
//
// This file is the sweep's input side.  The band's iall is band-local, so a
// block's rows of a step are one contiguous run of S x 3Hg bf16, 16-byte
// aligned for every Hg that is a multiple of 8: it goes by 16-byte cp.async
// into one padded tile of shared memory, no staging and no repack.  At the
// step's start each warp takes its units' iall from the tile into registers
// (ldmatrix, already in the accumulator layout of h Wh); after the barrier
// that follows, the next step's run is issued into the same tile, so it is in
// flight during this step's h Wh.  A second whole tile would not fit beside
// Wh at S = 64, Hg = 128 (235,776 of 232,448 bytes).
//
// The products differ from the plain version only in the order of their f32
// sums (a bf16 x bf16 product is exact in f32); each sum has one fixed order
// and there are no atomics, so two launches give the same bits.
//
// Bound on the card: bytes (iall in, hseq out: 6 Hg + 2 Hg bytes a
// sequence-step against Hg x 3Hg multiply-adds, 49k at Hg = 128, on the
// tensor cores).
#include "gru_fwd_sweep.cuh"
#include "gru_seq.cuh"

namespace {

// A block's shared memory, byte offsets: Wh, the hidden's two buffers, the
// step's iall tile (rows of gf_ldw), then an int a row.
struct GsLayout {
  int ld, whs, hs, tile, flags, bytes;
};

static __host__ __device__ __forceinline__ GsLayout gs_layout(int Hg, int S) {
  GsLayout o;
  const int b = (int)sizeof(gm_bf16);
  o.ld = gf_ldw(Hg);
  o.whs = 0;                                // (H16, ld): Wh, [k][r | z | n]
  o.hs = o.whs + gm_r16(Hg) * o.ld * b;     // 2 x (S, gf_ldh): the hidden
  o.tile = o.hs + 2 * S * gf_ldh(Hg) * b;   // (S, ld): iall of the step
  o.flags = o.tile + S * o.ld * b;          // (S,) ints: done of the step before
  o.bytes = o.flags + S * (int)sizeof(int);
  return o;
}

static __device__ __forceinline__ __nv_bfloat162 gs_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// K11's input side of gf_sweep: step t's iall run into the tile one step
// ahead, into the warps' registers at the step's start.
template <int MT>
struct GsIallInput {
  static constexpr int S = 16 * MT;
  const gm_bf16* iall;
  gm_bf16* tile;
  int Hg, T, Q, q0, n_rows, ld;

  __device__ GsIallInput(const GruSeqDims& d, const gm_bf16* iall_, gm_bf16* tile_, int ld_)
      : iall(iall_), tile(tile_), Hg(d.Hg), T(d.T), Q(d.n_env * d.N), q0(blockIdx.x * S),
        ld(ld_) {
    n_rows = min(S, Q - q0);
  }

  // Step t's rows of the block (band rows t Q + q0 ..) into the tile: warp w
  // copies rows w, w + 16, .., lane l chunks l and l + 32 of a row; rows past
  // Q are zeros.
  __device__ __forceinline__ void issue(int t) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, G3 = 3 * Hg;
    const gm_bf16* run = iall + ((size_t)t * Q + q0) * G3;
#pragma unroll
    for (int i = 0; i < S / GF_WARPS; ++i) {
      const int s = warp + GF_WARPS * i;
      const bool ok = s < n_rows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = (lane + 32 * h) * 8;
        if (cc < G3) gm_cp16(tile + s * ld + cc, ok ? run + (size_t)s * G3 + cc : iall, ok);
      }
    }
  }

  __device__ __forceinline__ void start() const { issue(0); }

  // The warp's units of the step's iall, from the tile: per m-tile one x4
  // (r and z, rows 0-7 and 8-15) and one x2 (n).
  __device__ __forceinline__ void arrived(int, __nv_bfloat162 (&ia)[3][MT][2]) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (8 * warp >= Hg) return;
    const int mat = lane >> 3, row = 8 * (mat & 1) + (lane & 7);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t rz[4], n[2];
      gm_ldsm4(rz, tile + (16 * m + row) * ld + (mat >> 1) * Hg + 8 * warp);
      gm_ldsm2(n, tile + (16 * m + row) * ld + 2 * Hg + 8 * warp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ia[0][m][h] = gs_bf2(rz[h]);
        ia[1][m][h] = gs_bf2(rz[2 + h]);
        ia[2][m][h] = gs_bf2(n[h]);
      }
    }
  }

  // After the barrier that follows arrived: every warp has read the tile, so
  // the next step's run goes into it.
  template <class Mark>
  __device__ __forceinline__ void gates(int t, __nv_bfloat162 (&)[3][MT][2], Mark& mark) const {
    if (t + 1 < T) issue(t + 1);
    gm_cp_commit();
    mark(1);
  }
};

template <int MT>
__global__ void __launch_bounds__(GF_THREADS, 1)
    gru_seq_fwd_kernel(GruSeqDims d, const gm_bf16* __restrict__ iall,
                       const uint8_t* __restrict__ done, const gm_bf16* __restrict__ h0,
                       const gm_bf16* __restrict__ wh, const float* __restrict__ bhn,
                       gm_bf16* __restrict__ hseq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GsLayout lo = gs_layout(d.Hg, 16 * MT);
  GsIallInput<MT> in(d, iall, (gm_bf16*)(smem + lo.tile), lo.ld);
  gf_sweep<MT>(d, (gm_bf16*)(smem + lo.whs), (gm_bf16*)(smem + lo.hs), (int*)(smem + lo.flags),
               done, h0, wh, bhn, hseq, in);
}

template <int MT>
int gs_launch(const GruSeqDims& d, int smem, const void* iall, const void* done, const void* h0,
              const void* wh, const void* bhn, void* hseq, cudaStream_t stream) {
  const int S = 16 * MT, Q = d.n_env * d.N;
  cudaError_t err = cudaFuncSetAttribute(gru_seq_fwd_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gru_seq_fwd_kernel<MT><<<(Q + S - 1) / S, GF_THREADS, smem, stream>>>(
      d, (const gm_bf16*)iall, (const uint8_t*)done, (const gm_bf16*)h0, (const gm_bf16*)wh,
      (const float*)bhn, (gm_bf16*)hseq);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan's numbers (rware_tpu_torch/ops/fused_gru.py::gru_seq_fwd_plan):
// rows, 16, 32 or 64 sequences a block, and smem, the block's dynamic shared
// memory in bytes, which must be what gs_layout gives.
extern "C" int rw_fused_gru_seq_fwd(int Hg, int T, int B, int N, int start_env, int n_env,
                                    int rows, int smem, const void* iall, const void* done,
                                    const void* h0, const void* wh, const void* bhn, void* hseq,
                                    void* stream) {
  if (!gsq_widths_ok(Hg, T, B, n_env) || N < 1 || start_env < 0 || start_env >= B
      || (rows != 16 && rows != 32 && rows != 64) || smem != gs_layout(Hg, rows).bytes)
    return (int)cudaErrorInvalidValue;
  const GruSeqDims d = {0, 0, Hg, T, B, N, start_env, n_env};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 64) return gs_launch<4>(d, smem, iall, done, h0, wh, bhn, hseq, s);
  if (rows == 32) return gs_launch<2>(d, smem, iall, done, h0, wh, bhn, hseq, s);
  return gs_launch<1>(d, smem, iall, done, h0, wh, bhn, hseq, s);
}
