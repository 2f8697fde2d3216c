// Tensor-core pieces of the GRU sequence kernels: the forward sweep of K9 and
// K11 (gru_fwd_sweep.cuh), K10's prologue, sweep and epilogue
// (fused_gru_bwd.cu) and the weight-gradient pass that K10, K12 and K13 share
// (gru_wgrad.cuh).
//
// Every product runs on bf16 operands with f32 sums:
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, its operands read from
// shared memory with ldmatrix (.trans where the tile is stored the other way
// round), and the tiles brought in with cp.async.  A bf16 x bf16 product is
// exact in f32, so these products differ from f32 FMAs on the same bf16
// values only in the order of the sum.
//
// Fragment layout of one m16n8k16 product, lane l, g = l / 4, c = l % 4:
//   A (16 x 16): a[0] (g, 2c..2c+1), a[1] (g+8, 2c..), a[2] (g, 2c+8..),
//                a[3] (g+8, 2c+8..);
//   B (16 x 8):  b[0] (k 2c..2c+1, n g), b[1] (k 2c+8.., n g);
//   C (16 x 8):  c[0..1] (g, 2c..2c+1), c[2..3] (g+8, 2c..2c+1).
// A thread's two accumulator columns are two neighbouring outputs, so the
// elementwise code around a product works on pairs (bf16x2, float2).
//
// Shared-memory tiles are bf16 rows of a multiple of 16 columns plus GM_PAD:
// a stride of 16 bytes past a multiple of 32 puts ldmatrix's eight rows on
// distinct banks.  The padding columns are zero whenever a product reads them.
#pragma once

#include "gru_core.cuh"

#define GM_THREADS 256  // eight warps a block
#define GM_PAD 8        // bf16 columns added to each shared-memory row

typedef __nv_bfloat16 gm_bf16;

static __host__ __device__ __forceinline__ int gm_r16(int x) { return (x + 15) / 16 * 16; }

static __device__ __forceinline__ uint32_t gm_sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void gm_ldsm4(uint32_t (&r)[4], const gm_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(gm_sa(p)));
}

static __device__ __forceinline__ void gm_ldsm4_t(uint32_t (&r)[4], const gm_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(gm_sa(p)));
}

static __device__ __forceinline__ void gm_ldsm2(uint32_t (&r)[2], const gm_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(gm_sa(p)));
}

static __device__ __forceinline__ void gm_ldsm2_t(uint32_t (&r)[2], const gm_bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(gm_sa(p)));
}

// c += a b on the tensor cores.
static __device__ __forceinline__ void gm_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
// (src is then not read, but must be a device address).
static __device__ __forceinline__ void gm_cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(gm_sa(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void gm_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
static __device__ __forceinline__ void gm_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A (16 x 16) from a [m][k] tile: rows m0.., columns k0...
static __device__ __forceinline__ void gm_frag_a(uint32_t (&a)[4], const gm_bf16* s, int ld,
                                                 int m0, int k0) {
  const int l = threadIdx.x & 31;
  gm_ldsm4(a, s + (size_t)(m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}

// A (16 x 16) from a [k][m] tile (stored transposed): rows m0.., k0...
static __device__ __forceinline__ void gm_frag_at(uint32_t (&a)[4], const gm_bf16* s, int ld,
                                                  int m0, int k0) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  gm_ldsm4_t(a, s + (size_t)(k0 + (mat >> 1) * 8 + (l & 7)) * ld + m0 + (mat & 1) * 8);
}

// B (16 x 8) from a [k][n] tile: rows k0.., columns n0...
static __device__ __forceinline__ void gm_frag_b_kn(uint32_t (&b)[2], const gm_bf16* s, int ld,
                                                    int n0, int k0) {
  const int l = threadIdx.x & 15;  // .x2 reads the addresses of lanes 0-15
  gm_ldsm2_t(b, s + (size_t)(k0 + l) * ld + n0);
}

// B (16 x 8) from an [n][k] tile: B[k][n] = s[n][k].
static __device__ __forceinline__ void gm_frag_b_nk(uint32_t (&b)[2], const gm_bf16* s, int ld,
                                                    int n0, int k0) {
  const int l = threadIdx.x & 15;
  gm_ldsm2(b, s + (size_t)(n0 + (l & 7)) * ld + k0 + (l >> 3) * 8);
}

// Two B (16 x 8) side by side from a [k][n] tile: b[0..1] columns n0..,
// b[2..3] columns n0 + 8...
static __device__ __forceinline__ void gm_frag_b2_kn(uint32_t (&b)[4], const gm_bf16* s, int ld,
                                                     int n0, int k0) {
  const int l = threadIdx.x & 31, mat = l >> 3;
  gm_ldsm4_t(b, s + (size_t)(k0 + (mat & 1) * 8 + (l & 7)) * ld + n0 + (mat >> 1) * 8);
}

static __device__ __forceinline__ __nv_bfloat162 gm_pack(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// The trajectory row (t, env, agent) of band sample smp, for (T, B, N, .)
// tensors read through the band.
static __device__ __forceinline__ long long gru_traj_row(const GruSeqDims& d, long long smp) {
  const int Q = d.n_env * d.N;
  const long long t = smp / Q;
  const int q = (int)(smp - t * Q);
  return (t * d.B + gru_env(d, q)) * d.N + q % d.N;
}
