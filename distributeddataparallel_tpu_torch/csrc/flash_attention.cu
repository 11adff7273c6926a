// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels of the training path, behind a plain C interface that
// ops/flash_attention.py loads with ctypes.
//
// Replaces the three Pallas TPU kernels in
// distributeddataparallel_tpu/ops/pallas_attention.py:
//   K1 flash_fwd_kernel      <- _flash_kernel   (forward, online softmax)
//   K2 flash_bwd_dq_kernel   <- _bwd_dq_kernel  (dq, kv tiles innermost)
//   K3 flash_bwd_dkv_kernel  <- _bwd_dkv_kernel (dk/dv, q tiles x GQA group
//                                                innermost)
//
// What each computes is what its TPU kernel computes: scale 1/sqrt(D),
// queries aligned to the END of kv (q_offset = Skv - Sq), causal entries
// above the diagonal masked with the finite NEG_INF (-1e30, not -inf), the
// l == 0 row guard, GQA query head h reading kv head h / (H / Hkv), and for
// bf16 inputs p and ds rounded to bf16 before their second product.
// Layouts: q/k/v/dout/out/dq/dk/dv are (B, S, H, D) read through element
// strides (last dim contiguous), lse and delta are plain (B, H, Sq) f32 —
// the TPU's (B*H, 8, Sq) sublane broadcast is not carried over.
//
// Bound on an H100 SXM at the GPT-2 124M training shapes (B=8, S=1024,
// H=12, D=64, causal, f32): K1 does 2*B*H*S^2*D/2 = 6.5 GFLOP of visible
// work, K2 3/2 of that, K3 twice that, over ~100 MB each: all three are
// bound by operations.  f32 at f32 accuracy runs at 67 TFLOP/s on the CUDA
// cores, or at 495/3 = 165 TFLOP/s on the tensor cores as 3xTF32 (each
// product split into three TF32 products); bf16 at 989 TFLOP/s.  So every
// product of the three kernels runs on the tensor cores.
//
// Design: every product is mma.sync — m16n8k8 TF32 for f32 with the 3xTF32
// split (big = tf32(x), small = tf32(x - big); the products small*big' +
// big*small' + big*big' accumulate in f32, smallest first, which keeps f32
// accuracy), m16n8k16 bf16 for bf16, f32 accumulators.  wgmma is not used:
// with TF32 operands it needs both operands K-major in shared memory, and
// four of the nine products (out = p v, dq = ds k, dk = ds^T q, dv = p^T do)
// contract over a sequence axis; mma.sync fragments load thread by thread
// from any layout (ldmatrix / ldmatrix.trans for bf16, scalar loads for
// TF32).  Four warps per block (two for K2/K3 in f32 at D > 128), each
// owning 16 of the block's rows — q rows in K1 and K2, kv rows in K3 — so
// recompute, masking, the softmax and p * (dp - delta) stay inside a warp;
// p and ds go from the accumulators into the next product's A operand
// through registers for bf16 (k16 fragments line up with the accumulator's,
// and packing rounds them to bf16 as the reference does) and through a
// per-warp shared-memory slab for TF32 (k8 fragments do not).  K1 keeps its
// online softmax in the accumulator layout: each lane holds rows g and
// g + 8 of its warp's 16, reduces their max and sum over the 4 lanes of its
// quad, keeps m and l in registers and rescales its output accumulators by
// exp(m_old - m_new) before each P V product.  The block's resident rows (Q
// in K1; Q, dO in K2; K, V in K3) are copied once; the streamed tiles (K/V
// in K1 and K2; Q/dO with their lse/delta rows in K3) go through a
// two-stage ring filled by 16-byte cp.async copies, so tile j+1 is in
// flight while tile j is computed; rows past the ragged edge and the
// head-dim pad (D rounded up to 64, 128 or 256) are zero-filled.  Block
// barriers only guard the ring.  The causal mask is applied only on tiles
// that cross the diagonal (or a ragged edge); warps with no visible entry in
// a tile skip it.  One block per (b*h, q tile, output column chunk) for K1
// and K2, per (b*Hkv, kv tile, column chunk) for K3, with the tile index as
// the grid's slow axis and the longest causal tiles first, so the last wave
// is not left with the longest blocks; for D > 128 each chunk of 128 output
// columns recomputes the scores (in K1 the same m and l bits in every
// chunk), so the accumulators fit in registers.  The TPU's sequential grid
// axis and its VMEM scratch become a loop inside the block with the
// accumulator in registers: no atomics, so every output is the same bits
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF

struct Strides {
  long long b, s, h;  // element strides; the head dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int B, Sq, Skv, H, Hkv, D, causal;
  float scale;
};

// One past the last kv position any row of the q tile [q0, q0 + TILE) sees.
__device__ __forceinline__ int kv_limit(const Params& p, int q0, int tile) {
  if (!p.causal) return p.Skv;
  const int q_offset = p.Skv - p.Sq;
  return min(p.Skv, q_offset + min(q0 + tile, p.Sq));
}

// ------------------------------------------------- tensor-core tools ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32 split: x ~= big + small with both TF32, |x - big - small| ~ 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Operand fragments of one mma.sync (lane = threadIdx.x % 32, g = lane / 4,
// t = lane % 4).  TF32 m16n8k8: A holds (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B holds (k=t, n=g), (k=t+4, n=g) — each as a big and a small
// part.  bf16 m16n8k16: A holds pairs (g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..); B pairs (k=2t.., n=g), (k=2t+8.., n=g).  The f32
// accumulator of both holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
struct FragA32 { uint32_t big[4], small[4]; };
struct FragB32 { uint32_t big[2], small[2]; };
struct FragA16 { uint32_t x[4]; };
struct FragB16 { uint32_t x[2]; };

template <typename T> struct Mma;
template <> struct Mma<float> {
  using A = FragA32;
  using B = FragB32;
  static constexpr int kK = 8;    // contraction depth of one mma
  static constexpr int kPad = 4;  // row pad (elements): ld = 4 (mod 32), see load_a
};
template <> struct Mma<__nv_bfloat16> {
  using A = FragA16;
  using B = FragB16;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;  // 16 bytes: ldmatrix rows in distinct banks
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&d)[4], const FragA32& a, const FragB32& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// 3xTF32 with the two correction terms into their own accumulator.
__device__ __forceinline__ void mma_split(float (&d)[4], float (&c)[4], const FragA32& a,
                                          const FragB32& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

__device__ __forceinline__ void mma(float (&d)[4], const FragA16& a, const FragB16& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

// A fragment: rows [0, 16) x columns [k0, k0 + kK) of a row-major tile.
// With ld = 4 (mod 32) the row reads of a TF32 fragment (rows g, columns t)
// hit 32 distinct banks; the column reads of load_b_kn (rows t, columns g)
// meet at most 2-way conflicts.
__device__ __forceinline__ void load_a(FragA32& a, const float* s, int ld, int k0, int lane) {
  const float* p = s + (lane >> 2) * ld + k0 + (lane & 3);
  split_tf32(p[0], a.big[0], a.small[0]);
  split_tf32(p[8 * ld], a.big[1], a.small[1]);
  split_tf32(p[4], a.big[2], a.small[2]);
  split_tf32(p[8 * ld + 4], a.big[3], a.small[3]);
}

__device__ __forceinline__ void load_a(FragA16& a, const __nv_bfloat16* s, int ld, int k0, int lane) {
  ldmatrix_x4(a.x[0], a.x[1], a.x[2], a.x[3], s + (lane & 15) * ld + k0 + 8 * (lane >> 4));
}

// B fragments of the n-tiles [n0, n0 + 8) and [n0 + 8, n0 + 16) at depth
// [k0, k0 + kK), from a row-major tile X stored as X[n][k] (B = X^T: the
// score products, whose operands both keep the head dim contiguous).
__device__ __forceinline__ void load_b_nk(FragB32 (&b)[2], const float* X, int ld, int n0, int k0,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = X + (n0 + 8 * i + (lane >> 2)) * ld + k0 + (lane & 3);
    split_tf32(p[0], b[i].big[0], b[i].small[0]);
    split_tf32(p[4], b[i].big[1], b[i].small[1]);
  }
}

__device__ __forceinline__ void load_b_nk(FragB16 (&b)[2], const __nv_bfloat16* X, int ld, int n0,
                                          int k0, int lane) {
  const __nv_bfloat16* p =
      X + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1);
  ldmatrix_x4(b[0].x[0], b[0].x[1], b[1].x[0], b[1].x[1], p);
}

// The same from a tile stored as X[k][n] (the products that contract over
// a sequence axis: dq = ds k, dk = ds^T q, dv = p^T do).
__device__ __forceinline__ void load_b_kn(FragB32 (&b)[2], const float* X, int ld, int n0, int k0,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = X + (k0 + (lane & 3)) * ld + n0 + 8 * i + (lane >> 2);
    split_tf32(p[0], b[i].big[0], b[i].small[0]);
    split_tf32(p[4 * ld], b[i].big[1], b[i].small[1]);
  }
}

__device__ __forceinline__ void load_b_kn(FragB16 (&b)[2], const __nv_bfloat16* X, int ld, int n0,
                                          int k0, int lane) {
  const __nv_bfloat16* p =
      X + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4);
  ldmatrix_x4_trans(b[0].x[0], b[0].x[1], b[1].x[0], b[1].x[1], p);
}

// acc[j] += A[0:16, 0:DP] . X[8j:8j+8, 0:DP]^T: a warp's 16 rows against the
// NT*8 rows of a streamed tile (S = Q K^T, dP = dO V^T, and their
// transposes in K3).  For TF32 the two correction terms of 3xTF32 go to
// their own accumulators, so the three products of one step do not wait on
// each other along the long contraction over the head dim.
template <typename T, int NT, int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* A, const T* X, int ld,
                                        int lane) {
  using M = Mma<T>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  float corr[kSplit ? NT : 1][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += M::kK) {
    typename M::A a;
    load_a(a, A, ld, k0, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      typename M::B b[2];
      load_b_nk(b, X, ld, 8 * j, k0, lane);
      if constexpr (kSplit) {
        mma_split(acc[j], corr[j], a, b[0]);
        mma_split(acc[j + 1], corr[j + 1], a, b[1]);
      } else {
        mma(acc[j], a, b[0]);
        mma(acc[j + 1], a, b[1]);
      }
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += corr[j][e];
  }
}

// acc[j] += P[0:16, 0:NS*8] . X[0:NS*8, c0+8j : c0+8j+8], P in accumulator
// layout (p or ds of this tile), X a streamed or resident tile whose
// columns past D are zero.  TF32 stages P through the warp's slab, bf16
// packs it from registers, rounding to bf16 as the reference does.  The
// TF32 corrections get their own accumulators only for narrow outputs
// (NO <= 8): for wider ones the NO independent accumulators already keep
// the tensor cores busy, and the extra registers would spill.
template <typename T, int NS, int NO>
__device__ __forceinline__ void mma_pv(float (&acc)[NO][4], const float (&pm)[NS][4], float* slab,
                                       const T* X, int ld, int c0, int lane) {
  using M = Mma<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kSplit = kF32 && NO <= 8;
  constexpr int kLds = NS * 8 + 4;  // slab row stride: A loads conflict-free
  if constexpr (kF32) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      *reinterpret_cast<float2*>(slab + g * kLds + 8 * j + 2 * t) = make_float2(pm[j][0], pm[j][1]);
      *reinterpret_cast<float2*>(slab + (g + 8) * kLds + 8 * j + 2 * t) = make_float2(pm[j][2], pm[j][3]);
    }
    __syncwarp();
  }
  float corr[kSplit ? NO : 1][4] = {};
#pragma unroll
  for (int kc = 0; kc < NS * 8 / M::kK; ++kc) {
    typename M::A a;
    if constexpr (kF32) {
      load_a(a, slab, kLds, 8 * kc, lane);
    } else {
      a.x[0] = pack_bf16(pm[2 * kc][0], pm[2 * kc][1]);
      a.x[1] = pack_bf16(pm[2 * kc][2], pm[2 * kc][3]);
      a.x[2] = pack_bf16(pm[2 * kc + 1][0], pm[2 * kc + 1][1]);
      a.x[3] = pack_bf16(pm[2 * kc + 1][2], pm[2 * kc + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      typename M::B b[2];
      load_b_kn(b, X, ld, c0 + 8 * j, kc * M::kK, lane);
      if constexpr (kSplit) {
        mma_split(acc[j], corr[j], a, b[0]);
        mma_split(acc[j + 1], corr[j + 1], a, b[1]);
      } else {
        mma(acc[j], a, b[0]);
        mma(acc[j + 1], a, b[1]);
      }
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += corr[j][e];
  }
  if constexpr (kF32) __syncwarp();  // the slab is rewritten by the next product
}

// Start copying rows [row0, row0 + ROWS) x [0, DP) of a (S, D) slice into a
// tile with row stride ld; rows at or past rows_valid and the pad columns
// [D, DP) are zero-filled.
template <typename T, int ROWS, int DP, int NTHREADS>
__device__ __forceinline__ void copy_tile_async(T* tile, int ld, const T* base, long long row_stride,
                                                int row0, int rows_valid, int D) {
  constexpr int E = 16 / sizeof(T), PER_ROW = DP / E;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E;
    const bool ok = row0 + r < rows_valid && c < D;
    cp_async16(tile + r * ld + c, ok ? base + (long long)(row0 + r) * row_stride + c : base,
               ok ? 16 : 0);
  }
}

// The same for ROWS entries of an f32 row vector (lse or delta).
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src, int row0,
                                                int rows_valid) {
  for (int i = threadIdx.x; i < ROWS; i += NTHREADS) {
    const bool ok = row0 + i < rows_valid;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store a warp's accumulator block (rows row0 + [0, 16), columns
// c0 + [0, NO*8)) times mul; rows at or past rows_valid and columns at or
// past D are left out.
template <typename T, int NO>
__device__ __forceinline__ void store_acc(T* base, long long row_stride, const float (&acc)[NO][4],
                                          float mul, int row0, int rows_valid, int c0, int D,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (c >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < rows_valid)
        st2(base + (long long)row * row_stride + c, acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
    }
  }
}

// p = exp(s * scale - lse) is computed in the plain version's order with
// the same expf: for bf16 the kernel then rounds the same f32 p and ds as
// the plain version, and only summation order can tip a rounding.

// Shared-memory plan of the three kernels: R resident tiles of BM rows (Q in
// K1; Q, dO in K2; K, V in K3), a two-stage ring of two streamed tiles of BN
// rows (K, V in K1 and K2; Q, dO in K3), in K3 a two-stage ring of the
// streamed rows' lse and delta, and for TF32 one 16 x (BN + 4) f32 slab per
// warp.  Rows hold DP (the head dim padded to 64, 128 or 256) plus a pad.
template <typename T, int WARPS, int BN, int DP>
struct TilePlan {
  static constexpr int kBM = 16 * WARPS;
  static constexpr int kThreadsPerBlock = 32 * WARPS;
  static constexpr int kLd = DP + Mma<T>::kPad;
  static constexpr int kSlab = std::is_same<T, float>::value ? 16 * (BN + 4) : 0;
  static constexpr size_t bytes(int resident, bool row_ring) {
    return sizeof(T) * (size_t)kLd * (resident * kBM + 4 * BN) +
           sizeof(float) * ((row_ring ? 4 * BN : 0) + WARPS * kSlab);
  }
};

// ---------------------------------------------------------------- K1 ----
// One block per (b*h, q tile of BM rows, chunk of DC output columns); the
// kv tiles stream through the ring.  As in the reference: scale applied to
// the f32 scores, causal entries NEG_INF and keys past the ragged edge -inf
// (p = 0), m from NEG_INF, l summing the f32 p, p rounded to the inputs'
// dtype before P V, the l == 0 guard.  For f32 at D <= 64 a register cap
// of three blocks per SM, which shared memory also fits, made the GPT-2
// shapes faster on the card, without spills.  Above D = 64 shared memory
// holds at most two f32 blocks, and bf16 spills under the cap at D = 128,
// so those builds have none.
template <typename T, int WARPS, int BN, int DC, int DP>
__global__ void __launch_bounds__(32 * WARPS, std::is_same<T, float>::value && DP == 64 ? 3 : 1)
    flash_fwd_kernel(const Params p) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  constexpr int BM = Plan::kBM, NTH = Plan::kThreadsPerBlock, NS = BN / 8, NO = DC / 8;
  constexpr int ld = Plan::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + BM * ld;  // stage s: K at ring + 2 s BN ld, V after it
  float* slabs = reinterpret_cast<float*>(ring + 4 * BN * ld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* slab = slabs + warp * Plan::kSlab;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
  const int c0 = blockIdx.z * DC;
  const int qw = q0 + 16 * warp;  // this warp's first q row
  const int q_offset = p.Skv - p.Sq;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  copy_tile_async<T, BM, DP, NTH>(Qs, ld, qb, p.sq.s, q0, p.Sq, D);
  cp_async_commit();

  // Rows g (index 0) and g + 8 (index 1) of the warp's 16.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_kv = (kv_limit(p, q0, BM) + BN - 1) / BN;
  auto prefetch = [&](int it) {
    T* Kt = ring + 2 * (it & 1) * BN * ld;
    copy_tile_async<T, BN, DP, NTH>(Kt, ld, kb, p.sk.s, it * BN, p.Skv, D);
    copy_tile_async<T, BN, DP, NTH>(Kt + BN * ld, ld, vb, p.sv.s, it * BN, p.Skv, D);
  };
  if (n_kv > 0) prefetch(0);
  cp_async_commit();
  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) prefetch(it + 1);  // in flight while this tile is computed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BN;
    const T* Kt = ring + 2 * (it & 1) * BN * ld;
    const T* Vt = Kt + BN * ld;
    // A warp whose rows all lie before this tile's first visible key (or
    // past Sq) has nothing to add: every row has seen key 0 by then, so the
    // tile's p would all be exp(NEG_INF - m) = 0 and its corr 1.
    if (qw < p.Sq && !(p.causal && k0 > q_offset + qw + 15)) {
      float s[NS][4] = {};
      mma_abt<T, NS, DP>(s, Qs + 16 * warp * ld, Kt, ld, lane);
      const bool edge = (p.causal && k0 + BN - 1 > q_offset + qw) || k0 + BN > p.Skv;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * p.scale;
          if (edge) {  // the tile crosses the diagonal or the ragged edge: mask
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = q_offset + qw + g + 8 * (e >> 1);
            if (p.causal && kpos > qpos) x = kNegInf;
            if (kpos >= p.Skv) x = -INFINITY;  // no key: p = 0
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);  // p, f32
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = corr[r] * l[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      mma_pv<T, NS, NO>(o, s, slab, Vt, ld, c0, lane);  // p.astype(v.dtype) @ v
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] /= l_safe[e >> 1];
  T* ob = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
  store_acc<T, NO>(ob, p.so.s, o, 1.f, qw, p.Sq, c0, D, lane);
  if (blockIdx.z == 0 && t == 0) {  // every chunk has the same m and l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw + g + 8 * r;
      if (row < p.Sq) p.lse_out[((long long)b * p.H + h) * p.Sq + row] = m[r] + logf(l_safe[r]);
    }
  }
}

// ---------------------------------------------------------------- K2 ----
// One block per (b*h, q tile of BM rows, chunk of DC output columns); the
// kv tiles stream through the ring.
template <typename T, int WARPS, int BN, int DC, int DP>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dq_kernel(const Params p) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  constexpr int BM = Plan::kBM, NTH = Plan::kThreadsPerBlock, NS = BN / 8, NO = DC / 8;
  constexpr int ld = Plan::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + BM * ld;    // dout
  T* ring = Os + BM * ld;  // stage s: K at ring + 2 s BN ld, V after it
  float* slabs = reinterpret_cast<float*>(ring + 4 * BN * ld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* slab = slabs + warp * Plan::kSlab;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal rows first
  const int c0 = blockIdx.z * DC;
  const int qw = q0 + 16 * warp;  // this warp's first q row
  const int q_offset = p.Skv - p.Sq;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  copy_tile_async<T, BM, DP, NTH>(Qs, ld, qb, p.sq.s, q0, p.Sq, D);
  copy_tile_async<T, BM, DP, NTH>(Os, ld, dob, p.sdo.s, q0, p.Sq, D);
  cp_async_commit();

  const long long row_base = ((long long)b * p.H + h) * p.Sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lse_r[r] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    delta_r[r] = row < p.Sq ? p.delta[row_base + row] : 0.f;
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  const int n_kv = (kv_limit(p, q0, BM) + BN - 1) / BN;
  auto prefetch = [&](int it) {
    T* Kt = ring + 2 * (it & 1) * BN * ld;
    copy_tile_async<T, BN, DP, NTH>(Kt, ld, kb, p.sk.s, it * BN, p.Skv, D);
    copy_tile_async<T, BN, DP, NTH>(Kt + BN * ld, ld, vb, p.sv.s, it * BN, p.Skv, D);
  };
  if (n_kv > 0) prefetch(0);
  cp_async_commit();
  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) prefetch(it + 1);  // in flight while this tile is computed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BN;
    const T* Kt = ring + 2 * (it & 1) * BN * ld;
    const T* Vt = Kt + BN * ld;
    // A warp whose rows all lie before this tile's first visible key (or
    // past Sq) has nothing to add.
    if (qw < p.Sq && !(p.causal && k0 > q_offset + qw + 15)) {
      float s[NS][4] = {}, dp[NS][4] = {};
      mma_abt<T, NS, DP>(s, Qs + 16 * warp * ld, Kt, ld, lane);
      mma_abt<T, NS, DP>(dp, Os + 16 * warp * ld, Vt, ld, lane);
      if ((p.causal && k0 + BN - 1 > q_offset + qw) || k0 + BN > p.Skv) {
        // The tile crosses the diagonal or the ragged edge: mask.  Masked
        // entries get p = 0, as exp(NEG_INF - lse) is exactly 0 in the
        // reference.
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = q_offset + qw + g + 8 * (e >> 1);
            const bool live = kpos < p.Skv && !(p.causal && kpos > qpos);
            const float pr = live ? expf(s[j][e] * p.scale - lse_r[e >> 1]) : 0.f;
            s[j][e] = pr * (dp[j][e] - delta_r[e >> 1]);  // ds
          }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr = expf(s[j][e] * p.scale - lse_r[e >> 1]);
            s[j][e] = pr * (dp[j][e] - delta_r[e >> 1]);
          }
      }
      mma_pv<T, NS, NO>(dq, s, slab, Kt, ld, c0, lane);
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();
  T* dqb = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  store_acc<T, NO>(dqb, p.sdq.s, dq, p.scale, qw, p.Sq, c0, D, lane);
}

// ---------------------------------------------------------------- K3 ----
// One block per (b*Hkv, kv tile of BM rows, chunk of DC output columns);
// the (group member, q tile) pairs stream through the ring.  Each warp
// computes the transposed scores of its 16 kv rows, so p^T and ds^T come
// out of the accumulators as the A operands of dv and dk.
template <typename T, int WARPS, int BN, int DC, int DP>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dkv_kernel(const Params p) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  constexpr int BM = Plan::kBM, NTH = Plan::kThreadsPerBlock, NS = BN / 8, NO = DC / 8;
  constexpr int ld = Plan::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BM * ld;
  T* ring = Vs + BM * ld;  // stage s: Q at ring + 2 s BN ld, dO after it
  float* rows = reinterpret_cast<float*>(ring + 4 * BN * ld);  // stage s: lse, delta
  float* slabs = rows + 4 * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* slab = slabs + warp * Plan::kSlab;
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.y * BM;  // longest causal column first
  const int c0 = blockIdx.z * DC;
  const int kw = k0 + 16 * warp;  // this warp's first kv row
  const int q_offset = p.Skv - p.Sq;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  copy_tile_async<T, BM, DP, NTH>(Ks, ld, kb, p.sk.s, k0, p.Skv, D);
  copy_tile_async<T, BM, DP, NTH>(Vs, ld, vb, p.sv.s, k0, p.Skv, D);
  cp_async_commit();

  float dk[NO][4] = {}, dv[NO][4] = {};

  // Causal: q row r sees kv row k0 only if q_offset + r >= k0.
  const int q_begin = p.causal ? max(0, k0 - q_offset) : 0;
  const int n_qt = q_begin < p.Sq ? (p.Sq - q_begin + BN - 1) / BN : 0;
  const int n_it = group * n_qt;
  auto q_start = [&](int it) { return q_begin + (it % n_qt) * BN; };
  auto prefetch = [&](int it) {
    const int h = hk * group + it / n_qt, q0 = q_start(it), st = it & 1;
    const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    const long long row_base = ((long long)b * p.H + h) * p.Sq;
    T* Qt = ring + 2 * st * BN * ld;
    copy_tile_async<T, BN, DP, NTH>(Qt, ld, qb, p.sq.s, q0, p.Sq, D);
    copy_tile_async<T, BN, DP, NTH>(Qt + BN * ld, ld, dob, p.sdo.s, q0, p.Sq, D);
    copy_rows_async<BN, NTH>(rows + 2 * st * BN, p.lse + row_base, q0, p.Sq);
    copy_rows_async<BN, NTH>(rows + 2 * st * BN + BN, p.delta + row_base, q0, p.Sq);
  };
  if (n_it > 0) prefetch(0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) prefetch(it + 1);  // in flight while this tile is computed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_start(it), st = it & 1;
    const T* Qt = ring + 2 * st * BN * ld;
    const T* Ot = Qt + BN * ld;
    const float* Ls = rows + 2 * st * BN;
    const float* Dl = Ls + BN;
    // A warp whose kv rows all lie after this tile's last visible query (or
    // past Skv) has nothing to add.
    if (kw < p.Skv && !(p.causal && kw > q_offset + q0 + BN - 1)) {
      float s[NS][4] = {}, dp[NS][4] = {};
      mma_abt<T, NS, DP>(s, Ks + 16 * warp * ld, Qt, ld, lane);   // s^T
      mma_abt<T, NS, DP>(dp, Vs + 16 * warp * ld, Ot, ld, lane);  // dp^T
      if ((p.causal && kw + 15 > q_offset + q0) || q0 + BN > p.Sq || kw + 16 > p.Skv) {
        // The tile crosses the diagonal or a ragged edge: mask.
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const int qrow = q0 + col;
            const int krow = kw + g + 8 * (e >> 1);
            const bool live = qrow < p.Sq && krow < p.Skv && !(p.causal && krow > q_offset + qrow);
            const float pr = live ? expf(s[j][e] * p.scale - Ls[col]) : 0.f;
            s[j][e] = pr;                         // p^T
            dp[j][e] = pr * (dp[j][e] - Dl[col]);  // ds^T
          }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float pr = expf(s[j][e] * p.scale - Ls[col]);
            s[j][e] = pr;
            dp[j][e] = pr * (dp[j][e] - Dl[col]);
          }
      }
      mma_pv<T, NS, NO>(dv, s, slab, Ot, ld, c0, lane);
      mma_pv<T, NS, NO>(dk, dp, slab, Qt, ld, c0, lane);
    }
    __syncthreads();  // the next prefetch overwrites this stage
  }
  cp_async_wait<0>();
  T* dkb = static_cast<T*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  T* dvb = static_cast<T*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
  store_acc<T, NO>(dkb, p.sdk.s, dk, p.scale, kw, p.Skv, c0, D, lane);
  store_acc<T, NO>(dvb, p.sdv.s, dv, 1.f, kw, p.Skv, c0, D, lane);
}

// ------------------------------------------------------------ launch ----
enum Kind { kFwd = 0, kBwdDq = 1, kBwdDkv = 2 };

int launch_kernel(void (*kern)(const Params), dim3 grid, int threads, size_t smem,
                  const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int WARPS, int BN, int DC, int DP>
int launch_fwd(const Params& p, cudaStream_t stream) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  const dim3 grid(p.B * p.H, (p.Sq + Plan::kBM - 1) / Plan::kBM, (p.D + DC - 1) / DC);
  return launch_kernel(flash_fwd_kernel<T, WARPS, BN, DC, DP>, grid, Plan::kThreadsPerBlock,
                       Plan::bytes(1, false), p, stream);
}

template <typename T, int WARPS, int BN, int DC, int DP>
int launch_dq(const Params& p, cudaStream_t stream) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  const dim3 grid(p.B * p.H, (p.Sq + Plan::kBM - 1) / Plan::kBM, (p.D + DC - 1) / DC);
  return launch_kernel(flash_bwd_dq_kernel<T, WARPS, BN, DC, DP>, grid, Plan::kThreadsPerBlock,
                       Plan::bytes(2, false), p, stream);
}

template <typename T, int WARPS, int BN, int DC, int DP>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using Plan = TilePlan<T, WARPS, BN, DP>;
  const dim3 grid(p.B * p.Hkv, (p.Skv + Plan::kBM - 1) / Plan::kBM, (p.D + DC - 1) / DC);
  return launch_kernel(flash_bwd_dkv_kernel<T, WARPS, BN, DC, DP>, grid, Plan::kThreadsPerBlock,
                       Plan::bytes(2, true), p, stream);
}

// Tiles per head dim: the head dim padded to DP = 64, 128 or 256 (a
// compile-time trip count for every product); BN streamed rows: 32 for TF32
// (on the card, 16 and 64 were slower for K2/K3), 64 for bf16 but 32 for
// K3 above D = 64 (registers); DC output columns per block, so the
// accumulators live in registers; for K2/K3 two warps in f32 at D > 128 so
// their two resident tiles and the ring fit in 227 KB (K1 has one resident
// tile and keeps four).
template <typename T>
int dispatch_d(Kind kind, const Params& p, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kBN = kF32 ? 32 : 64;
  if (kind == kFwd) {
    if (p.D <= 64) return launch_fwd<T, 4, kBN, 64, 64>(p, st);
    if (p.D <= 128) return launch_fwd<T, 4, kBN, 128, 128>(p, st);
    return launch_fwd<T, 4, kBN, 128, 256>(p, st);
  }
  if (kind == kBwdDq) {
    if (p.D <= 64) return launch_dq<T, 4, kBN, 64, 64>(p, st);
    if (p.D <= 128) return launch_dq<T, 4, kBN, 128, 128>(p, st);
    return launch_dq<T, kF32 ? 2 : 4, 32, 128, 256>(p, st);
  }
  if (p.D <= 64) return launch_dkv<T, 4, kBN, 64, 64>(p, st);
  if (p.D <= 128) return launch_dkv<T, 4, 32, 128, 128>(p, st);
  return launch_dkv<T, kF32 ? 2 : 4, 32, 128, 256>(p, st);
}

int run(Kind kind, int dtype, Params& p, void* stream) {
  // The tile index (tiles of 32 or 64 rows) is gridDim.y, which holds at
  // most 65535.
  if (p.D <= 0 || p.D % 8 || p.D > 256 || p.Sq <= 0 || p.Sq > p.Skv ||
      p.Hkv <= 0 || p.H % p.Hkv || p.B <= 0 || (long long)p.Skv > 32LL * 65535)
    return (int)cudaErrorInvalidValue;
  p.scale = 1.0f / sqrtf((float)p.D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(kind, p, st);
  if (dtype == 0) return dispatch_d<float>(kind, p, st);
  return (int)cudaErrorInvalidValue;
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

void set_shape(Params& p, int B, int Sq, int Skv, int H, int Hkv, int D, int causal) {
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.Hkv = Hkv; p.D = D; p.causal = causal;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: (b, s, h) element strides of each
// tensor in argument order.  Returns 0 or the cudaError_t of the launch.
extern "C" int ddp_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                             void* out, float* lse, const long long* strides,
                             int B, int Sq, int Skv, int H, int Hkv, int D,
                             int causal, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse_out = lse;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.so = strides_at(strides, 3);
  set_shape(p, B, Sq, Skv, H, Hkv, D, causal);
  return run(kFwd, dtype, p, stream);
}

extern "C" int ddp_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta,
                                void* dq, const long long* strides,
                                int B, int Sq, int Skv, int H, int Hkv, int D,
                                int causal, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta; p.dq = dq;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.sdo = strides_at(strides, 3);
  p.sdq = strides_at(strides, 4);
  set_shape(p, B, Sq, Skv, H, Hkv, D, causal);
  return run(kBwdDq, dtype, p, stream);
}

extern "C" int ddp_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, const long long* strides,
                                 int B, int Sq, int Skv, int H, int Hkv, int D,
                                 int causal, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dk = dk; p.dv = dv;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.sdo = strides_at(strides, 3);
  p.sdk = strides_at(strides, 4); p.sdv = strides_at(strides, 5);
  set_shape(p, B, Sq, Skv, H, Hkv, D, causal);
  return run(kBwdDkv, dtype, p, stream);
}
