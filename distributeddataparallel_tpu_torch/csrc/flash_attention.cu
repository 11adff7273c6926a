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
// l == 0 row guard, and GQA query head h reading kv head h / (H / Hkv).
// Layouts: q/k/v/dout/out/dq/dk/dv are (B, S, H, D) read through element
// strides (last dim contiguous), lse and delta are plain (B, H, Sq) f32 —
// the TPU's (B*H, 8, Sq) sublane broadcast is not carried over.
//
// Bound on an H100 SXM at the GPT-2 124M training shapes (B=8, S=1024,
// H=12, D=64, causal, f32): the work is f32 arithmetic on CUDA cores
// (67 TFLOP/s peak; 3.35 TB/s memory).  K1 does 2*B*H*S^2*D = 12.9 GFLOP
// over ~101 MB (0.19 ms, compute-bound), K2 3*B*H*S^2*D = 19.3 GFLOP
// (0.29 ms), K3 4*B*H*S^2*D = 25.8 GFLOP (0.38 ms).  All three are bound by
// operations, not bytes.
//
// What this simple design does about that bound: every tile product is a
// register-blocked FMA loop over shared-memory tiles (each thread holds a
// (TILE/16) x (TILE/16) block of scores and a (TILE/16) x (DMAX/16) block
// of the output), with 16-byte shared-memory loads on padded rows (row
// stride D + 4 floats, conflict-free across a quarter warp).  The (S, S)
// score matrix never leaves the block; HBM traffic is one read of each
// input tile per block pass.  The causal loop stops at the diagonal, so
// the work is the visible half of the square.  Tensor cores (wgmma), TMA
// pipelining and warp specialisation are not used: that is the later
// step toward the bound.  bf16 inputs are widened to f32 in shared memory
// and every product and sum is f32.
//
// Tiles: 64 query rows x 64 kv rows for D <= 128, 32 x 32 for D <= 256;
// 256 threads per block as a 16 x 16 grid.  One block per (b*h, q tile)
// for K1/K2, one per (b*Hkv, kv tile) for K3 — the TPU's sequential grid
// axis and its VMEM scratch accumulator become a loop inside the block
// with the accumulator in registers, so no atomics are needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Stage rows [row0, row0 + rows) x [0, D) of a (S, D) slice into a float
// tile with row stride ld; rows at or past rows_valid read as zeros (the
// ragged sequence edge).
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* base,
                                          long long row_stride, int row0,
                                          int rows_valid, int D, int rows) {
  const int per_row = D >> 2;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows_valid) x = ld4(base + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(tile + r * ld + c) = x;
  }
}

// acc[i][j] += dot(A[ty + 16 i, :D], B[tx + 16 j, :D]).
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* A,
                                         const float* Bm, int ld, int D,
                                         int ty, int tx) {
  for (int d = 0; d < D; d += 4) {
    float4 a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = ld4(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = ld4(Bm + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][4 g + e] += sum_kk P[ty + 16 i, kk] * M[kk, tx * 4 + 64 g + e]
// over kk in [0, K): the (TILE x TILE) x (TILE x D) product into this
// thread's rows and its float4 column groups.
template <int R, int NV>
__device__ __forceinline__ void tile_pv(float (&acc)[R][NV * 4], const float* P,
                                        int ldp, const float* M, int ld, int K,
                                        int D, int ty, int tx) {
  for (int kk = 0; kk < K; kk += 4) {
    float4 p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = ld4(P + (ty + 16 * i) * ldp + kk);
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int c = tx * 4 + 64 * g;
      if (c < D) {
        const float4 m0 = ld4(M + (kk + 0) * ld + c);
        const float4 m1 = ld4(M + (kk + 1) * ld + c);
        const float4 m2 = ld4(M + (kk + 2) * ld + c);
        const float4 m3 = ld4(M + (kk + 3) * ld + c);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float* a = &acc[i][4 * g];
          a[0] = fmaf(p[i].x, m0.x, fmaf(p[i].y, m1.x, fmaf(p[i].z, m2.x, fmaf(p[i].w, m3.x, a[0]))));
          a[1] = fmaf(p[i].x, m0.y, fmaf(p[i].y, m1.y, fmaf(p[i].z, m2.y, fmaf(p[i].w, m3.y, a[1]))));
          a[2] = fmaf(p[i].x, m0.z, fmaf(p[i].y, m1.z, fmaf(p[i].z, m2.z, fmaf(p[i].w, m3.z, a[2]))));
          a[3] = fmaf(p[i].x, m0.w, fmaf(p[i].y, m1.w, fmaf(p[i].z, m2.w, fmaf(p[i].w, m3.w, a[3]))));
        }
      }
    }
  }
}

// Reductions over the 16 threads (one half warp) that share a tile row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One past the last kv position any row of the q tile [q0, q0 + TILE) sees.
__device__ __forceinline__ int kv_limit(const Params& p, int q0, int tile) {
  if (!p.causal) return p.Skv;
  const int q_offset = p.Skv - p.Sq;
  return min(p.Skv, q_offset + min(q0 + tile, p.Sq));
}

// ---------------------------------------------------------------- K1 ----
template <typename T, int TILE, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  constexpr int R = TILE / 16;
  constexpr int NV = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, ld = D + 4, ldp = TILE + 4;
  float* Qs = smem;
  float* Ks = Qs + TILE * ld;
  float* Vs = Ks + TILE * ld;
  float* Ps = Vs + TILE * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * TILE;
  const int q_offset = p.Skv - p.Sq;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  load_tile(Qs, ld, qb, p.sq.s, q0, p.Sq, D, TILE);

  float m[R], l[R], acc[R][NV * 4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV * 4; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = kv_limit(p, q0, TILE);
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    load_tile(Ks, ld, kb, p.sk.s, k0, p.Skv, D, TILE);
    load_tile(Vs, ld, vb, p.sv.s, k0, p.Skv, D, TILE);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    tile_dot(s, Qs, Ks, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.causal && kpos > qpos) x = kNegInf;
        if (kpos >= p.Skv) x = -INFINITY;  // past the ragged edge: no key
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float e = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = e;
        sum += e;
      }
      sum = row_sum16(sum);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_pv<R, NV>(acc, Ps, ldp, Vs, ld, TILE, D, ty, tx);
  }

  T* ob = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int c = tx * 4 + 64 * g;
      if (c < D) {
        const float* a = &acc[i][4 * g];
        st4(ob + (long long)row * p.so.s + c,
            make_float4(a[0] / l_safe, a[1] / l_safe, a[2] / l_safe, a[3] / l_safe));
      }
    }
    if (tx == 0) p.lse_out[((long long)b * p.H + h) * p.Sq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------- K2 ----
template <typename T, int TILE, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const Params p) {
  constexpr int R = TILE / 16;
  constexpr int NV = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, ld = D + 4, ldp = TILE + 4;
  float* Qs = smem;
  float* Os = Qs + TILE * ld;  // dout
  float* Ks = Os + TILE * ld;
  float* Vs = Ks + TILE * ld;
  float* Ss = Vs + TILE * ld;  // ds
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * TILE;
  const int q_offset = p.Skv - p.Sq;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  const long long row_base = ((long long)b * p.H + h) * p.Sq;
  load_tile(Qs, ld, qb, p.sq.s, q0, p.Sq, D, TILE);
  load_tile(Os, ld, dob, p.sdo.s, q0, p.Sq, D, TILE);

  float lse_r[R], delta_r[R], dq[R][NV * 4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    delta_r[i] = row < p.Sq ? p.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NV * 4; ++c) dq[i][c] = 0.f;
  }

  const int kv_end = kv_limit(p, q0, TILE);
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    load_tile(Ks, ld, kb, p.sk.s, k0, p.Skv, D, TILE);
    load_tile(Vs, ld, vb, p.sv.s, k0, p.Skv, D, TILE);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot(s, Qs, Ks, ld, D, ty, tx);
    tile_dot(dp, Os, Vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < p.Skv && !(p.causal && kpos > qpos);
        // Masked entries: exp(NEG_INF - lse) is exactly 0 in the reference.
        const float pr = live ? expf(s[i][j] * p.scale - lse_r[i]) : 0.f;
        Ss[(ty + 16 * i) * ldp + tx + 16 * j] = pr * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_pv<R, NV>(dq, Ss, ldp, Ks, ld, TILE, D, ty, tx);
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int c = tx * 4 + 64 * g;
      if (c < D) {
        const float* a = &dq[i][4 * g];
        st4(dqb + (long long)row * p.sdq.s + c,
            make_float4(a[0] * p.scale, a[1] * p.scale, a[2] * p.scale, a[3] * p.scale));
      }
    }
  }
}

// ---------------------------------------------------------------- K3 ----
template <typename T, int TILE, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const Params p) {
  constexpr int R = TILE / 16;
  constexpr int NV = DMAX / 64;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, ld = D + 4, ldp = TILE + 4;
  float* Ks = smem;
  float* Vs = Ks + TILE * ld;
  float* Qs = Vs + TILE * ld;
  float* Os = Qs + TILE * ld;  // dout
  float* Ps = Os + TILE * ld;  // p transposed: [kv row][q row]
  float* Ss = Ps + TILE * ldp; // ds transposed
  float* Ls = Ss + TILE * ldp; // lse of the staged q rows
  float* Dl = Ls + TILE;       // delta of the staged q rows
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int group = p.H / p.Hkv;
  const int k0 = blockIdx.x * TILE;
  const int q_offset = p.Skv - p.Sq;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  load_tile(Ks, ld, kb, p.sk.s, k0, p.Skv, D, TILE);
  load_tile(Vs, ld, vb, p.sv.s, k0, p.Skv, D, TILE);

  float dk[R][NV * 4], dv[R][NV * 4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NV * 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Causal: q row r sees this tile only if q_offset + r >= k0.
  const int q_begin = p.causal ? (max(0, k0 - q_offset) / TILE) * TILE : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    const long long row_base = ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += TILE) {
      __syncthreads();
      load_tile(Qs, ld, qb, p.sq.s, q0, p.Sq, D, TILE);
      load_tile(Os, ld, dob, p.sdo.s, q0, p.Sq, D, TILE);
      for (int i = threadIdx.x; i < TILE; i += kThreads) {
        const int row = q0 + i;
        Ls[i] = row < p.Sq ? p.lse[row_base + row] : 0.f;
        Dl[i] = row < p.Sq ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();
      // Transposed tiles: this thread's rows are kv rows, its columns q rows.
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_dot(s, Ks, Qs, ld, D, ty, tx);
      tile_dot(dp, Vs, Os, ld, D, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qr = tx + 16 * j;
          const int qrow = q0 + qr;
          const bool live = kpos < p.Skv && qrow < p.Sq &&
                            !(p.causal && kpos > q_offset + qrow);
          const float pr = live ? expf(s[i][j] * p.scale - Ls[qr]) : 0.f;
          Ps[(ty + 16 * i) * ldp + qr] = pr;
          Ss[(ty + 16 * i) * ldp + qr] = pr * (dp[i][j] - Dl[qr]);
        }
      }
      __syncthreads();
      tile_pv<R, NV>(dv, Ps, ldp, Os, ld, TILE, D, ty, tx);
      tile_pv<R, NV>(dk, Ss, ldp, Qs, ld, TILE, D, ty, tx);
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  T* dvb = static_cast<T*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Skv) continue;
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const int c = tx * 4 + 64 * g;
      if (c < D) {
        const float* a = &dk[i][4 * g];
        st4(dkb + (long long)row * p.sdk.s + c,
            make_float4(a[0] * p.scale, a[1] * p.scale, a[2] * p.scale, a[3] * p.scale));
        const float* e = &dv[i][4 * g];
        st4(dvb + (long long)row * p.sdv.s + c, make_float4(e[0], e[1], e[2], e[3]));
      }
    }
  }
}

// ------------------------------------------------------------ launch ----
enum Kind { kFwd = 0, kBwdDq = 1, kBwdDkv = 2 };

template <int TILE>
size_t smem_bytes(Kind kind, int D) {
  const size_t tile = (size_t)TILE * (D + 4), ptile = (size_t)TILE * (TILE + 4);
  switch (kind) {
    case kFwd: return sizeof(float) * (3 * tile + ptile);
    case kBwdDq: return sizeof(float) * (4 * tile + ptile);
    default: return sizeof(float) * (4 * tile + 2 * ptile + 2 * TILE);
  }
}

template <typename T, int TILE, int DMAX>
int launch(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kern)(const Params);
  dim3 grid;
  if (kind == kFwd) {
    kern = flash_fwd_kernel<T, TILE, DMAX>;
    grid = dim3((p.Sq + TILE - 1) / TILE, p.B * p.H);
  } else if (kind == kBwdDq) {
    kern = flash_bwd_dq_kernel<T, TILE, DMAX>;
    grid = dim3((p.Sq + TILE - 1) / TILE, p.B * p.H);
  } else {
    kern = flash_bwd_dkv_kernel<T, TILE, DMAX>;
    grid = dim3((p.Skv + TILE - 1) / TILE, p.B * p.Hkv);
  }
  const size_t smem = smem_bytes<TILE>(kind, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(Kind kind, const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64, 64>(kind, p, stream);
  if (p.D <= 128) return launch<T, 64, 128>(kind, p, stream);
  return launch<T, 32, 256>(kind, p, stream);
}

int run(Kind kind, int dtype, Params& p, void* stream) {
  // B * H indexes gridDim.y, which holds at most 65535.
  if (p.D <= 0 || p.D % 8 || p.D > 256 || p.Sq <= 0 || p.Sq > p.Skv ||
      p.Hkv <= 0 || p.H % p.Hkv || p.B <= 0 || (long long)p.B * p.H > 65535)
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
