// FlashAttention-2 backward for Hopper (sm_90a), f32 and bf16 inputs:
// two kernels, dK/dV and dQ.
//
// Replaces paddle_tpu/ops/attention.py `_dkv_kernel` and `_dq_kernel`
// (driven by `_backward_pallas`), the Pallas TPU kernels. They compute
// the same functions, from the forward's per-row logsumexp (lse) and
// delta = rowsum(dO * O) (minus the lse cotangent), both computed
// outside the kernels:
//
//   s   = (q k^T) * scale + bias      bias broadcast over
//                                     [B|1, H|1, Sq|1, Sk] by strides
//   s   = -1e9 where key > query      when causal (Sq == Sk)
//   p   = exp(s - lse)
//   dp  = dO v^T
//   ds  = p * (dp - delta) * scale
//   dV  = p^T dO,  dK = ds^T q        (dkv kernel; optionally the raw
//                                     score grad p * (dp - delta), f32)
//   dQ  = ds k                        (dq kernel)
//
// The [Sq, Sk] probabilities are recomputed per tile and never reach
// device memory (except the raw score grad, when a trainable bias asks
// for it).
//
// What bounds it on an H100: the dkv kernel does 8*B*H*P*D FLOPs and the
// dq kernel 6*B*H*P*D (P = visible (query, key) pairs) of plain f32
// FMAs, against the card's 67 TFLOP/s of non-tensor-core f32: both are
// operations-bound at f32 (each moves a few bytes per FLOP). This first
// version is simple and right, not fast:
//
//   - no atomics: the dkv kernel runs one CTA per (b*h, 64-key tile) and
//     sweeps the query tiles, accumulating dK and dV in registers; the dq
//     kernel runs one CTA per (b*h, 64-query tile) and sweeps the key
//     tiles. Every output element is written by exactly one CTA, so a
//     result is bitwise repeatable;
//   - 2*D threads per CTA (128 at D = 64, 256 at D = 128), so the per-
//     thread accumulators stay at 32 floats per output at both head dims;
//   - tiles staged in shared memory as f32, row-major with a padded
//     leading dim (bf16 converted on load); each thread reads float4 runs
//     that the 8 lanes of a quarter warp spread over distinct banks;
//   - score products (thread owns 4 query rows x 64/(D/8) keys) and
//     output products (thread owns 4 rows x 8 columns) are f32 FMAs: no
//     tensor cores, no wgmma, no TMA, no warp specialization (later
//     work);
//   - causal: the dkv kernel skips query tiles wholly above the diagonal,
//     the dq kernel key tiles wholly above it (the dkv kernel writes
//     zeros to the raw score grad of the tiles it skips); ragged Sq and
//     Sk are bounds-checked (rows past Sq and keys past Sk take p = 0),
//     never padded; the bias is read through its strides, never
//     materialized.
//
// Shared memory per CTA: dkv 104,448 B at D = 64 (two CTAs per SM),
// 169,984 B at D = 128 (one); dq 87,040 B and 152,576 B.
//
// C interface, loaded with ctypes (kernels/build.py): every pointer and
// the stream are void*; each launch returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kLdP = kTile + 4;  // leading dim of the [64][64] tiles
constexpr float kMask = -1e9f;  // the causal mask value of the TPU kernel

template <int D>
struct Cfg {
  static constexpr int kThreads = 2 * D;
  static constexpr int kLd = D + 4;         // leading dim of [64][D] tiles
  // score tiles [64 rows][64 keys]: 16 row groups x kCG key groups; a
  // thread owns rows rg + 16 i (i < 4) and keys cg + kCG j (j < kNC)
  static constexpr int kCG = kThreads / 16;
  static constexpr int kNC = kTile / kCG;
  // output tiles [64][D]: 16 groups of 4 rows x kDG column groups; a
  // thread owns rows 4 og + i and columns 4 dg + c, D/2 + 4 dg + c
  static constexpr int kDG = D / 8;
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr int kPFloats = kTile * kLdP;
  static constexpr int kDkvSmem = (4 * kTileFloats + 2 * kPFloats) * 4;
  static constexpr int kDqSmem = (4 * kTileFloats + kPFloats) * 4;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } x;
  x.u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(x.h[0]);
  const float2 b = __bfloat1622float2(x.h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } x;
  x.h[0] = __floats2bfloat162_rn(a, b);
  x.h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = x.u;
}

// rows [row0, row0 + 64) of a row-major [S][D] matrix into a [64][kLd]
// f32 tile; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += Cfg<D>::kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4, row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = load4(src + (int64_t)row * D + c);
    *reinterpret_cast<float4*>(dst + r * Cfg<D>::kLd + c) = x;
  }
}

// acc[i][j] = sum_d a[rg + 16 i][d] * b[cg + kCG j][d] over two [64][kLd]
// tiles (the score-tile thread mapping)
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][Cfg<D>::kNC],
                                         const float* a, const float* b,
                                         int rg, int cg) {
  constexpr int kLd = Cfg<D>::kLd, kCG = Cfg<D>::kCG, kNC = Cfg<D>::kNC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNC; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (rg + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      const float4 bv = load4(b + (cg + kCG * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

struct Bias {
  const float* p;  // this (b, h)'s slice, or null
  int64_t sq, sk;
};

// p = exp(s - lse) for one score element; 0 past Sq / Sk
__device__ __forceinline__ float prob(float s, int row, int key, int Sq,
                                      int Sk, float lse, float scale,
                                      const Bias& bias, int causal) {
  if (row >= Sq || key >= Sk) return 0.f;
  float x = s * scale;
  if (bias.p != nullptr) x += bias.p[(int64_t)row * bias.sq + (int64_t)key * bias.sk];
  if (causal && key > row) x = kMask;
  return expf(x - lse);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 int64_t bias_sb, int64_t bias_sh, int64_t bias_sq,
                 int64_t bias_sk, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ ds, int H, int Sq,
                 int Sk, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kCG = C::kCG, kNC = C::kNC, kDG = C::kDG;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [64 keys][kLd]
  float* vs = ks + C::kTileFloats;    // [64 keys][kLd]
  float* qs = vs + C::kTileFloats;    // [64 rows][kLd]
  float* gs = qs + C::kTileFloats;    // [64 rows][kLd]
  float* ps = gs + C::kTileFloats;    // [64 rows][kLdP]  p
  float* dss = ps + C::kPFloats;      // [64 rows][kLdP]  ds * scale

  const int tid = threadIdx.x;
  const int rg = tid / kCG, cg = tid % kCG;  // score-tile mapping
  const int og = tid / kDG, dg = tid % kDG;  // output-tile mapping (keys)
  const int ik = blockIdx.x, bh = blockIdx.y, k0 = ik * kTile;

  const T* qb = q + (int64_t)bh * Sq * D;
  const T* gb = g + (int64_t)bh * Sq * D;
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;
  const float* lb = lse + (int64_t)bh * Sq;
  const float* db = delta + (int64_t)bh * Sq;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  float* dsb = ds == nullptr ? nullptr : ds + (int64_t)bh * Sq * Sk;

  load_tile<T, D>(ks, kb, k0, Sk);
  load_tile<T, D>(vs, vb, k0, Sk);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + kTile - 1) / kTile;
  const int iq0 = causal ? ik : 0;
  // query tiles below iq0 lie wholly above the causal diagonal: their
  // score grad is 0, written here so that every element of ds has a value
  if (dsb != nullptr) {
    const int rows = min(iq0 * kTile, Sq);
    for (int e = tid; e < rows * kTile; e += C::kThreads) {
      const int key = k0 + e % kTile;
      if (key < Sk) dsb[(int64_t)(e / kTile) * Sk + key] = 0.f;
    }
  }
  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();  // the previous tile's readers of qs/gs/ps/dss are done
    load_tile<T, D>(qs, qb, q0, Sq);
    load_tile<T, D>(gs, gb, q0, Sq);
    __syncthreads();

    float s[4][kNC], dp[4][kNC];
    tile_dot<D>(s, qs, ks, rg, cg);
    tile_dot<D>(dp, gs, vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i, row = q0 + r;
      const bool live = row < Sq;
      const float l = live ? lb[row] : 0.f;
      const float dl = live ? db[row] : 0.f;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int c = cg + kCG * j, key = k0 + c;
        const float p = prob(s[i][j], row, key, Sq, Sk, l, scale, bb, causal);
        const float dsr = p * (dp[i][j] - dl);
        if (dsb != nullptr && live && key < Sk)
          dsb[(int64_t)row * Sk + key] = dsr;
        ps[r * kLdP + c] = p;
        dss[r * kLdP + c] = dsr * scale;
      }
    }
    __syncthreads();

    // dV[key][d] += sum_r p[r][key] g[r][d];  dK[key][d] += sum_r ds[r][key] q[r][d]
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float4 pv = load4(ps + r * kLdP + 4 * og);
      const float4 sv = load4(dss + r * kLdP + 4 * og);
      const float4 g0 = load4(gs + r * kLd + 4 * dg);
      const float4 g1 = load4(gs + r * kLd + D / 2 + 4 * dg);
      const float4 q0v = load4(qs + r * kLd + 4 * dg);
      const float4 q1v = load4(qs + r * kLd + D / 2 + 4 * dg);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float gr[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float qr[8] = {q0v.x, q0v.y, q0v.z, q0v.w,
                           q1v.x, q1v.y, q1v.z, q1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          dv_acc[i][c] = fmaf(pr[i], gr[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sr[i], qr[c], dk_acc[i][c]);
        }
    }
  }

  T* dkb = dk + (int64_t)bh * Sk * D;
  T* dvb = dv + (int64_t)bh * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * og + i;
    if (key >= Sk) continue;
    const int64_t o = (int64_t)key * D + 4 * dg;
    store4(dkb + o, dk_acc[i][0], dk_acc[i][1], dk_acc[i][2], dk_acc[i][3]);
    store4(dkb + o + D / 2, dk_acc[i][4], dk_acc[i][5], dk_acc[i][6],
           dk_acc[i][7]);
    store4(dvb + o, dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
    store4(dvb + o + D / 2, dv_acc[i][4], dv_acc[i][5], dv_acc[i][6],
           dv_acc[i][7]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                int64_t bias_sb, int64_t bias_sh, int64_t bias_sq,
                int64_t bias_sk, const T* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Sq, int Sk, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int kLd = C::kLd, kCG = C::kCG, kNC = C::kNC, kDG = C::kDG;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [64 rows][kLd]
  float* gs = qs + C::kTileFloats;    // [64 rows][kLd]
  float* ks = gs + C::kTileFloats;    // [64 keys][kLd]
  float* vs = ks + C::kTileFloats;    // [64 keys][kLd]
  float* dsT = vs + C::kTileFloats;   // [64 keys][kLdP]  ds * scale, transposed

  const int tid = threadIdx.x;
  const int rg = tid / kCG, cg = tid % kCG;  // score-tile mapping
  const int og = tid / kDG, dg = tid % kDG;  // output-tile mapping (rows)
  const int iq = blockIdx.x, bh = blockIdx.y, q0 = iq * kTile;

  const T* qb = q + (int64_t)bh * Sq * D;
  const T* gb = g + (int64_t)bh * Sq * D;
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;

  load_tile<T, D>(qs, qb, q0, Sq);
  load_tile<T, D>(gs, gb, q0, Sq);
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    l[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dl[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }

  float dq_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dq_acc[i][c] = 0.f;

  int nk = (Sk + kTile - 1) / kTile;
  if (causal) nk = min(nk, iq + 1);  // later key tiles: all key > query
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kTile;
    __syncthreads();  // the previous tile's readers of ks/vs/dsT are done
    load_tile<T, D>(ks, kb, k0, Sk);
    load_tile<T, D>(vs, vb, k0, Sk);
    __syncthreads();

    float s[4][kNC], dp[4][kNC];
    tile_dot<D>(s, qs, ks, rg, cg);
    tile_dot<D>(dp, gs, vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int c = cg + kCG * j;
        const float p = prob(s[i][j], row, k0 + c, Sq, Sk, l[i], scale, bb,
                             causal);
        dsT[c * kLdP + r] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();

    // dQ[row][d] += sum_key ds[row][key] k[key][d]
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      const float4 sv = load4(dsT + c * kLdP + 4 * og);
      const float4 k0v = load4(ks + c * kLd + 4 * dg);
      const float4 k1v = load4(ks + c * kLd + D / 2 + 4 * dg);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float kr[8] = {k0v.x, k0v.y, k0v.z, k0v.w,
                           k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          dq_acc[i][cc] = fmaf(sr[i], kr[cc], dq_acc[i][cc]);
    }
  }

  T* dqb = dq + (int64_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * og + i;
    if (row >= Sq) continue;
    const int64_t o = (int64_t)row * D + 4 * dg;
    store4(dqb + o, dq_acc[i][0], dq_acc[i][1], dq_acc[i][2], dq_acc[i][3]);
    store4(dqb + o + D / 2, dq_acc[i][4], dq_acc[i][5], dq_acc[i][6],
           dq_acc[i][7]);
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               int64_t sb, int64_t sh, int64_t sq, int64_t sk, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               float* ds, int B, int H, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  const int smem = Cfg<D>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + kTile - 1) / kTile, B * H);
  flash_dkv_kernel<T, D><<<grid, Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, sb, sh, sq, sk,
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), ds, H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              int64_t sb, int64_t sh, int64_t sq, int64_t sk, const void* g,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  const int smem = Cfg<D>::kDqSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_dq_kernel<T, D><<<grid, Cfg<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, sb, sh, sq, sk,
      static_cast<const T*>(g), lse, delta, static_cast<T*>(dq), H, Sq, Sk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry of kernel `which` (0 = dK/dV, 1 = dQ) at head dim D:
// rows (query rows or keys) per CTA, threads per CTA and dynamic shared
// memory bytes. Returns cudaErrorInvalidValue for an unsupported D. The
// wrapper checks these against the card's limits before it launches.
int flash_attention_bwd_config(int which, int D, int* rows, int* threads,
                               int* smem_bytes) {
  *rows = kTile;
  if (D == 64) {
    *threads = Cfg<64>::kThreads;
    *smem_bytes = which == 0 ? Cfg<64>::kDkvSmem : Cfg<64>::kDqSmem;
  } else if (D == 128) {
    *threads = Cfg<128>::kThreads;
    *smem_bytes = which == 0 ? Cfg<128>::kDkvSmem : Cfg<128>::kDqSmem;
  } else {
    *threads = 0;
    *smem_bytes = 0;
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. bias may be null; its strides are in
// elements, 0 on each broadcast dim. ds may be null; when given it
// receives the raw score grad p * (dp - delta) as f32 [B, H, Sq, Sk].
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* bias, int64_t bias_sb, int64_t bias_sh,
                        int64_t bias_sq, int64_t bias_sk, const void* g,
                        const void* lse, const void* delta, void* dk,
                        void* dv, void* ds, int B, int H, int Sq, int Sk,
                        int D, int dtype, float scale, int causal,
                        void* stream) {
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dsp = static_cast<float*>(ds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, b, bias_sb, bias_sh, bias_sq,
                                 bias_sk, g, l, dl, dk, dv, dsp, B, H, Sq, Sk,
                                 scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, b, bias_sb, bias_sh, bias_sq,
                                  bias_sk, g, l, dl, dk, dv, dsp, B, H, Sq,
                                  Sk, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, b, bias_sb, bias_sh,
                                         bias_sq, bias_sk, g, l, dl, dk, dv,
                                         dsp, B, H, Sq, Sk, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, b, bias_sb, bias_sh,
                                          bias_sq, bias_sk, g, l, dl, dk, dv,
                                          dsp, B, H, Sq, Sk, scale, causal,
                                          s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* bias, int64_t bias_sb, int64_t bias_sh,
                       int64_t bias_sq, int64_t bias_sk, const void* g,
                       const void* lse, const void* delta, void* dq, int B,
                       int H, int Sq, int Sk, int D, int dtype, float scale,
                       int causal, void* stream) {
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, b, bias_sb, bias_sh, bias_sq,
                                bias_sk, g, l, dl, dq, B, H, Sq, Sk, scale,
                                causal, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, b, bias_sb, bias_sh, bias_sq,
                                 bias_sk, g, l, dl, dq, B, H, Sq, Sk, scale,
                                 causal, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, b, bias_sb, bias_sh,
                                        bias_sq, bias_sk, g, l, dl, dq, B, H,
                                        Sq, Sk, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, b, bias_sb, bias_sh,
                                         bias_sq, bias_sk, g, l, dl, dq, B,
                                         H, Sq, Sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
