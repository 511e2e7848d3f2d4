// FlashAttention-2 backward for Hopper (sm_90a), f32 and bf16 inputs:
// two kernels, dK/dV and dQ, each in a bf16 and an f32 design.
//
// Replaces paddle_tpu/ops/attention.py `_dkv_kernel` (:383) and
// `_dq_kernel` (:432), driven by `_backward_pallas` (:469), the Pallas
// TPU kernels. They compute the same functions, from the forward's
// per-row logsumexp (lse) and delta = rowsum(dO * O) (minus the lse
// cotangent), both computed outside the kernels:
//
//   s   = (q k^T) * scale + bias      bias broadcast over
//                                     [B|1, H|1, Sq|1, Sk] by strides
//   p   = exp(s - lse), 0 where key > query when causal (Sq == Sk)
//   dp  = dO v^T
//   ds  = p * (dp - delta) * scale
//   dV  = p^T dO,  dK = ds^T q        (dkv kernel; optionally the raw
//                                     score grad p * (dp - delta), f32)
//   dQ  = ds k                        (dq kernel)
//
// The [Sq, Sk] probabilities are recomputed per tile and never reach
// device memory (except the raw score grad, when a trainable bias asks
// for it). Both kernels recompute s and dp (the backward needs 10 units
// of B*H*P*D FLOPs, P the visible (query, key) pairs; the two kernels do
// 8 + 6 = 14), so that every output element is written by exactly one
// CTA: no atomics, and a result is bitwise repeatable.
//
// What bounds each dtype on an H100:
//   bf16: operations on the tensor cores, 989 TFLOP/s dense. Every
//     product is a warp-level mma.sync m16n8k16 (bf16 in, f32
//     accumulate), operands from ldmatrix (.trans where the layout needs
//     it). P and dS are rounded to bf16 before the dV, dK and dQ
//     products, as the TPU kernel and the plain version do.
//   f32: operations on the f32 FMA units, 67 TFLOP/s (no tensor cores:
//     TF32 would change the result, and the main path runs with TF32
//     off). Register micro-tiles of 4 rows x 8 (D = 64) or 4 (D = 128)
//     keys for the scores and 4 owned rows x 8 columns for the outputs
//     keep 10.7 FMAs per 16-byte shared-memory load.
//
// Layout, both designs: one CTA per (b*h, 64-key tile) for dK/dV, which
// sweeps the query tiles; one CTA per (b*h, 64-query tile) for dQ, which
// sweeps the key tiles. The swept tiles arrive by cp.async (16 bytes,
// zero-filled past Sq / Sk, no trip through registers), with the tile's
// lse and delta (dK/dV) and its bias slice, copied once per tile through
// the bias' strides (4-byte cp.async, zero-filled); a bias that
// broadcasts over the query rows (a key-pad mask) is one row, which the
// dK/dV kernels keep in registers for the whole sweep. exp is exp2f of
// (x - lse) * log2(e); masked scores take p = 0 without one.
//
//   bf16 (128 threads, 4 warps; each warp owns 16 rows of the CTA's 64):
//     a two-stage ring, so tile i+1 loads while tile i is computed.
//     dK/dV: K and V stay in shared memory; per swept tile the warp
//       computes S^T = K Q^T and dP^T = V dO^T into mma accumulators,
//       forms P^T and dS^T in registers, packs them to bf16 A fragments
//       and accumulates dV += P^T dO and dK += dS^T Q (B operands from
//       the ring by ldmatrix.trans). P^T and dS^T never touch shared
//       memory; the raw score grad is written from the f32 fragments.
//     dQ: the warp's Q and dO fragments stay in registers; per swept key
//       tile S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
//     Rows are padded by 16 bytes, so ldmatrix reads them without bank
//       conflicts. Swept tiles: 32 query rows for dK/dV; 64 keys for dQ
//       at D = 64, 32 at D = 128 (fewer accumulator registers). The
//       epilogue, not the products, bounds both kernels, so a tile wholly
//       inside [Sq, Sk] and below the causal diagonal takes an
//       instantiation without masks.
//   f32 (2 D threads): one stage of the swept tile, so that two CTAs of
//     4 warps share an SM at D = 64 and one of the two overlaps the
//     other's loads; p and ds * scale go through shared memory to the
//     output products (for dK/dV a full bias tile is staged where p then
//     goes). A two-stage ring costs the second CTA (140-175 KB): with
//     one CTA of 8 warps per SM the ring measured slower than this.
//
// Shared memory per CTA, at D = 64 | 128 (bf16 dK/dV: a full bias tile /
// a key-pad row or none; dQ: a full tile / a row / none):
//   bf16 dK/dV  54,784 / 37,376 B         |  87,552 / 70,144 B
//   bf16 dQ     90,112 / 55,840 / 55,296   |  88,064 / 69,920 / 69,632
//   f32 dK/dV  104,960                     | 170,496
//   f32 dQ     104,448 / 87,312 / 87,040   | 169,984 / 152,848 / 152,576
// (flash_attention_bwd_occupancy reports the CTAs per SM the card grants
// each; for bf16 the registers bind first: 3 CTAs at D = 64, 2 at 128).
//
// The cp.async, ldmatrix / mma.sync and f32 micro-tile helpers are
// flash_common.cuh's, shared with the forward kernel.
//
// C interface, loaded with ctypes (kernels/build.py): every pointer and
// the stream are void*; each launch returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

#include "launch_count.cuh"

namespace {

// launches of each kernel as the card ran them (count_launch): f32 dK/dV,
// f32 dQ, bf16 dK/dV, bf16 dQ
__device__ unsigned long long g_launches[4];

constexpr int kOwn = 64;  // keys (dK/dV) or query rows (dQ) per CTA

// p = exp(x - lse), x = s * scale + bias, or 0 where masked. x - lse is
// taken before the scaling by log2(e), so that a row whose every key
// carries the -1e9 mask (x and lse both near -1e9) keeps the plain
// version's rounding
__device__ __forceinline__ float prob(float s, float bias, float lse,
                                      float scale, bool live) {
  return live ? ex2((fmaf(s, scale, bias) - lse) * kLog2e) : 0.f;
}

// ------------------------------------------ bf16: tensor cores (mma.sync)
template <int D>
struct Bf {
  static constexpr int kThreads = 128;                // 4 warps x 16 rows
  // CTAs per SM the registers must allow: 3 at D = 64 (at most 168
  // registers, which both kernels fit without spills); 2 at D = 128,
  // where a cap of 168 spills hundreds of bytes
  static constexpr int kMinBlocks = D == 64 ? 3 : 2;
  // rows per swept tile: 32 query rows for dK/dV (at 64 its registers
  // spill under the cap of 168); 64 keys for dQ at D = 64, 32 at D = 128
  static constexpr int kDkvSweep = 32;
  static constexpr int kDqSweep = D == 64 ? 64 : 32;
  static constexpr int kLd = D + 8;                   // padded row, bf16
  // dK/dV ring stage: q, dO, lse, delta and `brows` bias rows of 64 keys
  __host__ __device__ static constexpr int dkv_stage(int brows) {
    return 4 * kDkvSweep * kLd + 8 * kDkvSweep + brows * (kOwn + 4) * 4;
  }
  __host__ __device__ static constexpr int dkv_smem(int brows) {
    return 4 * kOwn * kLd + 2 * dkv_stage(brows);
  }
  // dQ ring stage: k, v and `brows` bias rows of kDqSweep keys
  __host__ __device__ static constexpr int dq_stage(int brows) {
    return 4 * kDqSweep * kLd + brows * (kDqSweep + 4) * 4;
  }
  __host__ __device__ static constexpr int dq_smem(int brows) {
    return 4 * kOwn * kLd + 2 * dq_stage(brows);
  }
};

template <int D>
__global__ void __launch_bounds__(Bf<D>::kThreads, Bf<D>::kMinBlocks)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias, int64_t bias_sb,
                      int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                      const bf16* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ ds, int H,
                      int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[2]);
  using C = Bf<D>;
  constexpr int BM = C::kDkvSweep, LD = C::kLd, NT = C::kThreads;
  constexpr int NJ = BM / 8, LDB = kOwn + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64 keys][LD]
  bf16* vs = ks + kOwn * LD;                 // [64 keys][LD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kOwn * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int ik = blockIdx.x, bh = blockIdx.y, k0 = ik * kOwn;
  const bf16* qb = q + (int64_t)bh * Sq * D;
  const bf16* gb = g + (int64_t)bh * Sq * D;
  const float* lb = lse + (int64_t)bh * Sq;
  const float* db = delta + (int64_t)bh * Sq;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  float* dsb = ds == nullptr ? nullptr : ds + (int64_t)bh * Sq * Sk;
  // bias rows staged per query tile: a full tile, or none (a bias that
  // broadcasts over the query rows is read once, below, per key)
  const int sbr = bias != nullptr && bias_sq != 0 ? BM : 0;
  const int stage = C::dkv_stage(sbr);

  // this thread's accumulator rows: keys kr[0], kr[1] of the CTA's 64
  const int kr[2] = {16 * warp + gi, 16 * warp + gi + 8};
  bool kval[2];
  float brk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kval[h] = k0 + kr[h] < Sk;
    brk[h] = bb.p != nullptr && sbr == 0 && kval[h]
                 ? bb.p[(int64_t)(k0 + kr[h]) * bias_sk]
                 : 0.f;
  }

  const int nq = (Sq + BM - 1) / BM;
  const int iq0 = causal ? k0 / BM : 0;  // earlier tiles: all key > query
  if (dsb != nullptr) {  // their score grad is 0, written here
    const int rows = min(iq0 * BM, Sq);
    for (int e = threadIdx.x; e < rows * kOwn; e += NT) {
      const int key = k0 + e % kOwn;
      if (key < Sk) dsb[(int64_t)(e / kOwn) * Sk + key] = 0.f;
    }
  }

  auto load_stage = [&](int iq, int st) {
    unsigned char* s = ring + st * stage;
    bf16* qs = reinterpret_cast<bf16*>(s);
    bf16* gs = qs + BM * LD;
    float* ls = reinterpret_cast<float*>(gs + BM * LD);
    const int q0 = iq * BM;
    async_tile<bf16, BM, D, LD, NT>(qs, qb, q0, Sq);
    async_tile<bf16, BM, D, LD, NT>(gs, gb, q0, Sq);
    async_vec<NT>(ls, lb, q0, BM, Sq);
    async_vec<NT>(ls + BM, db, q0, BM, Sq);
    if (sbr) async_bias<kOwn, LDB, NT>(ls + 2 * BM, bb, BM, q0, Sq, k0, Sk);
  };

  async_tile<bf16, kOwn, D, LD, NT>(ks, k + (int64_t)bh * Sk * D, k0, Sk);
  async_tile<bf16, kOwn, D, LD, NT>(vs, v + (int64_t)bh * Sk * D, k0, Sk);
  load_stage(iq0, 0);
  cp_async_commit();

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int iq = iq0, st = 0; iq < nq; ++iq, st ^= 1) {
    if (iq + 1 < nq) load_stage(iq + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this tile (and K, V) have landed
    __syncthreads();
    const bf16* qs = reinterpret_cast<const bf16*>(ring + st * stage);
    const bf16* gs = qs + BM * LD;
    const float* ls = reinterpret_cast<const float*>(gs + BM * LD);
    const float* dl = ls + BM;
    const float* bs = dl + BM;
    const int q0 = iq * BM;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BM queries
    float sa[NJ][4] = {}, pa[NJ][4] = {};
    {
      uint32_t a[D / 16][4];
      load_a<D / 16, LD>(a, ks + 16 * warp * LD, lane);
      mma_rbt<NJ, D / 16, LD>(sa, a, qs, lane);
      load_a<D / 16, LD>(a, vs + 16 * warp * LD, lane);
      mma_rbt<NJ, D / 16, LD>(pa, a, gs, lane);
    }
    // P^T and dS^T in registers
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 l2 = load2(ls + 8 * j + 2 * t);
        const float2 d2 = load2(dl + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, qc = 8 * j + 2 * t + (e & 1), row = q0 + qc;
          const int key = k0 + kr[h];
          const bool live =
              !kMasked || (row < Sq && kval[h] && !(causal && key > row));
          const float b = sbr ? bs[qc * LDB + kr[h]] : brk[h];
          const float p =
              prob(sa[j][e], b, (e & 1) ? l2.y : l2.x, scale, live);
          const float dsr = p * (pa[j][e] - ((e & 1) ? d2.y : d2.x));
          if (dsb != nullptr && (!kMasked || (row < Sq && kval[h])))
            dsb[(int64_t)row * Sk + key] = dsr;
          sa[j][e] = p;
          pa[j][e] = dsr * scale;
        }
      }
    };
    if (q0 + BM > Sq || k0 + kOwn > Sk || (causal && q0 < k0 + kOwn))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    // dV += P^T dO, dK += dS^T Q (bf16 operands, f32 sums)
    mma_xb<NJ, D, LD>(dva, sa, gs, lane);
    mma_xb<NJ, D, LD>(dka, pa, qs, lane);
    __syncthreads();  // this stage is read; load_stage may refill it
  }

  store_rows<D>(dk + (int64_t)bh * Sk * D, dka, k0 + kr[0], k0 + kr[1], Sk,
                t);
  store_rows<D>(dv + (int64_t)bh * Sk * D, dva, k0 + kr[0], k0 + kr[1], Sk,
                t);
}

template <int D>
__global__ void __launch_bounds__(Bf<D>::kThreads, Bf<D>::kMinBlocks)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, int64_t bias_sb,
                     int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                     const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int H, int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[3]);
  using C = Bf<D>;
  constexpr int BN = C::kDqSweep, LD = C::kLd, NT = C::kThreads;
  constexpr int NJ = BN / 8, KD = D / 16, LDB = BN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64 rows][LD]
  bf16* gs = qs + kOwn * LD;                 // [64 rows][LD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(gs + kOwn * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int iq = blockIdx.x, bh = blockIdx.y, q0 = iq * kOwn;
  const bf16* kb = k + (int64_t)bh * Sk * D;
  const bf16* vb = v + (int64_t)bh * Sk * D;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  // bias rows staged per key tile: the CTA's 64 rows, or one row when the
  // bias broadcasts over the query rows
  const int sbr = bias == nullptr ? 0 : (bias_sq == 0 ? 1 : kOwn);
  const int stage = C::dq_stage(sbr);

  // this thread's accumulator rows
  int row[2], rr[2];
  float l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = 16 * warp + gi + 8 * h;
    row[h] = q0 + rr[h];
    const bool ok = row[h] < Sq;
    l[h] = ok ? lse[(int64_t)bh * Sq + row[h]] : 0.f;
    dl[h] = ok ? delta[(int64_t)bh * Sq + row[h]] : 0.f;
  }

  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + kOwn - 1) / BN + 1);  // later: key > query

  auto load_stage = [&](int ik, int st) {
    bf16* ks = reinterpret_cast<bf16*>(ring + st * stage);
    bf16* vs = ks + BN * LD;
    const int kt0 = ik * BN;
    async_tile<bf16, BN, D, LD, NT>(ks, kb, kt0, Sk);
    async_tile<bf16, BN, D, LD, NT>(vs, vb, kt0, Sk);
    if (sbr)
      async_bias<BN, LDB, NT>(reinterpret_cast<float*>(vs + BN * LD), bb,
                              sbr, sbr == 1 ? 0 : q0, Sq, kt0, Sk);
  };

  async_tile<bf16, kOwn, D, LD, NT>(qs, q + (int64_t)bh * Sq * D, q0, Sq);
  async_tile<bf16, kOwn, D, LD, NT>(gs, g + (int64_t)bh * Sq * D, q0, Sq);
  cp_async_commit();
  load_stage(0, 0);
  cp_async_commit();
  cp_async_wait1();  // q and dO have landed
  __syncthreads();
  uint32_t qa[KD][4], ga[KD][4];  // this warp's 16 rows, in registers
  load_a<KD, LD>(qa, qs + 16 * warp * LD, lane);
  load_a<KD, LD>(ga, gs + 16 * warp * LD, lane);

  float dqa[D / 8][4] = {};
  for (int ik = 0, st = 0; ik < nk; ++ik, st ^= 1) {
    if (ik + 1 < nk) load_stage(ik + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* ks = reinterpret_cast<const bf16*>(ring + st * stage);
    const bf16* vs = ks + BN * LD;
    const float* bs = reinterpret_cast<const float*>(vs + BN * LD);
    const int kt0 = ik * BN;

    // S = Q K^T, dP = dO V^T: this warp's 16 rows x BN keys
    float sa[NJ][4] = {}, pa[NJ][4] = {};
    mma_rbt<NJ, KD, LD>(sa, qa, ks, lane);
    mma_rbt<NJ, KD, LD>(pa, ga, vs, lane);
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kc0 = 8 * j + 2 * t;
        const float2 brow = sbr == 1 ? load2(bs + kc0) : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kc = kc0 + (e & 1), key = kt0 + kc;
          const bool live = !kMasked || (row[h] < Sq && key < Sk &&
                                         !(causal && key > row[h]));
          float b = (e & 1) ? brow.y : brow.x;
          if (sbr == kOwn) b = bs[rr[h] * LDB + kc];
          const float p = prob(sa[j][e], b, l[h], scale, live);
          sa[j][e] = p * (pa[j][e] - dl[h]) * scale;
        }
      }
    };
    if (q0 + kOwn > Sq || kt0 + BN > Sk || (causal && kt0 + BN - 1 > q0))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    // dQ += dS K
    mma_xb<NJ, D, LD>(dqa, sa, ks, lane);
    __syncthreads();
  }

  store_rows<D>(dq + (int64_t)bh * Sq * D, dqa, row[0], row[1], Sq, t);
}

// ------------------------------------------- f32: exact f32 FMAs, cp.async
// Geometry, both f32 kernels: 2 D threads, whose register micro-tiles of
// 4 rows x 8 (D = 64) or 4 (D = 128) keys cover the 64 x 64 score tile
// and whose micro-tiles of 4 owned rows x 8 columns cover the [64][D]
// outputs (10.7 FMAs per 16-byte shared-memory load in both); one stage
// of the swept tile, so that two CTAs of 4 warps share an SM at D = 64
// and one CTA of 8 warps has it at D = 128.
template <int D>
struct F32 {
  static constexpr int kThreads = 2 * D;
  static constexpr int kNC = D == 64 ? 8 : 4;
  static constexpr int kDG = D / 8;
  static constexpr int kLd = D + 4, kLdP = kOwn + 4;
  static_assert(kOwn * kOwn / (4 * kNC) == kThreads && 16 * kDG == kThreads,
                "");
  // dK/dV: k, v, q, dO, the bias tile then p, ds * scale, lse, delta
  __host__ __device__ static constexpr int dkv_smem() {
    return (4 * kOwn * kLd + 2 * kOwn * kLdP + 2 * kOwn) * 4;
  }
  // dQ: q, dO, k, v, (ds * scale)^T and `brows` bias rows
  __host__ __device__ static constexpr int dq_smem(int brows) {
    return (4 * kOwn * kLd + (kOwn + brows) * kLdP) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, int64_t bias_sb,
                     int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                     const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ ds, int H,
                     int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[0]);
  using C = F32<D>;
  constexpr int BM = kOwn, LD = C::kLd, LDP = C::kLdP;
  constexpr int NT = C::kThreads, NC = C::kNC, DG = C::kDG;
  extern __shared__ __align__(16) float smf[];
  float* ks = smf;              // [64 keys][LD]
  float* vs = ks + kOwn * LD;   // [64 keys][LD]
  float* qs = vs + kOwn * LD;   // [64 rows][LD]
  float* gs = qs + BM * LD;     // [64 rows][LD]
  float* ps = gs + BM * LD;     // [64 rows][LDP]  the bias tile, then p
  float* dss = ps + BM * LDP;   // [64 rows][LDP]  ds * scale
  float* ls = dss + BM * LDP;   // [64]  lse
  float* dl = ls + BM;          // [64]  delta

  const int tid = threadIdx.x;
  int rg, cg;  // scores: rows rg + 16 i, keys cg + 64/NC j
  score_map<kOwn, NC>(tid, rg, cg);
  const int og = tid / DG, dg = tid % DG;  // outputs: keys 4 og + i
  const int ik = blockIdx.x, bh = blockIdx.y, k0 = ik * kOwn;
  const float* qb = q + (int64_t)bh * Sq * D;
  const float* gb = g + (int64_t)bh * Sq * D;
  const float* lb = lse + (int64_t)bh * Sq;
  const float* db = delta + (int64_t)bh * Sq;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  float* dsb = ds == nullptr ? nullptr : ds + (int64_t)bh * Sq * Sk;
  const bool full_bias = bias != nullptr && bias_sq != 0;

  bool kval[NC];
  float brk[NC];  // a bias broadcast over the query rows, per key
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int key = k0 + cg + kOwn / NC * j;
    kval[j] = key < Sk;
    brk[j] = bb.p != nullptr && !full_bias && kval[j]
                 ? bb.p[(int64_t)key * bias_sk]
                 : 0.f;
  }

  const int nq = (Sq + BM - 1) / BM;
  const int iq0 = causal ? ik : 0;  // earlier tiles: all key > query
  if (dsb != nullptr) {  // their score grad is 0, written here
    const int rows = min(iq0 * BM, Sq);
    for (int e = tid; e < rows * kOwn; e += NT) {
      const int key = k0 + e % kOwn;
      if (key < Sk) dsb[(int64_t)(e / kOwn) * Sk + key] = 0.f;
    }
  }

  async_tile<float, kOwn, D, LD, NT>(ks, k + (int64_t)bh * Sk * D, k0, Sk);
  async_tile<float, kOwn, D, LD, NT>(vs, v + (int64_t)bh * Sk * D, k0, Sk);

  float dva[4][8] = {}, dka[4][8] = {};
  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * BM;
    // the previous tile's readers are done (the loop ends in a barrier)
    async_tile<float, BM, D, LD, NT>(qs, qb, q0, Sq);
    async_tile<float, BM, D, LD, NT>(gs, gb, q0, Sq);
    async_vec<NT>(ls, lb, q0, BM, Sq);
    async_vec<NT>(dl, db, q0, BM, Sq);
    if (full_bias) async_bias<kOwn, LDP, NT>(ps, bb, BM, q0, Sq, k0, Sk);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();

    float s[4][NC], dp[4][NC];
    tile_dot<D, LD, BM, kOwn, NC>(s, qs, ks, rg, cg);
    tile_dot<D, LD, BM, kOwn, NC>(dp, gs, vs, rg, cg);
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i, row = q0 + r;
        const bool rv = !kMasked || row < Sq;
        const float l = ls[r], dlt = dl[r];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = cg + kOwn / NC * j, key = k0 + c;
          const bool live =
              !kMasked || (rv && kval[j] && !(causal && key > row));
          // this thread reads its bias element and overwrites it with p
          const float b = full_bias ? ps[r * LDP + c] : brk[j];
          const float p = prob(s[i][j], b, l, scale, live);
          const float dsr = p * (dp[i][j] - dlt);
          if (dsb != nullptr && (!kMasked || (rv && kval[j])))
            dsb[(int64_t)row * Sk + key] = dsr;
          ps[r * LDP + c] = p;
          dss[r * LDP + c] = dsr * scale;
        }
      }
    };
    if (q0 + BM > Sq || k0 + kOwn > Sk || (causal && q0 < k0 + kOwn))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    __syncthreads();

    // dV[key][d] += sum_r p[r][key] g[r][d]
    // dK[key][d] += sum_r ds[r][key] q[r][d]
    out_product<DG, 8, BM, LDP, LD>(dva, ps, gs, og, dg);
    out_product<DG, 8, BM, LDP, LD>(dka, dss, qs, og, dg);
    __syncthreads();
  }

  store_out<D, DG, 8>(dv + (int64_t)bh * Sk * D, dva, k0 + 4 * og, Sk, dg);
  store_out<D, DG, 8>(dk + (int64_t)bh * Sk * D, dka, k0 + 4 * og, Sk, dg);
}

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, int64_t bias_sb,
                    int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                    const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[1]);
  using C = F32<D>;
  constexpr int BN = kOwn, LD = C::kLd, LDT = C::kLdP;
  constexpr int NT = C::kThreads, NC = C::kNC, DG = C::kDG;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;              // [64 rows][LD]
  float* gs = qs + kOwn * LD;   // [64 rows][LD]
  float* ks = gs + kOwn * LD;   // [64 keys][LD]
  float* vs = ks + BN * LD;     // [64 keys][LD]
  float* dsT = vs + BN * LD;    // [64 keys][LDT]  ds * scale, transposed
  float* bs = dsT + BN * LDT;   // [64 rows | 1][LDT]  the bias tile

  const int tid = threadIdx.x;
  int rg, cg;  // scores: rows rg + 16 i, keys cg + 64/NC j
  score_map<BN, NC>(tid, rg, cg);
  const int og = tid / DG, dg = tid % DG;  // outputs: rows 4 og + i
  const int iq = blockIdx.x, bh = blockIdx.y, q0 = iq * kOwn;
  const float* kb = k + (int64_t)bh * Sk * D;
  const float* vb = v + (int64_t)bh * Sk * D;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  // bias rows staged per key tile: the CTA's 64 rows, or one row when the
  // bias broadcasts over the query rows
  const int sbr = bias == nullptr ? 0 : (bias_sq == 0 ? 1 : kOwn);

  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    l[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : 0.f;
    dl[i] = row < Sq ? delta[(int64_t)bh * Sq + row] : 0.f;
  }

  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, iq + 1);  // later key tiles: all key > query

  async_tile<float, kOwn, D, LD, NT>(qs, q + (int64_t)bh * Sq * D, q0, Sq);
  async_tile<float, kOwn, D, LD, NT>(gs, g + (int64_t)bh * Sq * D, q0, Sq);

  float acc[4][8] = {};
  for (int ik = 0; ik < nk; ++ik) {
    const int kt0 = ik * BN;
    // the previous tile's readers are done (the loop ends in a barrier)
    async_tile<float, BN, D, LD, NT>(ks, kb, kt0, Sk);
    async_tile<float, BN, D, LD, NT>(vs, vb, kt0, Sk);
    if (sbr)
      async_bias<BN, LDT, NT>(bs, bb, sbr, sbr == 1 ? 0 : q0, Sq, kt0, Sk);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();

    float s[4][NC], dp[4][NC];
    tile_dot<D, LD, kOwn, BN, NC>(s, qs, ks, rg, cg);
    tile_dot<D, LD, kOwn, BN, NC>(dp, gs, vs, rg, cg);
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = cg + BN / NC * j, key = kt0 + c;
          const bool live =
              !kMasked || (row < Sq && key < Sk && !(causal && key > row));
          const float b = sbr ? bs[(sbr == 1 ? 0 : r) * LDT + c] : 0.f;
          const float p = prob(s[i][j], b, l[i], scale, live);
          dsT[c * LDT + r] = p * (dp[i][j] - dl[i]) * scale;
        }
      }
    };
    if (q0 + kOwn > Sq || kt0 + BN > Sk || (causal && kt0 + BN - 1 > q0))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    __syncthreads();

    // dQ[row][d] += sum_key ds[row][key] k[key][d]
    out_product<DG, 8, BN, LDT, LD>(acc, dsT, ks, og, dg);
    __syncthreads();
  }

  store_out<D, DG, 8>(dq + (int64_t)bh * Sq * D, acc, q0 + 4 * og, Sq, dg);
}

// ------------------------------------------------------------- launches
struct Geometry {
  const void* kernel;  // null: no configuration
  int threads;
  int smem_max;  // with a full bias tile
  int smem;      // with this launch's bias
};

// bias kind: 0 none, 1 broadcast over the query rows, 2 full
template <int D>
Geometry geometry_d(int which, int dtype, int kind) {
  if (dtype == 0 && which == 0)
    return {reinterpret_cast<const void*>(flash_dkv_f32_kernel<D>),
            F32<D>::kThreads, F32<D>::dkv_smem(),
            F32<D>::dkv_smem()};
  if (dtype == 0) {
    using C = F32<D>;
    return {reinterpret_cast<const void*>(flash_dq_f32_kernel<D>),
            C::kThreads, C::dq_smem(kOwn),
            C::dq_smem(kind == 2 ? kOwn : kind)};
  }
  using C = Bf<D>;
  if (which == 0)
    return {reinterpret_cast<const void*>(flash_dkv_bf16_kernel<D>),
            C::kThreads, C::dkv_smem(C::kDkvSweep),
            C::dkv_smem(kind == 2 ? C::kDkvSweep : 0)};
  return {reinterpret_cast<const void*>(flash_dq_bf16_kernel<D>),
          C::kThreads, C::dq_smem(kOwn), C::dq_smem(kind == 2 ? kOwn : kind)};
}

Geometry geometry(int which, int D, int dtype, int kind) {
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || kind < 0 ||
      kind > 2)
    return {nullptr, 0, 0, 0};
  if (D == 64) return geometry_d<64>(which, dtype, kind);
  if (D == 128) return geometry_d<128>(which, dtype, kind);
  return {nullptr, 0, 0, 0};
}

int bias_kind(const void* bias, int64_t bias_sq) {
  return bias == nullptr ? 0 : (bias_sq == 0 ? 1 : 2);
}

// args: the kernel's parameters in order, each a pointer to its value
int launch(int which, int D, int dtype, int kind, int sweep, int BH,
           void** args, cudaStream_t stream) {
  const Geometry geo = geometry(which, D, dtype, kind);
  if (geo.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      geo.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_max);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sweep + kOwn - 1) / kOwn, BH);
  err = cudaLaunchKernel(geo.kernel, grid, dim3(geo.threads), args,
                         (size_t)geo.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry of kernel `which` (0 = dK/dV, 1 = dQ) at head dim D and
// dtype (0 = float32, 1 = bfloat16): rows (keys or query rows) per CTA,
// threads per CTA and the most dynamic shared memory a launch takes (with
// a full bias tile). Returns cudaErrorInvalidValue for an unsupported D or
// dtype. The wrapper checks these against the card's limits before it
// launches.
int flash_attention_bwd_config(int which, int D, int dtype, int* rows,
                               int* threads, int* smem_bytes) {
  const Geometry geo = geometry(which, D, dtype, 2);
  *rows = kOwn;
  *threads = geo.threads;
  *smem_bytes = geo.smem_max;
  return geo.kernel == nullptr ? (int)cudaErrorInvalidValue : 0;
}

// CTAs per SM the card grants kernel `which` at D and dtype with a bias
// of kind `bias` (0 none, 1 broadcast over the query rows, 2 full), and
// the dynamic shared memory per CTA that takes.
int flash_attention_bwd_occupancy(int which, int D, int dtype, int bias,
                                  int* blocks, int* smem_bytes) {
  const Geometry geo = geometry(which, D, dtype, bias);
  if (geo.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      geo.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_max);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = geo.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, geo.kernel, geo.threads, (size_t)geo.smem);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v, g 16-byte aligned. bias may
// be null; its strides are in elements, 0 on each broadcast dim. ds may
// be null; when given it receives the raw score grad p * (dp - delta) as
// f32 [B, H, Sq, Sk].
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* bias, int64_t bias_sb, int64_t bias_sh,
                        int64_t bias_sq, int64_t bias_sk, const void* g,
                        const void* lse, const void* delta, void* dk,
                        void* dv, void* ds, int B, int H, int Sq, int Sk,
                        int D, int dtype, float scale, int causal,
                        void* stream) {
  void* args[] = {&q,     &k,       &v,     &bias, &bias_sb, &bias_sh,
                  &bias_sq, &bias_sk, &g,   &lse,  &delta,   &dk,
                  &dv,    &ds,      &H,     &Sq,   &Sk,      &scale,
                  &causal};
  return launch(0, D, dtype, bias_kind(bias, bias_sq), Sk, B * H, args,
                static_cast<cudaStream_t>(stream));
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* bias, int64_t bias_sb, int64_t bias_sh,
                       int64_t bias_sq, int64_t bias_sk, const void* g,
                       const void* lse, const void* delta, void* dq, int B,
                       int H, int Sq, int Sk, int D, int dtype, float scale,
                       int causal, void* stream) {
  void* args[] = {&q,     &k,       &v,   &bias, &bias_sb, &bias_sh,
                  &bias_sq, &bias_sk, &g, &lse,  &delta,   &dq,
                  &H,     &Sq,      &Sk,  &scale, &causal};
  return launch(1, D, dtype, bias_kind(bias, bias_sq), Sq, B * H, args,
                static_cast<cudaStream_t>(stream));
}

// This library's kernel launches as the card ran them, per slot of
// g_launches (f32 dK/dV, f32 dQ, bf16 dK/dV, bf16 dQ), into out[4].
int flash_attention_bwd_device_launches(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches)));
}

}  // extern "C"
