// FlashAttention-2 forward for Hopper (sm_90a), f32 and bf16 inputs: one
// kernel in a bf16 and an f32 design.
//
// Replaces paddle_tpu/ops/attention.py `_fwd_kernel` (:281), driven by
// `_forward_pallas` (:324), the Pallas TPU kernel. Computes the same
// function:
//
//   s   = (q k^T) * scale + bias          f32, bias broadcast over
//                                         [B|1, H|1, Sq|1, Sk] by strides
//   s   = -1e9 where key > query          when causal (Sq == Sk)
//   o   = softmax(s) v                    written in the input dtype
//   lse = logsumexp(s) per query row      f32
//
// with an online softmax over key tiles, so the [Sq, Sk] scores never
// reach device memory. Key tiles wholly above the causal diagonal are
// skipped; the ragged Sq and Sk edges are bounds-checked, never padded:
// keys past Sk take no weight (-inf), rows past Sq are not written. A row
// whose every key carries the -1e9 mask spreads its weight uniformly over
// the real keys.
//
// What bounds each dtype on an H100:
//   bf16: at [8, 12, 512, 64] the bytes (about 25 MB at 3.35 TB/s) and the
//     products (4 B H Sq Sk D FLOPs at 989 TFLOP/s) are within 20% of each
//     other. Both products are warp-level mma.sync m16n8k16 (bf16 in, f32
//     accumulate). On the card neither bound is near: every 64-row CTA
//     re-reads its head's K and V from L2, and the products with the
//     per-score softmax (a max, an exp and a sum per score) take about as
//     long again; the two overlap only in part.
//   f32: operations on the f32 FMA units, 67 TFLOP/s (no tensor cores:
//     TF32 would change the result, and the main path runs with TF32 off).
//
// Layout:
//   bf16 (128 threads, 4 warps; each warp owns 16 of the CTA's 64 query
//     rows): the warp's Q fragments are loaded once by ldmatrix and stay
//     in registers for the whole sweep. K and V tiles (64 keys at D = 64,
//     32 at D = 128, where the O accumulator takes 64 registers) arrive by
//     16-byte cp.async, zero-filled past Sk, into a two-stage ring: tile
//     i + 1 loads while tile i is computed. Rows are padded by 16 bytes so
//     that ldmatrix reads them without bank conflicts. S = Q K^T goes into
//     mma accumulators (K the B operand by ldmatrix); the online softmax
//     runs on them in registers (row max across the quad of lanes that
//     share a row); P is packed to bf16 A fragments in registers (two
//     adjacent m16n8 accumulator blocks are one m16n8k16 A operand) and
//     O += P V takes V by ldmatrix.trans. P never touches shared memory,
//     and it is rounded to bf16 exactly where the TPU kernel rounds it
//     (`p.astype(v.dtype)`, unnormalized). The output goes out as packed
//     bf16x2.
//   f32 (128 threads): 64 query rows and 64-key tiles at D = 64; 32 rows
//     at D = 128, so that two CTAs share an SM. One stage, split so that
//     the next K tile (and its bias) loads during P V and the next V tile
//     during Q K^T and the softmax; with two or three CTAs per SM one CTA
//     computes through the others' loads. Register micro-tiles of 4 rows
//     x 8 (D = 64) or 4 (D = 128) keys for the scores (tile_dot) and of 4
//     rows x 8 columns for the output; P goes through shared memory
//     transposed, written without bank conflicts at D = 64 (2-way at
//     D = 128), and each row's rescale factor through shared memory.
//   Both: the bias slice is copied once per key tile through its strides
//     (4-byte cp.async, zero-filled): one row of keys for a key-pad bias
//     (bias_sq == 0), the CTA's rows for a full one. x = s * scale + bias
//     is formed in natural units, then (x - m) is scaled by log2(e) for
//     the exp2: folding log2(e) into the bias or the max first would lose
//     the O(1) score differences next to a -1e9 mask (the ulp of 1e9 is
//     64). lse = m + log(l) in natural units. A key tile wholly inside Sk
//     and below the causal diagonal takes an instantiation without masks.
//
// Shared memory per CTA, at D = 64 | 128 (a full bias tile / a key-pad row
// / none):
//   bf16  82,944 / 46,656 / 46,080   |  72,704 / 52,544 / 52,224
//   f32   88,576 / 70,432 / 70,144   | 104,192 / 94,272 / 93,952
// (flash_attention_fwd_occupancy reports the CTAs per SM the card grants
// each; the registers may bind first.)
//
// C interface, loaded with ctypes (kernels/build.py): every pointer and
// the stream are void*; the launch returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

#include "launch_count.cuh"

namespace {

// launches of each kernel as the card ran them (count_launch): f32
// forward, bf16 forward
__device__ unsigned long long g_launches[2];

constexpr float kMask = -1e9f;  // the causal mask value of the TPU kernel

// ------------------------------------------ bf16: tensor cores (mma.sync)
template <int D>
struct Bf {
  static constexpr int kThreads = 128;  // 4 warps x 16 query rows
  static constexpr int kRows = 64;
  static constexpr int kMinBlocks = 3;  // CTAs per SM the registers allow
  static constexpr int kKeys = D == 64 ? 64 : 32;  // keys per ring stage
  static constexpr int kLd = D + 8;                // padded row, bf16
  // bias row, f32: 8 mod 32 words, so that the float2 reads of a
  // half-warp hit distinct banks
  static constexpr int kLdb = kKeys + 8;
  // ring stage: k, v and `brows` bias rows of kKeys keys (bytes)
  __host__ __device__ static constexpr int stage(int brows) {
    return 4 * kKeys * kLd + 4 * brows * kLdb;
  }
  __host__ __device__ static constexpr int smem(int brows) {
    return 2 * kRows * kLd + 2 * stage(brows);
  }
};

template <int D>
__global__ void __launch_bounds__(Bf<D>::kThreads, Bf<D>::kMinBlocks)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias, int64_t bias_sb,
                      int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[1]);
  using C = Bf<D>;
  constexpr int BM = C::kRows, BN = C::kKeys, LD = C::kLd, LDB = C::kLdb;
  constexpr int NT = C::kThreads, NJ = BN / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64 rows][LD]
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + BM * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int iq = blockIdx.x, bh = blockIdx.y, q0 = iq * BM;
  const int wr = 16 * warp;  // the warp's first row in the CTA
  const bf16* kb = k + (int64_t)bh * Sk * D;
  const bf16* vb = v + (int64_t)bh * Sk * D;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  // bias rows staged per key tile: the CTA's 64 rows, or one row when the
  // bias broadcasts over the query rows
  const int sbr = bias == nullptr ? 0 : (bias_sq == 0 ? 1 : BM);
  const int stage = C::stage(sbr);

  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);  // later: key > query

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

  async_tile<bf16, BM, D, LD, NT>(qs, q + (int64_t)bh * Sq * D, q0, Sq);
  cp_async_commit();
  load_stage(0, 0);
  cp_async_commit();
  cp_async_wait1();  // q has landed
  __syncthreads();
  uint32_t qa[KD][4];  // this warp's 16 rows, in registers
  load_a<KD, LD>(qa, qs + wr * LD, lane);

  // rows wr + gi (h = 0) and wr + gi + 8 (h = 1): running max (natural
  // units) and this thread's part of the running sum
  float oa[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int ik = 0, st = 0; ik < nk; ++ik, st ^= 1) {
    if (ik + 1 < nk) load_stage(ik + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* ks = reinterpret_cast<const bf16*>(ring + st * stage);
    const bf16* vs = ks + BN * LD;
    const float* bs = reinterpret_cast<const float*>(vs + BN * LD);
    const int kt0 = ik * BN;

    // S = Q K^T: this warp's 16 rows x BN keys
    float sa[NJ][4] = {};
    mma_rbt<NJ, KD, LD>(sa, qa, ks, lane);
    // x = s * scale + bias (masked), the rows' new max, then p
    float alpha[2];
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kc0 = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = wr + gi + 8 * h;  // the row in the CTA
          float2 b2 = make_float2(0.f, 0.f);
          if (sbr == 1) b2 = load2(bs + kc0);
          if (sbr == BM) b2 = load2(bs + rr * LDB + kc0);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * h + u, key = kt0 + kc0 + u;
            float x = fmaf(sa[j][e], scale, u ? b2.y : b2.x);
            if (kMasked) {
              if (key >= Sk)
                x = -INFINITY;  // keys past Sk take no weight
              else if (causal && key > q0 + rr)
                x = kMask;
            }
            sa[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = ex2((m[h] - mx[h]) * kLog2e);
        m[h] = mx[h];
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((sa[j][e] - m[e >> 1]) * kLog2e);
          sa[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
    };
    if (kt0 + BN > Sk || (causal && kt0 + BN - 1 > q0 + wr))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    // O = alpha O + P V (P rounded to bf16 in registers)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      oa[nd][0] *= alpha[0];
      oa[nd][1] *= alpha[0];
      oa[nd][2] *= alpha[1];
      oa[nd][3] *= alpha[1];
    }
    mma_xb<NJ, D, LD>(oa, sa, vs, lane);
    __syncthreads();  // this stage is read; load_stage may refill it
  }

  const int row[2] = {q0 + wr + gi, q0 + wr + gi + 8};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0 && row[h] < Sq)
      lse[(int64_t)bh * Sq + row[h]] = m[h] + logf(l[h]);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    oa[nd][0] /= l[0];
    oa[nd][1] /= l[0];
    oa[nd][2] /= l[1];
    oa[nd][3] /= l[1];
  }
  store_rows<D>(o + (int64_t)bh * Sq * D, oa, row[0], row[1], Sq, t);
}

// ------------------------------------------- f32: exact f32 FMAs, cp.async
template <int D>
struct F32 {
  static constexpr int kRows = D == 64 ? 64 : 32;  // query rows per CTA
  static constexpr int kKeys = 64;                 // keys per tile
  // 4 x 8 output micro-tiles cover the [kRows][D] output: 128 threads
  static constexpr int kThreads = kRows * D / 32;
  // CTAs per SM the registers must allow: 3 at D = 64 (with a key-pad
  // bias the shared memory allows 3), 2 at D = 128
  static constexpr int kMinBlocks = D == 64 ? 3 : 2;
  static constexpr int kNC = kRows * kKeys / (4 * kThreads);  // 8 | 4
  static constexpr int kTPR = kKeys / kNC;  // threads per score row: 8 | 16
  static constexpr int kRG = kThreads / kTPR;  // score row groups: 16 | 8
  static constexpr int kDG = D / 8;            // output column groups
  static constexpr int kLd = D + 4;            // padded row
  static constexpr int kLdp = kRows + 4;       // P^T row (one key)
  // bias row: kTPR mod 32 words, so that a warp's reads hit distinct banks
  static constexpr int kLdb = kKeys + kTPR;
  static_assert(kRG * 4 == kRows && kThreads / kDG * 4 == kRows, "");
  // q, k, v, P^T, the rows' rescale factors and sums, `brows` bias rows
  __host__ __device__ static constexpr int smem(int brows) {
    return 4 * (kRows * kLd + 2 * kKeys * kLd + kKeys * kLdp + 2 * kRows +
                brows * kLdb);
  }
};

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads, F32<D>::kMinBlocks)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, int64_t bias_sb,
                     int64_t bias_sh, int64_t bias_sq, int64_t bias_sk,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int Sq, int Sk, float scale, int causal) {
  count_launch(&g_launches[0]);
  using C = F32<D>;
  constexpr int BM = C::kRows, BN = C::kKeys, LD = C::kLd, LDP = C::kLdp;
  constexpr int LDB = C::kLdb, NT = C::kThreads, NC = C::kNC;
  constexpr int TPR = C::kTPR, RG = C::kRG, DG = C::kDG;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;              // [BM rows][LD]
  float* ks = qs + BM * LD;     // [BN keys][LD]
  float* vs = ks + BN * LD;     // [BN keys][LD]
  float* pT = vs + BN * LD;     // [BN keys][LDP]  p, transposed
  float* as = pT + BN * LDP;    // [BM]  each row's rescale factor
  float* ls = as + BM;          // [BM]  each row's sum
  float* bs = ls + BM;          // [BM | 1][LDB]  the bias tile

  const int tid = threadIdx.x;
  int rg, cg;  // scores: rows rg + RG i, keys cg + TPR j
  score_map<BN, NC>(tid, rg, cg);
  const int og = tid / DG, dg = tid % DG;  // outputs: rows 4 og + i
  const int iq = blockIdx.x, bh = blockIdx.y, q0 = iq * BM;
  const float* kb = k + (int64_t)bh * Sk * D;
  const float* vb = v + (int64_t)bh * Sk * D;
  Bias bb{nullptr, bias_sq, bias_sk};
  if (bias != nullptr)
    bb.p = bias + (int64_t)(bh / H) * bias_sb + (int64_t)(bh % H) * bias_sh;
  const int sbr = bias == nullptr ? 0 : (bias_sq == 0 ? 1 : BM);

  int nk = (Sk + BN - 1) / BN;
  if (causal) nk = min(nk, (q0 + BM - 1) / BN + 1);  // later: key > query

  // one stage in two groups: K and its bias, then V
  auto load_k = [&](int ik) {
    async_tile<float, BN, D, LD, NT>(ks, kb, ik * BN, Sk);
    if (sbr) async_bias<BN, LDB, NT>(bs, bb, sbr, sbr == 1 ? 0 : q0, Sq,
                                     ik * BN, Sk);
  };
  async_tile<float, BM, D, LD, NT>(qs, q + (int64_t)bh * Sq * D, q0, Sq);
  load_k(0);
  cp_async_commit();
  async_tile<float, BN, D, LD, NT>(vs, vb, 0, Sk);
  cp_async_commit();

  // score rows rg + RG i: running max (natural units) and this thread's
  // part of the running sum
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  float acc[4][8] = {};
  for (int ik = 0; ik < nk; ++ik) {
    const int kt0 = ik * BN;
    cp_async_wait1();  // q, this K tile and its bias have landed
    __syncthreads();

    float s[4][NC];
    tile_dot<D, LD, BM, BN, NC>(s, qs, ks, rg, cg);
    auto epilogue = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + RG * i, row = q0 + r;
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = cg + TPR * j, key = kt0 + c;
          const float b = sbr ? bs[(sbr == 1 ? 0 : r) * LDB + c] : 0.f;
          float x = fmaf(s[i][j], scale, b);
          if (kMasked) {
            if (key >= Sk)
              x = -INFINITY;  // keys past Sk take no weight
            else if (causal && key > row)
              x = kMask;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int w = 1; w < TPR; w <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float alpha = ex2((m[i] - mx) * kLog2e);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float p = ex2((s[i][j] - mx) * kLog2e);
          pT[(cg + TPR * j) * LDP + r] = p;
          sum += p;
        }
        l[i] = alpha * l[i] + sum;
        if (cg == 0) as[r] = alpha;
      }
    };
    if (kt0 + BN > Sk || (causal && kt0 + BN - 1 > q0))
      epilogue(Masked{});
    else
      epilogue(Interior{});
    cp_async_wait0();  // this V tile has landed
    __syncthreads();   // p and the factors are written; K is read
    if (ik + 1 < nk) load_k(ik + 1);
    cp_async_commit();

    // O = alpha O + P V
    const float4 a4 = load4(as + 4 * og);
    const float al[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= al[i];
    out_product<DG, 8, BN, LDP, LD>(acc, pT, vs, og, dg);
    __syncthreads();  // V, p and the factors are read
    if (ik + 1 < nk)
      async_tile<float, BN, D, LD, NT>(vs, vb, (ik + 1) * BN, Sk);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int r = rg + RG * i, row = q0 + r;
    if (cg == 0) {
      ls[r] = l[i];
      if (row < Sq) lse[(int64_t)bh * Sq + row] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();
  const float4 l4 = load4(ls + 4 * og);
  const float lr[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] /= lr[i];
  store_out<D, DG, 8>(o + (int64_t)bh * Sq * D, acc, q0 + 4 * og, Sq, dg);
}

// ------------------------------------------------------------- launches
struct Geometry {
  const void* kernel;  // null: no configuration
  int rows;            // query rows per CTA
  int threads;
  int smem_max;  // with a full bias tile
  int smem;      // with this launch's bias
};

// bias kind: 0 none, 1 broadcast over the query rows, 2 full
template <int D>
Geometry geometry_d(int dtype, int kind) {
  if (dtype == 0) {
    using C = F32<D>;
    const int brows = kind == 2 ? C::kRows : kind;
    return {reinterpret_cast<const void*>(flash_fwd_f32_kernel<D>), C::kRows,
            C::kThreads, C::smem(C::kRows), C::smem(brows)};
  }
  using C = Bf<D>;
  const int brows = kind == 2 ? C::kRows : kind;
  return {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<D>), C::kRows,
          C::kThreads, C::smem(C::kRows), C::smem(brows)};
}

Geometry geometry(int D, int dtype, int kind) {
  if ((dtype != 0 && dtype != 1) || kind < 0 || kind > 2)
    return {nullptr, 0, 0, 0, 0};
  if (D == 64) return geometry_d<64>(dtype, kind);
  if (D == 128) return geometry_d<128>(dtype, kind);
  return {nullptr, 0, 0, 0, 0};
}

}  // namespace

extern "C" {

// Launch geometry at head dim D and dtype (0 = float32, 1 = bfloat16):
// query rows per CTA, threads per CTA and the most dynamic shared memory
// a launch takes (with a full bias tile). Returns cudaErrorInvalidValue
// for an unsupported D or dtype. The wrapper checks these against the
// card's limits before it launches.
int flash_attention_fwd_config(int D, int dtype, int* rows, int* threads,
                               int* smem_bytes) {
  const Geometry geo = geometry(D, dtype, 2);
  *rows = geo.rows;
  *threads = geo.threads;
  *smem_bytes = geo.smem_max;
  return geo.kernel == nullptr ? (int)cudaErrorInvalidValue : 0;
}

// CTAs per SM the card grants the kernel at D and dtype with a bias of
// kind `bias` (0 none, 1 broadcast over the query rows, 2 full), and the
// dynamic shared memory per CTA that takes.
int flash_attention_fwd_occupancy(int D, int dtype, int bias, int* blocks,
                                  int* smem_bytes) {
  const Geometry geo = geometry(D, dtype, bias);
  if (geo.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      geo.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_max);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = geo.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, geo.kernel, geo.threads, (size_t)geo.smem);
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v 16-byte aligned. bias may be
// null; its strides are in elements, 0 on each broadcast dim. Returns a
// cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, int64_t bias_sb, int64_t bias_sh,
                        int64_t bias_sq, int64_t bias_sk, void* o, void* lse,
                        int B, int H, int Sq, int Sk, int D, int dtype,
                        float scale, int causal, void* stream) {
  const Geometry geo =
      geometry(D, dtype, bias == nullptr ? 0 : (bias_sq == 0 ? 1 : 2));
  if (geo.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      geo.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem_max);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q,   &k,  &v,  &bias, &bias_sb, &bias_sh, &bias_sq, &bias_sk,
                  &o,   &lse, &H, &Sq,   &Sk,      &scale,   &causal};
  const dim3 grid((Sq + geo.rows - 1) / geo.rows, B * H);
  err = cudaLaunchKernel(geo.kernel, grid, dim3(geo.threads), args,
                         (size_t)geo.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// This library's kernel launches as the card ran them, per slot of
// g_launches (f32 forward, bf16 forward), into out[2].
int flash_attention_fwd_device_launches(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches)));
}

}  // extern "C"
