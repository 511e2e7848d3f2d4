// Device helpers shared by the flash-attention kernels for Hopper
// (sm_90a): the forward (flash_attention_fwd.cu) and the dK/dV and dQ
// kernels (flash_attention_bwd.cu).
//
//   - cp.async copies global -> shared (16 bytes for tiles, 4 bytes for
//     the bias through its strides), zero-filled past the ragged edge;
//   - bf16 tensor-core pieces: ldmatrix (.trans), mma.sync m16n8k16 (bf16
//     in, f32 accumulate), packing f32 accumulators into bf16 A fragments
//     in registers, and the warp-level products built from them;
//   - f32 FMA pieces: register micro-tile products over row-major shared
//     tiles read by 16-byte loads.
//
// Header-only; every function is inline, in an anonymous namespace, so
// each kernel source compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4-byte async copy global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + R) of a row-major [S][D] matrix into a [R][LD] tile;
// rows past S are zero
template <typename T, int R, int D, int LD, int NT>
__device__ __forceinline__ void async_tile(T* dst, const T* src, int row0,
                                           int S) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kC = D / kE;          // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kC; i += NT) {
    const int r = i / kC, c = (i % kC) * kE, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * LD + c, src + (int64_t)(ok ? row : 0) * D + c, ok);
  }
}

// n floats from src[i0 ...] (zero past S)
template <int NT>
__device__ __forceinline__ void async_vec(float* dst, const float* src,
                                          int i0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = i0 + i < S;
    cp_async4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

struct Bias {
  const float* p;  // this (b, h)'s slice, or null
  int64_t sq, sk;  // element strides over query rows and keys (0: broadcast)
};

// rows [row0, row0 + rows) x keys [col0, col0 + C) of the bias into a
// [rows][LDB] f32 tile through its strides; zero past Sq / Sk
template <int C, int LDB, int NT>
__device__ __forceinline__ void async_bias(float* dst, const Bias& b,
                                           int rows, int row0, int Sq,
                                           int col0, int Sk) {
  for (int i = threadIdx.x; i < rows * C; i += NT) {
    const int r = i / C, c = i % C, row = row0 + r, col = col0 + c;
    const bool ok = row < Sq && col < Sk;
    cp_async4(dst + r * LDB + c,
              b.p + (ok ? (int64_t)row * b.sq + (int64_t)col * b.sk : 0), ok);
  }
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a tile wholly inside [Sq, Sk] and below the causal diagonal needs no
// masks: its epilogue is instantiated without them
using Masked = std::true_type;
using Interior = std::false_type;

// ------------------------------------------ bf16: tensor cores (mma.sync)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b on one 16 x 8 block: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment conventions (lane = 4 gi + t): an accumulator block x[j][0..3]
// holds rows gi, gi + 8 and columns 8 j + 2 t, + 1 of a 16 x 8 NJ tile.

// acc (16 x 8 NJ) += A B^T: A the warp's fragments (16 rows x 16 KD), B
// rows [0, 8 NJ) of a row-major [.][LD] shared tile (non-transposed
// ldmatrix gives the mma's column operand)
template <int NJ, int KD, int LD>
__device__ __forceinline__ void mma_rbt(float (&acc)[NJ][4],
                                        const uint32_t (&a)[KD][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t f[4];
      ldsm4(f, b + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * LD +
                   16 * kk + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * jj], a[kk], f[0], f[1]);
      mma16816(acc[2 * jj + 1], a[kk], f[2], f[3]);
    }
}

// the A fragments of rows [0, 16) x [0, 16 KD) of a row-major [.][LD] tile
template <int KD, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const bf16* p,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm4(a[kk], p + (lane & 15) * LD + 16 * kk + (lane >> 4) * 8);
}

// out (16 x D) += X B: X the bf16 rounding of the accumulator blocks
// x (16 x 8 NJ) as A fragments, B rows [0, 8 NJ) x [0, D) of a row-major
// [.][LD] shared tile (ldmatrix.trans)
template <int NJ, int D, int LD>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4],
                                       const float (&x)[NJ][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const uint32_t a[4] = {pack2(x[2 * kk][0], x[2 * kk][1]),
                           pack2(x[2 * kk][2], x[2 * kk][3]),
                           pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t f[4];
      ldsm4t(f, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    16 * nd + (lane >> 4) * 8);
      mma16816(out[2 * nd], a, f[0], f[1]);
      mma16816(out[2 * nd + 1], a, f[2], f[3]);
    }
  }
}

// rows r0 (+8) of a 16 x D accumulator into a row-major [S][D] bf16
// matrix, rows past S dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&x)[D / 8][4],
                                           int row0, int row1, int S, int t) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)row0 * D + c) =
          pack2(x[nd][0], x[nd][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)row1 * D + c) =
          pack2(x[nd][2], x[nd][3]);
  }
}

// ------------------------------------------- f32: exact f32 FMAs, cp.async
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// the score micro-tile of thread tid: rows rg + 16 i, keys cg + SC/NC j
template <int SC, int NC>
__device__ __forceinline__ void score_map(int tid, int& rg, int& cg) {
  rg = tid / (SC / NC);
  cg = tid % (SC / NC);
}

// acc[i][j] = sum_d a[rg + SR/4 i][d] * b[cg + SC/NC j][d] over two
// [.][LD] tiles
template <int D, int LD, int SR, int SC, int NC>
__device__ __forceinline__ void tile_dot(float (&acc)[4][NC], const float* a,
                                         const float* b, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = load4(a + (rg + SR / 4 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 bv = load4(b + (cg + SC / NC * j) * LD + d);
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

// output column c of column group dg (< DG): 4-column chunks, DG groups
// apart
template <int DG>
__device__ __forceinline__ int out_col(int dg, int c) {
  return 4 * dg + (c & 3) + (c >> 2) * 4 * DG;
}

// acc[i][c] += x[r][4 og + i] * y[r][out_col(dg, c)] over rows [0, R) of
// a [.][LDX] and a [.][LDY] tile
template <int DG, int OC, int R, int LDX, int LDY>
__device__ __forceinline__ void out_product(float (&acc)[4][OC],
                                            const float* x, const float* y,
                                            int og, int dg) {
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    const float4 xv = load4(x + r * LDX + 4 * og);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    float yr[OC];
#pragma unroll
    for (int c = 0; c < OC; c += 4) {
      const float4 y4 = load4(y + r * LDY + out_col<DG>(dg, c));
      yr[c] = y4.x, yr[c + 1] = y4.y, yr[c + 2] = y4.z, yr[c + 3] = y4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(xr[i], yr[c], acc[i][c]);
  }
}

// rows row0 + i (i < 4) of acc into a row-major [S][D] matrix
template <int D, int DG, int OC>
__device__ __forceinline__ void store_out(float* dst,
                                          const float (&acc)[4][OC], int row0,
                                          int S, int dg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; c += 4)
      store4(dst + (int64_t)(row0 + i) * D + out_col<DG>(dg, c), acc[i] + c);
  }
}

}  // namespace
