// Fused residual add + layer norm for Hopper (sm_90a): forward (K4) and
// backward (K5), f32 and bf16 inputs, f32 statistics.
//
// Replaces paddle_tpu/kernels/layernorm.py `_fwd_kernel` (driven by
// `_forward_pallas`) and `_bwd_kernel` (driven by `_backward_pallas`,
// differentiated through `_ln_res_bwd`). Rows are [N, D]:
//
//   forward   s    = x + r                       (f32, stored in x's type)
//             mean = sum(s) / D,  var = sum((s - mean)^2) / D   (two-pass)
//             y    = (s - mean) * rsqrt(var + eps) * scale + bias
//   backward  xhat = (s - mean) * rstd,  gyh = gy * scale
//             dx   = rstd * (gyh - mean(gyh) - xhat * mean(gyh * xhat))
//                    + gres
//             dscale = sum over rows of gy * xhat,  dbias = sum of gy
//
// What bounds it on an H100: bytes. At [4096, 768] f32 the forward reads
// x and r and writes y and s (4 x 12.58 MB) plus 32 KB of statistics,
// 50.36 MB, 0.0150 ms at 3.35 TB/s; the backward reads s, gy and gres
// and writes dx, about 50.4 MB. A few FLOPs per byte, far below the
// card's balance point, so the design aims at moving each byte once.
//
// Forward (K4): one warp per row, the row in registers (VPT = ceil(D /
// 32) values per lane, lane l holding columns l, l + 32, ...: every load
// and store of a warp is one coalesced 128-byte run at f32); the mean
// and the variance are two warp-shuffle reductions over the registers
// (the TPU kernel's two-pass variance), so s is read from device memory
// once. Rows wider than kMaxD (2048) take the wide forward: one CTA per
// row, each thread striding over the columns, the sums reduced across
// the CTA in warp order, x + r recomputed in f32 on each of its three
// passes (so the statistics are those of the f32 sum at bf16 too).
//
// Backward (K5): the TPU kernel adds dscale / dbias into one revisited
// [1, D] block along its sequential grid; Hopper has no such grid, so
// each CTA sums its own rows' contributions and writes one partial row,
// and a second kernel adds the partial rows per column in a fixed order,
// in double. No atomics, so a backward is bitwise repeatable. The first
// kernel:
//
//   - a persistent grid of CTAs of 8 warps: as many per SM as the card
//     keeps resident (at least 2 under __launch_bounds__' cap of 128
//     registers, at most 4); each CTA takes one contiguous block of
//     rows, a function of N and the grid alone;
//   - a row group holds a row in registers: one warp for D <= 1024, the
//     whole CTA for D <= 8192. Each thread holds NV groups of 4
//     contiguous columns (a float4 at f32, 8 bytes at bf16), so a warp's
//     loads and stores are 16- (8-) byte vectors over contiguous
//     columns. Only the raw s and gy stay in registers; xhat and gy *
//     scale are recomputed where they are needed, and scale sits in
//     shared memory. Rows whose width or pointers do not allow vectors
//     (D not a multiple of 4, a misaligned row) take scalar loads and
//     stores of the same columns, in the same kernel;
//   - each row group adds its rows' gy * xhat and gy into its own
//     [2, D] accumulators in shared memory (its own columns, no races);
//     at the end the CTA adds its groups' accumulators in group order
//     into its partial row;
//   - rows wider than 8192 take a streaming kernel that reads each row
//     twice and keeps the accumulators in the partial row.
//
// C interface, loaded with ctypes (kernels/build.py): every pointer and
// the stream are void*; each launch returns a cudaError_t as int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxD = 2048;       // the widest row a warp holds (forward)
constexpr int kWideThreads = 256;  // threads of a wide kernel's CTA
// backward
constexpr int kBwdThreads = 256;  // 8 warps per CTA
constexpr int kBwdWarps = kBwdThreads / kWarp;
constexpr int kBwdMinCtasPerSm = 2;  // the register cap: 128 a thread
constexpr int kBwdMaxCtasPerSm = 4;  // the grid's CTAs per SM, at most
constexpr int kBwdStreamCtasPerSm = 2;  // the streaming kernel's
constexpr int kBwdWarpMaxD = 1024;   // the widest row a warp holds (NV 8)
constexpr int kBwdCtaMaxD = 8192;    // the widest row a CTA holds (NV 8)
constexpr int kReduceWarps = 32;     // warps of the column reduction

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// butterfly sum: every lane ends with the same value, in the same order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four columns c .. c + 3 of a row (c < D): one vector load when `vec`
// (D % 4 == 0 and the row 4-element aligned), else scalar loads with 0
// past D
__device__ __forceinline__ void load4(const float* p, int c, int D,
                                      bool vec, float (&o)[4]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = c + k < D ? p[c + k] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int c, int D,
                                      bool vec, float (&o)[4]) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + c);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = lo.x;
    o[1] = lo.y;
    o[2] = hi.x;
    o[3] = hi.y;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = c + k < D ? __bfloat162float(p[c + k]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int c, int D, bool vec,
                                       const float (&o)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + c) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < D) p[c + k] = o[k];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int c, int D,
                                       bool vec, const float (&o)[4]) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p + c) = u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < D) p[c + k] = __float2bfloat16(o[k]);
  }
}

// this CTA's rows: [r0, r1), contiguous, a function of N and the grid
__device__ __forceinline__ void cta_rows(int N, int64_t* r0, int64_t* r1) {
  *r0 = (int64_t)N * blockIdx.x / gridDim.x;
  *r1 = (int64_t)N * (blockIdx.x + 1) / gridDim.x;
}

template <typename T, int VPT>
__global__ void ln_res_fwd_kernel(const T* __restrict__ x,
                                  const T* __restrict__ r,
                                  const T* __restrict__ scale,
                                  const T* __restrict__ bias,
                                  T* __restrict__ y, T* __restrict__ s_out,
                                  float* __restrict__ mean_out,
                                  float* __restrict__ var_out, int N, int D,
                                  float eps) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (row >= N) return;
  const int64_t off = row * D;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + kWarp * j;
    float t = 0.f;
    if (c < D) {
      t = to_f32(x[off + c]) + to_f32(r[off + c]);
      store(s_out + off + c, t);
    }
    v[j] = t;
    sum += t;
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (lane + kWarp * j < D) {
      const float d = v[j] - mean;
      sq += d * d;
    }
  }
  const float var = warp_sum(sq) / D;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + kWarp * j;
    if (c < D)
      store(y + off + c,
            (v[j] - mean) * rstd * to_f32(scale[c]) + to_f32(bias[c]));
  }
  if (lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

// the sum of every thread's v, in warp order: the same total on every
// thread. `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warps = blockDim.x / kWarp;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with `red`
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < warps; ++k) t += red[k];
  return t;
}

// the forward for rows wider than kMaxD: one CTA per row
template <typename T>
__global__ void ln_res_fwd_wide_kernel(const T* __restrict__ x,
                                       const T* __restrict__ r,
                                       const T* __restrict__ scale,
                                       const T* __restrict__ bias,
                                       T* __restrict__ y,
                                       T* __restrict__ s_out,
                                       float* __restrict__ mean_out,
                                       float* __restrict__ var_out, int D,
                                       float eps) {
  __shared__ float red[kWideThreads / kWarp];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  const T* rr = r + row * D;
  float sum = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float t = to_f32(xr[c]) + to_f32(rr[c]);
    store(s_out + row * D + c, t);
    sum += t;
  }
  const float mean = block_sum(sum, red) / D;
  float sq = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float d = to_f32(xr[c]) + to_f32(rr[c]) - mean;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / D;
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float d = to_f32(xr[c]) + to_f32(rr[c]) - mean;
    store(y + row * D + c, d * rstd * to_f32(scale[c]) + to_f32(bias[c]));
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}


// dx per row; this CTA's rows' dscale / dbias sums into one partial row.
// A row group of W warps holds a row: thread t of the group owns the
// columns 4 (t + 32 W j) .. + 3, j < NV. Shared memory (floats): scale
// padded to kDp columns, then each group's [2, kDp] accumulators, then
// 2 x 8 floats for the CTA-wide sums (W = 8).
template <typename T, int NV, int W>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtasPerSm)
    ln_res_bwd_kernel(const T* __restrict__ s, const float* __restrict__ mean,
                      const float* __restrict__ var,
                      const T* __restrict__ scale, const T* __restrict__ gy,
                      const T* __restrict__ gres, T* __restrict__ dx,
                      float* __restrict__ part_scale,
                      float* __restrict__ part_bias, int N, int D, float eps,
                      bool vec) {
  constexpr int kTpg = kWarp * W;                 // threads per row group
  constexpr int kGroups = kBwdThreads / kTpg;     // row groups per CTA
  constexpr int kDp = 4 * kTpg * NV;              // padded row width
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);
  float* acc = sc + kDp;
  float* red = acc + 2 * kGroups * kDp;
  const int grp = threadIdx.x / kTpg;
  const int tg = threadIdx.x % kTpg;
  for (int c = threadIdx.x; c < kDp; c += kBwdThreads)
    sc[c] = c < D ? to_f32(scale[c]) : 0.f;
  for (int i = threadIdx.x; i < 2 * kGroups * kDp; i += kBwdThreads)
    acc[i] = 0.f;
  __syncthreads();
  float* as = acc + 2 * grp * kDp;  // this group's dscale sums
  float* ab = as + kDp;             // and dbias sums
  int64_t r0, r1;
  cta_rows(N, &r0, &r1);
  for (int64_t row = r0 + grp; row < r1; row += kGroups) {
    const T* sr = s + row * D;
    const T* gr = gy + row * D;
    const float mu = mean[row];
    const float rstd = rsqrtf(var[row] + eps);
    float sv[NV][4], gv[NV][4];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = 4 * (tg + kTpg * j);
      if (c < D) {
        load4(sr, c, D, vec, sv[j]);
        load4(gr, c, D, vec, gv[j]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[j][k] = gv[j][k] = 0.f;
      }
    }
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = 4 * (tg + kTpg * j);
      const float4 s4 = *reinterpret_cast<const float4*>(sc + c);
      float4 ps = *reinterpret_cast<float4*>(as + c);
      float4 pb = *reinterpret_cast<float4*>(ab + c);
      const float scv[4] = {s4.x, s4.y, s4.z, s4.w};
      float psv[4] = {ps.x, ps.y, ps.z, ps.w};
      float pbv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float g = gv[j][k];
        const float xh = (sv[j][k] - mu) * rstd;
        const float gh = g * scv[k];
        a += gh;
        b += gh * xh;
        psv[k] += g * xh;
        pbv[k] += g;
      }
      *reinterpret_cast<float4*>(as + c) =
          make_float4(psv[0], psv[1], psv[2], psv[3]);
      *reinterpret_cast<float4*>(ab + c) =
          make_float4(pbv[0], pbv[1], pbv[2], pbv[3]);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if constexpr (W > 1) {  // the whole CTA holds the row
      const int w = threadIdx.x / kWarp;
      if (threadIdx.x % kWarp == 0) {
        red[w] = a;
        red[kBwdWarps + w] = b;
      }
      __syncthreads();
      a = b = 0.f;
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k) {
        a += red[k];
        b += red[kBwdWarps + k];
      }
      __syncthreads();  // every thread has read `red` before the next row
    }
    const float mg = a / D;
    const float mgx = b / D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = 4 * (tg + kTpg * j);
      if (c < D) {
        float rv[4], o[4];
        load4(gres + row * D, c, D, vec, rv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xh = (sv[j][k] - mu) * rstd;
          const float gh = gv[j][k] * sc[c + k];
          o[k] = rstd * (gh - mg - xh * mgx) + rv[k];
        }
        store4(dx + row * D, c, D, vec, o);
      }
    }
  }
  __syncthreads();
  // the groups' sums, added in group order
  for (int c = threadIdx.x; c < D; c += kBwdThreads) {
    float ts = 0.f, tb = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      ts += acc[2 * g * kDp + c];
      tb += acc[(2 * g + 1) * kDp + c];
    }
    part_scale[(int64_t)blockIdx.x * D + c] = ts;
    part_bias[(int64_t)blockIdx.x * D + c] = tb;
  }
}

// the backward for rows wider than kBwdCtaMaxD: the CTA takes its rows
// one at a time and reads each twice; thread t owns columns t, t +
// blockDim.x, ... of the CTA's partial row (its first row writes them,
// the others add to them), so no two threads touch one element
template <typename T>
__global__ void ln_res_bwd_stream_kernel(const T* __restrict__ s,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         const T* __restrict__ scale,
                                         const T* __restrict__ gy,
                                         const T* __restrict__ gres,
                                         T* __restrict__ dx,
                                         float* __restrict__ part_scale,
                                         float* __restrict__ part_bias, int N,
                                         int D, float eps) {
  __shared__ float red[kBwdWarps];
  float* ps = part_scale + (int64_t)blockIdx.x * D;
  float* pb = part_bias + (int64_t)blockIdx.x * D;
  int64_t r0, r1;
  cta_rows(N, &r0, &r1);
  for (int64_t row = r0; row < r1; ++row) {
    const int64_t off = row * D;
    const float mu = mean[row];
    const float rstd = rsqrtf(var[row] + eps);
    float a = 0.f, b = 0.f;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float g = to_f32(gy[off + c]);
      const float xh = (to_f32(s[off + c]) - mu) * rstd;
      const float gh = g * to_f32(scale[c]);
      a += gh;
      b += gh * xh;
      ps[c] = row == r0 ? g * xh : ps[c] + g * xh;
      pb[c] = row == r0 ? g : pb[c] + g;
    }
    const float mg = block_sum(a, red) / D;
    const float mgx = block_sum(b, red) / D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float xh = (to_f32(s[off + c]) - mu) * rstd;
      const float gh = to_f32(gy[off + c]) * to_f32(scale[c]);
      store(dx + off + c,
            rstd * (gh - mg - xh * mgx) + to_f32(gres[off + c]));
    }
  }
}

// dscale / dbias: the partial rows added per column in a fixed order, in
// double (a chain of 256 f32 adds of sums near 64 drifts by 1e-4 at
// N = 4096, twice the kernel's tolerance). Each CTA takes 32 columns;
// warp y adds the partial rows y, y + 32, y + 64, ... into two
// accumulators (rows y + 64 i and y + 32 + 64 i), so two loads are in
// flight; then warp 0 adds the 32 warps' sums in warp order.
__global__ void __launch_bounds__(kWarp * kReduceWarps)
    ln_res_bwd_reduce_kernel(const float* __restrict__ part_scale,
                             const float* __restrict__ part_bias, int ctas,
                             int D, float* __restrict__ dscale,
                             float* __restrict__ dbias) {
  __shared__ double acc[2][kReduceWarps][kWarp];
  const int c = blockIdx.x * kWarp + threadIdx.x;
  double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0;
  if (c < D) {
    int k = threadIdx.y;
    for (; k + kReduceWarps < ctas; k += 2 * kReduceWarps) {
      a0 += part_scale[(int64_t)k * D + c];
      b0 += part_bias[(int64_t)k * D + c];
      a1 += part_scale[(int64_t)(k + kReduceWarps) * D + c];
      b1 += part_bias[(int64_t)(k + kReduceWarps) * D + c];
    }
    if (k < ctas) {
      a0 += part_scale[(int64_t)k * D + c];
      b0 += part_bias[(int64_t)k * D + c];
    }
  }
  acc[0][threadIdx.y][threadIdx.x] = a0 + a1;
  acc[1][threadIdx.y][threadIdx.x] = b0 + b1;
  __syncthreads();
  if (threadIdx.y == 0 && c < D) {
    double sa = 0.0, sb = 0.0;
    for (int j = 0; j < kReduceWarps; ++j) {
      sa += acc[0][j][threadIdx.x];
      sb += acc[1][j][threadIdx.x];
    }
    dscale[c] = (float)sa;
    dbias[c] = (float)sb;
  }
}

// values per lane for a row of D columns; 0 outside 1..kMaxD, where
// D > kMaxD takes the wide kernels (the wrappers check D >= 1)
int vpt_for(int D) {
  if (D < 1 || D > kMaxD) return 0;
  const int need = (D + kWarp - 1) / kWarp;
  const int sizes[] = {4, 8, 16, 24, 32, 48, 64};
  for (int v : sizes)
    if (need <= v) return v;
  return 0;
}

template <typename T, int VPT>
int launch_fwd(const void* x, const void* r, const void* scale,
               const void* bias, void* y, void* s, float* mean, float* var,
               int N, int D, float eps, int rows_per_cta,
               cudaStream_t stream) {
  const int grid = (N + rows_per_cta - 1) / rows_per_cta;
  ln_res_fwd_kernel<T, VPT><<<grid, rows_per_cta * kWarp, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), static_cast<T*>(s), mean, var, N, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_wide(const void* x, const void* r, const void* scale,
                    const void* bias, void* y, void* s, float* mean,
                    float* var, int N, int D, float eps,
                    cudaStream_t stream) {
  ln_res_fwd_wide_kernel<T><<<N, kWideThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(y), static_cast<T*>(s), mean, var, D, eps);
  return (int)cudaGetLastError();
}

int launch_reduce(const float* part_scale, const float* part_bias, int ctas,
                  int D, float* dscale, float* dbias, cudaStream_t stream) {
  ln_res_bwd_reduce_kernel<<<(D + kWarp - 1) / kWarp,
                             dim3(kWarp, kReduceWarps), 0, stream>>>(
      part_scale, part_bias, ctas, D, dscale, dbias);
  return (int)cudaGetLastError();
}

template <typename T>
bool rows_vectorizable(int D, const void* s, const void* gy,
                       const void* gres, const void* dx) {
  const uintptr_t align = 4 * sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(s) |
                        reinterpret_cast<uintptr_t>(gy) |
                        reinterpret_cast<uintptr_t>(gres) |
                        reinterpret_cast<uintptr_t>(dx);
  return D % 4 == 0 && any % align == 0;
}

// the row kernel's dynamic shared memory: scale and each row group's
// [2, kDp] sums, plus 2 x 8 floats for the CTA-wide sums
template <int NV, int W>
constexpr int bwd_smem() {
  return (4 * kWarp * W * NV * (1 + 2 * (kBwdThreads / (kWarp * W))) +
          2 * kBwdWarps) *
         (int)sizeof(float);
}

// resident CTAs per SM of one row kernel (asked once), at most
// kBwdMaxCtasPerSm
template <typename T, int NV, int W>
int bwd_per_sm() {
  static const int n = [] {
    auto kernel = ln_res_bwd_kernel<T, NV, W>;
    int k = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bwd_smem<NV, W>()) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &k, kernel, kBwdThreads, bwd_smem<NV, W>()) != cudaSuccess ||
        k < 1)
      return 1;
    return k < kBwdMaxCtasPerSm ? k : kBwdMaxCtasPerSm;
  }();
  return n;
}

// the backward's row kernel for rows of up to 4 * 32 * W * NV columns,
// then the column reduction; ctas in [1, N]
template <typename T, int NV, int W>
int launch_bwd(const void* s, const float* mean, const float* var,
               const void* scale, const void* gy, const void* gres, void* dx,
               float* part_scale, float* part_bias, float* dscale,
               float* dbias, int N, int D, float eps, int ctas,
               cudaStream_t stream) {
  constexpr int kSmem = bwd_smem<NV, W>();
  auto kernel = ln_res_bwd_kernel<T, NV, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, kBwdThreads, kSmem, stream>>>(
      static_cast<const T*>(s), mean, var, static_cast<const T*>(scale),
      static_cast<const T*>(gy), static_cast<const T*>(gres),
      static_cast<T*>(dx), part_scale, part_bias, N, D, eps,
      rows_vectorizable<T>(D, s, gy, gres, dx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part_scale, part_bias, ctas, D, dscale, dbias, stream);
}

template <typename T>
int launch_bwd_stream(const void* s, const float* mean, const float* var,
                      const void* scale, const void* gy, const void* gres,
                      void* dx, float* part_scale, float* part_bias,
                      float* dscale, float* dbias, int N, int D, float eps,
                      int ctas, cudaStream_t stream) {
  ln_res_bwd_stream_kernel<T><<<ctas, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(s), mean, var, static_cast<const T*>(scale),
      static_cast<const T*>(gy), static_cast<const T*>(gres),
      static_cast<T*>(dx), part_scale, part_bias, N, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part_scale, part_bias, ctas, D, dscale, dbias, stream);
}

// the row kernels by width: X(widest D, NV, W). A warp per row (W = 1)
// up to kBwdWarpMaxD, a CTA per row (W = 8) up to kBwdCtaMaxD, NV groups
// of 4 columns per thread; wider rows take the streaming kernel
#define LN_BWD_CONFIGS(X) \
  X(128, 1, 1)            \
  X(256, 2, 1)            \
  X(512, 4, 1)            \
  X(768, 6, 1)            \
  X(kBwdWarpMaxD, 8, 1)   \
  X(2048, 2, 8)           \
  X(4096, 4, 8)           \
  X(6144, 6, 8)           \
  X(kBwdCtaMaxD, 8, 8)

template <typename T>
int dispatch_bwd(const void* s, const float* m, const float* v,
                 const void* scale, const void* gy, const void* gres,
                 void* dx, float* ps, float* pb, float* ds, float* db, int N,
                 int D, float eps, int ctas, cudaStream_t st) {
#define BWD(MAXD, NV, W)                                                    \
  if (D <= MAXD)                                                            \
    return launch_bwd<T, NV, W>(s, m, v, scale, gy, gres, dx, ps, pb, ds, db, \
                                N, D, eps, ctas, st);
  LN_BWD_CONFIGS(BWD)
#undef BWD
  return launch_bwd_stream<T>(s, m, v, scale, gy, gres, dx, ps, pb, ds, db,
                              N, D, eps, ctas, st);
}

// the row kernel's grid and dynamic shared memory for [N, D] rows on a
// card of `sms` SMs: as many CTAs per SM as stay resident, never more
// CTAs than row groups (8 rows a CTA pass for a warp per row, 1 for a
// CTA per row)
template <typename T>
int bwd_grid(int N, int D, int sms, int* smem) {
#define GRID(MAXD, NV, W)                                             \
  if (D <= MAXD) {                                                    \
    constexpr int kGroups = kBwdThreads / (kWarp * W);                \
    const int cap = sms * bwd_per_sm<T, NV, W>();                     \
    const int want = (N + kGroups - 1) / kGroups;                     \
    *smem = bwd_smem<NV, W>();                                        \
    return want < cap ? want : cap;                                   \
  }
  LN_BWD_CONFIGS(GRID)
#undef GRID
  *smem = 0;
  const int cap = sms * kBwdStreamCtasPerSm;
  return N < cap ? N : cap;
}

#define LN_DISPATCH(VPT_, CALL)            \
  switch (VPT_) {                          \
    case 4: return CALL(4);                \
    case 8: return CALL(8);                \
    case 16: return CALL(16);              \
    case 24: return CALL(24);              \
    case 32: return CALL(32);              \
    case 48: return CALL(48);              \
    case 64: return CALL(64);              \
    default: return (int)cudaErrorInvalidValue; \
  }


}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, r, scale, bias, y and s share it);
// mean and var are float32 [N]. One warp per row, rows_per_cta warps per
// CTA; for D > 2048 one CTA of 256 threads per row. Returns a cudaError_t.
int layernorm_residual_fwd(const void* x, const void* r, const void* scale,
                           const void* bias, void* y, void* s, void* mean,
                           void* var, int N, int D, int dtype, float eps,
                           int rows_per_cta, void* stream) {
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (D > kMaxD) {
    if (dtype == 0)
      return launch_fwd_wide<float>(x, r, scale, bias, y, s, m, v, N, D, eps,
                                    st);
    if (dtype == 1)
      return launch_fwd_wide<__nv_bfloat16>(x, r, scale, bias, y, s, m, v, N,
                                            D, eps, st);
    return (int)cudaErrorInvalidValue;
  }
  const int vpt = vpt_for(D);
#define FWD_F32(V) launch_fwd<float, V>(x, r, scale, bias, y, s, m, v, N, D, eps, rows_per_cta, st)
#define FWD_BF16(V) launch_fwd<__nv_bfloat16, V>(x, r, scale, bias, y, s, m, v, N, D, eps, rows_per_cta, st)
  if (dtype == 0) LN_DISPATCH(vpt, FWD_F32)
  if (dtype == 1) LN_DISPATCH(vpt, FWD_BF16)
#undef FWD_F32
#undef FWD_BF16
  return (int)cudaErrorInvalidValue;
}


// the backward's launch for [N, D] rows of dtype (0 = float32, 1 =
// bfloat16) on a card of `sms` SMs: returns the row kernel's CTAs (0 for
// an unknown dtype) and writes its threads per CTA and dynamic shared
// memory bytes
int layernorm_residual_bwd_grid(int N, int D, int dtype, int sms,
                                int* threads, int* smem) {
  *threads = kBwdThreads;
  if (N < 1 || D < 1 || sms < 1) return 0;
  if (dtype == 0) return bwd_grid<float>(N, D, sms, smem);
  if (dtype == 1) return bwd_grid<__nv_bfloat16>(N, D, sms, smem);
  return 0;
}

// s, scale, gy, gres and dx share dtype (0 = float32, 1 = bfloat16);
// mean, var, the partial rows [ctas, D] and dscale, dbias [D] are
// float32. ctas is the row kernel's grid, in [1, N]:
// layernorm_residual_bwd_grid's. Returns a cudaError_t.
int layernorm_residual_bwd(const void* s, const void* mean, const void* var,
                           const void* scale, const void* gy,
                           const void* gres, void* dx, void* part_scale,
                           void* part_bias, void* dscale, void* dbias, int N,
                           int D, int dtype, float eps, int ctas,
                           void* stream) {
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  float* ps = static_cast<float*>(part_scale);
  float* pb = static_cast<float*>(part_bias);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || D < 1 || ctas < 1 || ctas > N)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_bwd<float>(s, m, v, scale, gy, gres, dx, ps, pb, ds, db,
                               N, D, eps, ctas, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(s, m, v, scale, gy, gres, dx, ps, pb,
                                       ds, db, N, D, eps, ctas, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
