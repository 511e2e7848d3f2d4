// Grouped optimizer updates for Hopper (sm_90a): Adam (K6) and SGD (K7)
// over every parameter of a fused group in one launch, f32.
//
// Replaces paddle_tpu/kernels/optimizer_update.py `_adam_kernel` and
// `_sgd_kernel` (driven by `_sweep` / `sweep_group`). The TPU version
// concatenates every param, grad and moment into one stream, broadcasts
// the per-param scalars into two more per-element streams and splits
// the outputs back: at BERT-base scale that is several GB of extra
// traffic. Here it is a multi-tensor apply instead:
//
//   - a table in device memory holds, per param, its pointers (inputs,
//     the new tensors to write, its learning rate and beta powers), its
//     element count, the index of its first tile and whether all of its
//     element streams are 16-byte aligned; the wrapper uploads it from
//     pinned memory with a stream-ordered copy (no host sync);
//   - the bias-corrected rate lrt = lr * sqrt(1 - b2pow * beta2) /
//     (1 - b1pow * beta1) and the decay rate lr * wd are computed on the
//     device from the param's own LearningRate / Beta1Pow / Beta2Pow
//     tensors (no .item(), no host sync); the CTA that owns the param's
//     first tile also writes the new beta powers (b1pow * beta1,
//     b2pow * beta2).
//
//   Adam:  m' = beta1 m + (1 - beta1) g        v' = beta2 v + (1 - beta2) g g
//          p' = p - lrt m' / (sqrt(v') + eps)  [- lr wd p, decoupled decay]
//   SGD:   p' = p - lr g
//
// in the order of the op lowerings (ops/optimizer_ops.py).
//
// What bounds it on an H100: bytes. Adam reads p, g, m, v and writes p',
// m', v': 7 x 4 bytes per element, 3.72 GB for BERT-base's 132,919,866
// parameters, 1.111 ms at 3.35 TB/s; SGD moves 3 x 4 bytes per element,
// 0.476 ms. The design keeps enough bytes in flight to stream at that
// rate:
//
//   - a param is cut into tiles of kTile elements; a persistent grid (as
//     many CTAs per SM as are resident at once, at least 2 under the
//     register cap, so nothing spills) gives each CTA one contiguous run of tiles, so a
//     CTA finds its first param once (a binary search over the table)
//     and then walks forward through the table, reading a row only when
//     its run crosses into the next param;
//   - a tile is one pass of the CTA: each thread issues kIlp 16-byte
//     loads of every input stream before any arithmetic, then stores
//     kIlp 16-byte vectors of every output stream; 32-bit offsets
//     inside a tile. Plain loads and stores: on an H100, evict-first
//     cache hints (__ldcs / __stcs) measured slower, and 1 or 4 vectors
//     per thread, or 3 or 4 CTAs per SM, no faster;
//   - an entry whose streams are not all 16-byte aligned (a view at an
//     odd offset), and the last 1-3 elements of a size not divisible by
//     4, take a scalar loop inside the same launch.
//
// The wrapper pads each param's offset in the flat output buffers to 32
// elements (128 bytes), so from the second step on, when the outputs
// are the next step's Param / Moment1 / Moment2, every entry of a group
// takes the vector path.
//
// C interface, loaded with ctypes (kernels/build.py); each launch
// returns a cudaError_t as int.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kIlp = 2;        // 16-byte vectors per thread per stream
constexpr int kTile = kThreads * kIlp * 4;  // elements per tile: 2048
constexpr int kMinCtasPerSm = 2;  // the register cap: 128 a thread

// one row of the wrapper's int64 table (kernels/optimizer_update.py
// ADAM_FIELDS / SGD_FIELDS name the columns in this order)
struct AdamEntry {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  const float* lr;
  const float* b1p;
  const float* b2p;
  float* po;
  float* mo;
  float* vo;
  float* b1po;
  float* b2po;
  int64_t n;
  int64_t first_tile;
  int64_t vec;  // 1: p, g, m, v, po, mo, vo all 16-byte aligned
};

struct SgdEntry {
  const float* p;
  const float* g;
  const float* lr;
  float* po;
  int64_t n;
  int64_t first_tile;
  int64_t vec;  // 1: p, g, po all 16-byte aligned
};

static_assert(sizeof(AdamEntry) == 15 * 8, "table row of 15 int64");
static_assert(sizeof(SgdEntry) == 7 * 8, "table row of 7 int64");

// the last entry whose first tile is at or before tile t
template <typename E>
__device__ __forceinline__ int find_entry(const E* table, int count,
                                          int64_t t) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].first_tile <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// first tile past entry i (the total for the last entry)
template <typename E>
__device__ __forceinline__ int64_t entry_end(const E* table, int count,
                                             int i, int64_t tiles) {
  return i + 1 < count ? table[i + 1].first_tile : tiles;
}

struct AdamConsts {
  float beta1, beta2, omb1, omb2, eps, wd, lrt, lrwd;
};

__device__ __forceinline__ float adam_elem(float p, float g, float m,
                                           float v, const AdamConsts& c,
                                           float* mo, float* vo) {
  const float mn = c.beta1 * m + c.omb1 * g;
  const float vn = c.beta2 * v + c.omb2 * g * g;
  float pn = p - c.lrt * mn / (sqrtf(vn) + c.eps);
  if (c.wd != 0.f) pn = pn - c.lrwd * p;
  *mo = mn;
  *vo = vn;
  return pn;
}

__device__ __forceinline__ float4 adam_vec(const float4 p, const float4 g,
                                           const float4 m, const float4 v,
                                           const AdamConsts& c, float4* mo,
                                           float4* vo) {
  float4 po;
  po.x = adam_elem(p.x, g.x, m.x, v.x, c, &mo->x, &vo->x);
  po.y = adam_elem(p.y, g.y, m.y, v.y, c, &mo->y, &vo->y);
  po.z = adam_elem(p.z, g.z, m.z, v.z, c, &mo->z, &vo->z);
  po.w = adam_elem(p.w, g.w, m.w, v.w, c, &mo->w, &vo->w);
  return po;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// this CTA's run of tiles: [t0, t1), contiguous, a function of the tile
// count and the grid alone
__device__ __forceinline__ void cta_run(int64_t tiles, int64_t* t0,
                                        int64_t* t1) {
  *t0 = tiles * blockIdx.x / gridDim.x;
  *t1 = tiles * (blockIdx.x + 1) / gridDim.x;
}

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    adam_group_kernel(const AdamEntry* __restrict__ table, int count,
                      int64_t tiles, float beta1, float beta2,
                      float one_minus_beta1, float one_minus_beta2,
                      float eps, float weight_decay) {
  int64_t t, t1;
  cta_run(tiles, &t, &t1);
  if (t >= t1) return;
  AdamConsts c;
  c.beta1 = beta1;
  c.beta2 = beta2;
  c.omb1 = one_minus_beta1;
  c.omb2 = one_minus_beta2;
  c.eps = eps;
  c.wd = weight_decay;
  for (int i = find_entry(table, count, t); t < t1; ++i) {
    const AdamEntry e = table[i];
    const int64_t end = imin(entry_end(table, count, i, tiles), t1);
    const float lr = *e.lr;
    const float b1p = *e.b1p;
    const float b2p = *e.b2p;
    c.lrt = lr * sqrtf(1.f - b2p * beta2) / (1.f - b1p * beta1);
    c.lrwd = lr * weight_decay;
    if (t == e.first_tile && threadIdx.x == 0) {
      *e.b1po = b1p * beta1;
      *e.b2po = b2p * beta2;
    }
    for (; t < end; ++t) {
      const int64_t base = (t - e.first_tile) * kTile;
      const int len = (int)imin(kTile, e.n - base);
      const float* p = e.p + base;
      const float* g = e.g + base;
      const float* m = e.m + base;
      const float* v = e.v + base;
      float* po = e.po + base;
      float* mo = e.mo + base;
      float* vo = e.vo + base;
      int done = 0;
      if (e.vec) {
        const int nv = len >> 2;
        float4 P[kIlp], G[kIlp], M[kIlp], V[kIlp];
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          const int j = threadIdx.x + k * kThreads;
          if (j < nv) {
            P[k] = reinterpret_cast<const float4*>(p)[j];
            G[k] = reinterpret_cast<const float4*>(g)[j];
            M[k] = reinterpret_cast<const float4*>(m)[j];
            V[k] = reinterpret_cast<const float4*>(v)[j];
          }
        }
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          const int j = threadIdx.x + k * kThreads;
          if (j < nv) {
            float4 mn, vn;
            const float4 pn = adam_vec(P[k], G[k], M[k], V[k], c, &mn, &vn);
            reinterpret_cast<float4*>(po)[j] = pn;
            reinterpret_cast<float4*>(mo)[j] = mn;
            reinterpret_cast<float4*>(vo)[j] = vn;
          }
        }
        done = nv << 2;
      }
      for (int j = done + threadIdx.x; j < len; j += kThreads)
        po[j] = adam_elem(p[j], g[j], m[j], v[j], c, &mo[j], &vo[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    sgd_group_kernel(const SgdEntry* __restrict__ table, int count,
                     int64_t tiles) {
  int64_t t, t1;
  cta_run(tiles, &t, &t1);
  if (t >= t1) return;
  for (int i = find_entry(table, count, t); t < t1; ++i) {
    const SgdEntry e = table[i];
    const int64_t end = imin(entry_end(table, count, i, tiles), t1);
    const float lr = *e.lr;
    for (; t < end; ++t) {
      const int64_t base = (t - e.first_tile) * kTile;
      const int len = (int)imin(kTile, e.n - base);
      const float* p = e.p + base;
      const float* g = e.g + base;
      float* po = e.po + base;
      int done = 0;
      if (e.vec) {
        const int nv = len >> 2;
        float4 P[kIlp], G[kIlp];
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          const int j = threadIdx.x + k * kThreads;
          if (j < nv) {
            P[k] = reinterpret_cast<const float4*>(p)[j];
            G[k] = reinterpret_cast<const float4*>(g)[j];
          }
        }
#pragma unroll
        for (int k = 0; k < kIlp; ++k) {
          const int j = threadIdx.x + k * kThreads;
          if (j < nv) {
            float4 r;
            r.x = P[k].x - lr * G[k].x;
            r.y = P[k].y - lr * G[k].y;
            r.z = P[k].z - lr * G[k].z;
            r.w = P[k].w - lr * G[k].w;
            reinterpret_cast<float4*>(po)[j] = r;
          }
        }
        done = nv << 2;
      }
      for (int j = done + threadIdx.x; j < len; j += kThreads)
        po[j] = p[j] - lr * g[j];
    }
  }
}

// the persistent grid: as many CTAs per SM as the card keeps resident
// at once (asked once per kernel), at most one per tile
template <typename K>
int resident_ctas(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    0) != cudaSuccess ||
      n < 1)
    return 1;
  return n;
}

unsigned grid_for(int64_t tiles, int sms, int per_sm) {
  const int64_t cap = (int64_t)sms * per_sm;
  return (unsigned)(tiles < cap ? tiles : cap);
}

int adam_per_sm() {
  static const int n = resident_ctas(adam_group_kernel);
  return n;
}

int sgd_per_sm() {
  static const int n = resident_ctas(sgd_group_kernel);
  return n;
}

}  // namespace

extern "C" {

// the tile size and the threads per CTA the wrapper lays its table out
// and checks its launch with
int optimizer_group_tile() { return kTile; }
int optimizer_group_threads() { return kThreads; }

// the grid of a launch over `tiles` tiles on a card of `sms` SMs; kind
// 0 = Adam, 1 = SGD
int optimizer_group_grid(int kind, int64_t tiles, int sms) {
  return (int)grid_for(tiles, sms, kind == 0 ? adam_per_sm() : sgd_per_sm());
}

// table: `count` AdamEntry rows in device memory; tiles: the total tile
// count (the last row's first_tile plus its tiles); sms: the card's SM
// count. Returns a cudaError_t.
int adam_group(const void* table, int count, int64_t tiles, int sms,
               float beta1, float beta2, float one_minus_beta1,
               float one_minus_beta2, float eps, float weight_decay,
               void* stream) {
  if (count < 1 || tiles < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  adam_group_kernel<<<grid_for(tiles, sms, adam_per_sm()), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamEntry*>(table), count, tiles, beta1, beta2,
      one_minus_beta1, one_minus_beta2, eps, weight_decay);
  return (int)cudaGetLastError();
}

// table: `count` SgdEntry rows in device memory. Returns a cudaError_t.
int sgd_group(const void* table, int count, int64_t tiles, int sms,
              void* stream) {
  if (count < 1 || tiles < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  sgd_group_kernel<<<grid_for(tiles, sms, sgd_per_sm()), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const SgdEntry*>(table), count, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
