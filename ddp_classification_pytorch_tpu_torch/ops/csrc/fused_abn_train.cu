// Training-mode passes of the fused BatchNorm + LeakyReLU (activated ABN)
// for Hopper: the batch statistics that feed K1's forward (fused_abn.cu),
// and K1's exact batch-statistic backward.
//
// They replace the jnp around the JAX package's Pallas kernel in training
// (ops/pallas_kernels.py):
//   K1s  `batch_norm_leaky_relu`, :140-143: per channel mean = Σx / m and
//        var = Σx² / m − mean² in f32, not clamped; beside them inv_std =
//        1 / sqrt(var + eps) as K1 forms it, for the backward;
//   K1r  `_bwd`, :103-109: per channel Σdy and Σdy·x̂, with dy = g·gate(y)
//        (1 where y >= 0, else the slope) and x̂ = (x − mean)·inv_std;
//   K1d  `_bwd`, :113-117: dx = (inv_std / m)·(m·dx̂ − Σdx̂ − x̂·Σ(dx̂·x̂)),
//        dx̂ = dy·scale, where Σdx̂ = scale·Σdy and Σ(dx̂·x̂) = scale·Σ(dy·x̂)
//        come from K1r; f32 math, dx in x's dtype.
// x, g (the gradient of y), y and dx are (M = N*H*W, C) rows of NHWC
// (channels_last) activations, bf16 or f32, all of one layout; the (C,)
// vectors are f32.
//
// What bounds them on this card: each is a pass over the rows with a few
// flops an element, so memory bytes: K1s reads x (2 bytes an element in
// bf16), K1r reads g, y and x (6), K1d reads those and writes dx (8), at
// 3.35 TB/s on an H100 SXM.
//
// What the design does about it:
//  - K1s and K1r are one launch each, on a geometry of their own
//    (ops/fused_abn.py::sums_geometry): blocks of kSumThreads threads, tx
//    channel groups (a channel tile of at most 32 channels) by ty row lanes,
//    and few, long partials: a grid of gx channel tiles by gy row blocks,
//    at most one block an SM, where each lane sums at least kSumMinRows
//    rows when M allows, with kInFlight rows of loads in flight (16 bytes
//    of f32 or 8 of bf16 an access; 256 bytes a thread for K1s, 3 x 192 for
//    K1r), the row offset stepped by one add a row;
//  - each thread keeps f32 sums of its VEC channels over its rows in row
//    order; the block adds its lanes' sums in a fixed order with two
//    barriers (block_sums) and writes one partial of 2 x its channels to a
//    workspace of (gy, 2, C) f32;
//  - the same launch finalizes: one thread of each block bumps its channel
//    tile's integer counter with one acquire-release atomic; the block
//    that sees gy - 1 adds the tile's gy partials in block order, writes
//    the outputs and puts the counter back to 0. The order of every sum is
//    fixed by the geometry, never by which block finishes last, and there
//    are no floating-point atomics, so two launches give the same bits;
//  - the counters (one unsigned int a channel tile) and the workspace come
//    from the caller, who keeps them per card: nothing here allocates. Every
//    launch leaves the counters at 0. Launches that share them must run on
//    one stream, in order;
//  - K1d is an elementwise pass like K1's forward: R rows a thread, all
//    loads of g, y and x issued before the per-channel constants.
// Products that jnp rounds before a sum or difference are kept unfused
// (__fmul_rn), so each term rounds where the JAX package's does.
//
// Plain C interface, linked into K1's library (ops/fused_abn.py builds
// fused_abn.cu and this file together); launches on the caller's stream,
// does not synchronise.

#include "fused_abn.cuh"

namespace {

constexpr int kSumThreads = 256;  // a K1s/K1r block: SUM_THREADS in fused_abn.py
constexpr int kSumMinRows = 16;   // rows a lane sums, at least: SUM_MIN_ROWS
constexpr int kGradInputMaxRows = 4;  // R of K1d (3 row packs a row)

// The two terms K1s sums per channel: x and x².
template <typename T, int VEC>
struct StatsTerm {
  static constexpr int kInFlight = 64 / sizeof(T);  // rows of loads in flight
  const T* __restrict__ x;
  struct Elem {
    Pack<T, VEC> x;
  };
  __device__ __forceinline__ void prepare(int) {}
  __device__ __forceinline__ Elem load(long long o) const {  // o = row*C + c0
    Elem e;
    e.x = *reinterpret_cast<const Pack<T, VEC>*>(x + o);
    return e;
  }
  __device__ __forceinline__ void add(const Elem& e, float (&s1)[VEC],
                                      float (&s2)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f32(e.x.v[i]);
      s1[i] += v;
      s2[i] += __fmul_rn(v, v);
    }
  }
};

// The two terms K1r sums per channel: dy and dy·x̂.
template <typename T, int VEC>
struct GradTerm {
  static constexpr int kInFlight = 48 / sizeof(T);  // rows: 3 loads each
  const T* __restrict__ g;
  const T* __restrict__ y;
  const T* __restrict__ x;
  const float* __restrict__ mean;
  const float* __restrict__ inv;
  float slope;
  float mu[VEC], iv[VEC];
  struct Elem {
    Pack<T, VEC> g, y, x;
  };
  __device__ __forceinline__ void prepare(int c0) {
    load_channels<VEC>(mean, c0, mu);
    load_channels<VEC>(inv, c0, iv);
  }
  __device__ __forceinline__ Elem load(long long o) const {
    Elem e;
    e.g = *reinterpret_cast<const Pack<T, VEC>*>(g + o);
    e.y = *reinterpret_cast<const Pack<T, VEC>*>(y + o);
    e.x = *reinterpret_cast<const Pack<T, VEC>*>(x + o);
    return e;
  }
  __device__ __forceinline__ void add(const Elem& e, float (&s1)[VEC],
                                      float (&s2)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // the leaky-ReLU gate from the output's sign, as _bwd takes it
      const float dy =
          to_f32(e.g.v[i]) * (to_f32(e.y.v[i]) >= 0.0f ? 1.0f : slope);
      const float x_hat = (to_f32(e.x.v[i]) - mu[i]) * iv[i];
      s1[i] += dy;
      s2[i] += __fmul_rn(dy, x_hat);
    }
  }
};

// Adds the block's ty lanes of (s1, s2) for every channel of its tile, in
// an order fixed by the geometry, with two barriers: the lanes' values go
// to shared memory as rows of V = 2 * W (kind 0, s1, then kind 1, s2, of
// the tile's W = tx * VEC channels); H = tx * ty / V runs of threads each
// add a run of ceil(ty / H) consecutive lanes of one value, in lane order;
// then thread v < V adds the H runs of value v in order. Returns that total
// on thread v (t = ty_i * tx + tx_i), 0 elsewhere. Every thread of the block
// calls it; `sh` holds (2 * VEC + 1) * tx * ty floats and is free again
// after the caller's next __syncthreads(). The C side takes only blocks
// with V <= tx * ty (2 * VEC <= ty).
template <int VEC>
__device__ __forceinline__ float block_sums(const float (&s1)[VEC],
                                            const float (&s2)[VEC],
                                            float* __restrict__ sh) {
  const int tx = blockDim.x, ty = blockDim.y, n = tx * ty;
  const int w = tx * VEC, values = 2 * w, t = threadIdx.y * tx + threadIdx.x;
  float* row = sh + threadIdx.y * values + threadIdx.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    row[i] = s1[i];
    row[w + i] = s2[i];
  }
  __syncthreads();
  const int runs = n / values, len = (ty + runs - 1) / runs;
  float* part = sh + ty * values;  // runs x V, after the lanes' rows
  if (t < runs * values) {
    const int v = t % values, r = t / values;
    const int hi = min(ty, (r + 1) * len);
    float a = 0.0f;
    for (int l = r * len; l < hi; ++l) a += sh[l * values + v];
    part[r * values + v] = a;
  }
  __syncthreads();
  float total = 0.0f;
  if (t < values)
    for (int r = 0; r < runs; ++r) total += part[r * values + t];
  return total;
}

// Adds one to *counter and returns what it held, as one atomic at GPU
// scope with acquire-release semantics: called by one thread after a
// __syncthreads(), it releases the block's earlier stores (before anyone
// who sees the new count) and acquires those of the blocks counted before
// it (for the block's reads after the next __syncthreads()). One
// instruction: a relaxed atomic between two fences measured ≈ 0.35 µs a
// launch slower on the H100 (PERF.md).
__device__ __forceinline__ unsigned count_in(unsigned* counter) {
  unsigned seen;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(seen)
               : "l"(counter)
               : "memory");
  return seen;
}

// acc += VEC floats at p, read from L2 (written by other blocks of this
// launch: never through the non-coherent path).
template <int VEC>
__device__ __forceinline__ void add_floats(const float* __restrict__ p,
                                           float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + q);
      acc[4 * q] += v.x;
      acc[4 * q + 1] += v.y;
      acc[4 * q + 2] += v.z;
      acc[4 * q + 3] += v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += __ldcg(p + j);
  }
}

// The body of K1s and K1r, one launch: block (bx, by) of sums_geometry
// takes channel groups bx*tx .. bx*tx + tx - 1 and, on lane ty_i, the rows
// by*ty + ty_i + k*ty*gy for k < rows (those at or past m masked); writes
// its partial to ws[by][0][c] and ws[by][1][c]; the last block of channel
// tile bx to count in adds the tile's gy partials (lane l a run of
// ceil(gy / ty) consecutive ones, in block order, then block_sums). On
// that block only, returns shared memory holding the tile's two sums a
// channel, s1 of tile channel j at [j] and s2 at [tx * VEC + j], visible to
// every thread; nullptr on the others.
template <int VEC, class Term>
__device__ __forceinline__ const float* column_sums(
    Term t, long long m, int c, int rows, float* __restrict__ ws,
    unsigned* __restrict__ counters) {
  constexpr int U = Term::kInFlight;
  const int tx = blockDim.x, ty = blockDim.y, parts = gridDim.y;
  const int c0 = (blockIdx.x * tx + threadIdx.x) * VEC;
  const bool live = c0 < c;  // else only in a ragged last channel tile
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  const long long first = (long long)blockIdx.y * ty + threadIdx.y;
  if (live && first < m) {
    t.prepare(c0);
    const long long stride = (long long)ty * parts;
    // the lane's rows below m, in order: whole runs of U loads in flight,
    // then the rest masked; o steps from row to row as an element offset
    const int n = (int)min((long long)rows, (m - 1 - first) / stride + 1);
    const long long step = stride * c;
    long long o = first * c + c0;
    int k = 0;
    for (; k + U <= n; k += U) {
      typename Term::Elem e[U];
#pragma unroll
      for (int j = 0; j < U; ++j) e[j] = t.load(o + j * step);
#pragma unroll
      for (int j = 0; j < U; ++j) t.add(e[j], s1, s2);
      o += U * step;
    }
    if (k < n) {
      typename Term::Elem e[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (k + j < n) e[j] = t.load(o + j * step);
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (k + j < n) t.add(e[j], s1, s2);
    }
  }
  __shared__ __align__(16) float sh[(2 * kVec + 1) * kSumThreads];
  __shared__ bool last;
  const int w = tx * VEC, v = threadIdx.y * tx + threadIdx.x;
  const int tile0 = blockIdx.x * w, kind = v / w, j = v - kind * w;
  const float total = block_sums<VEC>(s1, s2, sh);
  if (v < 2 * w && tile0 + j < c)
    ws[(long long)blockIdx.y * 2 * c + (long long)kind * c + tile0 + j] = total;
  __syncthreads();
  if (v == 0)  // the tile's count, with the release and acquire it needs
    last = count_in(counters + blockIdx.x) == (unsigned)parts - 1;
  __syncthreads();
  if (!last) return nullptr;
  // the tile's partials, read past L1
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  if (live) {
    const int run = (parts + ty - 1) / ty, lane = threadIdx.y;
    const int hi = min(parts, (lane + 1) * run);
#pragma unroll 8
    for (int p = lane * run; p < hi; ++p) {
      const float* in = ws + (long long)p * 2 * c + c0;
      add_floats<VEC>(in, s1);
      add_floats<VEC>(in + c, s2);
    }
  }
  const float sum = block_sums<VEC>(s1, s2, sh);
  if (v < 2 * w) sh[v] = sum;  // lane 0's row: read for the last time above
  if (v == 0) counters[blockIdx.x] = 0u;
  __syncthreads();
  return sh;
}

// K1s: mean = Σx / m and var = Σx² / m − mean² (jnp.mean's division, mean²
// rounded before the difference, not clamped), and inv_std = 1 / sqrt(var
// + eps) with IEEE division and square root, as K1's forward forms it.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSumThreads)
abn_stats_kernel(const T* __restrict__ x, long long m, int c, int rows,
                 float eps, float* __restrict__ ws,
                 unsigned* __restrict__ counters,
                 float* __restrict__ mean, float* __restrict__ var,
                 float* __restrict__ inv) {
  const float* sums =
      column_sums<VEC>(StatsTerm<T, VEC>{x}, m, c, rows, ws, counters);
  const int w = blockDim.x * VEC, j = threadIdx.y * blockDim.x + threadIdx.x;
  const int ch = blockIdx.x * w + j;
  if (sums == nullptr || j >= w || ch >= c) return;
  const float n = (float)m;
  const float mu = sums[j] / n;
  const float v = sums[w + j] / n - __fmul_rn(mu, mu);
  mean[ch] = mu;
  var[ch] = v;
  inv[ch] = 1.0f / sqrtf(v + eps);
}

// K1r: dbias = Σdy, dscale = Σdy·x̂.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSumThreads)
abn_grad_sums_kernel(const T* __restrict__ g, const T* __restrict__ y,
                     const T* __restrict__ x, const float* __restrict__ mean,
                     const float* __restrict__ inv, long long m, int c,
                     int rows, float slope, float* __restrict__ ws,
                     unsigned* __restrict__ counters,
                     float* __restrict__ dscale, float* __restrict__ dbias) {
  const float* sums = column_sums<VEC>(
      GradTerm<T, VEC>{g, y, x, mean, inv, slope}, m, c, rows, ws, counters);
  const int w = blockDim.x * VEC, j = threadIdx.y * blockDim.x + threadIdx.x;
  const int ch = blockIdx.x * w + j;
  if (sums == nullptr || j >= w || ch >= c) return;
  dbias[ch] = sums[j];
  dscale[ch] = sums[w + j];
}

// K1d: K1's block, grid and row-stride loop (R rows a thread), with
// `__launch_bounds__` for two resident blocks: a thread holds 3R row packs
// and 24 constants.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
abn_grad_input_kernel(const T* __restrict__ g, const T* __restrict__ y,
                      const T* __restrict__ x, T* __restrict__ dx,
                      const float* __restrict__ scale,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ dscale,
                      const float* __restrict__ dbias, long long m, int c,
                      float slope) {
  const int tx = blockDim.x, ty = blockDim.y;
  const int c0 = (blockIdx.x * tx + threadIdx.x) * VEC;
  const long long tile = (long long)ty * R;
  const long long step = tile * gridDim.y;
  long long r = blockIdx.y * tile + threadIdx.y;
  if (c0 >= c) return;  // only in a ragged last channel tile
  Pack<T, VEC> gi[R], yi[R], xi[R];
  load_rows<T, VEC, R>(g, r, ty, m, c, c0, gi);
  load_rows<T, VEC, R>(y, r, ty, m, c, c0, yi);
  load_rows<T, VEC, R>(x, r, ty, m, c, c0, xi);
  float s[VEC], mu[VEC], iv[VEC], k[VEC], sum_dxhat[VEC], sum_dxhat_xhat[VEC];
  load_channels<VEC>(scale, c0, s);
  load_channels<VEC>(mean, c0, mu);
  load_channels<VEC>(inv, c0, iv);
  load_channels<VEC>(dbias, c0, sum_dxhat);
  load_channels<VEC>(dscale, c0, sum_dxhat_xhat);
  const float n = (float)m;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k[i] = iv[i] / n;
    sum_dxhat[i] = __fmul_rn(s[i], sum_dxhat[i]);  // Σdx̂ = scale·Σdy
    sum_dxhat_xhat[i] = __fmul_rn(s[i], sum_dxhat_xhat[i]);
  }
  for (;;) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = r + (long long)j * ty;
      if (row < m) {
        Pack<T, VEC> out;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float dy =
              to_f32(gi[j].v[i]) * (to_f32(yi[j].v[i]) >= 0.0f ? 1.0f : slope);
          const float dxhat = dy * s[i];
          const float x_hat = (to_f32(xi[j].v[i]) - mu[i]) * iv[i];
          const float t = (__fmul_rn(n, dxhat) - sum_dxhat[i]) -
                          __fmul_rn(x_hat, sum_dxhat_xhat[i]);
          out.v[i] = from_f32<T>(k[i] * t);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + row * c + c0) = out;
      }
    }
    r += step;
    if (r >= m) return;
    load_rows<T, VEC, R>(g, r, ty, m, c, c0, gi);
    load_rows<T, VEC, R>(y, r, ty, m, c, c0, yi);
    load_rows<T, VEC, R>(x, r, ty, m, c, c0, xi);
  }
}

// Whether K1s and K1r take geometry g for (m, c) (sums_geometry): the
// vector width on a C it divides and on 16-byte aligned pointers (the n
// pointers given), or the scalar path; the block they are built for (tx
// channel groups by kSumThreads / tx lanes); every channel group covered by
// gx channel tiles, each with a counter among the `tiles` given; gy row
// blocks whose lanes cover every row in `rows` steps (rows = ceil(m / (ty *
// gy))), none idle; and long partials: each lane at least kSumMinRows rows,
// unless one row block takes them all. K1's geometry is never taken.
bool sums_takes(const Geometry& g, long long m, int c, const void* const* ptrs,
                int n, int tiles) {
  if (g.vec != 1 && g.vec != kVec) return false;
  if (g.vec == kVec) {
    if (c % kVec != 0) return false;
    for (int i = 0; i < n; ++i)
      if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  }
  if (g.tx < 1 || g.tx > kSumThreads || g.ty != kSumThreads / g.tx ||
      2 * g.vec > g.ty)
    return false;
  if (g.gx < 1 || g.gx > tiles || g.gy < 1 || (unsigned)g.gy > kMaxGridY)
    return false;
  const long long groups = (c + g.vec - 1) / g.vec;
  if ((long long)g.gx * g.tx < groups || (long long)(g.gx - 1) * g.tx >= groups)
    return false;
  const long long lanes = (long long)g.ty * g.gy;
  if ((long long)(g.gy - 1) * g.ty >= m) return false;  // an idle row block
  if (g.rows < 1 || lanes * g.rows < m || lanes * (g.rows - 1) >= m)
    return false;
  return g.gy == 1 || lanes * kSumMinRows <= m;
}

template <typename T>
cudaError_t stats(const Geometry& g, const void* x, float* ws,
                  unsigned* counters, int tiles, float* mean, float* var,
                  float* inv, long long m, int c, float eps, cudaStream_t s) {
  const void* ptrs[2] = {x, ws};
  if (!sums_takes(g, m, c, ptrs, 2, tiles)) return cudaErrorInvalidValue;
  const dim3 grid(g.gx, g.gy), block(g.tx, g.ty);
  const T* xt = static_cast<const T*>(x);
  if (g.vec == kVec)
    abn_stats_kernel<T, kVec><<<grid, block, 0, s>>>(
        xt, m, c, g.rows, eps, ws, counters, mean, var, inv);
  else
    abn_stats_kernel<T, 1><<<grid, block, 0, s>>>(
        xt, m, c, g.rows, eps, ws, counters, mean, var, inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_sums(const Geometry& geo, const void* g, const void* y,
                      const void* x, const float* mean, const float* inv,
                      float* ws, unsigned* counters, int tiles, float* dscale,
                      float* dbias, long long m, int c, float slope,
                      cudaStream_t s) {
  const void* ptrs[6] = {g, y, x, mean, inv, ws};
  if (!sums_takes(geo, m, c, ptrs, 6, tiles)) return cudaErrorInvalidValue;
  const dim3 grid(geo.gx, geo.gy), block(geo.tx, geo.ty);
  const T *gt = static_cast<const T*>(g), *yt = static_cast<const T*>(y),
          *xt = static_cast<const T*>(x);
  if (geo.vec == kVec)
    abn_grad_sums_kernel<T, kVec><<<grid, block, 0, s>>>(
        gt, yt, xt, mean, inv, m, c, geo.rows, slope, ws, counters, dscale,
        dbias);
  else
    abn_grad_sums_kernel<T, 1><<<grid, block, 0, s>>>(
        gt, yt, xt, mean, inv, m, c, geo.rows, slope, ws, counters, dscale,
        dbias);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t grad_input_rows(const Geometry& geo, const T* g, const T* y,
                            const T* x, T* dx, const float* scale,
                            const float* mean, const float* inv,
                            const float* dscale, const float* dbias,
                            long long m, int c, float slope, cudaStream_t s) {
  const dim3 grid(geo.gx, geo.gy), block(geo.tx, geo.ty);
  switch (geo.rows) {
    case 1:
      abn_grad_input_kernel<T, VEC, 1><<<grid, block, 0, s>>>(
          g, y, x, dx, scale, mean, inv, dscale, dbias, m, c, slope);
      break;
    case 2:
      abn_grad_input_kernel<T, VEC, 2><<<grid, block, 0, s>>>(
          g, y, x, dx, scale, mean, inv, dscale, dbias, m, c, slope);
      break;
    default:
      abn_grad_input_kernel<T, VEC, 4><<<grid, block, 0, s>>>(
          g, y, x, dx, scale, mean, inv, dscale, dbias, m, c, slope);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_input(const Geometry& geo, const void* g, const void* y,
                       const void* x, void* dx, const float* scale,
                       const float* mean, const float* inv,
                       const float* dscale, const float* dbias, long long m,
                       int c, float slope, cudaStream_t s) {
  const void* ptrs[9] = {g, y, x, dx, scale, mean, inv, dscale, dbias};
  if (geo.rows > kGradInputMaxRows || !takes(geo, m, c, ptrs, 9))
    return cudaErrorInvalidValue;
  const T *gt = static_cast<const T*>(g), *yt = static_cast<const T*>(y),
          *xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (geo.vec == kVec)
    return grad_input_rows<T, kVec>(geo, gt, yt, xt, dxt, scale, mean, inv,
                                    dscale, dbias, m, c, slope, s);
  return grad_input_rows<T, 1>(geo, gt, yt, xt, dxt, scale, mean, inv, dscale,
                               dbias, m, c, slope, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. geometry: {vec, rows, tx, ty, gx, gy}
// (K1s, K1r: ops/fused_abn.py::sums_geometry; K1d: its grad_input_geometry,
// K1's rule with rows at most 4). ws: gy * 2 * c floats; counters: `tiles`
// unsigned ints, all 0, of which the launch uses gx and leaves them 0. Each
// returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a dtype code, a shape or a geometry it does not
// take.

// K1s: mean, var and inv_std of x's columns.
extern "C" int abn_stats(const void* x, float* ws, unsigned* counters,
                         float* mean, float* var, float* inv, long long m,
                         int c, float eps, int tiles, int dtype,
                         const int* geometry, void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry g = unpack(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)stats<float>(g, x, ws, counters, tiles, mean, var, inv, m,
                               c, eps, s);
    case 1:
      return (int)stats<__nv_bfloat16>(g, x, ws, counters, tiles, mean, var,
                                       inv, m, c, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1r: dscale = Σdy·x̂ and dbias = Σdy per channel.
extern "C" int abn_grad_sums(const void* g, const void* y, const void* x,
                             const float* mean, const float* inv, float* ws,
                             unsigned* counters, float* dscale, float* dbias,
                             long long m, int c, float slope, int tiles,
                             int dtype, const int* geometry, void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = unpack(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)grad_sums<float>(geo, g, y, x, mean, inv, ws, counters,
                                   tiles, dscale, dbias, m, c, slope, s);
    case 1:
      return (int)grad_sums<__nv_bfloat16>(geo, g, y, x, mean, inv, ws,
                                           counters, tiles, dscale, dbias, m,
                                           c, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1d: dx from g, y, x, the statistics and K1r's sums.
extern "C" int abn_grad_input(const void* g, const void* y, const void* x,
                              void* dx, const float* scale, const float* mean,
                              const float* inv, const float* dscale,
                              const float* dbias, long long m, int c,
                              float slope, int dtype, const int* geometry,
                              void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = unpack(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)grad_input<float>(geo, g, y, x, dx, scale, mean, inv, dscale,
                                    dbias, m, c, slope, s);
    case 1:
      return (int)grad_input<__nv_bfloat16>(geo, g, y, x, dx, scale, mean, inv,
                                            dscale, dbias, m, c, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
