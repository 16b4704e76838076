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
// What the design does about it (a simple kernel first):
//  - the two reductions share one partial-sum body over (row tile x channel
//    group), with K1's vector accesses along C and K1's geometry rule at
//    one row a thread: each thread keeps f32 sums of its VEC channels over
//    a row-stride loop with the loads of kUnroll rows in flight, the block
//    adds its rows' sums in shared memory in row order and writes one
//    partial per channel to a workspace of (gy, 2, C) f32; a second small
//    kernel adds each channel's gy partials, again in a fixed order. No
//    floating-point atomics, so two launches give the same bits. The
//    workspace comes from PyTorch's allocator: nothing here allocates;
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

constexpr int kUnroll = 4;        // rows whose loads a thread keeps in flight
constexpr int kFinalChannels = 32;  // the finalize block: channels ...
constexpr int kFinalLanes = 8;      // ... by lanes that split the partials
constexpr int kGradInputMaxRows = 4;  // R of K1d (3 row packs a row)

// The two terms K1s sums per channel: x and x².
template <typename T, int VEC>
struct StatsTerm {
  const T* __restrict__ x;
  int c;
  struct Elem {
    Pack<T, VEC> x;
  };
  __device__ __forceinline__ void prepare(int) {}
  __device__ __forceinline__ Elem load(long long row, int c0) const {
    Elem e;
    e.x = *reinterpret_cast<const Pack<T, VEC>*>(x + row * c + c0);
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
  const T* __restrict__ g;
  const T* __restrict__ y;
  const T* __restrict__ x;
  const float* __restrict__ mean;
  const float* __restrict__ inv;
  int c;
  float slope;
  float mu[VEC], iv[VEC];
  struct Elem {
    Pack<T, VEC> g, y, x;
  };
  __device__ __forceinline__ void prepare(int c0) {
    load_channels<VEC>(mean, c0, mu);
    load_channels<VEC>(inv, c0, iv);
  }
  __device__ __forceinline__ Elem load(long long row, int c0) const {
    const long long o = row * c + c0;
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

// Block (tx, ty) of K1's geometry at one row a thread: threadIdx.x walks
// VEC-wide channel groups, threadIdx.y rows; block (bx, by) takes rows
// by*ty + threadIdx.y, then every ty*gridDim.y rows on. Writes the block's
// two sums per channel to ws[by][0][c] and ws[by][1][c].
template <int VEC, class Term>
__device__ __forceinline__ void partial_sums(Term t, long long m, int c,
                                             float* __restrict__ ws) {
  const int tx = blockDim.x, ty = blockDim.y;
  const int c0 = (blockIdx.x * tx + threadIdx.x) * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  if (c0 < c) {  // else only in a ragged last channel tile
    t.prepare(c0);
    const long long stride = (long long)ty * gridDim.y;
    for (long long r = (long long)blockIdx.y * ty + threadIdx.y; r < m;
         r += kUnroll * stride) {
      typename Term::Elem e[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (r + j * stride < m) e[j] = t.load(r + j * stride, c0);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (r + j * stride < m) t.add(e[j], s1, s2);
    }
  }
  __shared__ float sh[2][kMaxThreads * kVec];
  const int slot = (threadIdx.y * tx + threadIdx.x) * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh[0][slot + i] = s1[i];
    sh[1][slot + i] = s2[i];
  }
  __syncthreads();
  if (threadIdx.y != 0 || c0 >= c) return;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  for (int j = 0; j < ty; ++j) {  // the block's rows, in order
    const int from = (j * tx + threadIdx.x) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += sh[0][from + i];
      s2[i] += sh[1][from + i];
    }
  }
  float* out = ws + (long long)blockIdx.y * 2 * c;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    out[c0 + i] = s1[i];
    out[c + c0 + i] = s2[i];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
abn_stats_partial_kernel(const T* __restrict__ x, long long m, int c,
                         float* __restrict__ ws) {
  partial_sums<VEC>(StatsTerm<T, VEC>{x, c}, m, c, ws);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
abn_grad_sums_partial_kernel(const T* __restrict__ g, const T* __restrict__ y,
                             const T* __restrict__ x,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv, long long m, int c,
                             float slope, float* __restrict__ ws) {
  partial_sums<VEC>(GradTerm<T, VEC>{g, y, x, mean, inv, c, slope}, m, c, ws);
}

// The sums of channel blockIdx.x * kFinalChannels + threadIdx.x over the
// `parts` partials of ws: lane l (threadIdx.y) adds partials l, l +
// kFinalLanes, ..., then lane 0 adds the lanes' sums in lane order. True on
// the thread that holds a channel's result.
__device__ __forceinline__ bool final_sums(const float* __restrict__ ws,
                                           int parts, int c, float& s1,
                                           float& s2) {
  const int ch = blockIdx.x * kFinalChannels + threadIdx.x;
  float a = 0.0f, b = 0.0f;
  if (ch < c)
    for (int j = threadIdx.y; j < parts; j += kFinalLanes) {
      a += ws[(long long)j * 2 * c + ch];
      b += ws[(long long)j * 2 * c + c + ch];
    }
  __shared__ float sh[2][kFinalLanes][kFinalChannels];
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || ch >= c) return false;
  s1 = s2 = 0.0f;
#pragma unroll
  for (int l = 0; l < kFinalLanes; ++l) {
    s1 += sh[0][l][threadIdx.x];
    s2 += sh[1][l][threadIdx.x];
  }
  return true;
}

// K1s's second pass: mean = Σx / m and var = Σx² / m − mean² (jnp.mean's
// division, mean² rounded before the difference, not clamped), and
// inv_std = 1 / sqrt(var + eps) with IEEE division and square root, as
// K1's forward forms it from var.
__global__ void __launch_bounds__(kFinalChannels * kFinalLanes)
abn_stats_finalize_kernel(const float* __restrict__ ws, int parts,
                          long long m, int c, float eps,
                          float* __restrict__ mean, float* __restrict__ var,
                          float* __restrict__ inv) {
  float s1, s2;
  if (!final_sums(ws, parts, c, s1, s2)) return;
  const int ch = blockIdx.x * kFinalChannels + threadIdx.x;
  const float n = (float)m;
  const float mu = s1 / n;
  const float v = s2 / n - __fmul_rn(mu, mu);
  mean[ch] = mu;
  var[ch] = v;
  inv[ch] = 1.0f / sqrtf(v + eps);
}

// K1r's second pass: dbias = Σdy, dscale = Σdy·x̂.
__global__ void __launch_bounds__(kFinalChannels * kFinalLanes)
abn_grad_sums_finalize_kernel(const float* __restrict__ ws, int parts, int c,
                              float* __restrict__ dscale,
                              float* __restrict__ dbias) {
  float s1, s2;
  if (!final_sums(ws, parts, c, s1, s2)) return;
  const int ch = blockIdx.x * kFinalChannels + threadIdx.x;
  dbias[ch] = s1;
  dscale[ch] = s2;
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

dim3 final_grid(int c) {
  return dim3((c + kFinalChannels - 1) / kFinalChannels);
}

template <typename T>
cudaError_t stats(const Geometry& g, const void* x, float* ws, float* mean,
                  float* var, float* inv, long long m, int c, float eps,
                  cudaStream_t s) {
  const void* ptrs[1] = {x};
  if (g.rows != 1 || !takes(g, m, c, ptrs, 1)) return cudaErrorInvalidValue;
  const dim3 grid(g.gx, g.gy), block(g.tx, g.ty);
  const T* xt = static_cast<const T*>(x);
  if (g.vec == kVec)
    abn_stats_partial_kernel<T, kVec><<<grid, block, 0, s>>>(xt, m, c, ws);
  else
    abn_stats_partial_kernel<T, 1><<<grid, block, 0, s>>>(xt, m, c, ws);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  abn_stats_finalize_kernel<<<final_grid(c), dim3(kFinalChannels, kFinalLanes),
                              0, s>>>(ws, g.gy, m, c, eps, mean, var, inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_sums(const Geometry& geo, const void* g, const void* y,
                      const void* x, const float* mean, const float* inv,
                      float* ws, float* dscale, float* dbias, long long m,
                      int c, float slope, cudaStream_t s) {
  const void* ptrs[5] = {g, y, x, mean, inv};
  if (geo.rows != 1 || !takes(geo, m, c, ptrs, 5))
    return cudaErrorInvalidValue;
  const dim3 grid(geo.gx, geo.gy), block(geo.tx, geo.ty);
  const T *gt = static_cast<const T*>(g), *yt = static_cast<const T*>(y),
          *xt = static_cast<const T*>(x);
  if (geo.vec == kVec)
    abn_grad_sums_partial_kernel<T, kVec><<<grid, block, 0, s>>>(
        gt, yt, xt, mean, inv, m, c, slope, ws);
  else
    abn_grad_sums_partial_kernel<T, 1><<<grid, block, 0, s>>>(
        gt, yt, xt, mean, inv, m, c, slope, ws);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  abn_grad_sums_finalize_kernel<<<final_grid(c),
                                  dim3(kFinalChannels, kFinalLanes), 0, s>>>(
      ws, geo.gy, c, dscale, dbias);
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
// (ops/fused_abn.py::geometry; rows 1 for the two reductions, at most 4 for
// K1d). ws: gy * 2 * c floats. Each returns cudaGetLastError() after its
// launches (0 = launched), or cudaErrorInvalidValue for a dtype code, a
// shape or a geometry it does not take.

// K1s: mean, var and inv_std of x's columns.
extern "C" int abn_stats(const void* x, float* ws, float* mean, float* var,
                         float* inv, long long m, int c, float eps, int dtype,
                         const int* geometry, void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry g = unpack(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)stats<float>(g, x, ws, mean, var, inv, m, c, eps, s);
    case 1:
      return (int)stats<__nv_bfloat16>(g, x, ws, mean, var, inv, m, c, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1r: dscale = Σdy·x̂ and dbias = Σdy per channel.
extern "C" int abn_grad_sums(const void* g, const void* y, const void* x,
                             const float* mean, const float* inv, float* ws,
                             float* dscale, float* dbias, long long m, int c,
                             float slope, int dtype, const int* geometry,
                             void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = unpack(geometry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)grad_sums<float>(geo, g, y, x, mean, inv, ws, dscale, dbias,
                                   m, c, slope, s);
    case 1:
      return (int)grad_sums<__nv_bfloat16>(geo, g, y, x, mean, inv, ws, dscale,
                                           dbias, m, c, slope, s);
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
