// Fused BatchNorm + LeakyReLU forward (inference-mode ABN) for Hopper.
//
// Replaces the TPU kernel `ops/pallas_kernels.py::_fused_kernel` of the JAX
// package (launched by `_fused_forward`, exposed as `fused_bn_leaky_relu`):
//
//     y = leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias)
//
// per channel over x viewed as (M = N*H*W, C) rows of NHWC (channels_last)
// activations. x and y are bf16 or f32; scale, bias, mean and var are f32
// (C,); the math is f32 and y has x's dtype.
//
// What bounds it on this card: it is an elementwise pass with ~6 flops per
// element, so it is bound by memory bytes, M*C*(in + out bytes) — for bf16
// 4 bytes an element, 3.35 TB/s on an H100 SXM. At serving batch sizes
// (1-8 images) a launch moves 0.1-13 MB, a few microseconds at that rate,
// so the rest of its time is the per-launch floor: the launch itself and
// the latency of the first loads. The floor is not this kernel's to remove
// (a CUDA graph per serving bucket is); what the kernel controls is how
// many of its own latencies it stacks on top of it.
//
// What the design does about it:
//  - one read and one write of each element, vector accesses along C of 4
//    channels (16 bytes of f32, 8 of bf16), neighbouring threads on
//    neighbouring addresses: a block is tx threads across the row's channel
//    groups by ty rows, and when C fits one block row (tx = C / 4),
//    consecutive rows are consecutive addresses, so a warp reads one
//    contiguous run whatever C is;
//  - each thread owns R rows of its channel group (R = 1, 2, 4 or 8) and
//    issues all R loads of x before it touches the per-channel constants,
//    so the loads of x and of the constants are in flight together instead
//    of one after the other;
//  - the constants are one float4 of each kind per thread, and inv_std =
//    1 / sqrt(var + eps) is formed once per thread for every row it owns
//    (IEEE division and square root, so the outputs stay bitwise those of
//    the kernel's earlier, slower layout);
//  - the grid is sized to the card: at most SMs x resident blocks, with a
//    row-stride loop for larger M, so any M is covered without a clamp.
// The launch geometry (vector width, R, block and grid) is chosen on the
// host (`ops/fused_abn.py::geometry`, cached per shape), and checked here.
// The measurements behind these choices, and the designs that lost
// (constants staged in shared memory, 16-byte bf16 accesses), are in
// PERF.md's Findings.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/_build.py, ops/fused_abn.py). It launches on the caller's
// stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // per block: MAX_THREADS in fused_abn.py
constexpr int kMinBlocksPerSm = 4;  // RESIDENT_BLOCKS there: <= 64 registers
constexpr unsigned kMaxGridY = 65535;
// Channels per vector access, both dtypes: 16 bytes of f32, 8 of bf16. A
// thread's constants are then one float4 of each kind (16 registers); with
// 16-byte bf16 accesses its 8 channels' 32 constants cost occupancy (and
// spilled at R >= 4), which measured slower on the H100 (PERF.md).
constexpr int kVec = 4;  // VEC in ops/fused_abn.py

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The per-channel constants of one thread's VEC channels.
template <int VEC>
struct Consts {
  float s[VEC], b[VEC], mu[VEC], inv[VEC];
};

template <int VEC>
__device__ __forceinline__ void put4(float (&out)[VEC], int q, float4 v) {
  out[4 * q] = v.x;
  out[4 * q + 1] = v.y;
  out[4 * q + 2] = v.z;
  out[4 * q + 3] = v.w;
}

// VEC values of p from channel c0 on: float4 loads when VEC is a multiple
// of 4 (the host takes the vector path only with every pointer 16-byte
// aligned and C a multiple of VEC).
template <int VEC>
__device__ __forceinline__ void load_channels(const float* __restrict__ p,
                                              int c0, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      put4(out, q, __ldg(reinterpret_cast<const float4*>(p + c0) + q));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = __ldg(p + c0 + j);
  }
}

// Rows r, r + ty, ..., r + (R - 1) * ty of a thread's tile: a warp's loads
// for one j are whole consecutive rows. Rows at or past m are masked.
template <typename T, int VEC, int R>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, long long r,
                                          int ty, long long m, int c, int c0,
                                          Pack<T, VEC> (&in)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long row = r + (long long)j * ty;
    if (row < m)
      in[j] = *reinterpret_cast<const Pack<T, VEC>*>(x + row * c + c0);
  }
}

template <typename T, int VEC, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ y, long long r,
                                           int ty, long long m, int c, int c0,
                                           const Pack<T, VEC> (&in)[R],
                                           const Consts<VEC>& k, float slope) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long row = r + (long long)j * ty;
    if (row < m) {
      Pack<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // same op order as the Pallas kernel: x_hat, then affine, then gate
        const float x_hat = (to_f32(in[j].v[i]) - k.mu[i]) * k.inv[i];
        const float v = x_hat * k.s[i] + k.b[i];
        out.v[i] = from_f32<T>(v >= 0.0f ? v : v * slope);
      }
      *reinterpret_cast<Pack<T, VEC>*>(y + row * c + c0) = out;
    }
  }
}

// Block (tx, ty): threadIdx.x walks VEC-wide channel groups, threadIdx.y
// rows. Block (bx, by) takes channel groups bx*tx .. bx*tx + tx - 1 and the
// row tiles by, by + gridDim.y, ... of ty*R rows each; a thread keeps its
// VEC channels for all of them.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
fused_abn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mean,
                     const float* __restrict__ var, long long m, int c,
                     float eps, float slope) {
  const int tx = blockDim.x, ty = blockDim.y;
  const int c0 = (blockIdx.x * tx + threadIdx.x) * VEC;
  const long long tile = (long long)ty * R;
  const long long step = tile * gridDim.y;
  long long r = blockIdx.y * tile + threadIdx.y;
  if (c0 >= c) return;  // only in a ragged last channel tile
  Pack<T, VEC> in[R];
  load_rows<T, VEC, R>(x, r, ty, m, c, c0, in);
  Consts<VEC> k;
  load_channels<VEC>(scale, c0, k.s);
  load_channels<VEC>(bias, c0, k.b);
  load_channels<VEC>(mean, c0, k.mu);
  load_channels<VEC>(var, c0, k.inv);
#pragma unroll
  for (int j = 0; j < VEC; ++j) k.inv[j] = 1.0f / sqrtf(k.inv[j] + eps);
  for (;;) {
    store_rows<T, VEC, R>(y, r, ty, m, c, c0, in, k, slope);
    r += step;
    if (r >= m) return;
    load_rows<T, VEC, R>(x, r, ty, m, c, c0, in);
  }
}

// An empty kernel: the device time of a launch of K1's geometry that does
// no work (chip_smoke.py's launch-floor yardstick).
__global__ void abn_launch_floor_kernel() {}

// The launch geometry the host chose (ops/fused_abn.py::geometry).
struct Geometry {
  int vec, rows, tx, ty, gx, gy;
};

// Whether the kernel takes geometry g for (m, c): the vector width on a C
// it divides and on 16-byte aligned pointers, or the scalar path; R of 1,
// 2, 4 or 8; at most kMaxThreads threads; every channel group and every
// row tile covered, and no block without work.
bool takes(const Geometry& g, long long m, int c, const void* const* ptrs) {
  if (g.vec != 1 && g.vec != kVec) return false;
  if (g.vec == kVec) {
    if (c % kVec != 0) return false;
    for (int i = 0; i < 6; ++i)
      if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  }
  if (g.rows != 1 && g.rows != 2 && g.rows != 4 && g.rows != 8) return false;
  if (g.tx < 1 || g.ty < 1 || g.tx * g.ty > kMaxThreads) return false;
  if (g.gx < 1 || g.gy < 1 || (unsigned)g.gy > kMaxGridY) return false;
  const long long groups = (c + g.vec - 1) / g.vec;
  if ((long long)g.gx * g.tx < groups || (long long)(g.gx - 1) * g.tx >= groups)
    return false;
  return (long long)(g.gy - 1) * g.ty * g.rows < m;
}

template <typename T, int VEC>
cudaError_t launch(const Geometry& g, const void* x, void* y,
                   const float* scale, const float* bias, const float* mean,
                   const float* var, long long m, int c, float eps,
                   float slope, cudaStream_t stream) {
  const dim3 grid(g.gx, g.gy), block(g.tx, g.ty);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (g.rows) {
    case 1:
      fused_abn_fwd_kernel<T, VEC, 1><<<grid, block, 0, stream>>>(
          xt, yt, scale, bias, mean, var, m, c, eps, slope);
      break;
    case 2:
      fused_abn_fwd_kernel<T, VEC, 2><<<grid, block, 0, stream>>>(
          xt, yt, scale, bias, mean, var, m, c, eps, slope);
      break;
    case 4:
      fused_abn_fwd_kernel<T, VEC, 4><<<grid, block, 0, stream>>>(
          xt, yt, scale, bias, mean, var, m, c, eps, slope);
      break;
    default:
      fused_abn_fwd_kernel<T, VEC, 8><<<grid, block, 0, stream>>>(
          xt, yt, scale, bias, mean, var, m, c, eps, slope);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Geometry& g, const void* x, void* y,
                     const float* scale, const float* bias, const float* mean,
                     const float* var, long long m, int c, float eps,
                     float slope, cudaStream_t stream) {
  const void* ptrs[6] = {x, y, scale, bias, mean, var};
  if (!takes(g, m, c, ptrs)) return cudaErrorInvalidValue;
  if (g.vec == kVec)
    return launch<T, kVec>(g, x, y, scale, bias, mean, var, m, c, eps, slope,
                           stream);
  return launch<T, 1>(g, x, y, scale, bias, mean, var, m, c, eps, slope,
                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. geometry: {vec, rows, tx, ty, gx, gy}
// (ops/fused_abn.py::geometry). Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a dtype code, a shape
// or a geometry the kernel does not take.
extern "C" int fused_abn_forward(const void* x, void* y, const float* scale,
                                 const float* bias, const float* mean,
                                 const float* var, long long m, int c,
                                 float eps, float slope, int dtype,
                                 const int* geometry, void* stream) {
  if (m <= 0 || c <= 0 || geometry == nullptr)
    return (int)cudaErrorInvalidValue;
  const Geometry g{geometry[0], geometry[1], geometry[2],
                   geometry[3], geometry[4], geometry[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(g, x, y, scale, bias, mean, var, m, c, eps,
                                  slope, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(g, x, y, scale, bias, mean, var, m,
                                          c, eps, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launches abn_launch_floor_kernel with the block and grid of geometry
// (tx, ty, gx, gy as above): the launch floor K1 sits on at that shape.
extern "C" int fused_abn_launch_floor(const int* geometry, void* stream) {
  if (geometry == nullptr) return (int)cudaErrorInvalidValue;
  abn_launch_floor_kernel<<<dim3(geometry[4], geometry[5]),
                            dim3(geometry[2], geometry[3]), 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
