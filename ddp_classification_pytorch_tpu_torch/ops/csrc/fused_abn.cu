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
// What bounds it on this card: it is an elementwise pass with ~5 flops per
// element, so it is bound by memory bytes, M*C*(in + out bytes) — for bf16
// 4 bytes an element, 3.35 TB/s on an H100 SXM. What the design does about
// it: one read and one write of each element, 16-byte vector accesses along
// C, neighbouring threads on neighbouring addresses (a warp covers whole
// consecutive rows when C is small), and the four per-channel vectors loaded
// once per thread into registers, not once per element. inv_std is formed
// there too, rsqrt(var + eps) in f32 as pallas_kernels.py:81 forms it before
// its kernel, so no separate launch computes it. At serving batch sizes
// (1-8 images) each launch moves 0.1-13 MB, so its real limit is launch
// latency, not bandwidth: the remedy for that (a CUDA graph per serving
// bucket) lives outside this kernel.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/_build.py, ops/fused_abn.py). It launches on the caller's
// stream, does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Block = (tx, ty) threads: threadIdx.x walks VEC-wide channel groups,
// threadIdx.y walks rows; blocks stride over rows (grid.y) and channel
// tiles (grid.x). A thread keeps the same VEC channels for its whole row
// loop, so the per-channel vectors are read once per thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_abn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mean,
                     const float* __restrict__ var, long long m, int c,
                     float eps, float slope) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= c) return;
  float s[VEC], b[VEC], mu[VEC], inv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    // VEC > 1 only when c % VEC == 0, so a group never straddles the edge
    s[j] = scale[c0 + j];
    b[j] = bias[c0 + j];
    mu[j] = mean[c0 + j];
    inv[j] = 1.0f / sqrtf(var[c0 + j] + eps);
  }
  const long long row_step = (long long)gridDim.y * blockDim.y;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y; r < m;
       r += row_step) {
    const long long off = r * c + c0;
    Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // same op order as the Pallas kernel: x_hat, then affine, then gate
      const float x_hat = (to_f32(in.v[j]) - mu[j]) * inv[j];
      const float v = x_hat * s[j] + b[j];
      out.v[j] = from_f32<T>(v >= 0.0f ? v : v * slope);
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + off) = out;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, const float* scale,
                   const float* bias, const float* mean, const float* var,
                   long long m, int c, float eps, float slope,
                   cudaStream_t stream) {
  const int groups = (c + VEC - 1) / VEC;  // channel groups per row
  int tx = 1;
  while (tx < groups && tx < kThreads) tx <<= 1;
  const int ty = kThreads / tx;
  const long long row_blocks = (m + ty - 1) / ty;
  dim3 block(tx, ty);
  dim3 grid((groups + tx - 1) / tx,
            (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
  fused_abn_fwd_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, mean, var, m,
      c, eps, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, const float* scale,
                     const float* bias, const float* mean, const float* var,
                     long long m, int c, float eps, float slope,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // 16-byte accesses: 8 bf16, 4 f32
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (c % kVec == 0 && aligned)
    return launch<T, kVec>(x, y, scale, bias, mean, var, m, c, eps, slope,
                           stream);
  return launch<T, 1>(x, y, scale, bias, mean, var, m, c, eps, slope, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a dtype code or a
// shape the kernel does not take.
extern "C" int fused_abn_forward(const void* x, void* y, const float* scale,
                                 const float* bias, const float* mean,
                                 const float* var, long long m, int c,
                                 float eps, float slope, int dtype,
                                 void* stream) {
  if (m <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(x, y, scale, bias, mean, var, m, c, eps,
                                  slope, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, y, scale, bias, mean, var, m, c,
                                          eps, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
