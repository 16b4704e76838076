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
// stream, does not synchronise and allocates nothing. The vector types,
// row loads and geometry check it shares with the training passes
// (fused_abn_train.cu) are in fused_abn.cuh.

#include "fused_abn.cuh"

namespace {

// The per-channel constants of one thread's VEC channels.
template <int VEC>
struct Consts {
  float s[VEC], b[VEC], mu[VEC], inv[VEC];
};

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
  if (!takes(g, m, c, ptrs, 6)) return cudaErrorInvalidValue;
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
  const Geometry g = unpack(geometry);
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
