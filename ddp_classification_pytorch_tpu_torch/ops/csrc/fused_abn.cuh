// What the fused ABN kernels share: K1's forward (fused_abn.cu) and the
// training passes K1s, K1r and K1d (fused_abn_train.cu) all walk x viewed as
// (M = N*H*W, C) rows of NHWC (channels_last) activations, with vector
// accesses of kVec channels, under one launch geometry chosen on the host
// (ops/fused_abn.py::geometry) and checked here.

#pragma once

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

// The launch geometry the host chose (ops/fused_abn.py::geometry).
struct Geometry {
  int vec, rows, tx, ty, gx, gy;
};

// Whether a kernel takes geometry g for (m, c): the vector width on a C it
// divides and on 16-byte aligned pointers (the n pointers it is given), or
// the scalar path; R of 1, 2, 4 or 8; at most kMaxThreads threads; every
// channel group and every row tile covered, and no block without work.
bool takes(const Geometry& g, long long m, int c, const void* const* ptrs,
           int n) {
  if (g.vec != 1 && g.vec != kVec) return false;
  if (g.vec == kVec) {
    if (c % kVec != 0) return false;
    for (int i = 0; i < n; ++i)
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

// The geometry the host packed as {vec, rows, tx, ty, gx, gy}.
Geometry unpack(const int* geometry) {
  return Geometry{geometry[0], geometry[1], geometry[2],
                  geometry[3], geometry[4], geometry[5]};
}

}  // namespace
