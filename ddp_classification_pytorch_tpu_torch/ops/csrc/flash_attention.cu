// Flash attention for Hopper: the forward (K2) and the two backward kernels
// (K3: dQ; K4: dK and dV).
//
// Replaces the TPU kernels of the JAX package's `ops/flash_attention.py`:
//   K2  `_flash_kernel`  (launched by `_flash_forward`)
//   K3  `_dq_kernel`     (launched by `_flash_backward_impl`)
//   K4  `_dkv_kernel`    (launched by `_flash_backward_impl`)
//
// Layout: q, k, v, dO, O, dQ, dK, dV are (BH, T, D) row-major, D = 64, in
// bf16 or f32; lse and delta = rowsum(dO * O) are (BH, T) f32.
//
//   K2: S = Q K^T * scale; online softmax over kv tiles with the running
//       max m and normaliser l in f32; O = (sum_k P V) / l; lse = m + log l.
//   K3: P = exp(S - lse), dP = dO V^T, dS = P * (dP - delta),
//       dQ = sum_k dS K * scale.
//   K4: dV = sum_q P^T dO, dK = sum_q dS^T Q * scale (same recomputation).
//
// Rounding points follow the Pallas kernels: P is cast to V's dtype before
// P V (K2) and to dO's before P^T dO (K4), dS to K's/Q's dtype before its
// products (K3, K4); every product accumulates in f32; O, dQ, dK, dV are
// written in the input dtype; m, l and lse stay f32. Masked scores are
// -1e30, not -inf, as in the JAX kernels (no inf - inf).
//
// What bounds them on this card: at the ViT-B/16 shape (BH 384, T 1024,
// D 64) each kernel does 2-4 products of T^2 D per head, 1e11-2e11
// operations against 0.2-0.3 GB of operands, so the tensor cores bound
// them (989 TFLOP/s bf16 dense: 0.10, 0.16, 0.21 ms). What the design does
// about it: the (T, T) scores never reach device memory; each block keeps
// one tile of its fixed operand in shared memory and streams the other
// operand through in tiles, so device memory sees O(T D) bytes.
//
// In bf16 all three run the Hopper kernels, which hold the main path: K2
// in `flash_fwd_sm90.cu` (wgmma products, the online softmax in registers,
// a TMA ring for K and V), K3 and K4 in `flash_bwd_sm90.cu` (wgmma
// products, scores in registers, double-buffered TMA loads); the entry
// points below hand bf16 operands to them. What stays here is the f32 path
// of all three: CUDA-core products in full f32 (no TF32), with every
// product's result staged through shared memory so that the softmax, the
// masks and the running accumulators work on elements each thread owns at
// a known place: thread t owns row t/2, columns 32*(t%2) .. +31 of every
// 64x64 tile.
//
// Grid (f32): K2 and K3 take one block per (bh, 64-row q tile) and loop
// over the kv tiles (the Pallas kernels' sequential last grid axis); K4
// takes one block per (bh, 64-row kv tile) and loops over the q tiles.
// Ragged T is masked in the kernels: rows past T load as zeros and are not
// written, columns past T score -1e30. Causal skips tiles wholly above the
// diagonal and masks within the diagonal tile.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (ops/_build.py, ops/flash_attention.py). Each entry point launches
// on the caller's stream, does not synchronise, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of every tile (q and kv)
constexpr int kD = 64;         // head dimension
constexpr int kThreads = 128;  // 4 warps; warp w computes product rows 16w..16w+15
constexpr int kLdC = kD + 4;   // f32 staging tiles (row pitch, floats)
constexpr float kNegInf = -1e30f;

template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = kD + 4; };

template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * Ld<T>::v * (int)sizeof(T);
}
constexpr int kCBytes = kTile * kLdC * (int)sizeof(float);

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Logical (row, col) of a 64x64 operand held in shared memory with pitch LD.
struct RowMajor {
  template <int LD> __device__ static int off(int r, int c) { return r * LD + c; }
};
struct ColMajor {  // the transpose of a row-major tile
  template <int LD> __device__ static int off(int r, int c) { return c * LD + r; }
};

// C (64x64 f32, pitch kLdC) = A (64x64) x B (64x64), A and B in shared
// memory; CUDA cores, full f32 (no TF32); each thread computes the 32
// elements it owns.
template <class LA, class LB>
__device__ __forceinline__ void tile_product(const float* A, const float* B,
                                             float* C) {
  constexpr int LD = Ld<float>::v;
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  for (int k = 0; k < kD; ++k) {
    const float a = A[LA::template off<LD>(r, k)];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += a * B[LB::template off<LD>(k, c0 + j)];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) C[r * kLdC + c0 + j] = acc[j];
}

// Copy rows [row0, row0 + 64) of a (T, 64) row-major matrix into a shared
// tile with pitch Ld<T>; rows at or past `t` become zeros. 16-byte accesses.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int t) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = kD / VEC;
  constexpr int LD = Ld<T>::v;
  for (int i = threadIdx.x; i < kTile * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, cv = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD + cv);
    *reinterpret_cast<uint4*>(dst + r * LD + cv) = v;
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Write the 32 values a thread owns (row r, columns c0..c0+31) to global.
template <typename T>
__device__ __forceinline__ void store_row32(T* dst, const float* vals) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < 32; j += VEC) {
    Pack<T, VEC> pack;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pack.v[e] = from_f32<T>(vals[j + e]);
    *reinterpret_cast<Pack<T, VEC>*>(dst + j) = pack;
  }
}

__device__ __forceinline__ float pair_max(float v) {
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}
__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// ------------------------------------------------------------------ K2 --
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, float scale, int causal) {
  constexpr int LD = Ld<T>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* sV = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* sP = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  float* sC = reinterpret_cast<float*>(smem + 4 * tile_bytes<T>());

  const size_t base = (size_t)blockIdx.x * t * kD;
  const int iq = blockIdx.y, q0 = iq * kTile;
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
  const int row = q0 + r;

  load_tile(sQ, q + base, q0, t);
  float m = kNegInf, l = 0.0f, acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  const int nk = (t + kTile - 1) / kTile;
  const int nk_run = causal ? min(nk, iq + 1) : nk;  // skip tiles above the diagonal
  for (int jk = 0; jk < nk_run; ++jk) {
    const int k0 = jk * kTile;
    load_tile(sK, k + base, k0, t);
    load_tile(sV, v + base, k0, t);
    __syncthreads();
    tile_product<RowMajor, ColMajor>(sQ, sK, sC);  // S = Q K^T
    __syncthreads();
    float s[32], mc = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + c0 + j;
      s[j] = sC[r * kLdC + c0 + j] * scale;
      if (col >= t || (causal && col > row)) s[j] = kNegInf;
      mc = fmaxf(mc, s[j]);
    }
    const float m_new = fmaxf(m, pair_max(mc));
    const float corr = expf(m - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      sP[r * LD + c0 + j] = from_f32<T>(p);  // P in V's dtype before P V
    }
    l = l * corr + pair_sum(rs);
    m = m_new;
    __syncthreads();
    tile_product<RowMajor, RowMajor>(sP, sV, sC);  // P V
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = acc[j] * corr + sC[r * kLdC + c0 + j];
  }
  if (row < t) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = acc[j] / l;
    store_row32(o + base + (size_t)row * kD + c0, acc);
    if (c0 == 0) lse[(size_t)blockIdx.x * t + row] = m + logf(l);
  }
}

// ------------------------------------------------------------------ K3 --
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int t, float scale, int causal) {
  constexpr int LD = Ld<T>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* sK = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* sV = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  T* sdS = reinterpret_cast<T*>(smem + 4 * tile_bytes<T>());
  float* sC1 = reinterpret_cast<float*>(smem + 5 * tile_bytes<T>());
  float* sC2 = reinterpret_cast<float*>(smem + 5 * tile_bytes<T>() + kCBytes);

  const size_t base = (size_t)blockIdx.x * t * kD;
  const int iq = blockIdx.y, q0 = iq * kTile;
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
  const int row = q0 + r;
  const bool live = row < t;
  const float lse_r = live ? lse[(size_t)blockIdx.x * t + row] : 0.0f;
  const float dsum_r = live ? delta[(size_t)blockIdx.x * t + row] : 0.0f;

  load_tile(sQ, q + base, q0, t);
  load_tile(sdO, dout + base, q0, t);
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  const int nk = (t + kTile - 1) / kTile;
  const int nk_run = causal ? min(nk, iq + 1) : nk;
  for (int jk = 0; jk < nk_run; ++jk) {
    const int k0 = jk * kTile;
    load_tile(sK, k + base, k0, t);
    load_tile(sV, v + base, k0, t);
    __syncthreads();
    tile_product<RowMajor, ColMajor>(sQ, sK, sC1);   // S = Q K^T
    tile_product<RowMajor, ColMajor>(sdO, sV, sC2);  // dP = dO V^T
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + c0 + j;
      float s = sC1[r * kLdC + c0 + j] * scale;
      if (col >= t || (causal && col > row)) s = kNegInf;
      const float p = expf(s - lse_r);
      const float ds = p * (sC2[r * kLdC + c0 + j] - dsum_r);
      sdS[r * LD + c0 + j] = from_f32<T>(ds);  // dS in K's dtype
    }
    __syncthreads();
    tile_product<RowMajor, RowMajor>(sdS, sK, sC1);  // dS K
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += sC1[r * kLdC + c0 + j] * scale;
  }
  if (live) store_row32(dq + base + (size_t)row * kD + c0, acc);
}

// ------------------------------------------------------------------ K4 --
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int t, float scale,
                 int causal) {
  constexpr int LD = Ld<T>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* sQ = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* sdO = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  T* sP = reinterpret_cast<T*>(smem + 4 * tile_bytes<T>());
  T* sdS = reinterpret_cast<T*>(smem + 5 * tile_bytes<T>());
  float* sC1 = reinterpret_cast<float*>(smem + 6 * tile_bytes<T>());
  float* sC2 = reinterpret_cast<float*>(smem + 6 * tile_bytes<T>() + kCBytes);

  const size_t base = (size_t)blockIdx.x * t * kD;
  const int jk = blockIdx.y, k0 = jk * kTile;
  // in the score tile thread t owns q row r of the current q tile; in the
  // dK/dV accumulators it owns kv row r of this block's tile
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;

  load_tile(sK, k + base, k0, t);
  load_tile(sV, v + base, k0, t);
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc_k[j] = acc_v[j] = 0.0f;

  const int nq = (t + kTile - 1) / kTile;
  for (int iq = causal ? jk : 0; iq < nq; ++iq) {  // skip q tiles above the diagonal
    const int q0 = iq * kTile, row = q0 + r;
    const bool live = row < t;
    const float lse_r = live ? lse[(size_t)blockIdx.x * t + row] : 0.0f;
    const float dsum_r = live ? delta[(size_t)blockIdx.x * t + row] : 0.0f;
    load_tile(sQ, q + base, q0, t);
    load_tile(sdO, dout + base, q0, t);
    __syncthreads();
    tile_product<RowMajor, ColMajor>(sQ, sK, sC1);   // S = Q K^T   (q x kv)
    tile_product<RowMajor, ColMajor>(sdO, sV, sC2);  // dP = dO V^T (q x kv)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + c0 + j;
      float s = sC1[r * kLdC + c0 + j] * scale;
      if (!live || col >= t || (causal && col > row)) s = kNegInf;
      const float p = expf(s - lse_r);
      const float ds = p * (sC2[r * kLdC + c0 + j] - dsum_r);
      sP[r * LD + c0 + j] = from_f32<T>(p);    // P in dO's dtype
      sdS[r * LD + c0 + j] = from_f32<T>(ds);  // dS in Q's dtype
    }
    __syncthreads();
    tile_product<ColMajor, RowMajor>(sP, sdO, sC1);  // P^T dO  (kv x D)
    tile_product<ColMajor, RowMajor>(sdS, sQ, sC2);  // dS^T Q  (kv x D)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc_v[j] += sC1[r * kLdC + c0 + j];
      acc_k[j] += sC2[r * kLdC + c0 + j] * scale;
    }
  }
  if (k0 + r < t) {
    store_row32(dk + base + (size_t)(k0 + r) * kD + c0, acc_k);
    store_row32(dv + base + (size_t)(k0 + r) * kD + c0, acc_v);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem_bytes) {
  // above 48 KB only as opted-in dynamic shared memory
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

bool bad_args(int bh, int t, int d, int dtype) {
  return bh <= 0 || t <= 0 || d != kD || (dtype != 0 && dtype != 1);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t, float scale, int causal,
                       cudaStream_t s) {
  const int smem = 4 * tile_bytes<T>() + kCBytes;
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int t, float scale, int causal,
                      cudaStream_t s) {
  const int smem = 5 * tile_bytes<T>() + 2 * kCBytes;
  cudaError_t err = prepare(flash_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dq_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), t, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int t, float scale,
                       int causal, cudaStream_t s) {
  const int smem = 6 * tile_bytes<T>() + 2 * kCBytes;
  cudaError_t err = prepare(flash_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t + kTile - 1) / kTile);
  flash_dkv_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// flash_fwd_sm90.cu and flash_bwd_sm90.cu: the bf16 K2, K3 and K4
int flash_fwd_bf16_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int t, float scale, int causal, cudaStream_t stream);
int flash_dq_bf16_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bh, int t,
                       float scale, int causal, cudaStream_t stream);
int flash_dkv_bf16_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int bh,
                        int t, float scale, int causal, cudaStream_t stream);
int flash_fwd_sm90_resources(int* out);
int flash_bwd_sm90_resources(int* out);

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch (0 = launched), or cudaErrorInvalidValue for a dtype code or a
// shape the kernels do not take (D must be 64).

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int t, int d, float scale,
                         int causal, int dtype, void* stream) {
  if (bad_args(bh, t, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? (int)launch_fwd<float>(q, k, v, o, lse, bh, t, scale, causal, s)
             : flash_fwd_bf16_sm90(q, k, v, o, lse, bh, t, scale, causal, s);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int bh, int t, int d, float scale, int causal,
                        int dtype, void* stream) {
  if (bad_args(bh, t, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? (int)launch_dq<float>(q, k, v, dout, lse, delta, dq, bh, t,
                                     scale, causal, s)
             : flash_dq_bf16_sm90(q, k, v, dout, lse, delta, dq, bh, t, scale,
                                  causal, s);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int bh, int t,
                         int d, float scale, int causal, int dtype,
                         void* stream) {
  if (bad_args(bh, t, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? (int)launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                      scale, causal, s)
             : flash_dkv_bf16_sm90(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                   scale, causal, s);
}

// What the three bf16 Hopper kernels hold on this card, for chip_smoke.py's
// record only (no launch path calls it): per kernel (K2, K3, K4) registers
// per thread, dynamic shared memory per block in bytes and resident blocks
// per SM from the occupancy calculator, three ints each. Returns 0 or a
// CUDA error code.
extern "C" int flash_sm90_resources(int* out) {
  const int err = flash_fwd_sm90_resources(out);
  return err != 0 ? err : flash_bwd_sm90_resources(out + 3);
}
