// Flash attention backward for Hopper, bf16: K3 (dQ) and K4 (dK, dV) with
// wgmma products, scores kept in registers and double-buffered TMA loads.
//
// Replaces the TPU kernels of the JAX package's `ops/flash_attention.py`:
//   K3  `_dq_kernel`   (launched by `_flash_backward_impl`)
//   K4  `_dkv_kernel`  (launched by `_flash_backward_impl`)
// for bf16 operands. f32 operands keep the CUDA-core kernels of
// `flash_attention.cu`, which also holds the C entry points `flash_dq` and
// `flash_dkv` that call `flash_dq_bf16_sm90` / `flash_dkv_bf16_sm90` below.
//
// Function, as the Pallas kernels compute it (q, k, v, dO (BH, T, 64) bf16;
// lse, delta (BH, T) f32):
//   S = Q K^T * scale (masked: -1e30), P = exp(S - lse),
//   dP = dO V^T, dS = P * (dP - delta),
//   K3: dQ = sum_kv bf16(dS) K * scale
//   K4: dV = sum_q bf16(P)^T dO,  dK = sum_q bf16(dS)^T Q * scale
// Every product accumulates in f32; P and dS are rounded to bf16 before
// their products; dQ, dK, dV are written in bf16. The scale of dQ and dK is
// applied once to the f32 sum (the Pallas kernels scale each tile's
// product: the two differ by f32 rounding only).
//
// What bounds them: at the ViT-B/16 shape (BH 384, T 1024, D 64) K3 does
// three products of T^2 D per head and K4 four, 1.5e11 and 2.1e11
// operations: 0.156 and 0.208 ms at 989 TFLOP/s bf16, against 0.076 and
// 0.091 ms for their bytes (5 and 6 (BH, T, D) operands, each read or
// written once, at 3.35 TB/s). The tensor cores bound them.
//
// What the design does about the four costs of the first (WMMA) version:
// 1. Products through wgmma. Each block is one warpgroup (128 threads) and
//    issues `wgmma.mma_async` m64n64k16 bf16 -> f32. Products whose B
//    operand is a row-major (rows x 64) tile (S = Q K^T, dP = dO V^T; in K4
//    S^T = K Q^T, dP^T = V dO^T) read A and B K-major straight from
//    swizzled shared memory; dQ += dS K, dV += P^T dO and dK += dS^T Q read
//    B MN-major (the transpose bit) from the same tiles.
// 2. Scores in registers. S, dP, P and dS stay in the wgmma accumulator
//    layout: thread (warp w, lane l) owns rows 16w + l/4 (+8) and columns
//    8j + 2(l%4) (+1) of each 64x64 tile. Masks, exp and P * (dP - delta)
//    are applied in place, and the f32 accumulator of a score tile, rounded
//    to bf16, is already the register A operand of the next product (the
//    m64k16 A fragment has the accumulator's layout), so no score and no
//    f32 product goes through shared memory. K4 computes the transposed
//    scores (kv rows x q columns) so that P^T and dS^T are its A operands;
//    the per-column lse and delta of each q tile arrive with the tile.
// 3. Asynchronous, double-buffered loads. The streamed tiles (K, V in K3;
//    Q, dO, lse, delta in K4) go through a two-stage ring in shared memory,
//    filled by TMA (`cp.async.bulk.tensor`) against an mbarrier per stage:
//    tile j + 1 (and j + 2 once tile j's products finish) is in flight while
//    tile j is computed. A 3-D tensor map over (D, T, BH) zero-fills rows
//    past T within each head and writes the 128-byte swizzle wgmma reads.
//    One barrier per tile remains: it frees the stage for its next load.
// 4. Occupancy. No f32 staging tiles: K3 holds 48 KB of shared memory and
//    K4 50 KB per block (the WMMA version: 79 and 88 KB), and the launch
//    bounds keep at least 3 (K3) and 2 (K4) blocks resident per SM, so
//    another block's products run while one block does its softmax.
//
// Grid: K3 one block per (64-row q tile, bh), streaming the kv tiles, causal
// stopping at the diagonal; K4 one block per (64-row kv tile, bh), streaming
// the q tiles from the diagonal on. Consecutive blocks share a head, so its
// streamed tiles stay in L2. Each output element is written by one block
// and no atomics are used: results are bitwise deterministic. Rows past T
// load as zeros and are not written; columns past T score -1e30; tiles
// wholly above the diagonal are skipped.
//
// The PTX and tensor-map helpers are shared with K2 (flash_sm90.cuh).

#include "flash_sm90.cuh"

namespace {

constexpr int kTile = 64;       // rows of every tile (q and kv)
constexpr int kThreads = 128;   // one warpgroup
constexpr int kTileBytes = kTile * kD * 2;  // 8 KB, one swizzled bf16 tile
constexpr int kStatBytes = kTile * 4;       // one tile's lse or delta row

// Shared-memory plan (offsets from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
// K3: Q | dO | stage 0: K, V | stage 1: K, V | barriers
constexpr int kDqStage = 2 * kTileBytes;
constexpr int kDqBars = 2 * kTileBytes + 2 * kDqStage;
// K4: K | V | stage 0: Q, dO, lse, delta | stage 1: ... | barriers
constexpr int kDkvStage = 2 * kTileBytes + 1024;  // stats padded to 1 KB
constexpr int kDkvBars = 2 * kTileBytes + 2 * kDkvStage;
constexpr int kSmemDq = kDqBars + 64 + 1024;   // + alignment slack
constexpr int kSmemDkv = kDkvBars + 64 + 1024;

// ------------------------------------------------- K3/K4 helpers --
// TMA: 64 f32 at element `i` of a flat (BH * T) map.
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int i) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(i)
      : "memory");
}

// Write a 64x64 f32 accumulator, times `scale`, as bf16 rows [row0, row0+64)
// of a (T, 64) matrix; rows at or past t are not written. For blocks of one
// warpgroup.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const float (&d)[32],
                                           int row0, int t, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * kD + col) =
          __floats2bfloat162_rn(d[4 * j + 2 * i] * scale, d[4 * j + 2 * i + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ K3 --
__global__ void __launch_bounds__(kThreads, 3)
flash_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int t, int nq, float scale,
                     int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_q = s_base + kDqBars, bar_full = bar_q + 8;  // + 8 * stage

  const int iq = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int q0 = iq * kTile;
  const int nk = (t + kTile - 1) / kTile;
  const int n = causal ? min(nk, iq + 1) : nk;  // kv tiles this block streams
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, 2 * kTileBytes);
    tma_tile(s_base, &tm_q, bar_q, q0, bh);
    tma_tile(s_base + kTileBytes, &tm_do, bar_q, q0, bh);
    for (int s = 0; s < 2 && s < n; ++s) {
      const uint32_t st = s_base + 2 * kTileBytes + s * kDqStage;
      mbar_expect_tx(bar_full + 8 * s, kDqStage);
      tma_tile(st, &tm_k, bar_full + 8 * s, s * kTile, bh);
      tma_tile(st + kTileBytes, &tm_v, bar_full + 8 * s, s * kTile, bh);
    }
  }
  __syncthreads();

  // this thread's two rows: their lse and delta stay in registers
  const int rloc = 16 * warp + (lane >> 2);
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rloc + 8 * i;
    const bool live = row < t;
    lse_r[i] = live ? lse[(size_t)bh * t + row] * kLog2e : 0.0f;
    dsum_r[i] = live ? delta[(size_t)bh * t + row] : 0.0f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const uint64_t dq_desc = tile_desc(s_base), ddo_desc = tile_desc(s_base + kTileBytes);
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const uint32_t st = s_base + 2 * kTileBytes + s * kDqStage;
    const uint64_t dk = tile_desc(st), dv = tile_desc(st + kTileBytes);
    mbar_wait(bar_full + 8 * s, (it >> 1) & 1);

    float sc[32], dp[32];
    wg_fence();
    product_ss(sc, dq_desc, dk);    // S = Q K^T
    product_ss(dp, ddo_desc, dv);   // dP = dO V^T
    wg_commit();
    wg_wait_all();
    fence_acc(sc);
    fence_acc(dp);

    const int k0 = it * kTile;
    const bool edge = k0 + kTile > t || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = sc[e] * scale_log2;  // S * scale, in log2 units
          if (edge) {
            const int row = q0 + rloc + 8 * i, col = k0 + 8 * j + 2 * (lane & 3) + c;
            if (col >= t || (causal && col > row)) x = kNegInf;
          }
          const float p = exp2f(x - lse_r[i]);
          sc[e] = p * (dp[e] - dsum_r[i]);  // dS
        }
    uint32_t ds[4][4];
    to_frag(sc, ds);  // dS in K's dtype

    wg_fence();
    fence_acc(acc);
    product_rs(acc, ds, dk);  // dQ += dS K (K read MN-major)
    wg_commit();
    wg_wait_all();
    fence_acc(acc);
    fence_frag(ds);

    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && it + 2 < n) {
      mbar_expect_tx(bar_full + 8 * s, kDqStage);
      tma_tile(st, &tm_k, bar_full + 8 * s, (it + 2) * kTile, bh);
      tma_tile(st + kTileBytes, &tm_v, bar_full + 8 * s, (it + 2) * kTile, bh);
    }
  }
  store_tile(dq + (size_t)bh * t * kD, acc, q0, t, scale);
}

// ------------------------------------------------------------------ K4 --
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int t, int nk, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_kv = s_base + kDkvBars, bar_full = bar_kv + 8;

  const int jk = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int k0 = jk * kTile;
  const int nq = (t + kTile - 1) / kTile;
  const int iq0 = causal ? jk : 0;  // q tiles wholly above the diagonal skipped
  const int n = nq - iq0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr uint32_t kStageTx = 2 * kTileBytes + 2 * kStatBytes;

  auto load_stage = [&](int s, int iq) {
    const uint32_t st = s_base + 2 * kTileBytes + s * kDkvStage;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, kStageTx);
    tma_tile(st, &tm_q, bar, iq * kTile, bh);
    tma_tile(st + kTileBytes, &tm_do, bar, iq * kTile, bh);
    tma_row(st + 2 * kTileBytes, &tm_lse, bar, bh * t + iq * kTile);
    tma_row(st + 2 * kTileBytes + 512, &tm_delta, bar, bh * t + iq * kTile);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kTileBytes);
    tma_tile(s_base, &tm_k, bar_kv, k0, bh);
    tma_tile(s_base + kTileBytes, &tm_v, bar_kv, k0, bh);
    for (int s = 0; s < 2 && s < n; ++s) load_stage(s, iq0 + s);
  }
  __syncthreads();

  const int rloc = 16 * warp + (lane >> 2);  // kv rows rloc, rloc + 8
  const int cloc = 2 * (lane & 3);           // q columns 8j + cloc (+1)
  const float scale_log2 = scale * kLog2e;
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.0f;
  const uint64_t dk_desc = tile_desc(s_base), dv_desc = tile_desc(s_base + kTileBytes);
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const uint32_t st = s_base + 2 * kTileBytes + s * kDkvStage;
    const uint64_t dq_s = tile_desc(st), ddo_s = tile_desc(st + kTileBytes);
    const float* s_lse = reinterpret_cast<const float*>(
        smem + 2 * kTileBytes + s * kDkvStage + 2 * kTileBytes);
    const float* s_dsum = s_lse + 128;
    mbar_wait(bar_full + 8 * s, (it >> 1) & 1);

    float sc[32], dp[32];
    wg_fence();
    product_ss(sc, dk_desc, dq_s);   // S^T = K Q^T   (kv x q)
    product_ss(dp, dv_desc, ddo_s);  // dP^T = V dO^T (kv x q)
    wg_commit();
    wg_wait_all();
    fence_acc(sc);
    fence_acc(dp);

    const int q0 = (iq0 + it) * kTile;
    const bool edge = q0 + kTile > t || k0 + kTile > t || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(s_lse + 8 * j + cloc);
      const float2 d2 = *reinterpret_cast<const float2*>(s_dsum + 8 * j + cloc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float x = sc[e] * scale_log2;
          if (edge) {
            const int row = k0 + rloc + 8 * i, col = q0 + 8 * j + cloc + c;
            if (col >= t || row >= t || (causal && row > col)) x = kNegInf;
          }
          const float p = exp2f(x - (c ? l2.y : l2.x) * kLog2e);
          sc[e] = p;
          dp[e] = p * (dp[e] - (c ? d2.y : d2.x));  // dS^T
        }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_frag(sc, pa);   // P^T in dO's dtype
    to_frag(dp, dsa);  // dS^T in Q's dtype

    wg_fence();
    fence_acc(acc_v);
    fence_acc(acc_k);
    product_rs(acc_v, pa, ddo_s);  // dV += P^T dO (dO read MN-major)
    product_rs(acc_k, dsa, dq_s);  // dK += dS^T Q (Q read MN-major)
    wg_commit();
    wg_wait_all();
    fence_acc(acc_v);
    fence_acc(acc_k);
    fence_frag(pa);
    fence_frag(dsa);

    __syncthreads();
    if (tid == 0 && it + 2 < n) load_stage(s, iq0 + it + 2);
  }
  const size_t base = (size_t)bh * t * kD;
  store_tile(dk + base, acc_k, k0, t, scale);
  store_tile(dv + base, acc_v, k0, t, 1.0f);
}

// ------------------------------------------------------------- host --
// flat (BH * T) f32 row statistics, 64-element boxes. A box that runs past
// the head's T reads the next head's values (finite; those q columns are
// masked) or, past the end, zeros.
bool row_map(CUtensorMap* map, const float* ptr, int bh, int t) {
  const cuuint64_t dims[1] = {(cuuint64_t)bh * t};
  const cuuint64_t unused[1] = {16};  // a rank-1 map has no strides
  const cuuint32_t box[1] = {kTile}, step[1] = {1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
                   unused, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool dq_smem_set[kMaxDevices] = {};
bool dkv_smem_set[kMaxDevices] = {};

}  // namespace

// Called by flash_dq / flash_dkv (flash_attention.cu) for bf16 operands,
// after their argument checks. Return cudaGetLastError() after the launch,
// or an error code if the tensor maps cannot be made.
int flash_dq_bf16_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int bh, int t,
                       float scale, int causal, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map(&mq, q, bh, t, kTile) || !tile_map(&mk, k, bh, t, kTile) ||
      !tile_map(&mv, v, bh, t, kTile) || !tile_map(&mdo, dout, bh, t, kTile))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_dq_kernel_sm90), kSmemDq, dq_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nq = (t + kTile - 1) / kTile;
  flash_dq_kernel_sm90<<<dim3((unsigned)nq * bh), kThreads, kSmemDq, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), t, nq, scale, causal);
  return (int)cudaGetLastError();
}

// What the two kernels hold on this card (see kernel_resources), K3 into
// out[0..2], K4 into out[3..5]; called by flash_sm90_resources
// (flash_attention.cu) for chip_smoke.py's record only.
int flash_bwd_sm90_resources(int* out) {
  cudaError_t err = kernel_resources(reinterpret_cast<const void*>(flash_dq_kernel_sm90),
                                     kThreads, kSmemDq, dq_smem_set, out);
  if (err == cudaSuccess)
    err = kernel_resources(reinterpret_cast<const void*>(flash_dkv_kernel_sm90), kThreads,
                           kSmemDkv, dkv_smem_set, out + 3);
  return (int)err;
}

int flash_dkv_bf16_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int bh,
                        int t, float scale, int causal, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  if (!tile_map(&mq, q, bh, t, kTile) || !tile_map(&mk, k, bh, t, kTile) ||
      !tile_map(&mv, v, bh, t, kTile) || !tile_map(&mdo, dout, bh, t, kTile) ||
      !row_map(&mlse, lse, bh, t) || !row_map(&mdelta, delta, bh, t))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(flash_dkv_kernel_sm90),
                               kSmemDkv, dkv_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nk = (t + kTile - 1) / kTile;
  flash_dkv_kernel_sm90<<<dim3((unsigned)nk * bh), kThreads, kSmemDkv, stream>>>(
      mq, mk, mv, mdo, mlse, mdelta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t, nk, scale, causal);
  return (int)cudaGetLastError();
}
