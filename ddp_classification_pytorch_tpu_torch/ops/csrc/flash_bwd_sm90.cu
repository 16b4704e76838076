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
// The tensor-map encoder is fetched from the driver at run time
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of every tile (q and kv)
constexpr int kD = 64;          // head dimension: one 128-byte bf16 row
constexpr int kThreads = 128;   // one warpgroup
constexpr int kTileBytes = kTile * kD * 2;  // 8 KB, one swizzled bf16 tile
constexpr int kStatBytes = kTile * 4;       // one tile's lse or delta row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// ------------------------------------------------------ PTX helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one (64, 64) bf16 box at element (0, row, bh) of a (D, T, BH) map.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// TMA: 64 f32 at element `i` of a flat (BH * T) map.
__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int i) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(i)
      : "memory");
}

// wgmma shared-memory descriptor of a 1024-byte aligned (64 x 64) bf16 tile
// in the 128-byte swizzle TMA writes: 8-row groups 1024 bytes apart (SBO);
// the leading offset is unused at this width. K-major operands step 32
// bytes per k16 slice (+2 in the address field), MN-major ones 16 rows of
// 128 bytes (+128).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr uint64_t kKStep = 2;     // K-major: 32 bytes
constexpr uint64_t kMNStep = 128;  // MN-major: 2048 bytes

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (the asm statements are ordered; these tie each
// register to that order).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define WG_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WG_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (+)= A B, m64n64k16: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16: A from registers (the m64k16 fragment), B MN-major
// in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// c (+)= A B over k = 64 (four k16 slices), A and B K-major tiles.
__device__ __forceinline__ void product_ss(float (&c)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(c, a + kk * kKStep, b + kk * kKStep, kk > 0);
}

// c += A B over k = 64: A in registers, B an MN-major tile.
__device__ __forceinline__ void product_rs(float (&c)[32], const uint32_t (&a)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(c, a[kk], b + kk * kMNStep);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a 64x64 tile, rounded to bf16, as the register A
// operand of a product over its 64 columns: k16 slice kk is accumulator
// elements 8kk .. 8kk + 7, in order.
__device__ __forceinline__ void to_frag(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Write a 64x64 f32 accumulator, times `scale`, as bf16 rows [row0, row0+64)
// of a (T, 64) matrix; rows at or past t are not written.
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

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + 1023u) & ~1023u) - a);
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (D, T, BH) bf16 operand, (64, 64, 1) boxes, 128-byte swizzle; rows past T
// of a head read as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int bh, int t) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)t * kD * 2};
  const cuuint32_t box[3] = {kD, kTile, 1}, step[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute call is host work every launch would otherwise repeat. Two
// threads that race here both set it, which is harmless.
constexpr int kMaxDevices = 64;
cudaError_t allow_smem(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
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
  if (!tile_map(&mq, q, bh, t) || !tile_map(&mk, k, bh, t) || !tile_map(&mv, v, bh, t) ||
      !tile_map(&mdo, dout, bh, t))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_dq_kernel_sm90), kSmemDq, dq_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nq = (t + kTile - 1) / kTile;
  flash_dq_kernel_sm90<<<dim3((unsigned)nq * bh), kThreads, kSmemDq, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), t, nq, scale, causal);
  return (int)cudaGetLastError();
}

// What the two kernels hold on this card, for chip_smoke.py's record only
// (no launch path calls it): per kernel (K3, then K4) registers per thread,
// dynamic shared memory per block in bytes, and resident blocks per SM from
// the occupancy calculator.
extern "C" int flash_bwd_sm90_resources(int* out) {
  const void* kernels[2] = {reinterpret_cast<const void*>(flash_dq_kernel_sm90),
                            reinterpret_cast<const void*>(flash_dkv_kernel_sm90)};
  const int smem[2] = {kSmemDq, kSmemDkv};
  bool* set[2] = {dq_smem_set, dkv_smem_set};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = allow_smem(kernels[i], smem[i], set[i]);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernels[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 * i + 2], kernels[i],
                                                          kThreads, smem[i]);
    if (err != cudaSuccess) return (int)err;
    out[3 * i] = attr.numRegs;
    out[3 * i + 1] = smem[i];
  }
  return 0;
}

int flash_dkv_bf16_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int bh,
                        int t, float scale, int causal, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  if (!tile_map(&mq, q, bh, t) || !tile_map(&mk, k, bh, t) || !tile_map(&mv, v, bh, t) ||
      !tile_map(&mdo, dout, bh, t) || !row_map(&mlse, lse, bh, t) ||
      !row_map(&mdelta, delta, bh, t))
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
