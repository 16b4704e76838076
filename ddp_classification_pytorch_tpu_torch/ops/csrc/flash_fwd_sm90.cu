// Flash attention forward for Hopper, bf16: K2 with wgmma products, the
// online softmax in registers and a TMA ring for K and V.
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package's
// `ops/flash_attention.py` (line 79; launched by `_flash_forward`) for bf16
// operands. f32 operands keep the CUDA-core `flash_fwd_kernel<float>` of
// `flash_attention.cu`, which also holds the C entry point `flash_fwd` that
// calls `flash_fwd_bf16_sm90` below.
//
// Function, as the Pallas kernel computes it (q, k, v (BH, T, 64) bf16):
//   S = Q K^T (f32) * scale, masked entries -1e30 (columns past T; above
//   the diagonal when causal); over the kv tiles, with f32 running max m
//   and normaliser l: m_new = max(m, rowmax S), p = exp(S - m_new),
//   l = l exp(m - m_new) + rowsum p (p in f32), acc = acc exp(m - m_new) +
//   bf16(p) V (f32); O = acc / l in bf16, lse = m + log l in f32.
// The scale and log2(e) are folded into one exp2 argument (an FMA on the
// raw score), computed by `ex2.approx.ftz`: it differs from
// expf(S * scale - m) by f32 rounding only (and flushes p below 2^-126,
// which no bf16 P V sum can see, to zero).
//
// What bounds it: at the ViT-B/16 shape (BH 384, T 1024, D 64) the two
// products do 2 * 2 * BH * T^2 * D = 1.03e11 operations, 0.104 ms at 989
// TFLOP/s bf16, against 0.060 ms for its four (BH, T, D) bf16 operands
// (201 MB) at 3.35 TB/s: the tensor cores bound it. The exponentials come
// close behind: BH * T^2 = 4.0e8 exp2 on the SMs' special-function units.
//
// What the design does about the four costs of the first (WMMA) version:
// 1. Products through wgmma. S = Q K^T is `wgmma.mma_async` m64n128k16 with
//    Q and K K-major in 128-byte-swizzled shared memory; O += P V is
//    m64n64k16 with P from registers and V MN-major (the transpose bit).
//    No product's result is staged through shared memory.
// 2. The online softmax in registers. S stays in the wgmma accumulator
//    layout: a thread owns two rows, and a row's max is two __shfl_xor
//    steps across the four lanes of a quad (its sum stays per thread until
//    the end). The bf16-rounded p, as it stands, is the register A operand
//    of O += P V (the m64k16 A fragment has the accumulator's layout). No
//    score touches shared memory.
// 3. A TMA ring, no __syncthreads in the loop. K and V tiles of 128 rows
//    stream through a ring of four stages, filled by `cp.async.bulk.tensor`
//    against a "full" mbarrier per stage and freed by an "empty" mbarrier
//    that every consumer warp arrives on. One producer warp issues every
//    load and runs ahead of the consumers, across work items too: Q has two
//    buffers, so the next item's Q and first K/V tiles load while the
//    consumers finish the current item and write its O.
// 4. Tiles, overlap and occupancy. A block covers 128 q rows with two
//    consumer warpgroups of 64 rows each, which share every K/V stage (half
//    the K/V traffic per q row of a 64-row block), plus the producer warp.
//    That is one block per SM, so the overlap is made inside the block:
//    each warpgroup issues S of tile j + 1 together with P V of tile j and
//    runs tile j + 1's exponentials while P V is in flight (in place in the
//    finished S accumulator; P and acc are written only after P V
//    completes, so ptxas never serialises the products), and the two
//    warpgroups take turns to issue their products (named barriers 1 and
//    2), so one's softmax runs under the other's products. The grid is
//    persistent: one block per SM walks over the work items.
//
// Work items are (128-row q tile, bh), ordered head by head, so the blocks
// in flight share a few heads' K/V in L2; within a head the q tiles go last
// to first, so causal blocks take their longest items first. Causal items
// stop at the diagonal tile and mask only the tiles that cross it or T;
// tiles above it are never loaded. Rows past T load as zeros (the 3-D
// tensor map) and are not written. Each output row is written by one
// block, no atomics: bitwise deterministic.

#include "flash_sm90.cuh"

namespace {

constexpr int kBlockQ = 128;       // q rows per work item: two warpgroups of 64
constexpr int kKv = 128;           // kv rows per streamed tile (== kBlockQ)
constexpr int kStages = 4;         // K/V ring depth
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kFwdThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kQBytes = kBlockQ * kD * 2;              // 16 KB
constexpr int kKvBytes = kKv * kD * 2;                 // 16 KB, K or V
constexpr int kStageBytes = 2 * kKvBytes;              // K, V
// Shared-memory plan (offsets from a 1024-byte aligned base):
// Q 0 | Q 1 | stage 0: K, V | ... | stage 3 | barriers: qfull[2],
// qempty[2], full[4], empty[4]
constexpr int kRing = 2 * kQBytes;
constexpr int kBars = kRing + kStages * kStageBytes;
constexpr int kSmemFwd = kBars + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// 2^x on the special-function unit (denormal results flush to zero).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x 128 score tile, in place in the
// accumulator layout. `sc` holds the raw scores Q K^T and on return the f32
// p = exp(S * scale - m_new); `m` is the running max of the raw scores of
// this thread's two rows (scale > 0, so the max commutes with scaling), `l`
// this thread's share of the running normaliser, `corr` exp(m_old - m_new)
// per row. Rows row0 and row0 + 8, columns col0 + 8j (+1).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge, int row0,
                                             int col0, int t, int causal,
                                             float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = row0 + 8 * i, col = col0 + 8 * j + c;
          if (col >= t || (causal && col > row)) sc[4 * j + 2 * i + c] = kNegInf;
        }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2_ftz((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    neg[i] = -mx[i] * scale_log2;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float pe = ex2_ftz(fmaf(sc[e], scale_log2, neg[i]));
        l[i] += pe;  // summed in f32, before rounding
        sc[e] = pe;
      }
}

__device__ __forceinline__ void rescale(float (&acc)[32], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[4 * j + 2 * i + c] *= corr[i];
}

// ------------------------------------------------------------------ K2 --
// Block b takes the work items b, b + grid, b + 2 grid, ... of `items` =
// nq * BH; item -> (q tile nq - 1 - item % nq, bh = item / nq).
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int t,
                      int nq, int items, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar_qfull = s_base + kBars, bar_qempty = bar_qfull + 16;
  const uint32_t bar_full = bar_qempty + 16, bar_empty = bar_full + 8 * kStages;
  const int nk = (t + kKv - 1) / kKv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto item_tile = [&](int item) { return nq - 1 - item % nq; };
  auto item_n = [&](int iq) { return causal ? min(nk, iq + 1) : nk; };  // kv tiles

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_qfull + 8 * b, 1);
      mbar_init(bar_qempty + 8 * b, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      int tile = 0, local = 0;  // ring tiles and items this block has loaded
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
        const int iq = item_tile(item), bh = item / nq, n = item_n(iq);
        const int qb = local & 1;
        if (local >= 2) mbar_wait(bar_qempty + 8 * qb, ((local >> 1) - 1) & 1);
        mbar_expect_tx(bar_qfull + 8 * qb, kQBytes);
        tma_tile(s_base + qb * kQBytes, &tm_q, bar_qfull + 8 * qb, iq * kBlockQ, bh);
        for (int j = 0; j < n; ++j, ++tile) {
          const int s = tile % kStages;
          if (tile >= kStages) mbar_wait(bar_empty + 8 * s, (tile / kStages - 1) & 1);
          const uint32_t st = s_base + kRing + s * kStageBytes;
          mbar_expect_tx(bar_full + 8 * s, kStageBytes);
          tma_tile(st, &tm_k, bar_full + 8 * s, j * kKv, bh);
          tma_tile(st + kKvBytes, &tm_v, bar_full + 8 * s, j * kKv, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp >> 2;
  const int cq = 2 * (lane & 3);
  const float scale_log2 = scale * kLog2e;
  auto stage = [&](int tile) { return s_base + kRing + (tile % kStages) * kStageBytes; };
  auto wait_full = [&](int tile) {
    mbar_wait(bar_full + 8 * (tile % kStages), (tile / kStages) & 1);
  };
  auto release = [&](uint32_t bar) {  // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int base = 0, local = 0;  // the ring index of the item's first kv tile
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
    const int iq = item_tile(item), bh = item / nq, n = item_n(iq);
    const int wq0 = iq * kBlockQ + 64 * wg;
    const int row0 = wq0 + 16 * (warp & 3) + (lane >> 2);  // and row0 + 8
    const int qb = local & 1;
    const uint64_t dq = tile_desc(s_base + qb * kQBytes + wg * (kQBytes / 2));
    auto edge = [&](int j) {  // kv tile j crosses T or the diagonal
      const int k0 = j * kKv;
      return k0 + kKv > t || (causal && k0 + kKv - 1 > wq0);
    };
    auto release_stage = [&](int j) { release(bar_empty + 8 * ((base + j) % kStages)); };

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];
    float acc[32], sc[64];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    mbar_wait(bar_qfull + 8 * qb, (local >> 1) & 1);

    wait_full(base);
    wg_fence();
    product_ss(sc, dq, tile_desc(stage(base)));  // S of tile 0
    wg_commit();
    wg_wait_all();
    fence_acc(sc);
    softmax_tile(sc, m, l, corr, edge(0), row0, cq, t, causal, scale_log2);
    to_frag(sc, p);                // P in V's dtype
    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
    for (int j = 0; j + 1 < n; ++j) {
      wait_full(base + j + 1);
      fence_acc(acc);
      fence_frag(p);
      fence_acc(sc);
      named_sync(1 + wg);  // this warpgroup's turn to issue
      wg_fence();
      product_ss(sc, dq, tile_desc(stage(base + j + 1)));  // S of tile j + 1
      wg_commit();
      product_rs(acc, p, tile_desc(stage(base + j) + kKvBytes));  // O += P V, tile j
      wg_commit();
      named_arrive(2 - wg);  // the other warpgroup's turn
      wg_wait<1>();          // S done, P V in flight
      fence_acc(sc);
      softmax_tile(sc, m, l, corr, edge(j + 1), row0, (j + 1) * kKv + cq, t, causal,
                   scale_log2);
      wg_wait_all();
      fence_acc(acc);
      fence_frag(p);
      release_stage(j);
      rescale(acc, corr);
      to_frag(sc, p);
    }
    fence_acc(acc);
    fence_frag(p);
    named_sync(1 + wg);
    wg_fence();
    product_rs(acc, p, tile_desc(stage(base + n - 1) + kKvBytes));  // the last P V
    wg_commit();
    // warpgroup 1's last turn: it hands none back, as warpgroup 0 issues
    // nothing more in this item (each barrier sees n turns per item)
    if (wg == 0) named_arrive(2);
    wg_wait_all();
    fence_acc(acc);
    fence_frag(p);
    release_stage(n - 1);
    release(bar_qempty + 8 * qb);
    base += n;

    // O = acc / l in bf16, lse = m * scale + log l, rows < T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* ob = o + (size_t)bh * t * kD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= t) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * kD + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / l[i], acc[4 * j + 2 * i + 1] / l[i]);
      if ((lane & 3) == 0) lse[(size_t)bh * t + row] = m[i] * scale + logf(l[i]);
    }
  }
}

// ------------------------------------------------------------- host --
bool fwd_smem_set[kMaxDevices] = {};

// SMs of the current device, read once per device.
int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && count[dev] > 0) return count[dev];
  int c = 0;
  if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) count[dev] = c;
  return c;
}

}  // namespace

// Called by flash_fwd (flash_attention.cu) for bf16 operands, after its
// argument checks. Returns cudaGetLastError() after the launch, or an error
// code if the tensor maps cannot be made.
int flash_fwd_bf16_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                        int bh, int t, float scale, int causal, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tile_map(&mq, q, bh, t, kBlockQ) || !tile_map(&mk, k, bh, t, kKv) ||
      !tile_map(&mv, v, bh, t, kKv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(flash_fwd_kernel_sm90), kSmemFwd, fwd_smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nq = (t + kBlockQ - 1) / kBlockQ, items = nq * bh, sms = sm_count();
  if (sms <= 0) return (int)cudaErrorNoDevice;
  flash_fwd_kernel_sm90<<<dim3((unsigned)(sms < items ? sms : items)), kFwdThreads,
                          kSmemFwd, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse,
                                              t, nq, items, scale, causal);
  return (int)cudaGetLastError();
}

// What the kernel holds on this card (see kernel_resources) into out[0..2];
// called by flash_sm90_resources (flash_attention.cu) for chip_smoke.py's
// record only.
int flash_fwd_sm90_resources(int* out) {
  return (int)kernel_resources(reinterpret_cast<const void*>(flash_fwd_kernel_sm90),
                               kFwdThreads, kSmemFwd, fwd_smem_set, out);
}
