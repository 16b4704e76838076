// Building blocks shared by the Hopper flash-attention kernels: K2 in
// `flash_fwd_sm90.cu`, K3 and K4 in `flash_bwd_sm90.cu`.
//
// - mbarriers and TMA tile loads (`cp.async.bulk.tensor`) into shared memory
//   in the 128-byte swizzle;
// - wgmma shared-memory descriptors of such tiles, and `wgmma.mma_async`
//   bf16 -> f32 products: m64n64k16 and m64n128k16 with A and B K-major in
//   shared memory, m64n64k16 with A from registers and B MN-major;
// - the accumulator-to-A-fragment conversion that keeps scores in
//   registers;
// - on the host: the (D, T, BH) tensor maps (the encoder fetched from the
//   driver at run time, so no library needs -lcuda), the once-per-device
//   opt-in to more than 48 KB of dynamic shared memory, and a kernel's
//   registers, shared memory and resident blocks for the smoke's record.
//
// Accumulator layout of an m64nN f32 tile (wgmma): thread (warp w of the
// warpgroup, lane l) owns rows 16w + l/4 and 16w + l/4 + 8 and, of each
// 8-column group j, columns 8j + 2(l%4) and 8j + 2(l%4) + 1, held in
// d[4j + 2i + c] (i: the row, c: the column within the pair).
//
// Everything has internal linkage: each source that includes this header
// gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;  // head dimension: one 128-byte bf16 row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

// TMA: one (64, rows) bf16 box at element (0, row, bh) of a (D, T, BH) map
// (rows as the map was made with, see tile_map).
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a 1024-byte aligned bf16 tile of
// 128-byte rows in the 128-byte swizzle TMA writes: 8-row groups 1024 bytes
// apart (SBO); the leading offset is unused at this width. K-major operands
// step 32 bytes per k16 slice (+2 in the address field), MN-major ones 16
// rows of 128 bytes (+128).
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
template <int N>
__device__ __forceinline__ void wg_wait() {  // at most N groups still pending
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (the asm statements are ordered; these tie each
// register to that order).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K16>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K16][4]) {
#pragma unroll
  for (int k = 0; k < K16; ++k)
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
#define WG_ACC64(d)                                                           \
  WG_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define WG_D64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

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

// d (+)= A B, m64n128k16: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
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

// c = A B over k = 64 (four k16 slices), A and B K-major tiles; c is an
// m64n64 (32 floats) or m64n128 (64 floats) accumulator.
template <int N>
__device__ __forceinline__ void product_ss(float (&c)[N], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(c, a + kk * kKStep, b + kk * kKStep, kk > 0);
}

// c += A B over k = 16 K16: A in registers, B an MN-major tile of 16 K16
// rows.
template <int K16>
__device__ __forceinline__ void product_rs(float (&c)[32], uint32_t (&a)[K16][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) wgmma_rs(c, a[kk], b + kk * kMNStep);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a 64 x 16 K16 tile, rounded to bf16, as the
// register A operand of a product over its columns: k16 slice kk is
// accumulator elements 8kk .. 8kk + 7, in order (the m64k16 A fragment has
// the accumulator's layout).
template <int K16>
__device__ __forceinline__ void to_frag(const float (&d)[8 * K16],
                                        uint32_t (&a)[K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + 1023u) & ~1023u) - a);
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

// (D, T, BH) bf16 operand, (64, rows, 1) boxes, 128-byte swizzle; rows past
// T of a head read as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int bh, int t, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)t * kD * 2};
  const cuuint32_t box[3] = {kD, (cuuint32_t)rows, 1}, step[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

// Registers per thread, dynamic shared memory per block (bytes) and
// resident blocks per SM (the occupancy calculator) of one kernel, into
// out[0..2].
cudaError_t kernel_resources(const void* kernel, int threads, int smem, bool* done,
                             int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = smem;
  return cudaSuccess;
}

}  // namespace
