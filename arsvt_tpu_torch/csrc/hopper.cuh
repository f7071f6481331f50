// Hopper (sm_90a) building blocks for kernels fed by the Tensor Memory
// Accelerator and multiplied by warpgroup MMAs, in inline PTX:
//   - tensor maps (host): a 2-D bf16 tensor cut into 64 x 64 boxes with
//     the 128-byte swizzle, encoded through the driver's
//     cuTensorMapEncodeTiled (found with cudaGetDriverEntryPoint, so the
//     library needs no -lcuda);
//   - mbarriers, TMA loads (cp.async.bulk.tensor) that complete on them,
//     and TMA stores from shared memory;
//   - wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulators in registers)
//     with both operands in shared memory, either major order, through
//     128-byte-swizzle matrix descriptors;
//   - setmaxnreg, to move registers from a producer warpgroup to consumers.
//
// Shared-memory tiles. A TMA box is 64 elements (128 bytes) of the
// contiguous dimension by 64 of the other, 8 KB, stored as 64 lines of 128
// bytes whose 16-byte chunks are permuted by XOR with (line % 8): eight
// lines make one 1,024-byte swizzle atom. An operand tile is two boxes, 16
// KB at a 1,024-byte aligned address:
//   K-major (k contiguous; rows x 64 k): boxes at rows r0 and r0 + 64,
//     one after the other, i.e. 128 lines of 128 bytes;
//   MN-major (m or n contiguous; 64 k x 128 mn): boxes at mn0 and mn0 +
//     64, each 64 k-lines of 64 mn-elements.
// `desc_k` and `desc_mn` give the wgmma descriptors of such tiles (see
// there).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBox = 64;                         // elements a box side
constexpr int kBoxBytes = kBox * kBox * 2;       // 8 KB of bf16
constexpr int kTileBytes = 2 * kBoxBytes;        // an operand tile
constexpr uint32_t kAtomBytes = 1024;            // 8 lines of 128 bytes

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 tensor (outer, inner), in 64 x 64 boxes
// with the 128-byte swizzle; a box past the edges reads zeros. inner must
// be a multiple of 8 (16-byte row strides) and ptr 16-byte aligned.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int outer,
                            int inner) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------- device side

// Shared memory is addressed by 32-bit shared-window addresses
// throughout: 64-bit generic pointers to barriers and ring slots would
// double the registers the kernels keep for them.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ void ld_shared_v4(uint32_t addr,
                                             uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float ld_shared_bf16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA transfers to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Cycles a wait may take before the kernel traps (about 2 s).
constexpr long long kWaitLimitCycles = 1ll << 32;

// The same, trapping once the wait has taken kWaitLimitCycles: for a
// producer, whose ring fills and stops it whenever any part of the
// pipeline stops, so a transfer that never lands ends the launch with an
// error instead of hanging it. (The consumers wait without the clock:
// its registers would spill their accumulators.)
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kWaitLimitCycles) __trap();
}

// The box of `map` at (inner c0, outer c1) into shared memory at dst; its
// bytes count towards the transfers bar expects.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A box of shared memory at src (laid out as tma_load leaves it) to `map`
// at (inner c0, outer c1); the parts past the tensor's edges are not
// written. Completion is tracked by bulk groups (commit, wait).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until the committed stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the async proxy
// (a TMA store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) of `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A 128-byte-swizzle matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor of 64 rows of a K-major tile at `tile` (a 1,024-byte
// aligned run of 128-byte lines, one line a row), 16 deep: 8-row groups
// lie one atom apart (SBO); LBO is unused for a swizzled K-major operand.
// Step k (16 deeper) starts kStepK * k bytes into each line (the hardware
// applies the swizzle to the address).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile) {
  return make_desc(tile, 16, kAtomBytes);
}
constexpr uint32_t kStepK = 32;

// The descriptor of an MN-major tile at `tile` (boxes of 64 mn at
// kBoxBytes from one another, 64 k-lines each), 16 deep: its two 8-line
// groups lie one atom apart (SBO), and 64-wide MN groups one box apart
// (LBO). Step k starts kStepMn * k bytes in (16 lines, 2 atoms).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile) {
  return make_desc(tile, kBoxBytes, kAtomBytes);
}
constexpr uint32_t kStepMn = 2 * kAtomBytes;

// A descriptor moved `bytes` on: the address field counts 16-byte units
// and does not carry below 256 KB.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait (the asynchronous MMA writes them behind
// its back).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), bf16 operands in shared
// memory; kTransA / kTransB: 0 for a K-major operand, 1 for MN-major.
// Accumulator layout: thread 32w + 4g + t of the warpgroup holds rows 16w
// + g (d[4j], d[4j + 1]) and 16w + g + 8 (d[4j + 2], d[4j + 3]) at columns
// 8j + 2t and 8j + 2t + 1, j = 0..15.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

}  // namespace hopper
