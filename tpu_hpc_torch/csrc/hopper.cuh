// Hopper (sm_90a) building blocks shared by flash_attention.cu and
// paged_attention.cu: the common constants and conversions, wgmma
// descriptors and instructions, mbarriers, TMA tile loads and the
// tensor-map encoder.
//
// Shared-memory tiles hold 16-bit [rows][kD] operands as kD / 64
// "panels" of 64 columns (128 bytes a row), each panel laid out as TMA's
// 128-byte swizzle writes it and as wgmma's 128-byte-swizzle descriptors
// read it: row r at r * 128 bytes, its 16-byte chunk c at chunk
// c ^ (r % 8). A tile of R rows keeps panel p at p * R * 128. The
// swizzle is a function of the address, so any box that starts on an
// 8-row (1024-byte) boundary of a tile lands exactly where one box of
// the whole tile would have put its rows.
//
// Everything here sits in an unnamed namespace: each source that
// includes it gets its own internal copy, and the library exports only
// the sources' extern "C" entry points.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

// kernels/attention.py MASK_VALUE: finite, so a fully masked row keeps
// m = MASK_VALUE and the m_safe rule zeroes its probabilities.
constexpr float kMaskValue = -1e30f;

// dtype codes shared with kernels/attention.py::DTYPE_CODES.
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3 };

constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr int kPanelRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// max(a, b) that keeps a NaN, as jnp.max and jnp.maximum do (fmaxf
// returns the other operand). A NaN score the mask leaves visible makes
// its row's running max NaN, so alpha, l, O and lse all turn NaN on any
// tile, edge or not: the row comes out NaN, as from the JAX kernel.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory. Above
// 48 KB that takes an opt-in, made once per kernel and device for the
// whole 227 KB (the opt-in is a cap; a launch's occupancy follows the
// bytes it asks for), so later launches skip cudaFuncSetAttribute.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> granted;
  const std::pair<const void*, int> key{reinterpret_cast<const void*>(kernel), dev};
  std::lock_guard<std::mutex> lock(mu);
  if (granted.count(key) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) granted.insert(key);
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory
// (start address, leading and stride byte offsets, layout type 1).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Rows [r0, r0 + 64) of a tile of `rows` rows, k-step kk (columns
// 16 kk .. 16 kk + 15) read K-major: the operand's k dimension is the
// tile's column. 8-row groups 1024 bytes apart; the k-step moves 32
// bytes inside the swizzled row (or to the next panel).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int r0, int kk) {
  return gmma_desc(tile + (kk >> 2) * rows * kPanelRowBytes +
                       r0 * kPanelRowBytes + (kk & 3) * 32,
                   16, 1024);
}

// Rows 16 kk .. 16 kk + 15 of a tile of `rows` rows as the k dimension
// and all its columns as n, read MN-major (the columns contiguous):
// the next 64 columns one panel (rows * 128 bytes) on, the next 8 rows
// 1024 bytes on.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  return gmma_desc(tile + kk * 16 * kPanelRowBytes, rows * kPanelRowBytes,
                   1024);
}

// An mbarrier expecting `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to
// the TMA unit (call from the initialising thread, then a barrier).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes)
               : "memory");
}

// One plain arrival.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity)
      : "memory");
}

// Orders this thread's plain shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Loads one box per 64-column panel from a 4-D tensor map at
// coordinates (64 p, c1, c2, c3) into a tile of `tile_rows` rows at
// `dst` (panel p at dst + p * tile_rows * 128). For a [B, S, H, D]
// array (bshd_map below) the coordinates are (column, head, row,
// batch). Rows past the array and columns past D arrive as zeros;
// completion of the box bytes is counted on `bar`.
template <int kD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c1, int c2, int c3,
                                         int tile_rows) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst + p * tile_rows * kPanelRowBytes),
           "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * p), "r"(c1), "r"(c2),
           "r"(c3), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Tells the compiler the registers change here, so no read of an
// accumulator (or of an A fragment's register) moves across a wgmma wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two floats rounded to T and packed low-first, as one 32-bit register
// of a wgmma A fragment.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t out;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    out = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    out = *reinterpret_cast<const uint32_t*>(&v);
  }
  return out;
}

// The wgmma instructions the kernels issue. Accumulator layout of
// m64nNk16 (fp32): warp w of the warpgroup holds rows 16 w .. 16 w + 15;
// lane l holds, for each 8-column group j, d[4j] and d[4j + 1] at row
// l / 4, columns 8j + 2 (l % 4) + {0, 1}, and d[4j + 2], d[4j + 3] at row
// l / 4 + 8. So each row lives in the 4 lanes of one quad. The A
// fragment of a register-sourced product (k-step of 16 columns) is that
// layout for two groups, packed in pairs: so the packed accumulator of
// one product is the A operand of the next with no data movement. SS: A
// and B from shared memory, both K-major. RS: A from registers, B
// MN-major (imm-trans-b 1).

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
}

// dQ / dK / dV / O += A . B with N = kD (the head-dim variant).
template <typename T, int kD>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[kD / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (kD == 64) {
    wgmma_rs_n64<T>(d, a, db, 1);
  } else {
    wgmma_rs_n128<T>(d, a, db, 1);
  }
}

// 16-bit tensor-map element type of T.
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against libcuda; null where the installed CUDA lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map over a 16-bit [B, S, H, D] array whose boxes are 64
// columns by `rows` rows of one (batch, head), 128-byte swizzled;
// rows past S and columns past D read as zeros. (The paged pool
// (blocks, block_size, kv_heads, d) is such an array, with pages as
// batches; so is a (heads, rows, d) array, read as [heads, rows, 1, d].)
template <typename T>
cudaError_t bshd_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
                     int d, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * h, 2ull * d * h * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, tma_type<T>(), 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// =====================================================================
// The online-softmax walk of a 16-bit flash forward, shared by the
// training forward (flash_attention.cu) and the paged chunked prefill
// (paged_attention.cu): one consumer warpgroup's 64 query rows against
// a stream of 64-key K and V tiles. The kernels differ only in who
// loads the tiles (a producer warp, or for an int8 pool a converter
// warpgroup) and in the mask, which may also carry per-key scales
// (walk_scaled below).
//
// Ring: stage st holds a K tile at k + st * walk_tile_bytes<kD>() and a
// V tile at v + st * walk_tile_bytes<kD>() (64 rows x kD, the panels above),
// with three mbarriers 8 bytes apart per stage: full_k and full_v (one
// producer arrival plus the TMA bytes) and empty (one arrival per
// consumer warpgroup once its products have read the stage).
//
// Per tile, in registers only:
//   S = Q . K^T                      SS wgmma, 64 x 64 fp32
//   m, P = exp(S - m), l, alpha      the quad's shuffles give the row max
//   O = alpha O + P . V              P packed to T as the A fragment of
//                                    an RS wgmma, V read MN-major
// and the next tile's S is issued before this tile's P . V, so the
// softmax of tile t runs while the tensor cores do P . V of tile t - 1
// (wgmma.wait_group 1). Scores are taken in log2 units (scale * log2 e
// folded into one multiply, exp2); masked scores become the finite
// kMaskValue, and the m_safe rule of the Pallas kernels keeps a row that
// has seen no key at P = 0, alpha = 0.
// =====================================================================

constexpr int kWalkKeys = 64;  // keys per streamed tile

template <int kD>
__host__ __device__ constexpr int walk_tile_bytes() {
  return kWalkKeys * kD * 2;
}

struct WalkRing {
  uint32_t k, v;                  // stage 0's K and V tiles
  uint32_t full_k, full_v, empty;  // stage 0's barriers (+ 8 st)
  int stages;
};

// This thread's two rows of one warpgroup's 64: the running max m (log2
// units, kMaskValue until a key is seen), this thread's share of the
// row sum l (the quad's four shares add up to it), and O (kD / 2 fp32).
template <int kD>
struct WalkRows {
  float o[kD / 2];
  float m[2];
  float l[2];
};

// Key index, within its 64-key tile, of accumulator element i of lane.
__device__ __forceinline__ int walk_key(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Frees stage st of the ring for the producer: one arrival per
// warpgroup, after the warpgroup's products that read it completed.
__device__ __forceinline__ void walk_release(const WalkRing& ring, int st) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(ring.empty + 8 * st);
}

// A warpgroup that needs no more tiles still frees tiles [from, to) in
// order, each once it has arrived, so the ring's phases keep step with
// the warpgroup that does need them.
__device__ __forceinline__ void walk_skip(const WalkRing& ring, int from,
                                          int to) {
  for (int kt = from; kt < to; ++kt) {
    const int st = kt % ring.stages;
    mbar_wait(ring.full_v + 8 * st, (kt / ring.stages) & 1);
    walk_release(ring, st);
  }
}

// Per-key scales of a Mask policy. A mask with members s_scale(kt, key)
// and p_scale(kt, key) (key: the key's index 0-63 within tile kt) has
// them applied by the walk: S of that key is multiplied by s_scale
// before the softmax, and P by p_scale after the row sum l is taken and
// before P is packed for P . V -- an int8 pool's page scales, with the
// tiles holding the raw integers. A mask without them (the 16-bit walks)
// compiles to the walk it had before the hooks existed.
template <typename Mask, typename = void>
struct walk_scaled : std::false_type {};
template <typename Mask>
struct walk_scaled<Mask, std::void_t<decltype(&Mask::s_scale),
                                     decltype(&Mask::p_scale)>>
    : std::true_type {};

// One tile's online-softmax step on S (raw dot products in, P out, in
// place): updates m and l and returns alpha per row. The mask is
// applied element by element (mask.sees(r, key): may this thread's row
// r see key?) only where mask.edge(kt) says tile kt needs it.
template <typename Mask>
__device__ __forceinline__ void walk_softmax(float (&s)[32], int kt,
                                             float scale2, const Mask& mask,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  constexpr bool kScaled = walk_scaled<Mask>::value;
  const int lane = threadIdx.x & 31;
  const bool edge = mask.edge(kt);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x;
    if constexpr (kScaled) {
      x = s[i] * (mask.s_scale(kt, walk_key(i, lane)) * scale2);
    } else {
      x = s[i] * scale2;
    }
    if (edge && !mask.sees(r, kt * kWalkKeys + walk_key(i, lane)))
      x = kMaskValue;
    s[i] = x;
    mx[r] = fmax_nan(mx[r], x);
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmax_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_safe[r] = mx[r] <= kMaskValue * 0.5f ? 0.f : mx[r];
    alpha[r] = exp2f(m[r] - m_safe[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = exp2f(s[i] - m_safe[r]);
    if (edge) p = s[i] > kMaskValue * 0.5f ? p : 0.f;
    s[i] = p;
    sum[r] += p;
  }
  l[0] = alpha[0] * l[0] + sum[0];
  l[1] = alpha[1] * l[1] + sum[1];
  if constexpr (kScaled) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= mask.p_scale(kt, walk_key(i, lane));
  }
}

// P (fp32, accumulator layout) rounded to T as four k-steps of A
// fragments.
template <typename T>
__device__ __forceinline__ void walk_pack(uint32_t (&pf)[4][4],
                                          const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pf[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// S = Q . K^T for this warpgroup's rows [r0, r0 + 64) of a Q tile of
// q_rows rows, against the K tile at k.
template <typename T, int kD>
__device__ __forceinline__ void walk_scores(float (&s)[32], uint32_t q_tile,
                                            int q_rows, int r0, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n64<T>(s, kmajor_desc(q_tile, q_rows, r0, kk),
                    kmajor_desc(k, kWalkKeys, 0, kk), kk > 0);
}

template <typename T, int kD>
__device__ __forceinline__ void walk_pv(float (&o)[kD / 2],
                                        const uint32_t (&pf)[4][4],
                                        uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kWalkKeys / 16; ++kk)
    wgmma_rs_nd<T, kD>(o, pf[kk], mnmajor_desc(v, kWalkKeys, kk));
}

// Tiles [0, n_tiles) of the ring through the online softmax into rows
// (which must start with o = 0, m = kMaskValue, l = 0). Every tile read
// is freed; the caller frees tiles it never reads with walk_skip.
template <typename T, int kD, typename Mask>
__device__ __forceinline__ void walk(WalkRows<kD>& rows, uint32_t q_tile,
                                     int q_rows, int r0, const WalkRing& ring,
                                     int n_tiles, float scale2,
                                     const Mask& mask) {
  if (n_tiles <= 0) return;
  constexpr int kTile = walk_tile_bytes<kD>();
  float s[32], alpha[2];
  uint32_t pf[4][4];

  mbar_wait(ring.full_k, 0);
  wgmma_fence();
  walk_scores<T, kD>(s, q_tile, q_rows, r0, ring.k);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  walk_softmax(s, 0, scale2, mask, rows.m, rows.l, alpha);  // O is still 0
  walk_pack<T>(pf, s);

  for (int kt = 1; kt < n_tiles; ++kt) {
    const int st = kt % ring.stages;
    const int pst = (kt - 1) % ring.stages;
    mbar_wait(ring.full_k + 8 * st, (kt / ring.stages) & 1);
    wgmma_fence();
    walk_scores<T, kD>(s, q_tile, q_rows, r0, ring.k + st * kTile);
    wgmma_commit();
    mbar_wait(ring.full_v + 8 * pst, ((kt - 1) / ring.stages) & 1);
    walk_pv<T, kD>(rows.o, pf, ring.v + pst * kTile);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt; P . V of tile kt - 1 may still run
    reg_fence(s);
    walk_softmax(s, kt, scale2, mask, rows.m, rows.l, alpha);
    wgmma_wait<0>();
    reg_fence(rows.o);
    reg_fence(pf);
    walk_release(ring, pst);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) rows.o[i] *= alpha[(i >> 1) & 1];
    walk_pack<T>(pf, s);
  }
  const int last = n_tiles - 1;
  const int lst = last % ring.stages;
  mbar_wait(ring.full_v + 8 * lst, (last / ring.stages) & 1);
  wgmma_fence();
  walk_pv<T, kD>(rows.o, pf, ring.v + lst * kTile);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(rows.o);
  reg_fence(pf);
  walk_release(ring, lst);
}

// The finished rows: l summed over the quad, the l_safe rule, and the
// natural-log lse (exactly kMaskValue for a row that saw no key).
// Writes out[row][col] for this thread's column pairs of its two rows
// (row_ptr[r] null for a row past the end) and returns lse per row.
template <typename T, int kD>
__device__ __forceinline__ void walk_finish(WalkRows<kD>& rows, T* const (&row_ptr)[2],
                                            int d, float (&lse)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = rows.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    lse[r] = rows.m[r] <= kMaskValue * 0.5f ? kMaskValue
                                            : rows.m[r] * kLn2 + logf(l_safe);
    const float inv = 1.f / l_safe;
    if (row_ptr[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < d)
        *reinterpret_cast<uint32_t*>(row_ptr[r] + col) =
            pack2<T>(rows.o[4 * j + 2 * r] * inv, rows.o[4 * j + 2 * r + 1] * inv);
    }
  }
}

}  // namespace
