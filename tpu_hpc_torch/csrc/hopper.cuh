// Hopper (sm_90a) building blocks shared by flash_attention.cu and
// paged_attention.cu: the common constants and conversions, wgmma
// descriptors and instructions, mbarriers, thread block clusters, TMA
// tile loads (multicast into a cluster too) and the tensor-map encoder.
//
// Shared-memory tiles hold [rows][kD] operands as "panels" of 128 bytes
// a row -- 64 columns of a 16-bit tile (kD / 64 panels), 32 of an fp32
// (TF32) tile (kD / 32 panels) -- each panel laid out as TMA's 128-byte
// swizzle writes it and as wgmma's 128-byte-swizzle descriptors read
// it: row r at r * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8).
// A tile of R rows keeps panel p at p * R * 128. The swizzle is a
// function of the address, so any box that starts on an 8-row
// (1024-byte) boundary of a tile lands exactly where one box of the
// whole tile would have put its rows.
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

// Calls f with the instantiation (std::integral_constant kD) that holds
// head dim d: 64, 128 or 256 columns, none wider than kMaxD. A d below
// kD is padded: its columns past d are zeros in shared memory.
template <int kMaxD = 256, typename F>
int by_head_dim(int d, F&& f) {
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if constexpr (kMaxD > 128) {
    if (d > 128) return f(std::integral_constant<int, 256>{});
  }
  return f(std::integral_constant<int, 128>{});
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

// Rows [r0, r0 + 64) of a tile of `rows` rows, k-step kk read K-major:
// the operand's k dimension is the tile's column. A k-step is 32 bytes
// whatever the element: 16 columns of a 16-bit tile (k16), 8 of a TF32
// one (k8), so four k-steps fill a panel row either way and the same
// byte offsets serve both (kD / 16 k-steps of a 16-bit tile, kD / 8 of
// an fp32 one). 8-row groups 1024 bytes apart; the k-step moves 32
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

// Thread block clusters. A kernel launched with clusters of c blocks
// (flash_attention.cu's kD 256 forward and dq: the query heads of one KV
// group) reaches the shared memory of every block of its cluster: the
// same CTA-relative address names the same bytes in each. cluster_rank
// is this block's index in its cluster (0 .. c - 1).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// One arrival on the mbarrier at CTA-relative address `bar` of block
// `rank` of this block's cluster (this block's own where rank is its
// own): a ring stage this thread's warpgroup has finished reading --
// its wgmma reads complete (wgmma.wait_group) -- is free for the TMA
// loads of that block's producer, which only its barrier orders.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(rank)
      : "memory");
}

// Every thread of every block of the cluster meets here: after the
// barriers' initialisation (before any block multicasts into another's
// ring or arrives on its barriers), and before a block exits (while a
// peer may still arrive on its barriers).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Orders this thread's plain shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 64-column box (panel) of a 4-D tensor map at coordinates (c0,
// c1, c2, c3), written at `dst` in every block of the cluster that
// `mask` names (bit r: block r), each block's mbarrier at `bar`
// counting the box's bytes: one read from L2 feeds them all.
__device__ __forceinline__ void tma_box_multicast(uint32_t dst,
                                                  const CUtensorMap* map,
                                                  uint32_t bar, int c0, int c1,
                                                  int c2, int c3,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar), "h"(mask)
      : "memory");
}

// One warpgroup's arrival on the empty barrier `bar` of a ring stage it
// has finished reading (after the products that read it completed), in
// each of the `peers` blocks of the cluster that share the ring (peers
// 1: this block's own).
__device__ __forceinline__ void free_stage(uint32_t bar, int peers) {
  const int t = threadIdx.x & 127;
  if (peers == 1) {
    if (t == 0) mbar_arrive(bar);
    return;
  }
  if (t < peers) mbar_arrive_remote(bar, t);  // one thread a block, at once
}

// Loads one box per 64-column panel from a 4-D tensor map at
// coordinates (64 p, c1, c2, c3) into a tile of `tile_rows` rows at
// `dst` (panel p at dst + p * tile_rows * 128). For a [B, S, H, D]
// array (bshd_map below) the coordinates are (column, head, row,
// batch). Rows past the array and columns past D arrive as zeros;
// completion of the box bytes is counted on `bar`. `panels` (at most
// kD / 64): only the first panels load -- a padded head dim's panels
// wholly past D are left to the caller, which zeroes them once.
template <int kD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c1, int c2, int c3,
                                         int tile_rows, int panels = kD / 64) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    if (p >= panels) break;
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst + p * tile_rows * kPanelRowBytes),
           "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * p), "r"(c1), "r"(c2),
           "r"(c3), "r"(bar)
        : "memory");
  }
}

// tma_tile into the tile at `dst` of every block of a cluster of
// `peers` that share it: panel p's box is loaded by block (first + p) %
// peers alone and multicast into all of them, each block's barrier
// `bar` counting its bytes -- one read from L2 for the cluster. The
// caller offsets `first` between the tiles of one stage so the boxes
// spread over the blocks. peers 1: tma_tile.
template <int kD>
__device__ __forceinline__ void tma_tile_shared(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int c1, int c2,
                                                int c3, int tile_rows,
                                                int panels, int peers,
                                                uint32_t rank, int first) {
  if (peers == 1) {
    tma_tile<kD>(dst, map, bar, c1, c2, c3, tile_rows, panels);
    return;
  }
  const uint16_t all = static_cast<uint16_t>((1u << peers) - 1u);
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    if (p >= panels) break;
    if ((first + p) % peers == static_cast<int>(rank))
      tma_box_multicast(dst + p * tile_rows * kPanelRowBytes, map, bar, 64 * p,
                        c1, c2, c3, all);
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

// Two neighbouring outputs (lo first) in T: one 4-byte store of a packed
// 16-bit pair, or one 8-byte store of a float pair.
template <typename T>
__device__ __forceinline__ void store2(T* at, float lo, float hi) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(at) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(at) = pack2<T>(lo, hi);
  }
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

// SS m64n32k16: the split dk/dv's half of a score tile (hopper.cuh's
// accumulator layout, N 32).
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// dQ / dK / dV / O += A . B with N = kD (the head-dim variant). kD 256
// is two N 128 products: columns 128-255 of B start `half_bytes` past
// its first column (two 64-column panels on), and their accumulators
// are d[64 ..], which is where an N 256 product keeps them.
template <typename T, int kD>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[kD / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db,
                                            uint32_t half_bytes = 0) {
  if constexpr (kD == 64) {
    wgmma_rs_n64<T>(d, a, db, 1);
  } else if constexpr (kD == 128) {
    wgmma_rs_n128<T>(d, a, db, 1);
  } else {
    static_assert(kD == 256, "head-dim variants: 64, 128, 256");
    wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&d[0]), a, db, 1);
    // The descriptor's start address is bits 0-13 (address / 16); a
    // shared-memory address stays below 2^18, so adding cannot carry.
    wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                     db + (half_bytes >> 4), 1);
  }
}

// The widest load, in bytes (16, 8, 4, 2 or 1), that every row of an
// array at `base` whose rows (of any head) are `row_bytes` apart allows
// at each 16-byte column chunk: a head dim whose rows are not a whole
// number of 16 bytes (a bf16 row of 36 columns is 72 bytes) puts its
// rows, and so its chunks, on 8-, 4-, 2- or 1-byte boundaries.
__host__ __device__ __forceinline__ int vec_bytes(const void* base,
                                                  long long row_bytes) {
  const uint32_t x = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(base)) |
                     static_cast<uint32_t>(row_bytes) | 16u;
  return static_cast<int>(x & (0u - x));
}

// `bytes` bytes (at most 16, a multiple of vw, which divides p's
// address) from global memory at p, as the low bytes of a 16-byte chunk
// whose other bytes are zeros, in vw-byte loads: a row's last chunk
// never reads past the row, and a misaligned row is read at the width
// its address allows. Callers keep their 16-byte loads for rows of a
// whole number of 16 bytes (vw 16: every chunk whole) and take this
// only for the others, a branch uniform over the kernel -- kept apart,
// the loop of 16-byte loads compiles as it did without it.
__device__ __forceinline__ uint4 ld_chunk(const void* p, int bytes, int vw) {
  const unsigned char* b = static_cast<const unsigned char*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (vw >= 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (8 * i < bytes) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(b + 8 * i));
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
      }
    }
  } else if (vw == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i < bytes) w[i] = __ldg(reinterpret_cast<const unsigned int*>(b + 4 * i));
  } else if (vw == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < bytes)
        w[i >> 1] |= static_cast<uint32_t>(__ldg(
                         reinterpret_cast<const unsigned short*>(b + 2 * i)))
                     << (16 * (i & 1));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < bytes) w[i >> 2] |= static_cast<uint32_t>(__ldg(b + i)) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes of 16-byte column chunk cc of a row of d elements of `esize`
// bytes that lie inside the row (0 past its end).
__host__ __device__ __forceinline__ int chunk_bytes(int cc, int d, int esize) {
  const int left = (d * esize) - 16 * cc;
  return left <= 0 ? 0 : left < 16 ? left : 16;
}

// Zeroes the 64-column panels [from, to) of a tile of `rows` rows
// (panel p at tile + p * rows * 128), each of `threads` threads from
// thread t on: a padded head dim's panels wholly past d, which no load
// writes. The caller fences (fence_proxy_async) before a wgmma reads
// them.
__device__ __forceinline__ void zero_panels(uint32_t tile, int rows, int from,
                                            int to, int t, int threads) {
  const int n = (to - from) * rows * kPanelRowBytes / 16;
  const uint32_t at = tile + from * rows * kPanelRowBytes;
  for (int i = t; i < n; i += threads)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at + 16 * i),
                 "r"(0u)
                 : "memory");
}

// 64-column panels of a 16-bit kD-column tile that hold a column below
// d: a padded head dim's boxes load only these. Only kD 256 has a panel
// wholly past d (its last, at d 129-192): it is zeroed once
// (zero_dead_panels) and never loaded. A d the 64- or 128-column kernels
// take reaches their last panel.
template <int kD>
__device__ __forceinline__ int live_panels(int d) {
  return kD == 256 ? (d + 63) / 64 : kD / 64;
}

// Zeroes the panels past live_panels(d) of `n` 16-bit tiles of `rows`
// rows each, laid out back to back from `tile`, each of `threads`
// threads from threadIdx.x on; the caller fences (fence_proxy_async)
// before a wgmma reads them. Only kD 256 has any.
template <int kD>
__device__ __forceinline__ void zero_dead_panels(uint32_t tile, int rows, int n,
                                                 int d, int threads) {
  const int panels = live_panels<kD>(d);
  if (panels >= kD / 64) return;
  for (int i = 0; i < n; ++i)
    zero_panels(tile + i * rows * kD * 2, rows, panels, kD / 64, threadIdx.x,
                threads);
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
  // Blocks of the cluster that share the stream (tma_tile_shared): a
  // stage is freed in each of them. 1: the block's own ring alone.
  int peers = 1;
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

// Key index, within its tile, of accumulator element i of lane (a
// 64-key tile's 32 elements, a 32-key tile's 16).
__device__ __forceinline__ int walk_key(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Frees stage st of the ring for the producer: one arrival per
// warpgroup, after the warpgroup's products that read it completed --
// on the stage's empty barrier of every block that shares the ring.
__device__ __forceinline__ void walk_release(const WalkRing& ring, int st) {
  free_stage(ring.empty + 8 * st, ring.peers);
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
// compiles to the walk it had before the hooks existed. Every mask also
// has edge(k_last): whether the tile whose last key is k_last needs the
// element-wise mask at all.
template <typename Mask, typename = void>
struct walk_scaled : std::false_type {};
template <typename Mask>
struct walk_scaled<Mask, std::void_t<decltype(&Mask::s_scale),
                                     decltype(&Mask::p_scale)>>
    : std::true_type {};

// One tile's online-softmax step on S (raw dot products in, P out, in
// place) for tiles of 2 N keys (N accumulator elements a thread):
// updates m and l and returns alpha per row. The mask is applied element
// by element (mask.sees(r, key): may this thread's row r see key?) only
// where mask.edge says tile kt needs it.
template <int N, typename Mask>
__device__ __forceinline__ void walk_softmax(float (&s)[N], int kt,
                                             float scale2, const Mask& mask,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  constexpr bool kScaled = walk_scaled<Mask>::value;
  constexpr int kKeys = 2 * N;
  const int lane = threadIdx.x & 31;
  const bool edge = mask.edge(kt * kKeys + kKeys - 1);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float x;
    if constexpr (kScaled) {
      x = s[i] * (mask.s_scale(kt, walk_key(i, lane)) * scale2);
    } else {
      x = s[i] * scale2;
    }
    if (edge && !mask.sees(r, kt * kKeys + walk_key(i, lane)))
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
  for (int i = 0; i < N; ++i) {
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
    for (int i = 0; i < N; ++i) s[i] *= mask.p_scale(kt, walk_key(i, lane));
  }
}

// P (fp32, accumulator layout) rounded to T as N / 8 k-steps (16 keys
// each) of A fragments.
template <typename T, int N>
__device__ __forceinline__ void walk_pack(uint32_t (&pf)[N / 8][4],
                                          const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
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
    wgmma_rs_nd<T, kD>(o, pf[kk], mnmajor_desc(v, kWalkKeys, kk),
                       2 * kWalkKeys * kPanelRowBytes);
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
// (row_ptr[r] null for a row past the end), never a column at or past
// d: a pair as one store where d is even (kEven: the pair is then whole
// and aligned), element by element otherwise; returns lse per row.
template <typename T, int kD, bool kEven = true>
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
      if constexpr (kEven) {
        if (col < d)
          store2<T>(row_ptr[r] + col, rows.o[4 * j + 2 * r] * inv,
                    rows.o[4 * j + 2 * r + 1] * inv);
      } else {
        if (col < d) row_ptr[r][col] = from_f<T>(rows.o[4 * j + 2 * r] * inv);
        if (col + 1 < d)
          row_ptr[r][col + 1] = from_f<T>(rows.o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// =====================================================================
// Split TF32: float32 and mixed-dtype attention on the tensor cores.
//
// wgmma has a TF32 form (m64nNk8, fp32 accumulator, 495 dense TFLOP/s
// on an H100 SXM against 67 for fp32 FMAs). TF32 keeps 10 explicit
// mantissa bits, so one pass would round every fp32 operand to 2^-11;
// instead each fp32 operand x is split as hi = tf32(x), lo = tf32(x -
// hi), and a product of two fp32 operands takes three passes (hi hi, hi
// lo, lo hi: the lo lo term is below 2^-22), two where one side is exact
// in TF32, one where both are. Every bf16, f16 and int8 value is exact
// in TF32, so those operands are never split. The rounding
// (tf32_rna_bits) is to nearest, ties away from zero (cvt.rna), written
// with integer operations: the same bits as
// kernels/attention.py::tf32_round, which the CPU tests and
// chip_smoke.py's controls use.
//
// Non-finite operands. A non-finite x splits as (x, 0), so inf - inf
// never puts a NaN in lo, and a finite x near FLT_MAX whose rounding
// would overflow is truncated instead. The cross terms of S = Q . K^T go
// to an accumulator of their own, added to the main term's only where
// that is finite: a row whose main term saw an inf or a NaN keeps it
// as is, as the plain version's fp32 product does (inf times a lo of 0
// or of the other sign would otherwise make a NaN where it has +-inf).
// P (>= 0, or NaN) splits with hi truncated and lo >= 2^-126 wherever hi
// > 0 (tf32_split_p), so P . V's three terms of a key agree in sign and
// an inf in V gives +-inf, as p * inf does, never inf - inf.
// =====================================================================

// TF32 rounding of the bits of a finite float (ties away from zero; a
// rounding that would overflow to inf truncates instead).
__device__ __forceinline__ uint32_t tf32_rna_bits(uint32_t u) {
  const uint32_t r = (u + 0x1000u) & 0xFFFFE000u;
  return (r & 0x7F800000u) == 0x7F800000u ? (u & 0xFFFFE000u) : r;
}

__device__ __forceinline__ bool finite_bits(uint32_t u) {
  return (u & 0x7F800000u) != 0x7F800000u;
}

// x = hi + lo to within 2^-22 |x|, both exact in TF32; (x, 0) for a
// non-finite x. Selects, not a branch: a branch per value would keep the
// compiler from interleaving the values' dependent integer chains.
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  const uint32_t u = __float_as_uint(x);
  const bool finite = finite_bits(u);
  const float h = __uint_as_float(tf32_rna_bits(u));
  // |x - h| <= 2^-11 |x|: its rounding cannot overflow.
  const float l =
      __uint_as_float((__float_as_uint(x - h) + 0x1000u) & 0xFFFFE000u);
  hi = finite ? h : x;
  lo = finite ? l : 0.f;
}

// A probability p (>= 0, or NaN) as TF32 bits hi + lo: hi truncated, so
// lo = p - hi >= 0 (rounded: within 2^-21 p), and lo at least 2^-126
// wherever hi > 0; (0, 0) for p = 0.
__device__ __forceinline__ void tf32_split_p(float p, uint32_t& hi,
                                             uint32_t& lo) {
  const float h = __uint_as_float(__float_as_uint(p) & 0xFFFFE000u);
  const float l = __uint_as_float(tf32_rna_bits(__float_as_uint(p - h)));
  hi = __float_as_uint(h);
  lo = __float_as_uint(h > 0.f ? fmaxf(l, 1.17549435e-38f) : 0.f);
}

// Four int8 values (the bytes of w, lowest first) as floats, exactly:
// each byte with its sign bit flipped (x + 128) becomes the low mantissa
// bits of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// The 16 / sizeof(T) values of a 16-byte chunk of T as floats (exact).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& x, float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      f[j] = __uint_as_float(w[j]);
    } else if constexpr (std::is_same<T, int8_t>::value) {
      float g[4];
      i8x4_to_f32(w[j], g);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[4 * j + i] = g[i];
    } else if constexpr (std::is_same<T, __half>::value) {
      const float2 g = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
      f[2 * j] = g.x;
      f[2 * j + 1] = g.y;
    } else {
      const float2 g =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[2 * j] = g.x;
      f[2 * j + 1] = g.y;
    }
  }
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Columns c .. c + 3 (c % 4 == 0) of row r of a K-major fp32 tile of
// `rows` rows (kD / 32 panels): one 16-byte chunk.
__device__ __forceinline__ uint32_t kmajor_f32_at(uint32_t tile, int rows,
                                                  int r, int c) {
  return tile + (c >> 5) * rows * kPanelRowBytes + r * kPanelRowBytes +
         ((((c & 31) >> 2) ^ (r & 7)) << 4);
}

// The 16 / sizeof(T) columns from cc * 16 / sizeof(T) of row r, from one
// 16-byte chunk of T, into a K-major fp32 tile of `rows` rows: split
// into hi and lo tiles where T is float and kSplit, else exact in hi.
template <typename T, bool kSplit>
__device__ __forceinline__ void put_kmajor(uint32_t hi, uint32_t lo, int rows,
                                           int r, int cc, const uint4& x) {
  constexpr int kE = 16 / sizeof(T);
  float f[kE];
  unpack16<T>(x, f);
#pragma unroll
  for (int i = 0; i < kE; i += 4) {
    const uint32_t at = kmajor_f32_at(0, rows, r, cc * kE + i);
    if constexpr (kSplit) {
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(f[i + e], h[e], l[e]);
      st_shared4(hi + at, h[0], h[1], h[2], h[3]);
      st_shared4(lo + at, l[0], l[1], l[2], l[3]);
    } else {
      st_shared4(hi + at, f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
}

// Key t (0-31) of a 32-key tile, column c, in the transposed V tile
// [kD rows][32 keys] that TF32 P . V reads K-major (one panel: 32 fp32
// keys a row). Within each 8-key group, key j sits at k slot j / 2 + 4
// (j % 2): the slots a lane's P fragment gives keys 2 l and 2 l + 1 (see
// tf32_pv), so P leaves its accumulator with no shuffle.
__device__ __forceinline__ uint32_t vt_at(int t, int c) {
  const int slot = (t & ~7) + ((t & 7) >> 1) + 4 * (t & 1);
  return c * kPanelRowBytes + ((((slot >> 2)) ^ (c & 7)) << 4) + (slot & 3) * 4;
}

// One 16-byte chunk (8 16-bit columns from 8 cc) of row t into a 16-bit
// tile of `rows` rows in the TMA panel layout (64 columns a panel).
__device__ __forceinline__ void put_panel16(uint32_t tile, int rows, int t,
                                            int cc, const uint4& x) {
  const uint32_t at = tile + (cc >> 3) * rows * kPanelRowBytes +
                      t * kPanelRowBytes + (((cc & 7) ^ (t & 7)) << 4);
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// wgmma TF32 products. SS: S (64 x 32) += A . B^T, both K-major in
// shared memory. RS: O (64 x N) += A . B with A from registers (the
// m64k8 fragment: a[0] row l / 4, k l % 4; a[1] row + 8; a[2] k + 4;
// a[3] both) and B K-major ([N rows][k]). TF32 has no transposed form.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int kD>
__device__ __forceinline__ void wgmma_tf32_rs_nd(float (&d)[kD / 2],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  static_assert(kD == 64 || kD == 128, "TF32 RS products are N 64 or 128");
  if constexpr (kD == 64) {
    wgmma_tf32_rs_n64(d, a, db);
  } else {
    wgmma_tf32_rs_n128(d, a, db);
  }
}

// ---------------------------------------------------------------------
// The TF32 walk: one consumer warpgroup's 64 query rows of QT against a
// stream of 32-key tiles of a KT pool, written into shared memory by two
// converter warpgroups (tf32_converters; each kernel says where its
// rows live).
//
// Shared memory, from a 1024-byte-aligned base (Tf32Layout): Q as a
// K-major fp32 tile of 64 rows (hi, and lo where QT is float); then
// kStages stages, each a K tile [32 keys][kD] (hi, lo where KT is float)
// and a V tile of the kDV columns of O the block holds -- for a 16-bit
// pool the 16-bit [32 keys][kDV] panels TMA would write (P . V on the
// 16-bit wgmma, V MN-major), else the transposed fp32 [kDV][32 keys]
// tile (hi, lo where KT is float) of vt_at; then, for an int8 pool, the
// K and V page scale of each key of each stage; then the barriers:
// bar_q, and per stage full_k, full_v (128 arrivals each, from the K or
// the V converters), empty_k and empty_v (one consumer arrival each). K
// and V of a stage are freed apart, K once S and the softmax have read
// it, V once P . V has, so each converter waits only for the half it
// writes -- a one-stage ring still overlaps the conversion of tile kt +
// 1's K with P . V of tile kt - 1.
//
// Column halves (kD 256). A float32 Q tile split in hi and lo is 128 KB
// there, and one stage of K and V^T split likewise another 128 KB: more
// than a block's 227 KB. So at kD 256 a block holds kDV = 128 of O's
// columns (kHalves = 2 blocks a row tile): it streams every K tile whole
// (S needs all kD columns) but only its half of V, and O takes 64 fp32 a
// thread, as at kD 128. S is computed by both halves: 1.5x the products
// of one block holding all of O, and twice the blocks -- at Gemma-2B's
// chunk (one KV head, group 8: 30 row tiles) 60 instead of 30 on 132
// SMs. A float32 q and pool then fit one stage (230,440 bytes), a 16-bit
// q over a float32 pool one, a float32 q over int8 or a 16-bit pool two,
// mixed 16-bit pairs four.
//
// Per tile:
//   S = Q . K^T      SS m64n32k8 TF32: 1-3 passes (the cross terms into
//                    an accumulator of their own, see above)
//   softmax          walk_softmax (the 16-bit walk's, on 32-key tiles)
//   O += P . V       a 16-bit pool: P rounded to KT (walk_pack), RS
//                    m64nDk16; else P split (tf32_split_p), RS m64nDk8
//                    TF32 over V^T: 2 passes, 3 where KT is float
// with the next tile's S issued before this tile's P . V, as in walk.
// ---------------------------------------------------------------------

constexpr int kTf32Keys = 32;      // keys per streamed tile
constexpr int kTf32Rows = 64;      // query rows of a block
// A consumer warpgroup, then two converter warpgroups: one writes the K
// tiles (and Q, with the other), one the V tiles. The consumer's
// accumulators take up to 232 registers a thread, the converters 136
// (setmaxnreg: tf32_regs_*; 168 each at launch, __launch_bounds__).
constexpr int kTf32Threads = 384;

template <typename QT, typename KT, int kD>
struct Tf32Layout {
  static constexpr bool kQSplit = std::is_same<QT, float>::value;
  static constexpr bool kKSplit = std::is_same<KT, float>::value;
  static constexpr bool kPV16 = sizeof(KT) == 2;
  static constexpr bool kScaled = std::is_same<KT, int8_t>::value;
  static constexpr int kHalves = kD > 128 ? 2 : 1;  // blocks a row tile
  static constexpr int kDV = kD / kHalves;          // O's columns a block
  static constexpr int kQTile = kTf32Rows * kD * 4;
  static constexpr int kKTile = kTf32Keys * kD * 4;
  static constexpr int kVTile = kPV16 ? kTf32Keys * kDV * 2 : kDV * kTf32Keys * 4;
  static constexpr int kQ = kQTile * (kQSplit ? 2 : 1);
  static constexpr int kStage = (kKTile + kVTile) * (kKSplit ? 2 : 1);
  static constexpr int kScales = kScaled ? 2 * kTf32Keys * 4 : 0;  // a stage's
  // As many stages as fit beside Q (at most 4): 2 for float32 q and
  // pool at d 128 (197.7 KB), 3 for a 16-bit q over a float32 pool; at
  // kD 256 (column halves) 1 for a float32 pool, 2 for a float32 q over
  // int8 or 16 bits, 4 for mixed 16-bit pairs.
  static constexpr int kFit = (kMaxSmem - 1024 - kQ - 256) / (kStage + kScales);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem =
      1024 + kQ + kStages * (kStage + kScales) + (1 + 4 * kStages) * 8;
  static_assert(kStages >= 1 && kSmem <= static_cast<size_t>(kMaxSmem),
                "the TF32 ring's tiles exceed 227 KB");
};

// Addresses of a TF32 walk's shared memory (Tf32Layout), from its
// 1024-byte-aligned base.
struct Tf32Ring {
  uint32_t q;                      // Q hi (lo one tile on)
  uint32_t stage;                  // stage 0: K hi, K lo, V hi, V lo
  uint32_t scales;                 // int8 pools: [stages][2][32] floats
  uint32_t bar_q, full_k, full_v, empty_k, empty_v;  // per stage, 8 bytes apart

  template <typename L>
  __device__ __forceinline__ static Tf32Ring at(uint32_t base) {
    Tf32Ring r;
    r.q = base;
    r.stage = base + L::kQ;
    r.scales = r.stage + L::kStages * L::kStage;
    r.bar_q = r.scales + L::kStages * L::kScales;
    r.full_k = r.bar_q + 8;
    r.full_v = r.full_k + 8 * L::kStages;
    r.empty_k = r.full_v + 8 * L::kStages;
    r.empty_v = r.empty_k + 8 * L::kStages;
    return r;
  }
  template <typename L>
  __device__ __forceinline__ uint32_t k(int st) const {
    return stage + st * L::kStage;
  }
  template <typename L>
  __device__ __forceinline__ uint32_t v(int st) const {
    return stage + st * L::kStage + L::kKTile * (L::kKSplit ? 2 : 1);
  }
};

// Initialises a TF32 walk's barriers (call from one thread, then a
// block barrier).
template <typename L>
__device__ __forceinline__ void tf32_ring_init(const Tf32Ring& ring) {
  mbar_init(ring.bar_q, 256);
  for (int st = 0; st < L::kStages; ++st) {
    mbar_init(ring.full_k + 8 * st, 128);
    mbar_init(ring.full_v + 8 * st, 128);
    mbar_init(ring.empty_k + 8 * st, 1);
    mbar_init(ring.empty_v + 8 * st, 1);
  }
  mbar_fence_init();
}

// Register reallocation between the roles (all four warps of a
// warpgroup together): a converter warpgroup drops to kConv registers a
// thread, the consumer takes what they free, 3 x 168 - 2 kConv (232 for
// 136; a kernel whose consumer holds more, as dk/dv's, takes 248 for
// 128).
template <int kConv = 136>
__device__ __forceinline__ void tf32_regs_converter() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConv) : "memory");
}
template <int kConv = 136>
__device__ __forceinline__ void tf32_regs_consumer() {
  static_assert(kConv % 8 == 0 && kConv >= 24, "setmaxnreg: a multiple of 8");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(3 * 168 - 2 * kConv)
               : "memory");
}

// Converter thread c (0-255, both warpgroups) writing its share of a
// 64-row K-major tile (hi, and lo where kSplit): row r = c % 64, 16-byte
// chunks c / 64, c / 64 + 4, ... of the row at `row` (null past the end:
// zeros), kD columns of which d are real, read at vw bytes a load
// (vec_bytes; the last chunk only up to the row's end).
template <typename T, bool kSplit, int kD, bool kWhole = true>
__device__ __forceinline__ void tf32_put_rows64(uint32_t hi, uint32_t lo, int c,
                                                const T* row, int d,
                                                int vw = 16) {
  constexpr int kE = 16 / sizeof(T);
  const int r = c & 63;
#pragma unroll
  for (int j = c >> 6; j < kD / kE; j += 4) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row != nullptr && j * kE < d) {
      if constexpr (kWhole) {
        x = __ldg(reinterpret_cast<const uint4*>(row + j * kE));
      } else {
        x = ld_chunk(row + j * kE, chunk_bytes(j, d, sizeof(T)), vw);
      }
    }
    put_kmajor<T, kSplit>(hi, lo, kTf32Rows, r, j, x);
  }
}

// The converters' share of the 64-row Q tile, then their arrival on bar_q.
template <typename QT, typename L, int kD, bool kWhole>
__device__ __forceinline__ void tf32_put_q(const Tf32Ring& ring, int c,
                                           const QT* row, int d, int vw) {
  tf32_put_rows64<QT, L::kQSplit, kD, kWhole>(ring.q, ring.q + L::kQTile, c,
                                              row, d, vw);
  fence_proxy_async();
  mbar_arrive(ring.bar_q);
}

// Where a key of a tile lives: its K and V rows (null past the live
// keys: zeros) and, for an int8 pool, its page's scales (0 past the live
// keys).
template <typename KT>
struct Tf32Src {
  const KT* k;
  const KT* v;
  float ksc, vsc;
};

// A converter thread's share of one K or V tile, in registers. Thread c
// (0-127 of its warpgroup: warp w = c / 32, lane l) takes kPer 16-byte
// chunks; its i-th covers, across the warp, 4 keys x 8 neighbouring
// chunks (128 contiguous bytes of each key's row, so a load touches 4
// lines), or 8 keys x 4 chunks where a row has only 4. The 4 keys t0,
// t0 + 2, t0 + 4, t0 + 6 of a load fill the four words of a
// transposed-V chunk (vt_at), and each lane stores its columns in an
// order rotated by its chunk (rot), so neither a float32 K tile nor the
// transposed V tile sees a bank conflict. A thread touches two keys of
// a tile (one where a row has 4 chunks): key(c, 0) and key(c, 1).
template <typename KT, int kD>
struct Tf32Share {
  static constexpr int kE = 16 / sizeof(KT);  // elements of a chunk
  static constexpr int kC = kD / kE;          // chunks of a row
  static constexpr int kPer = kC / 4;         // chunks a thread takes
  uint4 x[kPer];

  __device__ __forceinline__ static int key(int c, int i) {
    const int l = c & 31, w = c >> 5;
    if constexpr (kC >= 8) {
      const int ks = (4 * i + w) & 7;  // w for an even i, w + 4 for an odd
      return (ks >> 1) * 8 + (ks & 1) + 2 * (l & 3);
    } else {
      return 8 * w + (l & 7);
    }
  }
  __device__ __forceinline__ static int chunk(int c, int i) {
    const int l = c & 31, w = c >> 5;
    if constexpr (kC >= 8) {
      return ((4 * i + w) >> 3) * 8 + (l >> 2);
    } else {
      return l >> 3;
    }
  }
  // Which of the thread's two keys its i-th chunk belongs to.
  __device__ __forceinline__ static int which(int i) {
    return kC >= 8 ? (i & 1) : 0;
  }
  // The rotation of a lane's store order into the transposed V tile.
  __device__ __forceinline__ static int rot(int c) {
    const int l = c & 31;
    if constexpr (kC < 8) return 2 * (l >> 3);
    return kE == 4 ? (l >> 3) : (l >> 2);
  }
};

// Loads the thread's chunks of the rows (K or V) of its two keys
// (rows[j]: null past the live keys, zeros): 16-byte loads where every
// row is a whole number of 16 bytes (kWhole), else vw bytes a load
// (vec_bytes; a row's last chunk only up to its end).
template <typename KT, int kD, bool kWhole = true>
__device__ __forceinline__ void tf32_load(Tf32Share<KT, kD>& x, int c,
                                          const KT* const (&rows)[2], int d,
                                          int vw = 16) {
  using X = Tf32Share<KT, kD>;
#pragma unroll
  for (int i = 0; i < X::kPer; ++i) {
    const KT* row = rows[X::which(i)];
    const int cc = X::chunk(c, i);
    x.x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row != nullptr && cc * X::kE < d) {
      if constexpr (kWhole) {
        x.x[i] = __ldg(reinterpret_cast<const uint4*>(row + cc * X::kE));
      } else {
        x.x[i] = ld_chunk(row + cc * X::kE, chunk_bytes(cc, d, sizeof(KT)), vw);
      }
    }
  }
}

// Column cc * kE + (e + rot) % kE of key t (0-31) into the transposed V
// tile, for e = 0 .. kE - 1: the chunk's values rotated by rot first (one
// select a value a bit of rot), so the store order is a lane's own.
template <typename T, bool kSplit>
__device__ __forceinline__ void put_vt(uint32_t hi, uint32_t lo, int t, int cc,
                                       const uint4& x, int rot) {
  constexpr int kE = 16 / sizeof(T);
  float f[kE];
  unpack16<T>(x, f);
#pragma unroll
  for (int b = 1; b < kE; b <<= 1) {
    float g[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) g[e] = (rot & b) ? f[(e + b) % kE] : f[e];
#pragma unroll
    for (int e = 0; e < kE; ++e) f[e] = g[e];
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const uint32_t at = vt_at(t, cc * kE + ((e + rot) & (kE - 1)));
    if constexpr (kSplit) {
      float h, l;
      tf32_split(f[e], h, l);
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hi + at), "f"(h) : "memory");
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(lo + at), "f"(l) : "memory");
    } else {
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hi + at), "f"(f[e]) : "memory");
    }
  }
}

// Waits until use `use` of a ring of `stages` stages may write its
// stage: the consumer has freed that stage's use use - stages (empty:
// the ring's stage-0 barrier, 8 bytes a stage).
__device__ __forceinline__ void tf32_acquire(uint32_t empty, int use, int stages) {
  if (use >= stages)
    mbar_wait(empty + 8 * (use % stages), (use / stages - 1) & 1);
}

// One converter warpgroup's part of every tile [0, n_tiles): the K tiles
// (kV false; with an int8 pool's K and V scales, which the softmax
// reads, written before the K tile's arrival) or the V tiles (kD: the
// block's L::kDV columns from col0). Thread c (0-127). src_of(key) names
// where key `key` of the walk lives. A tile goes in kPieces pieces of kW
// columns -- one, but two of 128 for a float32 K tile at kD 256, whose
// share would take 128 registers a thread twice over (the loads in
// flight beside the ones being written) -- and the loads of the next
// piece are issued before this one is converted, so their latency hides
// behind that work; a tile is written once the consumer has freed its
// half of the stage, and arrives on full_k or full_v after its last
// piece.
template <bool kV, typename KT, typename L, int kD, bool kWhole, typename SrcOf>
__device__ __forceinline__ void tf32_convert(const Tf32Ring& ring, int c,
                                             int n_tiles, int d,
                                             const SrcOf& src_of, int vw,
                                             int col0 = 0) {
  constexpr int kW = kD > 128 && sizeof(KT) == 4 ? 128 : kD;
  constexpr int kPieces = kD / kW;
  using X = Tf32Share<KT, kW>;
  if (n_tiles <= 0) return;
  const int rot = X::rot(c);
  // Piece u's rows (tile u / kPieces, columns from (u % kPieces) kW).
  const auto rows = [&](int u, const KT* (&r)[2]) {
    const int kt = u / kPieces, off = col0 + (u - kt * kPieces) * kW;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Tf32Src<KT> src = src_of(kt * kTf32Keys + X::key(c, j));
      const KT* row = kV ? src.v : src.k;
      r[j] = row == nullptr ? nullptr : row + off;
    }
  };
  const auto width = [&](int u) { return d - col0 - (u % kPieces) * kW; };
  const int n_units = n_tiles * kPieces;
  const KT* r0[2];
  rows(0, r0);
  X x;
  tf32_load<KT, kW, kWhole>(x, c, r0, width(0), vw);
  for (int u = 0; u < n_units; ++u) {
    const int kt = u / kPieces, piece = u - kt * kPieces;
    const int st = kt % L::kStages;
    const KT* rn[2] = {nullptr, nullptr};
    if (u + 1 < n_units) rows(u + 1, rn);
    X next;
    tf32_load<KT, kW, kWhole>(next, c, rn, width(u + 1), vw);
    if (piece == 0) tf32_acquire(kV ? ring.empty_v : ring.empty_k, kt, L::kStages);
    if constexpr (kV) {
      const uint32_t v = ring.v<L>(st);
#pragma unroll
      for (int i = 0; i < X::kPer; ++i) {
        if constexpr (L::kPV16) {
          put_panel16(v, kTf32Keys, X::key(c, i), X::chunk(c, i), x.x[i]);
        } else {
          put_vt<KT, L::kKSplit>(v, v + L::kVTile, X::key(c, i), X::chunk(c, i),
                                 x.x[i], rot);
        }
      }
    } else {
      if constexpr (L::kScaled) {
        if (c < kTf32Keys) {
          const Tf32Src<KT> mine = src_of(kt * kTf32Keys + c);
          const uint32_t slot = ring.scales + (st * 64 + c) * 4;
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(slot), "f"(mine.ksc)
                       : "memory");
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(slot + 128), "f"(mine.vsc)
                       : "memory");
        }
      }
      const uint32_t k = ring.k<L>(st);
#pragma unroll
      for (int i = 0; i < X::kPer; ++i)
        put_kmajor<KT, L::kKSplit>(k, k + L::kKTile, kTf32Keys, X::key(c, i),
                                   piece * X::kC + X::chunk(c, i), x.x[i]);
    }
    if (piece == kPieces - 1) {
      fence_proxy_async();
      mbar_arrive((kV ? ring.full_v : ring.full_k) + 8 * st);
    }
    x = next;
  }
}

// The converters' side of a TF32 kernel: both warpgroups write Q (its
// rows: q_row(r), null past the end), then the first the K tiles and the
// second the V tiles (the block's L::kDV columns from col0). ct: the
// thread's index among the 256 converters. kWhole: every row of q and of
// the pool is a whole number of 16 bytes (16-byte loads); else vq, vk
// are the widest loads q's rows and the K and V rows allow (vec_bytes).
// A kernel instantiates one or the other: the narrow loads' code,
// compiled beside the 16-byte path, slowed it.
template <typename QT, typename KT, typename L, int kD, bool kWhole = true,
          typename QRow, typename SrcOf>
__device__ __forceinline__ void tf32_converters(const Tf32Ring& ring, int ct,
                                                int n_tiles, int d,
                                                const QRow& q_row,
                                                const SrcOf& src_of,
                                                int vq = 16, int vk = 16,
                                                int col0 = 0) {
  tf32_regs_converter();
  tf32_put_q<QT, L, kD, kWhole>(ring, ct, q_row(ct & 63), d, vq);
  if (ct < 128) {
    tf32_convert<false, KT, L, kD, kWhole>(ring, ct, n_tiles, d, src_of, vk);
  } else {
    tf32_convert<true, KT, L, L::kDV, kWhole>(ring, ct - 128, n_tiles, d,
                                              src_of, vk, col0);
  }
}

// A (64 rows) . B^T (32 rows), both K-major tiles of kD fp32 columns, in
// the passes their splits need: A hi . B hi into s, the cross terms (A hi
// . B lo where B is split, A lo . B hi where A is) into s2.
template <bool kASplit, bool kBSplit, int kD>
__device__ __forceinline__ void tf32_ss_passes(float (&s)[16], float (&s2)[16],
                                               uint32_t ah, uint32_t al,
                                               uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk)
    wgmma_tf32_ss_n32(s, kmajor_desc(ah, kTf32Rows, 0, kk),
                      kmajor_desc(bh, kTf32Keys, 0, kk), kk > 0);
  if constexpr (kBSplit) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)
      wgmma_tf32_ss_n32(s2, kmajor_desc(ah, kTf32Rows, 0, kk),
                        kmajor_desc(bl, kTf32Keys, 0, kk), kk > 0);
  }
  if constexpr (kASplit) {
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)
      wgmma_tf32_ss_n32(s2, kmajor_desc(al, kTf32Rows, 0, kk),
                        kmajor_desc(bh, kTf32Keys, 0, kk), kBSplit || kk > 0);
  }
}

// x, as a value the compiler cannot see through where kOn. The column
// halves' walk (kD 256) launders its tile addresses here each tile, so
// the wgmma descriptors built from them (up to 96 a tile) are built
// where they are issued and not hoisted out of the tile loop as
// loop-invariant: a one-stage ring's would all be, and held across the
// loop they take more registers than the consumer has (888 bytes of
// spills over a float32 pool, ptxas).
template <bool kOn>
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  if constexpr (kOn) asm volatile("" : "+r"(x));
  return x;
}

// S (and its cross terms, S2) of the consumer's 64 rows against stage
// st's K tile.
template <typename L, int kD>
__device__ __forceinline__ void tf32_scores(float (&s)[16], float (&s2)[16],
                                            const Tf32Ring& ring, int st) {
  constexpr bool kOpaque = L::kHalves > 1;
  const uint32_t q = opaque<kOpaque>(ring.q);
  const uint32_t kh = opaque<kOpaque>(ring.k<L>(st));
  tf32_ss_passes<L::kQSplit, L::kKSplit, kD>(s, s2, q, q + L::kQTile, kh,
                                             kh + L::kKTile);
}

// S = S + S2 where S is finite; S as it is where it is not.
__device__ __forceinline__ void tf32_add_finite(float (&s)[16],
                                                const float (&s2)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = isfinite(s[i]) ? s[i] + s2[i] : s[i];
}

template <typename L>
__device__ __forceinline__ void tf32_combine(float (&s)[16], const float (&s2)[16]) {
  if constexpr (L::kQSplit || L::kKSplit) tf32_add_finite(s, s2);
}

// A 64 x 32 fp32 accumulator (S's layout) as the split A operand of an RS
// TF32 product over its 32 columns (tf32_frag_step: one of them, from
// columns 8 j .. 8 j + 7): four k8 steps of hi and lo, a lane's
// columns 2 l and 2 l + 1 of each 8-column group in its k slots l and
// l + 4 (the B tile's rows permuted to match: vt_at). kProb: the values
// are probabilities, split sign-coherently (tf32_split_p); else any
// value (tf32_split).
template <bool kProb>
__device__ __forceinline__ void tf32_frag_step(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&s)[16], int j) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    // Fragment x of step j: s[4 j], s[4 j + 2], s[4 j + 1], s[4 j + 3].
    const float v = s[4 * j + (((x & 1) << 1) | (x >> 1))];
    if constexpr (kProb) {
      tf32_split_p(v, hi[x], lo[x]);
    } else {
      float h, l;
      tf32_split(v, h, l);
      hi[x] = __float_as_uint(h);
      lo[x] = __float_as_uint(l);
    }
  }
}

template <bool kProb>
__device__ __forceinline__ void tf32_frags(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const float (&s)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) tf32_frag_step<kProb>(hi[j], lo[j], s, j);
}

// O (64 x kD) += A . B over 32 k, A split in registers (tf32_frags), B a
// transposed fp32 tile [kD rows][32] (vt_at): A hi . B hi, A lo . B hi,
// and A hi . B lo where B is split.
template <bool kBSplit, int kD>
__device__ __forceinline__ void tf32_rs_passes(float (&o)[kD / 2],
                                               const uint32_t (&hi)[4][4],
                                               const uint32_t (&lo)[4][4],
                                               uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t b = kmajor_desc(bh, kD, 0, j);
    wgmma_tf32_rs_nd<kD>(o, hi[j], b);
    wgmma_tf32_rs_nd<kD>(o, lo[j], b);
    if constexpr (kBSplit)
      wgmma_tf32_rs_nd<kD>(o, hi[j], kmajor_desc(bl, kD, 0, j));
  }
}

// P as the A operand of P . V: for a 16-bit pool, rounded to KT (two
// k16 steps, p16); else split (four k8 steps of hi and lo), a lane's
// keys 2 l and 2 l + 1 of each 8-key group in its k slots l and l + 4.
template <typename L>
struct Tf32P {
  uint32_t p16[2][4];
  uint32_t hi[4][4], lo[4][4];
};

template <typename KT, typename L>
__device__ __forceinline__ void tf32_pack(Tf32P<L>& p, const float (&s)[16]) {
  if constexpr (L::kPV16) {
    walk_pack<KT>(p.p16, s);
  } else {
    tf32_frags<true>(p.hi, p.lo, s);
  }
}

template <typename L>
__device__ __forceinline__ void tf32_fence_p(Tf32P<L>& p) {
  if constexpr (L::kPV16) {
    reg_fence(p.p16);
  } else {
    reg_fence(p.hi);
    reg_fence(p.lo);
  }
}

template <typename KT, typename L, int kD>
__device__ __forceinline__ void tf32_pv(float (&o)[kD / 2], const Tf32P<L>& p,
                                        uint32_t v) {
  v = opaque<(L::kHalves > 1)>(v);
  if constexpr (L::kPV16) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_rs_nd<KT, kD>(o, p.p16[kk], mnmajor_desc(v, kTf32Keys, kk));
  } else {
    tf32_rs_passes<L::kKSplit, kD>(o, p.hi, p.lo, v, v + L::kVTile);
  }
}

// Tiles [0, n_tiles) of the ring through the online softmax into rows
// (o = 0, m = kMaskValue, l = 0 on entry; O the block's L::kDV columns),
// once Q has arrived. Every tile's K is freed after its softmax, its V
// after its P . V.
template <typename QT, typename KT, int kD, typename Mask>
__device__ __forceinline__ void tf32_walk(
    WalkRows<Tf32Layout<QT, KT, kD>::kDV>& rows, const Tf32Ring& ring,
    int n_tiles, float scale2, const Mask& mask) {
  using L = Tf32Layout<QT, KT, kD>;
  constexpr int kS = L::kStages;
  constexpr int kDV = L::kDV;
  mbar_wait(ring.bar_q, 0);
  if (n_tiles <= 0) return;
  const bool lead = (threadIdx.x & 127) == 0;  // frees stages for the warpgroup
  float s[16], s2[16], alpha[2];
  Tf32P<L> p;

  // A stage's K is freed once the softmax has read it -- in the column
  // halves (kD 256) over a pool without scales as soon as S has, so the
  // K converter starts on the next tile while the softmax runs (the
  // narrower walks keep the order they were measured with).
  constexpr bool kEarlyK = L::kHalves > 1 && !L::kScaled;
  const auto free_k = [&](int st) {
    if (lead) mbar_arrive(ring.empty_k + 8 * st);
  };
  mbar_wait(ring.full_k, 0);
  wgmma_fence();
  tf32_scores<L, kD>(s, s2, ring, 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(s2);
  if constexpr (kEarlyK) free_k(0);
  tf32_combine<L>(s, s2);
  walk_softmax(s, 0, scale2, mask, rows.m, rows.l, alpha);  // O is still 0
  if constexpr (!kEarlyK) free_k(0);
  tf32_pack<KT>(p, s);

  for (int kt = 1; kt < n_tiles; ++kt) {
    const int st = kt % kS;
    const int pst = (kt - 1) % kS;
    mbar_wait(ring.full_k + 8 * st, (kt / kS) & 1);
    wgmma_fence();
    tf32_scores<L, kD>(s, s2, ring, st);
    wgmma_commit();
    mbar_wait(ring.full_v + 8 * pst, ((kt - 1) / kS) & 1);
    tf32_pv<KT, L, kDV>(rows.o, p, ring.v<L>(pst));
    wgmma_commit();
    wgmma_wait<1>();  // S of tile kt; P . V of tile kt - 1 may still run
    reg_fence(s);
    reg_fence(s2);
    if constexpr (kEarlyK) free_k(st);
    tf32_combine<L>(s, s2);
    walk_softmax(s, kt, scale2, mask, rows.m, rows.l, alpha);
    if constexpr (!kEarlyK) free_k(st);
    wgmma_wait<0>();
    reg_fence(rows.o);
    tf32_fence_p(p);
    if (lead) mbar_arrive(ring.empty_v + 8 * pst);
#pragma unroll
    for (int i = 0; i < kDV / 2; ++i) rows.o[i] *= alpha[(i >> 1) & 1];
    tf32_pack<KT>(p, s);
  }
  const int last = n_tiles - 1;
  const int lst = last % kS;
  mbar_wait(ring.full_v + 8 * lst, (last / kS) & 1);
  wgmma_fence();
  tf32_pv<KT, L, kDV>(rows.o, p, ring.v<L>(lst));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(rows.o);
  tf32_fence_p(p);
  if (lead) mbar_arrive(ring.empty_v + 8 * lst);
}

// The int8 pool's scale hooks on a TF32 walk (walk_scaled): each key's
// page scales from the stage's slots.
template <typename Mask>
struct Tf32ScaledMask : Mask {
  const float* scales;  // [stages][2][32] in shared memory
  int stages;
  __device__ __forceinline__ float s_scale(int kt, int key) const {
    return scales[(kt % stages) * 64 + key];
  }
  __device__ __forceinline__ float p_scale(int kt, int key) const {
    return scales[(kt % stages) * 64 + 32 + key];
  }
};

}  // namespace
