// Paged attention over the serving engine's KV pool, for Hopper (sm_90a).
//
// Kernels replacing the two Pallas kernels of the JAX package's
// tpu_hpc/kernels/paged_attention.py:
//
//   paged_decode_split_kernel    replace _decode_kernel (launched by
//   paged_decode_combine_kernel  paged_decode_attention): the first walks
//                                one run of a slot's pages, the second
//                                merges the runs (flash-decoding).
//   paged_prefill_wgmma_kernel   replace _prefill_kernel (launched by
//   paged_prefill_gather_kernel  paged_prefill_attention): the first for
//   paged_prefill_tf32_kernel    16-bit q and pool of one dtype on pages
//   paged_prefill_kernel         that TMA boxes tile, the second for the
//                                same pair at every other page size and
//                                for an int8 pool under a 16-bit q, the
//                                third for every other pair (float32 q
//                                or pool, float32 q over int8, mixed
//                                16-bit dtypes) on split TF32, all three
//                                at any page size and head dim up to
//                                256; the fourth (scalar) only for
//                                every pair past 256 (prefill_route
//                                below).
//
// Head dims. Every kernel but the scalar one is instantiated at kD 64,
// 128 and 256 columns (the TF32 prefill's kD 256 blocks each holding
// half of the output's columns), and pads a
// head dim to the instantiation that holds it: columns d .. kD - 1 of Q, K and V are zeros in shared
// memory (a TMA box zero-fills past the tensor map's d, panels wholly
// past it are zeroed once; the gathering and converting producers
// write zeros), the output stores d columns, the scale stays d^-0.5.
// Rows that are not a whole number of 16 bytes (a bf16 row of 36
// columns is 72 bytes) are read at the width their address allows,
// never past their end (vec_bytes, ld_chunk in hopper.cuh), and staged
// 16-byte aligned; a tensor map cannot stride them, so the 16-bit
// prefill gathers them, Q included.
//
// They compute what the Pallas kernels compute -- online softmax in
// fp32 with the MASK_VALUE / m_safe / l_safe rules, the causal limit
// taken from data (pos per slot, start per chunk), inactive slots
// written as zeros, optional int8 pages dequantized with one f32 scale
// per page -- but are laid out for the card, not carried over block by
// block. Every kernel rounds P to a 16-bit pool's dtype before P . V, as
// the Pallas kernels' p.astype(v.dtype) does (each relative to its own
// running max, where the plain versions round relative to the whole
// view's max), and keeps P in fp32 for float32 and int8 pools -- apart
// from the int8 prefill, whose arithmetic is set out with its design
// below.
//
//   * the TPU grid's sequential page axis becomes a loop inside one
//     thread block (split into runs of pages for the decode);
//   * scalar prefetch becomes each block reading its own table row,
//     pos and active flag;
//   * a block issues no read of a page past its causal limit, of a
//     dead table entry, or (decode) of anything at all for an inactive
//     slot. The Pallas kernels redirect those reads to scratch page 0;
//     these kernels simply do not make them.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//
//   decode   bytes. Each live KV page of a head is read once and a query
//            row does 4 d FLOPs per key, so the work is g FLOPs per
//            byte of a 16-bit pool (g query rows per KV head) -- far
//            below the card's ~295 FLOP/byte ridge. The bound is the
//            live KV bytes over 3.35 TB/s.
//   prefill  at the main path's shapes (Llama-2-7B: 32 heads, d 128, a
//            256-token chunk over up to 512 keys) the causal FLOPs
//            (~1.6 GFLOP) and the bytes (~10 MB) give bounds of
//            ~1.6 us and ~3 us: bytes again, by a small margin. An int8
//            pool halves the page bytes: the 7B chunk at start 256 moves
//            8.39 MB (q and out in bf16, 32 int8 pages of K and V with
//            their scales), 2.50 us at 3.35 TB/s; with 8 KV heads and
//            g 8 (the 70B attention dims) the same chunk does 3.23 GFLOP,
//            3.26 us at the bf16 rate, and operations bound it.
//
// The decode is built to keep the memory system busy:
//
//   * split over pages. Grid (kv_heads, runs, slots x row groups): a
//     block walks one run of pages_per_split table entries (at least
//     kDecodeMinPages), so a long context is spread over many SMs and
//     the grid fills the card at GQA shapes too; the heads of a run are
//     neighbours in the grid, so the blocks that read one page run
//     together. The host picks the number of runs from max_blocks and
//     slots x kv_heads alone (never from pos, which would synchronise
//     the stream). A run past pos, or an inactive slot, writes an empty
//     partial (lse = MASK_VALUE) and returns without a load. A run's
//     partial is its output normalised by its own sum (fp32) and its
//     lse; paged_decode_combine_kernel merges a slot's runs in a fixed
//     order with lse_merge's m_safe and denom_safe rules (no atomics:
//     two launches give the same bits). With one run the split kernel
//     writes the output itself.
//   * pipelined 16-byte loads. A run is streamed as tiles of up to 32
//     keys of one page (K and V, bs rows of d contiguous elements at a
//     stride of kv_heads d) by 16-byte cp.async into a ring of
//     kDecodeStages tiles: the next tiles are in flight while one is
//     consumed, and a block meets one barrier per tile. Keys past pos
//     in the last page are zero-filled, never read.
//   * arithmetic in registers. The block's query rows and their fp32
//     output live in registers; a key group of kD / 8 lanes (kD: d
//     rounded up to 64, 128 or 256) owns one key at a time, each lane 8
//     columns of it, so a score is 8 FMAs and a short shuffle
//     reduction, and K and V are read from shared memory once for all
//     g rows. Each key group keeps its own running max and sum (exp2,
//     with log2 e folded into the scale) over its keys; the groups'
//     partials are merged once, at the end of the run. int8 pages fold
//     the page scale into S and P (s = (q . k_int8) k_scale, p
//     v_scale): the fp32 rounding order differs from the reference's
//     k.astype(f32) * scale by that reordering only.
//
// The 16-bit prefill is built for the tensor cores and the copy engine:
// one block per (KV head, 64 grouped q rows), whose Q tile arrives by
// TMA and whose 64-key K and V tiles are assembled from one TMA box per
// page into a ring that a producer warp keeps ahead of the consumer
// warpgroup; scores, probabilities and the output accumulate in
// registers through the online-softmax walk the training forward uses
// (hopper.cuh).
//
// The gathering prefill runs the same grid, Q tile and walk, with a
// producer warpgroup that reads each tile key by key through the table
// row, so pages of any size (12 tokens, 250) fill the 64-key tiles; over
// a pool of q's dtype its tiles are the TMA route's. Over an int8 pool
// it adds:
//
//   * exact int8 tiles. An int8 value (-127..127) is exact in bf16 and
//     in f16, so the K and V tiles the walk reads hold the raw integers
//     in q's dtype, no scale applied; wgmma's Q . K_int is exact per
//     product and summed in fp32.
//   * page scales folded into S and P, through the walk's key-scale
//     hooks (walk_scaled in hopper.cuh): S = (q . k_int) * (k_scale *
//     sm_scale) per key column in fp32 after the wgmma -- the reference
//     computes q . (k_int * k_scale) in f32, so the two differ only in
//     the order of fp32 rounding; the row sum l is taken from the
//     unscaled P, and then P is multiplied by the key's v_scale and
//     packed to q's dtype as the A operand of the RS wgmma P . V. That
//     packing rounds P * v_scale to q's dtype (relative 2^-9 in bf16,
//     2^-11 in f16, the same rounding the 16-bit prefill gives P; in f16
//     a product below 6.1e-5 loses precision as a subnormal); the Pallas
//     kernel keeps P in f32 in interpret mode (on a TPU an f32 dot at
//     default precision passes its inputs through bf16 as well). The
//     card holds it against the plain version (fp32 throughout) under
//     checks/tolerance.py's rule for q's dtype.
//   * conversion in the producer warpgroup. Its 128 threads each own
//     one 16-byte column chunk of kD / 32 rows of every tile: they read
//     it with 16-byte global loads (half the 16-bit route's page bytes;
//     no tensor map for the pool, so none to encode or cache), convert
//     it to the 16-bit tile in the 128-byte-swizzled panel layout the
//     walk's descriptors read, fence.proxy.async, and arrive on the
//     stage's full barrier. The 16-bit ring lets the producers run up
//     to kPrefillStages tiles ahead of the walk. Keys past the tile's
//     last row come out as zeros and their scales as 0, so 0 x NaN
//     never enters S or P . V. Each key's page scales are written to
//     the stage's scale slot before the arrival (a tile's keys, and an
//     8-key group of them, may come from two pages). Shared memory at d
//     128: Q 16 KB, the 16-bit ring 96 KB (3 stages of K and V), scales
//     1,536 bytes and barriers 80: 117,328 bytes with the alignment
//     slack; one block an SM. At kD 256: Q 32 KB and the ring 192 KB,
//     232,016 bytes with the scales, under the 232,448 a block may take,
//     so all three stages stay.
//
// The TF32 prefill (float32 and mixed pairs) runs the same grid on the
// TF32 walk of hopper.cuh, with converter warpgroups that gather key by
// key as the gathering route does; its design is set out above the
// kernel; at kD 256, where its float32 tiles would not fit one block,
// two blocks a row tile each hold half of the output's columns. Only
// the pairs past head_dim 256 keep the first, simple design: scalar fp32
// FMAs over shared memory, K/V pages staged with plain loads a step of
// keys at a time, four barriers a step.
// PERF.md carries the measured times against the bounds.
//
// Plain C interface, loaded with ctypes by
// tpu_hpc_torch/kernels/_build.py. Every entry point launches on the
// stream it is given, allocates nothing, and returns
// cudaGetLastError() so the caller raises on a refused launch.

#include "hopper.cuh"

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kPrefillThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// ---------------------------------------------------------------------
// Decode: one query token per slot, split over runs of pages.
// ---------------------------------------------------------------------
constexpr int kDecodeThreads = 128;       // 4 warps
constexpr int kDecodeStages = 4;          // tiles in the cp.async ring
constexpr int kDecodeMaxRows = 4;         // query rows of one block
constexpr int kDecodeMinPages = 8;        // pages of one run, at least
constexpr int kDecodeMaxSplits = 32;      // runs of one slot, at most
constexpr int kDecodeBlocksPerSm = 16;    // grid the split aims for
constexpr int kDecodeKeysPerGroup = 4;    // keys of a tile per key group
constexpr int kDecodeTileBytes = 16384;   // K (or V) bytes of a tile

// Lanes of one key group (8 columns each) and key groups per block, for
// head dims up to kD.
template <int kD>
struct DecodeShape {
  static constexpr int kLanes = kD / 8;
  static constexpr int kGroups = kDecodeThreads / kLanes;
};

// Column of element e (0-7) of lane l's slice of a row: 16-bit and int8
// rows give a lane 8 neighbouring columns (one 16- or 8-byte shared
// load), float32 rows two runs of 4, one in each half of a kD-wide row
// (two 16-byte loads); the group's loads are conflict-free either way.
template <typename KT, int kD>
__device__ __forceinline__ int slice_col(int l, int e) {
  if constexpr (sizeof(KT) == 4) {
    return (e >> 2) * (kD / 2) + 4 * l + (e & 3);
  } else {
    return 8 * l + e;
  }
}

__device__ __forceinline__ float2 to_f2(__half2 x) { return __half22float2(x); }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}

// Lane l's 8 elements of a d-element row in shared memory, as floats;
// columns at or past d read as 0. The row is staged 16-byte aligned and
// zero-filled up to its next 16 bytes (DecodeCopy), so a load that
// starts before d and runs past it reads zeros there.
template <typename KT, int kD>
__device__ __forceinline__ void load_slice(const KT* row, int l, int d,
                                           float (&x)[8]) {
  if constexpr (sizeof(KT) == 4) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * (kD / 2) + 4 * l;
      const float4 v = c < d ? *reinterpret_cast<const float4*>(row + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * half] = v.x;
      x[4 * half + 1] = v.y;
      x[4 * half + 2] = v.z;
      x[4 * half + 3] = v.w;
    }
  } else if constexpr (sizeof(KT) == 2) {
    using KT2 = typename std::conditional<std::is_same<KT, __half>::value,
                                          __half2, __nv_bfloat162>::type;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (8 * l < d) u = *reinterpret_cast<const uint4*>(row + 8 * l);
    const KT2* p = reinterpret_cast<const KT2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = to_f2(p[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    uint2 u = make_uint2(0u, 0u);
    if (8 * l < d) u = *reinterpret_cast<const uint2*>(row + 8 * l);
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(b[i]);
  }
}

// P as the P . V product takes it: rounded to a 16-bit pool's dtype (as
// the Pallas kernel's p.astype(v.dtype)), fp32 otherwise.
template <typename KT>
__device__ __forceinline__ float pool_round(float p) {
  if constexpr (std::is_same<KT, __half>::value) {
    return __half2float(__float2half_rn(p));
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else {
    return p;
  }
}

// One online-softmax step for row r over the bs scores in s[0:bs]:
// scores become probabilities in place, as P . V takes them (rounded to
// a 16-bit pool's dtype by pool_round); m, l (the sum of the unrounded
// probabilities) and the rescale factor alpha are updated as in the
// Pallas kernels (m_safe keeps a fully masked row at exp(.) = 0 instead
// of exp(0) = 1). A NaN score keeps its max (fmax_nan, as jnp.max) and
// its probability: only a masked score is kept out of P, so the row
// comes out NaN as from the JAX kernel.
template <typename KT>
__device__ __forceinline__ void softmax_step(float* s, int bs, float* m,
                                             float* l, float* alpha) {
  const float m_prev = *m;
  float mx = m_prev;
  for (int t = 0; t < bs; ++t) mx = fmax_nan(mx, s[t]);
  const float m_safe = (mx <= kMaskValue * 0.5f) ? 0.f : mx;
  float sum = 0.f;
  for (int t = 0; t < bs; ++t) {
    const float p = !(s[t] <= kMaskValue * 0.5f) ? expf(s[t] - m_safe) : 0.f;
    s[t] = pool_round<KT>(p);
    sum += p;
  }
  const float a = expf(m_prev - m_safe);
  *l = a * (*l) + sum;
  *alpha = a;
  *m = mx;
}

// Element i of a q-dtype array (dtype code of kernels/attention.py).
__device__ __forceinline__ float load_q(const void* p, size_t i, int dtype) {
  if (dtype == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  if (dtype == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_q(void* p, size_t i, float x, int dtype) {
  if (dtype == kF16) {
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  } else if (dtype == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte cp.async; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Bytes of the run's page ids (and int8 scales) ahead of the ring.
__host__ __device__ inline int decode_table_bytes(int pages, bool quant) {
  return align16(pages * (quant ? 12 : 4));
}

// Bytes of a K or V row staged in shared memory: the row rounded up to
// whole 16-byte chunks, so every staged row starts 16-byte aligned
// whatever d (a bf16 row of 36 columns is 72 bytes, staged in 80).
__host__ __device__ constexpr int staged_row_bytes(int d, int esize) {
  return align16(d * esize);
}

// Shared memory of a split block: the run's table, then the ring of
// kDecodeStages (K, V) tiles, reused at the end for the key groups'
// partials: o [groups][rows][d], m and l [groups][rows], the merge
// weights [groups][rows].
template <int kD, int kRows>
size_t split_smem_bytes(int pages, bool quant, int tile_keys, int d,
                         int esize) {
  constexpr int kGroups = DecodeShape<kD>::kGroups;
  const size_t ring = static_cast<size_t>(kDecodeStages) * 2 * tile_keys *
                      staged_row_bytes(d, esize);
  const size_t merge = sizeof(float) * (static_cast<size_t>(kGroups) * kRows * d +
                                        3 * kGroups * kRows);
  return decode_table_bytes(pages, quant) + (ring > merge ? ring : merge);
}

// Keys of one streamed tile: the largest divisor of bs that keeps every
// key group at kDecodeKeysPerGroup keys or fewer, a tile's K bytes at
// kDecodeTileBytes or fewer, and 32 keys at most.
int decode_tile_keys(int d, int bs, int esize, int groups) {
  int cap = kDecodeKeysPerGroup * groups;
  cap = cap < 32 ? cap : 32;
  const int by_bytes = kDecodeTileBytes / staged_row_bytes(d, esize);
  cap = cap < by_bytes ? cap : by_bytes;
  for (int t = cap < bs ? cap : bs; t > 1; --t) {
    if (bs % t == 0) return t;
  }
  return 1;
}

// Runs per slot: enough blocks for kDecodeBlocksPerSm per SM if every
// slot's view were full, at least kDecodeMinPages pages a run, at most
// kDecodeMaxSplits runs; none past max_blocks.
int decode_splits(int slots, int hkv, int g, int max_blocks, int sms) {
  const int base = slots * hkv * ((g + kDecodeMaxRows - 1) / kDecodeMaxRows);
  int most = max_blocks / kDecodeMinPages;
  most = most < kDecodeMaxSplits ? most : kDecodeMaxSplits;
  most = most > 1 ? most : 1;
  int n = (kDecodeBlocksPerSm * sms + base - 1) / (base > 0 ? base : 1);
  n = n < most ? n : most;
  n = n > 1 ? n : 1;
  const int pps = (max_blocks + n - 1) / n;
  return (max_blocks + pps - 1) / pps;
}

// cp.async of n (4 or 8) bytes; src_bytes 0 writes zeros and reads
// nothing.
template <int N>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

// The largest head dim the decode and the 16-bit prefill take on the
// card (the kD 256 instantiations).
constexpr int kMaxHeadDim = 256;

// Head dims the decode takes: every d from 1 to kMaxHeadDim, in the
// instantiation of 64, 128 or 256 columns (DecodeShape) that holds it.
bool decode_takes(int d) { return d >= 1 && d <= kMaxHeadDim; }

// One chunk of a staged decode row (DecodeCopy) from a row that is not a
// whole number of 16 bytes (vw < 16): its c_bytes as cp.async pieces of
// vw bytes (8 or 4), or through registers (ld_chunk) on 2- and 1-byte
// boundaries; the rest of the chunk, and all of it where !live, zeros.
// Not inlined, and free of the copier's state: its temporaries stay out
// of the register budget of the 16-byte path, which the 4-row blocks
// fill to their cap.
__device__ __noinline__ void decode_copy_part(uint32_t dst, const void* src,
                                              bool live, int vw, int c_bytes) {
  const unsigned char* b = static_cast<const unsigned char*>(src);
  if (vw == 8) {
#pragma unroll
    for (int off = 0; off < 16; off += 8) {
      // A piece past the row's end reads nothing (its source: the
      // chunk's own first byte).
      const bool in = live && off < c_bytes;
      cp_async_ca<8>(dst + off, b + (in ? off : 0), in ? 8 : 0);
    }
  } else if (vw == 4) {
#pragma unroll
    for (int off = 0; off < 16; off += 4) {
      const bool in = live && off < c_bytes;
      cp_async_ca<4>(dst + off, b + (in ? off : 0), in ? 4 : 0);
    }
  } else {
    const uint4 x = live ? ld_chunk(b, c_bytes, vw) : make_uint4(0u, 0u, 0u, 0u);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
}

// The split kernel's copies: thread tid moves 16-byte chunk `my_chunk`
// of rows my_row, my_row + row_step, ... of a tile's K rows then V rows
// (k and v already point at that chunk of the head), and issue() walks
// the run's tiles in order -- a page at a time, bs / tile_keys tiles a
// page -- so no division is left in the loop. A row is staged at
// row_bytes (staged_row_bytes: 16-byte aligned) whatever d. Where the
// rows in global memory are a whole number of 16 bytes (vw 16) a chunk
// is one 16-byte cp.async; else the chunk's c_bytes (a row's last chunk
// stops at its end) go as cp.async pieces of vw bytes (8 or 4), or, on
// 2- and 1-byte boundaries, through registers (ld_chunk, then a shared
// store); the rest of the chunk is zero-filled either way.
template <typename KT>
struct DecodeCopy {
  const KT* k;
  const KT* v;
  const int* tbl;      // the run's page ids, in shared memory
  size_t tok_stride;   // elements from one key to the next
  uint32_t ring;       // this thread's chunk of stage 0's first K row
  int bs, tile_keys, row_bytes, tile_bytes, row_step, my_row, key0, key_end,
      n_tiles, vw, c_bytes;
  int page = 0, row = 0;  // the next tile's page (in the run) and row

  // Loads tile `tile` (the next one) into its ring stage; keys past the
  // run's end are zero-filled. Always one commit group, so the wait
  // counts of the walk hold at the end of the run too.
  __device__ __forceinline__ void issue(int tile) {
    if (tile < n_tiles && my_row < row_step) {
      const int k_first = key0 + tile * tile_keys;
      const size_t base = (static_cast<size_t>(tbl[page]) * bs + row) * tok_stride;
      const uint32_t dst0 = ring + (tile % kDecodeStages) * 2 * tile_bytes;
      if (vw == 16) {  // whole 16-byte chunks (a branch uniform over the kernel)
        for (int r = my_row; r < 2 * tile_keys; r += row_step) {
          const int which = r >= tile_keys;
          const int t = r - which * tile_keys;
          cp_async16(dst0 + which * tile_bytes + t * row_bytes,
                     (which ? v : k) + base + t * tok_stride,
                     k_first + t < key_end ? 16 : 0);
        }
      } else {
        for (int r = my_row; r < 2 * tile_keys; r += row_step) {
          const int which = r >= tile_keys;
          const int t = r - which * tile_keys;
          decode_copy_part(dst0 + which * tile_bytes + t * row_bytes,
                           (which ? v : k) + base + t * tok_stride,
                           k_first + t < key_end, vw, c_bytes);
        }
      }
    }
    row += tile_keys;
    if (row == bs) {
      row = 0;
      ++page;
    }
    cp_async_commit();
  }
};

// Up to 128 registers a thread: left to itself ptxas holds the g-1 and
// g-2 instantiations at 64-96 and spills a few bytes; the cap lets them
// grow instead, and keeps the 4-row ones at 128 (4 blocks an SM).
template <typename KT, int kD, int kRows>
__global__ void __maxnreg__(128) paged_decode_split_kernel(
    const void* __restrict__ q,          // (slots, hkv, g, d), q_dtype
    const KT* __restrict__ k_pages,      // (num_blocks, bs, hkv, d)
    const KT* __restrict__ v_pages,
    const int* __restrict__ tables,      // (slots, table_width)
    const int* __restrict__ pos,         // (slots,)
    const int* __restrict__ active,      // (slots,)
    const float* __restrict__ k_scale,   // (num_blocks,): int8 pools
    const float* __restrict__ v_scale,
    void* __restrict__ out,              // (slots, hkv, g, d): one run
    float* __restrict__ o_part,          // (slots, hkv, runs, g, d)
    float* __restrict__ lse_part,        // (slots, hkv, runs, g)
    int q_dtype, int hkv, int g, int d, int bs, int table_width,
    int max_blocks, int pages_per_split, int tile_keys, float scale2) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kLanes = DecodeShape<kD>::kLanes;
  constexpr int kGroups = DecodeShape<kD>::kGroups;
  const int h = blockIdx.x;  // heads first: a run's pages are read together
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int row_groups = (g + kRows - 1) / kRows;
  const int slot = blockIdx.z / row_groups;
  const int row0 = (blockIdx.z - slot * row_groups) * kRows;
  const int n_rows = min(kRows, g - row0);
  const int tid = threadIdx.x;
  const int l = tid % kLanes;   // lane within the key group
  const int kg = tid / kLanes;  // key group
  const size_t head = static_cast<size_t>(slot) * hkv + h;
  const size_t part_row = (head * n_split + split) * g + row0;

  extern __shared__ __align__(16) unsigned char decode_smem[];
  int* tbl = reinterpret_cast<int*>(decode_smem);
  float* ksc = reinterpret_cast<float*>(tbl + pages_per_split);
  float* vsc = ksc + pages_per_split;
  unsigned char* ring = decode_smem + decode_table_bytes(pages_per_split, kQuant);

  // pos, the run's page ids and the query rows load together: a table
  // entry is read whether or not its page is live (no page is read for
  // it), so the first page loads wait for one round trip, not two.
  const int p_pos = pos[slot];
  const int is_active = active[slot];
  const int page0 = split * pages_per_split;
  const int page_end = min(page0 + pages_per_split, max_blocks);
  const int* trow = tables + static_cast<size_t>(slot) * table_width + page0;
  for (int i = tid; i < page_end - page0; i += kDecodeThreads) tbl[i] = trow[i];
  // This lane's 8 columns of the block's query rows.
  float qr[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = slice_col<KT, kD>(l, e);
      qr[r][e] = r < n_rows && col < d
                     ? load_q(q, (head * g + row0 + r) * d + col, q_dtype)
                     : 0.f;
    }
  }
  if (is_active == 0 || page0 > p_pos / bs) {
    // The empty partial: no key seen, nothing read.
    if (n_split == 1) {
      for (int i = tid; i < n_rows * d; i += kDecodeThreads)
        store_q(out, (head * g + row0) * d + i, 0.f, q_dtype);
    } else {
      for (int r = tid; r < n_rows; r += kDecodeThreads)
        lse_part[part_row + r] = kMaskValue;
    }
    return;
  }
  const int key0 = page0 * bs;
  const int key_end = min(page_end * bs, p_pos + 1);
  const int n_pages = (key_end - key0 + bs - 1) / bs;
  const int n_tiles = (key_end - key0 + tile_keys - 1) / tile_keys;

  if constexpr (kQuant) {
    for (int i = tid; i < n_pages; i += kDecodeThreads) {
      ksc[i] = k_scale[trow[i]];
      vsc[i] = v_scale[trow[i]];
    }
  }
  __syncthreads();  // the table is in shared memory
  constexpr int kEsize = static_cast<int>(sizeof(KT));
  const int row_bytes = staged_row_bytes(d, kEsize);
  const int ds = row_bytes / kEsize;  // elements between staged rows
  const int tile_bytes = tile_keys * row_bytes;

  const int chunks_row = row_bytes / 16;
  const int my_row = tid / chunks_row;
  const int my_chunk = tid - my_row * chunks_row;
  const size_t my_col = static_cast<size_t>(h) * d + my_chunk * (16 / kEsize);
  DecodeCopy<KT> copy{k_pages + my_col, v_pages + my_col, tbl,
                      static_cast<size_t>(hkv) * d,
                      smem_u32(ring) + my_chunk * 16, bs, tile_keys, row_bytes,
                      tile_bytes, kDecodeThreads / chunks_row, my_row, key0,
                      key_end, n_tiles,
                      min(vec_bytes(k_pages, d * kEsize),
                          vec_bytes(v_pages, d * kEsize)),
                      chunk_bytes(my_chunk, d, kEsize)};

  float o[kRows][8];
  float m[kRows], lsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMaskValue;
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[r][e] = 0.f;
  }
  const int kpg = (tile_keys + kGroups - 1) / kGroups;  // keys per group

#pragma unroll
  for (int st = 0; st < kDecodeStages - 1; ++st) copy.issue(st);
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kDecodeStages - 2>();  // this thread's copies of `tile`
    __syncthreads();  // everyone's copies; the stage refilled below is free
    copy.issue(tile + kDecodeStages - 1);
    const KT* ks = reinterpret_cast<const KT*>(
        ring + (tile % kDecodeStages) * 2 * tile_bytes);
    const KT* vs = ks + tile_keys * ds;
    const int k_first = key0 + tile * tile_keys;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kQuant) {
      k_sc = ksc[k_first / bs - page0];
      v_sc = vsc[k_first / bs - page0];
    }
    // Scores of the group's keys, in log2 units.
    float s[kDecodeKeysPerGroup][kRows];
#pragma unroll
    for (int j = 0; j < kDecodeKeysPerGroup; ++j) {
      if (j >= kpg) break;  // uniform over the block
      const int t = kg + j * kGroups;
      const bool seen = t < tile_keys && k_first + t < key_end;
      float kx[8];
      if (seen) {
        load_slice<KT, kD>(ks + t * ds, l, d, kx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qr[r][e], kx[e], part);
        part = group_sum<kLanes>(part);
        s[j][r] = seen ? part * k_sc * scale2 : kMaskValue;
      }
    }
    // Online softmax over them, per row; a NaN score keeps the max and P
    // (as the JAX kernel, whose row then comes out NaN).
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kDecodeKeysPerGroup; ++j)
        if (j < kpg) mx = fmax_nan(mx, s[j][r]);
      const float m_safe = mx <= kMaskValue * 0.5f ? 0.f : mx;
      const float alpha = exp2f(m[r] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kDecodeKeysPerGroup; ++j) {
        if (j < kpg) {
          const float p = !(s[j][r] <= kMaskValue * 0.5f) ? exp2f(s[j][r] - m_safe) : 0.f;
          s[j][r] = p;
          sum += p;
        }
      }
      lsum[r] = alpha * lsum[r] + sum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[r][e] *= alpha;
    }
    // O += P . V, V read once for all rows.
#pragma unroll
    for (int j = 0; j < kDecodeKeysPerGroup; ++j) {
      if (j >= kpg) break;
      const int t = kg + j * kGroups;
      if (t < tile_keys && k_first + t < key_end) {
        float vx[8];
        load_slice<KT, kD>(vs + t * ds, l, d, vx);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pv = pool_round<KT>(s[j][r]) * v_sc;
#pragma unroll
          for (int e = 0; e < 8; ++e) o[r][e] = fmaf(pv, vx[e], o[r][e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // every group is done with the ring

  // Merge the key groups' partials: o, m, l through shared memory.
  float* o_s = reinterpret_cast<float*>(ring);   // [groups][rows][d]
  float* m_s = o_s + kGroups * kRows * d;        // [groups][rows]
  float* l_s = m_s + kGroups * kRows;
  float* w_s = l_s + kGroups * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < n_rows) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = slice_col<KT, kD>(l, e);
        if (col < d) o_s[(kg * kRows + r) * d + col] = o[r][e];
      }
      if (l == 0) {
        m_s[kg * kRows + r] = m[r];
        l_s[kg * kRows + r] = lsum[r];
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < n_rows; r += kDecodeThreads) {
    float mx = kMaskValue;
    for (int i = 0; i < kGroups; ++i) mx = fmax_nan(mx, m_s[i * kRows + r]);
    const float m_safe = mx <= kMaskValue * 0.5f ? 0.f : mx;
    float total = 0.f;
    for (int i = 0; i < kGroups; ++i) {
      const float w = exp2f(m_s[i * kRows + r] - m_safe);
      w_s[i * kRows + r] = w;
      total += w * l_s[i * kRows + r];
    }
    const float l_safe = total == 0.f ? 1.f : total;
    const float inv = __fdividef(1.f, l_safe);  // l_safe >= 1: no slow path
    for (int i = 0; i < kGroups; ++i) w_s[i * kRows + r] *= inv;
    if (n_split > 1) {
      lse_part[part_row + r] =
          mx <= kMaskValue * 0.5f ? kMaskValue : mx * kLn2 + logf(l_safe);
    }
  }
  __syncthreads();
  for (int i = tid; i < n_rows * d; i += kDecodeThreads) {
    const int r = i / d;
    const int x = i - r * d;
    float acc = 0.f;
    for (int j = 0; j < kGroups; ++j)
      acc = fmaf(w_s[j * kRows + r], o_s[(j * kRows + r) * d + x], acc);
    if (n_split == 1) {
      store_q(out, (head * g + row0) * d + i, acc, q_dtype);
    } else {
      o_part[part_row * d + i] = acc;
    }
  }
}

// Merges a slot's runs: grid (kv_heads, slots). Per row, the runs'
// weights exp(lse - m_safe) / denom_safe as in kernels/attention.py's
// lse_merge, summed over the runs in order. The runs that saw a key are
// a prefix (those that start at or before pos); only they were written,
// and only they are read. An inactive slot's runs all saw none: its
// output is zeros, and nothing but its lse is read. A NaN lse (a run
// that saw a NaN score) counts as live and makes the row NaN.
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_combine_kernel(
    const float* __restrict__ o_part,    // (slots, hkv, runs, g, d)
    const float* __restrict__ lse_part,  // (slots, hkv, runs, g)
    void* __restrict__ out, int q_dtype, int hkv, int g, int d, int n_split) {
  const int slot = blockIdx.y;
  const size_t head = static_cast<size_t>(slot) * hkv + blockIdx.x;
  const int tid = threadIdx.x;
  extern __shared__ float combine_w[];  // [g][runs], then the live runs
  int* live_runs = reinterpret_cast<int*>(combine_w + g * n_split);
  for (int r = tid; r < g; r += kDecodeThreads) {
    const float* lse = lse_part + head * n_split * g + r;
    float mx = kMaskValue;
    int n_live = 0;
    for (int i = 0; i < n_split; ++i) {
      const float x = lse[i * g];
      mx = fmax_nan(mx, x);
      n_live += !(x <= kMaskValue * 0.5f);
    }
    const float m_safe = mx <= kMaskValue * 0.5f ? 0.f : mx;
    float denom = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float w = expf(lse[i * g] - m_safe);
      combine_w[r * n_split + i] = w;
      denom += w;
    }
    // denom_safe; a live run's weight is 1 at the max, so denom >= 1.
    const float inv = __fdividef(1.f, denom == 0.f ? 1.f : denom);
    for (int i = 0; i < n_live; ++i) combine_w[r * n_split + i] *= inv;
    if (r == 0) *live_runs = n_live;
  }
  __syncthreads();
  const int n_live = *live_runs;
  if (d % 4 != 0) {  // rows of the partials not 16-byte aligned: by element
    for (int i = tid; i < g * d; i += kDecodeThreads) {
      const int r = i / d;
      const float* o = o_part + (head * n_split * g + r) * d + (i - r * d);
      const float* w = combine_w + r * n_split;
      float acc = 0.f;
      for (int run = 0; run < n_live; ++run)
        acc = fmaf(w[run], o[static_cast<size_t>(run) * g * d], acc);
      store_q(out, head * g * d + i, acc, q_dtype);
    }
    return;
  }
  const int d4 = d / 4;
  const float4* o4 = reinterpret_cast<const float4*>(o_part);
  for (int i = tid; i < g * d4; i += kDecodeThreads) {
    const int r = i / d4;
    const float4* o = o4 + (head * n_split * g + r) * d4 + (i - r * d4);
    const float* w = combine_w + r * n_split;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int run = 0; run < n_live; ++run) {
      const float4 v = o[static_cast<size_t>(run) * g * d4];
      acc.x = fmaf(w[run], v.x, acc.x);
      acc.y = fmaf(w[run], v.y, acc.y);
      acc.z = fmaf(w[run], v.z, acc.z);
      acc.w = fmaf(w[run], v.w, acc.w);
    }
    const size_t at = head * g * d + 4 * static_cast<size_t>(i);
    store_q(out, at, acc.x, q_dtype);
    store_q(out, at + 1, acc.y, q_dtype);
    store_q(out, at + 2, acc.z, q_dtype);
    store_q(out, at + 3, acc.w, q_dtype);
  }
}

// ---------------------------------------------------------------------
// Chunked prefill, any pair of dtypes, at the head dims the tensor-core
// routes below do not take (prefill_route: every pair past
// kMaxHeadDim): grid (kv_heads, row tiles).
// Grouped query row r of head h sits at position start + r / g; a block
// owns tq consecutive rows and walks the pages up to its last row's
// causal limit, tk keys of a page at a time (scalar_tile: a whole page
// where it fits). Shared-memory rows are padded to d + 1 floats so the
// per-key dot products hit distinct banks.
// ---------------------------------------------------------------------
template <typename QT, typename KT>
__global__ void __launch_bounds__(kPrefillThreads) paged_prefill_kernel(
    const QT* __restrict__ q,           // (hkv, bucket, g, d)
    const KT* __restrict__ k_pages,     // (num_blocks, bs, hkv, d)
    const KT* __restrict__ v_pages,
    const int* __restrict__ table,      // (table_width,)
    const float* __restrict__ k_scale,  // (num_blocks,) or null
    const float* __restrict__ v_scale,
    QT* __restrict__ out,               // (hkv, bucket, g, d)
    int hkv, int bucket, int g, int d, int bs, int max_blocks, int start,
    int tq, int tk, float sm_scale) {
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_rows_total = bucket * g;
  const int row0 = blockIdx.y * tq;
  const int nrows = min(tq, n_rows_total - row0);
  const int dp = d + 1;

  extern __shared__ float smem[];
  float* qs = smem;                 // [tq][dp]
  float* acc = qs + tq * dp;        // [tq][dp]
  float* kt = acc + tq * dp;        // [tk][dp]
  float* vt = kt + tk * dp;         // [tk][dp]
  float* sc = vt + tk * dp;         // [tq][tk]
  float* m = sc + tq * tk;          // [tq]
  float* l = m + tq;                // [tq]
  float* alpha = l + tq;            // [tq]

  const size_t qbase = (static_cast<size_t>(h) * n_rows_total + row0) * d;
  for (int i = tid; i < nrows * d; i += kPrefillThreads) {
    const int r = i / d;
    const int x = i - r * d;
    qs[r * dp + x] = to_f(q[qbase + i]);
    acc[r * dp + x] = 0.f;
  }
  for (int r = tid; r < nrows; r += kPrefillThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }

  // Causal page skip: pages whose first key is past this tile's last
  // row are never read.
  const int last_pos = start + (row0 + nrows - 1) / g;
  const int n_pages = min(last_pos / bs + 1, max_blocks);
  const size_t tok_stride = static_cast<size_t>(hkv) * d;
  const size_t page_stride = static_cast<size_t>(bs) * tok_stride;

  for (int j = 0; j < n_pages; ++j) {
    const int page = table[j];
    const float ksc = k_scale != nullptr ? k_scale[page] : 1.f;
    const float vsc = v_scale != nullptr ? v_scale[page] : 1.f;
    for (int t0 = 0; t0 < bs; t0 += tk) {  // keys t0 .. t0 + nk - 1 of the page
      const int nk = min(tk, bs - t0);
      const KT* kp = k_pages + page * page_stride + t0 * tok_stride +
                     static_cast<size_t>(h) * d;
      const KT* vp = v_pages + page * page_stride + t0 * tok_stride +
                     static_cast<size_t>(h) * d;
      __syncthreads();  // the previous keys' tiles are no longer read
      for (int i = tid; i < nk * d; i += kPrefillThreads) {
        const int t = i / d;
        const int x = i - t * d;
        kt[t * dp + x] = to_f(kp[t * tok_stride + x]) * ksc;
        vt[t * dp + x] = to_f(vp[t * tok_stride + x]) * vsc;
      }
      __syncthreads();
      for (int i = tid; i < nrows * nk; i += kPrefillThreads) {
        const int r = i / nk;
        const int t = i - r * nk;
        const int qpos = start + (row0 + r) / g;
        float s = kMaskValue;
        if (j * bs + t0 + t <= qpos) {
          const float* qrow = qs + r * dp;
          const float* krow = kt + t * dp;
          float dot = 0.f;
          for (int x = 0; x < d; ++x) dot += qrow[x] * krow[x];
          s = dot * sm_scale;
        }
        sc[i] = s;
      }
      __syncthreads();
      for (int r = tid; r < nrows; r += kPrefillThreads)
        softmax_step<KT>(sc + r * nk, nk, m + r, l + r, alpha + r);
      __syncthreads();
      for (int i = tid; i < nrows * d; i += kPrefillThreads) {
        const int r = i / d;
        const int x = i - r * d;
        const float* p = sc + r * nk;
        float a = acc[r * dp + x] * alpha[r];
        for (int t = 0; t < nk; ++t) a += p[t] * vt[t * dp + x];
        acc[r * dp + x] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * d; i += kPrefillThreads) {
    const int r = i / d;
    const int x = i - r * d;
    const float lr = l[r];
    out[qbase + i] = from_f<QT>(acc[r * dp + x] / (lr == 0.f ? 1.f : lr));
  }
}

// ---------------------------------------------------------------------
// Chunked prefill, 16-bit q and pool of one dtype on pages TMA boxes
// tile (prefill_route's kRouteWgmma). Grid
// (kv_heads, row tiles of kPrefillRows), the last (heaviest) row tiles
// first. One consumer warpgroup owns the tile's 64 grouped q rows; a
// producer warp loads the Q tile by TMA and assembles each 64-key K or V
// tile of the ring from 64 / bs pages -- one TMA box per page (64
// columns x bs rows of one head) at row j * bs of the tile, or one
// 64-row box of a page of 64 or more keys -- reading the block's own
// table row. A page past the tile's last row (or past max_blocks) is
// never read; the rows it would have filled in the last tile are written
// as zeros instead, so a masked P of 0 never meets stale or
// uninitialised bytes (0 x NaN is NaN in P . V). The walk is the
// training forward's (hopper.cuh), with qpos = start + r / g.
// ---------------------------------------------------------------------
constexpr int kPrefillRows = 64;
constexpr int kPrefillWgmmaThreads = 160;  // a consumer warpgroup + a producer warp
constexpr int kPrefillStages = 3;
// The page extent of the pool's tensor map: the table names the pages
// (as in the other kernels, its entries are trusted), so the map need
// not know the pool's length.
constexpr int kPoolPages = 1 << 30;

template <int kD>
constexpr size_t prefill_wgmma_smem_bytes() {
  return kPrefillRows * kD * 2 + 2 * kPrefillStages * walk_tile_bytes<kD>() +
         (1 + 3 * kPrefillStages) * 8 + 1024;
}

// The prefill's mask for one thread: its two rows at positions qpos[0],
// qpos[1], the tile's first row at `first`; keys past the view
// (max_blocks * bs) do not exist.
struct PrefillMask {
  int qpos[2];
  int first;
  int n_keys;
  __device__ __forceinline__ bool edge(int k_last) const {
    return k_last > first || k_last >= n_keys;
  }
  __device__ __forceinline__ bool sees(int r, int key) const {
    return key <= qpos[r] && key < n_keys;
  }
};

// The mask of a tensor-core prefill thread's two grouped rows, r0 and
// r0 + 8, in the 64-row tile from row0.
__device__ __forceinline__ PrefillMask prefill_mask(int r0, int row0, int g,
                                                    int start, int n_keys) {
  return PrefillMask{{start + r0 / g, start + (r0 + 8) / g}, start + row0 / g,
                     n_keys};
}

// The consumer warpgroup of a tensor-core prefill: rows r0 and r0 + 8
// through the walk over the ring's n_tiles tiles once the Q tile has
// arrived on bar_q, then written to out (hkv, bucket, g, d) -- in column
// pairs where d is even (kEven), by element otherwise.
template <typename T, int kD, bool kEven = true, typename Mask>
__device__ __forceinline__ void prefill_consume(const Mask& mask, int r0,
                                                uint32_t s_q, uint32_t bar_q,
                                                const WalkRing& ring,
                                                int n_tiles, float sm_scale,
                                                T* out, int h, int n_rows,
                                                int d) {
  WalkRows<kD> rows;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) rows.o[i] = 0.f;
  rows.m[0] = rows.m[1] = kMaskValue;
  rows.l[0] = rows.l[1] = 0.f;

  mbar_wait(bar_q, 0);
  walk<T, kD>(rows, s_q, kPrefillRows, 0, ring, n_tiles, sm_scale * kLog2e,
              mask);
  T* row_ptr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    row_ptr[r] = row < n_rows
                     ? out + (static_cast<size_t>(h) * n_rows + row) * d
                     : nullptr;
  }
  float row_lse[2];  // not an output of the prefill
  walk_finish<T, kD, kEven>(rows, row_ptr, d, row_lse);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kPrefillWgmmaThreads) paged_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // q as [hkv, bucket g, 1, d]
    const __grid_constant__ CUtensorMap tm_k,  // pool as [pages, bs, hkv, d]
    const __grid_constant__ CUtensorMap tm_v,
    const int* __restrict__ table,  // (table_width,)
    T* __restrict__ out,            // (hkv, bucket, g, d)
    int bucket, int g, int d, int bs, int max_blocks, int start,
    float sm_scale) {
  constexpr int kQ = kPrefillRows * kD * 2;
  constexpr int kTile = walk_tile_bytes<kD>();
  const int h = blockIdx.x;
  const int n_rows = bucket * g;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kPrefillRows;
  const int nrows = min(kPrefillRows, n_rows - row0);
  const int warp = threadIdx.x >> 5;  // 0-3 consumers, 4 the producer
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  WalkRing ring;
  ring.k = s_q + kQ;
  ring.v = ring.k + kPrefillStages * kTile;
  const uint32_t bar_q = ring.v + kPrefillStages * kTile;
  ring.full_k = bar_q + 8;
  ring.full_v = ring.full_k + 8 * kPrefillStages;
  ring.empty = ring.full_v + 8 * kPrefillStages;
  ring.stages = kPrefillStages;

  // Keys the tile's last row can see, the tiles and pages they span.
  const int n_keys = max_blocks * bs;
  const int last_pos = start + (row0 + nrows - 1) / g;
  const int live_keys = min(last_pos + 1, n_keys);
  const int n_tiles = (live_keys + kWalkKeys - 1) / kWalkKeys;
  const int n_pages = (live_keys + bs - 1) / bs;
  // Panels holding a column below d: the boxes load only these; the
  // rest of a padded head dim (e.g. 192-255 at d 136) is zeroed here,
  // once, in Q and in every stage, and no box ever writes it.
  const int panels = live_panels<kD>(d);
  if (panels < kD / 64) {
    zero_dead_panels<kD>(s_q, kPrefillRows, 1, d, kPrefillWgmmaThreads);
    zero_dead_panels<kD>(ring.k, kWalkKeys, 2 * kPrefillStages, d,
                         kPrefillWgmmaThreads);
    fence_proxy_async();
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q);
    for (int st = 0; st < kPrefillStages; ++st) {
      mbar_init(ring.full_k + 8 * st);
      mbar_init(ring.full_v + 8 * st);
      mbar_init(ring.empty + 8 * st, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(bar_q, kPrefillRows * kPanelRowBytes * panels);
      tma_tile<kD>(s_q, &tm_q, bar_q, 0, row0, h, kPrefillRows, panels);
    }
    const int box = min(bs, kWalkKeys);  // rows of one box
    const int per = kWalkKeys / box;     // boxes (pages) per tile
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kPrefillStages;
      if (kt >= kPrefillStages)
        mbar_wait(ring.empty + 8 * st, (kt / kPrefillStages - 1) & 1);
      const int first_page = kt * kWalkKeys / bs;
      const int n_live = min(per, n_pages - first_page);
      const uint32_t k_tile = ring.k + st * kTile;
      const uint32_t v_tile = ring.v + st * kTile;
      if (n_live < per) {  // the last tile: zero the rows no page fills
        const int z0 = n_live * box * kPanelRowBytes;
        const int z_bytes = kWalkKeys * kPanelRowBytes - z0;
        for (int p = 0; p < kD / 64; ++p) {
          for (int i = 16 * lane; i < z_bytes; i += 16 * 32) {
            const uint32_t off = p * kWalkKeys * kPanelRowBytes + z0 + i;
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                         :: "r"(k_tile + off), "r"(0u) : "memory");
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                         :: "r"(v_tile + off), "r"(0u) : "memory");
          }
        }
        fence_proxy_async();
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t bytes = n_live * box * kPanelRowBytes * panels;
        const int t0 = bs > kWalkKeys ? kt * kWalkKeys % bs : 0;
        mbar_expect_tx(ring.full_k + 8 * st, bytes);
        for (int i = 0; i < n_live; ++i)
          tma_tile<kD>(k_tile + i * box * kPanelRowBytes, &tm_k,
                       ring.full_k + 8 * st, h, t0, table[first_page + i],
                       kWalkKeys, panels);
        mbar_expect_tx(ring.full_v + 8 * st, bytes);
        for (int i = 0; i < n_live; ++i)
          tma_tile<kD>(v_tile + i * box * kPanelRowBytes, &tm_v,
                       ring.full_v + 8 * st, h, t0, table[first_page + i],
                       kWalkKeys, panels);
      }
    }
    return;
  }

  const int r0 = row0 + 16 * warp + (lane >> 2);
  prefill_consume<T, kD>(prefill_mask(r0, row0, g, start, n_keys), r0, s_q,
                         bar_q, ring, n_tiles, sm_scale, out, h, n_rows, d);
}

// ---------------------------------------------------------------------
// Chunked prefill through a gathering producer, at any page size
// (prefill_route's kRouteWgmmaGather: 16-bit q and pool of one dtype on
// pages TMA boxes cannot tile; kRouteWgmmaInt8: an int8 pool under a
// 16-bit q, every page size): the 16-bit prefill's grid, Q tile (TMA),
// walk and consumer, with a producer warpgroup in place of the TMA
// warp. Its 128 threads gather each 64-key K and V tile key by key
// through the block's own table row (table[key / bs]), so a tile may
// span any number of pages or part of one. Each thread owns one 16-byte
// column chunk of kCpr / 2 rows of every tile (kD / 16 rows over a 16-bit
// pool, kD / 32 over int8; the chunks of one key's row are neighbouring
// threads, so the loads coalesce), loads them (K and V) with 16-byte
// global loads, and writes them where TMA's 128-byte swizzle would have
// put them: as they are over a pool of q's dtype, as their raw integers
// in T (exact) over int8. Then it fences and arrives on the stage's full
// barrier (128 arrivals). Keys past the tile's last row (live_keys) and
// columns past d are never read and are written as zeros, so a masked P
// of 0 never meets stale bytes. Over a pool of q's dtype the tiles hold
// what the TMA route's boxes hold at every key the mask lets through, and
// zeros where the TMA route may hold a key it hides, so a chunk's output
// is the TMA route's over the same keys, bit for bit. Over an int8 pool
// thread c also reads the page scale of key c (K, threads 0-63) or key c
// - 64 (V, 64-127) of the tile -- one a key, since a tile's keys, and an
// 8-key group of them, may come from two pages -- and writes it to the
// stage's scale slot before arriving (0 past live_keys, so 0 x NaN never
// enters S or P . V); PrefillInt8Mask hands the scales to the walk.
// Each thread reads the table entries of all its rows of tile kt + 1,
// then their data, before it writes tile kt: one table read's latency
// a tile, hidden behind the wait for the stage and the stores (read row
// by row, that latency set the kernel's time: PERF.md). At kD 256 a
// 16-bit pool's chunks of a tile would take 256 registers a thread, so
// the thread loads K and V as halves, one half ahead. kWhole: the rows
// of q and the pool are a whole number of 16 bytes (Q by TMA, 16-byte
// loads, output in column pairs); the other instantiation reads rows on
// the boundaries they have (ld_chunk), Q too, and stores by element.
// ---------------------------------------------------------------------
constexpr int kGatherThreads = 256;  // a consumer warpgroup + a producer warpgroup

// Dynamic shared memory, from a 1024-byte-aligned base: the Q tile, the
// walk's 16-bit K and V ring, an int8 pool's per-key scales
// [kPrefillStages][128] (64 K, then 64 V), the barriers. d 128: 16 + 96
// KB, 1,536 bytes of scales over int8 and 80 of barriers; d 64: half
// the tiles; d 256: twice (32 + 192 KB; 232,016 bytes over int8, with
// the 1,024 of alignment slack).
template <int kD, bool kScaled>
constexpr size_t prefill_gather_smem_bytes() {
  return kPrefillRows * kD * 2 + 2 * kPrefillStages * walk_tile_bytes<kD>() +
         (kScaled ? kPrefillStages * 2 * kWalkKeys * sizeof(float) : 0) +
         (1 + 3 * kPrefillStages) * 8 + 1024;
}
static_assert(prefill_gather_smem_bytes<256, true>() <= kMaxSmem &&
                  prefill_wgmma_smem_bytes<256>() <= kMaxSmem,
              "kD 256 keeps three stages of K and V");

// The int8 pool's mask: the 16-bit prefill's, plus each key's page
// scales, which the walk folds into S and P.
struct PrefillInt8Mask : PrefillMask {
  const float* scales;  // [kPrefillStages][2][kWalkKeys] in shared memory
  __device__ __forceinline__ float s_scale(int kt, int key) const {
    return scales[(kt % kPrefillStages) * 2 * kWalkKeys + key];
  }
  __device__ __forceinline__ float p_scale(int kt, int key) const {
    return scales[(kt % kPrefillStages) * 2 * kWalkKeys + kWalkKeys + key];
  }
};

// 16-byte chunk c (8 columns of 16 bits) of row t into the tile at
// `tile` (kD columns, 64 rows, the 128-byte-swizzled panels of
// hopper.cuh).
__device__ __forceinline__ void put_chunk16(uint32_t tile, int t, int c,
                                            const uint4& x) {
  const uint32_t dst = tile + (c >> 3) * kWalkKeys * kPanelRowBytes +
                       t * kPanelRowBytes + (((c & 7) ^ (t & 7)) << 4);
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// Chunk cc of row t of a KT pool into the 16-bit tile: a 16-bit chunk as
// it is; an int8 chunk (16 columns) as the 16-bit chunks 2 cc and 2 cc +
// 1 of its raw integers in T.
template <typename T, typename KT>
__device__ __forceinline__ void put_pool_chunk(const uint4& x, uint32_t tile,
                                               int t, int cc) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      i8x4_to_f32(w[j], f);
      o[2 * j] = pack2<T>(f[0], f[1]);
      o[2 * j + 1] = pack2<T>(f[2], f[3]);
    }
    put_chunk16(tile, t, 2 * cc, make_uint4(o[0], o[1], o[2], o[3]));
    put_chunk16(tile, t, 2 * cc + 1, make_uint4(o[4], o[5], o[6], o[7]));
  } else {
    put_chunk16(tile, t, cc, x);
  }
}

template <typename T, typename KT, int kD, bool kWhole>
__global__ void __launch_bounds__(kGatherThreads, 1) paged_prefill_gather_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // q as [hkv, bucket g, 1, d]
    const T* __restrict__ q,                   // (hkv, bucket, g, d)
    const KT* __restrict__ k_pages,            // (num_blocks, bs, hkv, d)
    const KT* __restrict__ v_pages,
    const int* __restrict__ table,             // (table_width,)
    const float* __restrict__ k_scale,         // (num_blocks,): int8 pools
    const float* __restrict__ v_scale,
    T* __restrict__ out,                       // (hkv, bucket, g, d)
    int hkv, int bucket, int g, int d, int bs, int max_blocks, int start,
    float sm_scale) {
  constexpr bool kScaled = std::is_same<KT, int8_t>::value;
  constexpr int kQ = kPrefillRows * kD * 2;
  constexpr int kTile = walk_tile_bytes<kD>();
  constexpr int kScaleBytes = kScaled ? 2 * kWalkKeys * 4 : 0;  // a stage's
  const int h = blockIdx.x;
  const int n_rows = bucket * g;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kPrefillRows;
  const int nrows = min(kPrefillRows, n_rows - row0);
  const int warp = threadIdx.x >> 5;  // 0-3 consumers, 4-7 the producers
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  WalkRing ring;
  ring.k = s_q + kQ;
  ring.v = ring.k + kPrefillStages * kTile;
  const uint32_t s_sc = ring.v + kPrefillStages * kTile;
  const uint32_t bar_q = s_sc + kScaleBytes * kPrefillStages;
  ring.full_k = bar_q + 8;
  ring.full_v = ring.full_k + 8 * kPrefillStages;
  ring.empty = ring.full_v + 8 * kPrefillStages;
  ring.stages = kPrefillStages;
  float* scales = reinterpret_cast<float*>(smem_raw + (s_sc - smem_u32(smem_raw)));

  // Keys the tile's last row can see, and the tiles they span.
  const int n_keys = max_blocks * bs;
  const int last_pos = start + (row0 + nrows - 1) / g;
  const int live_keys = min(last_pos + 1, n_keys);
  const int n_tiles = (live_keys + kWalkKeys - 1) / kWalkKeys;
  // Q's panels holding a column below d; a TMA load of Q fills only
  // those, and the rest of a padded head dim is zeroed here, once (kD
  // 256 only, as in the TMA kernel).
  const int panels = live_panels<kD>(d);
  if (kWhole && panels < kD / 64) {
    zero_dead_panels<kD>(s_q, kPrefillRows, 1, d, kGatherThreads);
    fence_proxy_async();
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, kWhole ? 1 : 128);
    for (int st = 0; st < kPrefillStages; ++st) {
      mbar_init(ring.full_k + 8 * st, 128);
      mbar_init(ring.full_v + 8 * st, 128);
      mbar_init(ring.empty + 8 * st, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup
    constexpr int kE = 16 / sizeof(KT);           // pool columns of a chunk
    constexpr int kCpr = kD / kE;                 // chunks of a row
    constexpr int kRowStep = 128 / kCpr;          // between a thread's rows
    constexpr int kRows = kWalkKeys / kRowStep;   // rows of a tile per thread
    // Loaded one tile ahead, a thread's K and V chunks of a tile take
    // 4 kRows registers twice over: 128 up to kD 128 (and for int8 at
    // 256). A 16-bit pool at kD 256 (16 rows a thread) would take 256,
    // so there the thread loads K and V as two halves, each one half
    // ahead of the one it writes.
    constexpr bool kHalves = kRows > 8;
    const int c = threadIdx.x - 128;
    const int cc = c % kCpr;
    const int t0 = c / kCpr;
    if constexpr (kWhole) {
      if (c == 0) {
        mbar_expect_tx(bar_q, kPrefillRows * kPanelRowBytes * panels);
        tma_tile<kD>(s_q, &tm_q, bar_q, 0, row0, h, kPrefillRows, panels);
      }
    } else {
      // Rows not a whole number of 16 bytes (q's or the pool's): q's may
      // be ones a tensor map cannot stride, so the producers load the Q
      // tile, every column (zeros past d and past the last row), then
      // each arrives.
      const int vq = vec_bytes(q, static_cast<long long>(d) * 2);
      for (int i = c; i < kPrefillRows * (kD / 8); i += 128) {
        const int r = i / (kD / 8);
        const int qc = i - r * (kD / 8);
        const int bytes = chunk_bytes(qc, d, 2);
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrows && bytes > 0)
          x = ld_chunk(q + (static_cast<size_t>(h) * n_rows + row0 + r) * d + qc * 8,
                       bytes, vq);
        put_chunk16(s_q, r, qc, x);
      }
      fence_proxy_async();
      mbar_arrive(bar_q);
    }
    const size_t tok = static_cast<size_t>(hkv) * d;  // elements between keys
    const size_t col = static_cast<size_t>(h) * d + cc * kE;
    // This thread's chunk: its bytes inside the row (0: wholly past d,
    // written as zeros and never read) and, for rows not a whole number
    // of 16 bytes, the widest load they allow.
    const int c_bytes = chunk_bytes(cc, d, sizeof(KT));
    const int vw = kWhole ? 16
                          : min(vec_bytes(k_pages, static_cast<long long>(d) * sizeof(KT)),
                                vec_bytes(v_pages, static_cast<long long>(d) * sizeof(KT)));
    // This thread's rows of tile kt: their page (-1: not read -- past the
    // live keys, past the last tile, or a chunk past d) and row in it.
    // Every row's table entry is read first, then the rows, so one table
    // read's latency covers them all.
    const auto rows_of = [&](int kt, int (&page)[kRows], int (&at)[kRows]) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = kt * kWalkKeys + t0 + r * kRowStep;
        const int p = key / bs;
        at[r] = key - p * bs;
        page[r] = kt < n_tiles && key < live_keys && c_bytes > 0
                      ? __ldg(table + p) : -1;
      }
    };
    // This thread's scale of tile kt (a key past the live keys: 0).
    const auto scale_of = [&](int kt) {
      float sc = 0.f;
      if constexpr (kScaled) {
        const int key = kt * kWalkKeys + (c & (kWalkKeys - 1));
        if (kt < n_tiles && key < live_keys)
          sc = __ldg((c < kWalkKeys ? k_scale : v_scale) + __ldg(table + key / bs));
      }
      return sc;
    };
    const auto put_rows = [&](const uint4 (&x)[kRows], uint32_t tile) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        put_pool_chunk<T, KT>(x[r], tile, t0 + r * kRowStep, cc);
    };
    // The producer's loop: 16-byte loads where every row is a whole
    // number of 16 bytes (kWhole), else ld_chunk's narrower ones, in a
    // kernel of its own -- compiled into one kernel, the narrow path
    // slowed the 16-byte one by a tenth at 12-token pages (NVIDIA H100
    // 80GB HBM3, 700.00 W; PERF.md).
    const auto chunk = [&](const KT* p) {
      if constexpr (kWhole) {
        return __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        return ld_chunk(p, c_bytes, vw);
      }
    };
    if constexpr (!kHalves) {
      // Tile kt's chunks of this thread and its scale, in registers.
      struct Chunks {
        uint4 k[kRows], v[kRows];
        float sc;
      };
      const auto load = [&](int kt, Chunks& x) {
        int page[kRows], at[kRows];
        rows_of(kt, page, at);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          x.k[r] = x.v[r] = make_uint4(0u, 0u, 0u, 0u);
          if (page[r] >= 0) {
            const size_t off =
                (static_cast<size_t>(page[r]) * bs + at[r]) * tok + col;
            x.k[r] = chunk(k_pages + off);
            x.v[r] = chunk(v_pages + off);
          }
        }
        x.sc = scale_of(kt);
      };
      // The loads of tile kt + 1 are issued before tile kt is written,
      // so their latency hides behind the wait for its stage and its
      // stores.
      Chunks x;
      load(0, x);
      for (int kt = 0; kt < n_tiles; ++kt) {
        Chunks next;
        load(kt + 1, next);
        const int st = kt % kPrefillStages;
        if (kt >= kPrefillStages)
          mbar_wait(ring.empty + 8 * st, (kt / kPrefillStages - 1) & 1);
        if constexpr (kScaled) scales[st * 2 * kWalkKeys + c] = x.sc;
        put_rows(x.k, ring.k + st * kTile);
        fence_proxy_async();
        mbar_arrive(ring.full_k + 8 * st);
        put_rows(x.v, ring.v + st * kTile);
        fence_proxy_async();
        mbar_arrive(ring.full_v + 8 * st);
        x = next;
      }
    } else {
      // Half p of the walk: K (p even) or V (p odd) of tile p / 2; the
      // thread's scale rides with the K half (both a stage's K and V
      // scales must be in place when its K tile arrives: the softmax
      // reads them).
      struct Half {
        uint4 x[kRows];
        float sc;
      };
      const auto load = [&](int p, Half& x) {
        const int kt = p >> 1;
        const KT* pool = (p & 1) ? v_pages : k_pages;
        int page[kRows], at[kRows];
        rows_of(kt, page, at);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          x.x[r] = make_uint4(0u, 0u, 0u, 0u);
          if (page[r] >= 0)
            x.x[r] = chunk(pool + (static_cast<size_t>(page[r]) * bs + at[r]) *
                                      tok + col);
        }
        x.sc = (p & 1) ? 0.f : scale_of(kt);
      };
      Half x;
      load(0, x);
      for (int p = 0; p < 2 * n_tiles; ++p) {
        Half next;
        load(p + 1, next);
        const int kt = p >> 1;
        const int st = kt % kPrefillStages;
        if ((p & 1) == 0) {
          if (kt >= kPrefillStages)
            mbar_wait(ring.empty + 8 * st, (kt / kPrefillStages - 1) & 1);
          if constexpr (kScaled) scales[st * 2 * kWalkKeys + c] = x.sc;
          put_rows(x.x, ring.k + st * kTile);
          fence_proxy_async();
          mbar_arrive(ring.full_k + 8 * st);
        } else {
          put_rows(x.x, ring.v + st * kTile);
          fence_proxy_async();
          mbar_arrive(ring.full_v + 8 * st);
        }
        x = next;
      }
    }
    return;
  }

  const int r0 = row0 + 16 * warp + (lane >> 2);
  const PrefillMask mask = prefill_mask(r0, row0, g, start, n_keys);
  if constexpr (kScaled) {
    prefill_consume<T, kD, kWhole>(PrefillInt8Mask{mask, scales}, r0, s_q,
                                   bar_q, ring, n_tiles, sm_scale, out, h,
                                   n_rows, d);
  } else {
    prefill_consume<T, kD, kWhole>(mask, r0, s_q, bar_q, ring, n_tiles,
                                   sm_scale, out, h, n_rows, d);
  }
}

// ---------------------------------------------------------------------
// Chunked prefill, every pair the kernels above do not take
// (prefill_route's kRouteTf32), at any page size: float32 q or pool,
// and mixed 16-bit dtypes, on the TF32 tensor cores (hopper.cuh, the
// TF32 walk). The
// 16-bit route's grid: one block per (KV head, 64 grouped q rows), the
// last (heaviest) row tiles first. Two converter warpgroups stand where
// the TMA producer is: together they read Q once, then one each 32-key
// tile of K and the other of V -- keys past the tile's last row's
// position are never read and come out as zeros, as do columns past d
// -- with coalesced 16-byte global loads through the block's own table
// row, split the fp32 values into TF32 hi and lo (16-bit and int8
// values are exact), write them in the panels the walk's descriptors
// read, and arrive on the stage's barriers. The consumer warpgroup runs
// the walk:
//
//   q / pool      S = Q . K^T          P . V
//   f32 / f32     3 TF32 passes        P split, V split: 3 passes
//   f32 / int8    2 (q split; k_scale  P * v_scale split, V exact: 2
//                 folded into S)
//   f32 / 16-bit  2 (q split)          P rounded to the pool's dtype,
//                                      16-bit wgmma (as the Pallas
//                                      kernel's p.astype(v.dtype))
//   16-bit / f32  2 (k split)          P split, V split: 3
//   f16 / bf16,   1 (both exact)       P rounded to the pool's dtype,
//   bf16 / f16                         16-bit wgmma
//
// Shared memory at d 128 (Tf32Layout): float32 q and pool, Q 64 KB and
// two stages of 64 KB; a 16-bit q over a float32 pool, Q 32 KB and three
// stages; the others four stages. The converters' work, not the tensor
// cores, sets the time over a float32 pool (PERF.md). Every head dim up
// to 256: at kD 256 (d 129-256) a float32 Q tile and one stage would
// take 256 KB, so there the grid is (KV heads, row tiles x 2) and each
// block of a row tile's pair holds one half of O's columns (col0:
// Tf32Layout's column halves): both walk every K tile, each converts
// and multiplies only its half of V, and each writes its own columns.
// kWhole as in the gathering kernel (the narrow instantiation's
// converters spill over a float32 pool at kD 128: ptxas, PERF.md).
// ---------------------------------------------------------------------
template <typename QT, typename KT, int kD, bool kWhole>
__global__ void __launch_bounds__(kTf32Threads, 1) paged_prefill_tf32_kernel(
    const QT* __restrict__ q,           // (hkv, bucket, g, d)
    const KT* __restrict__ k_pages,     // (num_blocks, bs, hkv, d)
    const KT* __restrict__ v_pages,
    const int* __restrict__ table,      // (table_width,)
    const float* __restrict__ k_scale,  // (num_blocks,): int8 pools
    const float* __restrict__ v_scale,
    QT* __restrict__ out,               // (hkv, bucket, g, d)
    int hkv, int bucket, int g, int d, int bs, int max_blocks, int start,
    float sm_scale) {
  using L = Tf32Layout<QT, KT, kD>;
  constexpr int kDV = L::kDV;  // O's columns this block holds
  const int h = blockIdx.x;
  const int n_rows = bucket * g;
  const int tile = blockIdx.y / L::kHalves;
  const int col0 = (blockIdx.y - tile * L::kHalves) * kDV;
  const int row0 = (gridDim.y / L::kHalves - 1 - tile) * kTf32Rows;
  const int nrows = min(kTf32Rows, n_rows - row0);
  const int warp = threadIdx.x >> 5;  // 0-3 the consumers, 4-11 the converters
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Tf32Ring ring = Tf32Ring::at<L>(base);

  // Keys the tile's last row can see, and the tiles they span.
  const int n_keys = max_blocks * bs;
  const int last_pos = start + (row0 + nrows - 1) / g;
  const int live_keys = min(last_pos + 1, n_keys);
  const int n_tiles = (live_keys + kTf32Keys - 1) / kTf32Keys;

  if (threadIdx.x == 0) tf32_ring_init<L>(ring);
  __syncthreads();

  if (warp >= 4) {  // the converter warpgroups
    const size_t tok = static_cast<size_t>(hkv) * d;  // elements between keys
    const auto q_row = [&](int r) {
      return row0 + r < n_rows ? q + (static_cast<size_t>(h) * n_rows + row0 + r) * d
                               : nullptr;
    };
    const auto src_of = [&](int key) {
      Tf32Src<KT> src{nullptr, nullptr, 0.f, 0.f};  // past the live keys
      if (key < live_keys) {
        const int p = key / bs;
        const int page = __ldg(table + p);
        const size_t off = (static_cast<size_t>(page) * bs + key - p * bs) * tok +
                           static_cast<size_t>(h) * d;
        src.k = k_pages + off;
        src.v = v_pages + off;
        if constexpr (L::kScaled) {
          src.ksc = __ldg(k_scale + page);
          src.vsc = __ldg(v_scale + page);
        }
      }
      return src;
    };
    // The widest loads q's rows and the pool's rows allow, where they
    // are not all a whole number of 16 bytes (!kWhole).
    const int vq = kWhole ? 16 : vec_bytes(q, static_cast<long long>(d) * sizeof(QT));
    const int vk = kWhole ? 16
                          : min(vec_bytes(k_pages, static_cast<long long>(d) * sizeof(KT)),
                                vec_bytes(v_pages, static_cast<long long>(d) * sizeof(KT)));
    tf32_converters<QT, KT, L, kD, kWhole>(ring, threadIdx.x - 128, n_tiles, d,
                                           q_row, src_of, vq, vk, col0);
    return;
  }

  tf32_regs_consumer();
  const int r0 = row0 + 16 * warp + (lane >> 2);
  WalkRows<kDV> rows;
#pragma unroll
  for (int i = 0; i < kDV / 2; ++i) rows.o[i] = 0.f;
  rows.m[0] = rows.m[1] = kMaskValue;
  rows.l[0] = rows.l[1] = 0.f;
  const PrefillMask mask = prefill_mask(r0, row0, g, start, n_keys);
  const float scale2 = sm_scale * kLog2e;
  if constexpr (L::kScaled) {
    const Tf32ScaledMask<PrefillMask> scaled{
        mask,
        reinterpret_cast<const float*>(smem_raw + (ring.scales - smem_u32(smem_raw))),
        L::kStages};
    tf32_walk<QT, KT, kD>(rows, ring, n_tiles, scale2, scaled);
  } else {
    tf32_walk<QT, KT, kD>(rows, ring, n_tiles, scale2, mask);
  }
  QT* row_ptr[2];  // from the block's first column
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    row_ptr[rr] = row < n_rows
                      ? out + (static_cast<size_t>(h) * n_rows + row) * d + col0
                      : nullptr;
  }
  float row_lse[2];  // not an output of the prefill
  walk_finish<QT, kDV, kWhole>(rows, row_ptr, min(d - col0, kDV), row_lse);
}

size_t prefill_smem_bytes(int tq, int d, int tk) {
  const size_t dp = d + 1;
  return sizeof(float) *
         (2 * tq * dp + 2 * tk * dp + static_cast<size_t>(tq) * tk + 3 * tq);
}

// Which prefill kernel takes a launch, by dtypes, head dim and page
// size. Every page size >= 1 takes a tensor-core route at every head dim
// up to kMaxHeadDim for every pair; a head dim below the instantiation's kD
// (64, 128, 256) is padded: columns d .. kD - 1 of Q, K and V are zeros
// in shared memory, the output stores d columns, and the scale stays
// d^-0.5.
//   paged_prefill_wgmma_kernel   16-bit q and pool of one dtype on pages
//                                that stack into 64-key tiles on 8-row
//                                boundaries (bs 8, 16, 32 or 64) or
//                                split into them (bs a multiple of 64),
//                                whose TMA boxes it issues a page at a
//                                time, at a d whose rows a tensor map can
//                                stride (a whole number of 16 bytes:
//                                d % 8 == 0);
//   paged_prefill_gather_kernel  the same pair at every other page size
//                                and d (kRouteWgmmaGather), and an int8
//                                pool under a 16-bit q (kRouteWgmmaInt8),
//                                its producer gathering key by key;
//   paged_prefill_tf32_kernel    every other pair (float32 q or pool,
//                                mixed 16-bit dtypes), at d 129-256 in
//                                column halves of O (Tf32Layout);
//   paged_prefill_kernel         (scalar) every pair past kMaxHeadDim.
enum PrefillRoute {
  kRouteScalar = 0, kRouteWgmma = 1, kRouteWgmmaInt8 = 2, kRouteTf32 = 3,
  kRouteWgmmaGather = 4
};

// A build with -DTPUHPC_PREFILL_BOXES=0 gathers 16-bit pools at every
// page size (docs/port/gather_vs_boxes.py times it against the TMA
// boxes); the default library takes the boxes wherever they tile.
#ifndef TPUHPC_PREFILL_BOXES
#define TPUHPC_PREFILL_BOXES 1
#endif

int prefill_route(int q_dtype, int kv_dtype, int d, int bs) {
  if (d < 1 || d > kMaxHeadDim) return kRouteScalar;
  const bool q16 = q_dtype == kF16 || q_dtype == kBF16;
  const bool boxes = TPUHPC_PREFILL_BOXES && d % 8 == 0 &&
      ((bs >= 8 && kWalkKeys % bs == 0) || bs % kWalkKeys == 0);
  if (q16 && kv_dtype == q_dtype) return boxes ? kRouteWgmma : kRouteWgmmaGather;
  if (q16 && kv_dtype == kI8) return kRouteWgmmaInt8;
  return kRouteTf32;
}

// The scalar route's tile: tq rows (64, halved while the grid would
// leave SMs of the 132 idle, down to 16) over steps of tk keys (a whole
// page), tk halved (down to 16) and then tq while the tile would not fit
// shared memory -- a 250-token page at d 256 does not at any tq.
void scalar_tile(int hkv, int bucket, int g, int d, int bs, int* tq_out,
                 int* tk_out) {
  const int n_rows = bucket * g;
  int tq = 64, tk = bs;
  while (tq > 16 && hkv * ((n_rows + tq - 1) / tq) < 132) tq >>= 1;
  while (prefill_smem_bytes(tq, d, tk) > static_cast<size_t>(kMaxSmem)) {
    if (tk > 16) {
      tk = (tk + 1) / 2;
    } else if (tq > 1) {
      tq >>= 1;
    } else if (tk > 1) {
      tk = (tk + 1) / 2;
    } else {
      break;
    }
  }
  *tq_out = tq;
  *tk_out = tk;
}

// Rows per prefill block. The tensor-core routes: kPrefillRows. The
// scalar route: scalar_tile's.
int prefill_tile_rows(int hkv, int bucket, int g, int d, int bs, int route) {
  if (route != kRouteScalar) return kPrefillRows;
  int tq, tk;
  scalar_tile(hkv, bucket, g, d, bs, &tq, &tk);
  return tq;
}

// A decode launch's arguments, as the C entry point takes them.
struct DecodeArgs {
  const void *q, *k_pages, *v_pages, *tables, *pos, *active, *k_scale, *v_scale;
  void* out;
  float *o_part, *lse_part;
  int slots, hkv, g, d, bs, table_width, max_blocks, n_split, q_dtype;
  float sm_scale;
};

// The split kernel over every run, then (more than one run) the combine.
template <typename KT, int kD, int kRows>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int esize = sizeof(KT);
  const int pps = (a.max_blocks + a.n_split - 1) / a.n_split;
  const int tile = decode_tile_keys(a.d, a.bs, esize, DecodeShape<kD>::kGroups);
  const size_t smem = split_smem_bytes<kD, kRows>(pps, kQuant, tile, a.d, esize);
  auto kernel = paged_decode_split_kernel<KT, kD, kRows>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_groups = (a.g + kRows - 1) / kRows;
  kernel<<<dim3(a.hkv, a.n_split, a.slots * row_groups), kDecodeThreads, smem,
           stream>>>(
      a.q, static_cast<const KT*>(a.k_pages), static_cast<const KT*>(a.v_pages),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.active), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), a.out, a.o_part, a.lse_part,
      a.q_dtype, a.hkv, a.g, a.d, a.bs, a.table_width, a.max_blocks, pps, tile,
      a.sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const size_t combine_smem = sizeof(float) * (a.g * a.n_split + 1);
  err = allow_smem(paged_decode_combine_kernel, combine_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<<<dim3(a.hkv, a.slots), kDecodeThreads,
                                combine_smem, stream>>>(
      a.o_part, a.lse_part, a.out, a.q_dtype, a.hkv, a.g, a.d, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for the head dim (64, 128 or 256 columns a key group)
// and the group (1, 2 or 4 query rows a block; larger groups take row
// groups of 4).
template <typename KT, int kD>
int launch_decode_rows(const DecodeArgs& a, cudaStream_t stream) {
  if (a.g <= 1) return launch_decode<KT, kD, 1>(a, stream);
  if (a.g <= 2) return launch_decode<KT, kD, 2>(a, stream);
  return launch_decode<KT, kD, kDecodeMaxRows>(a, stream);
}

template <typename KT>
int launch_decode_shape(const DecodeArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch_decode_rows<KT, 64>(a, stream);
  if (a.d <= 128) return launch_decode_rows<KT, 128>(a, stream);
  return launch_decode_rows<KT, 256>(a, stream);  // d 129-256
}

// SMs of the current device, read once per device.
int device_sms() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    cached[dev] = n;
  }
  return cached[dev];
}

// The pool's tensor map, encoded at the first launch over a pool
// (pointer, page shape, box; the dtype is T) and reused after: a map
// holds only those, so the cached map is the one the call would encode.
constexpr size_t kPoolMapCacheSize = 4096;

template <typename T>
cudaError_t pool_map(CUtensorMap* map, const void* pool, int bs, int hkv, int d,
                     int box) {
  using Key = std::tuple<const void*, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key{pool, bs, hkv, d, box};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = bshd_map<T>(map, pool, kPoolPages, bs, hkv, d, box);
  if (err != cudaSuccess) return err;
  if (cache.size() >= kPoolMapCacheSize) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// Whether q's rows (q_esize bytes an element) and the pool's (kv_esize)
// are all a whole number of 16 bytes from 16-byte-aligned bases: the
// gathering and TF32 kernels' 16-byte path (and q by TMA), else their
// narrow-row instantiation.
bool rows_whole(const void* q, const void* k_pages, const void* v_pages, int d,
                int q_esize, int kv_esize) {
  const long long qb = static_cast<long long>(d) * q_esize;
  const long long kb = static_cast<long long>(d) * kv_esize;
  return vec_bytes(q, qb) == 16 && vec_bytes(k_pages, kb) == 16 &&
         vec_bytes(v_pages, kb) == 16;
}

template <typename T, int kD>
int launch_prefill_wgmma(const void* q, const void* k_pages, const void* v_pages,
                         const void* table, void* out, int hkv, int bucket, int g,
                         int d, int bs, int max_blocks, int start, float sm_scale,
                         cudaStream_t stream) {
  CUtensorMap m[3];
  const int box = bs < kWalkKeys ? bs : kWalkKeys;
  cudaError_t err = bshd_map<T>(&m[0], q, hkv, bucket * g, 1, d, kPrefillRows);
  if (err == cudaSuccess) err = pool_map<T>(&m[1], k_pages, bs, hkv, d, box);
  if (err == cudaSuccess) err = pool_map<T>(&m[2], v_pages, bs, hkv, d, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = prefill_wgmma_smem_bytes<kD>();
  auto kernel = paged_prefill_wgmma_kernel<T, kD>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bucket * g + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(hkv, tiles), kPrefillWgmmaThreads, smem, stream>>>(
      m[0], m[1], m[2], static_cast<const int*>(table), static_cast<T*>(out),
      bucket, g, d, bs, max_blocks, start, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, int kD>
int launch_prefill_gather(const void* q, const void* k_pages, const void* v_pages,
                          const void* table, const void* k_scale,
                          const void* v_scale, void* out, int hkv, int bucket,
                          int g, int d, int bs, int max_blocks, int start,
                          float sm_scale, cudaStream_t stream) {
  constexpr bool kScaled = std::is_same<KT, int8_t>::value;
  if (kScaled && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // The kernel for rows that are all a whole number of 16 bytes (q's
  // by TMA, the pool's in 16-byte loads), or the one for the others
  // (rows_whole).
  const bool whole = rows_whole(q, k_pages, v_pages, d, 2, sizeof(KT));
  CUtensorMap tm_q = {};
  cudaError_t err = whole ? bshd_map<T>(&tm_q, q, hkv, bucket * g, 1, d, kPrefillRows)
                          : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = prefill_gather_smem_bytes<kD, kScaled>();
  auto kernel = whole ? paged_prefill_gather_kernel<T, KT, kD, true>
                      : paged_prefill_gather_kernel<T, KT, kD, false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bucket * g + kPrefillRows - 1) / kPrefillRows;
  kernel<<<dim3(hkv, tiles), kGatherThreads, smem, stream>>>(
      tm_q, static_cast<const T*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int*>(table),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<T*>(out), hkv, bucket, g, d, bs, max_blocks, start, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int kD>
int launch_prefill_tf32(const void* q, const void* k_pages, const void* v_pages,
                        const void* table, const void* k_scale,
                        const void* v_scale, void* out, int hkv, int bucket,
                        int g, int d, int bs, int max_blocks, int start,
                        float sm_scale, cudaStream_t stream) {
  using L = Tf32Layout<QT, KT, kD>;
  if (L::kScaled && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rows_whole(q, k_pages, v_pages, d, sizeof(QT), sizeof(KT))
                    ? paged_prefill_tf32_kernel<QT, KT, kD, true>
                    : paged_prefill_tf32_kernel<QT, KT, kD, false>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bucket * g + kTf32Rows - 1) / kTf32Rows;
  kernel<<<dim3(hkv, tiles * L::kHalves), kTf32Threads, L::kSmem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int*>(table),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), hkv, bucket, g, d, bs, max_blocks, start, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* table, const void* k_scale, const void* v_scale,
                   void* out, int hkv, int bucket, int g, int d, int bs,
                   int max_blocks, int start, float sm_scale, int route,
                   cudaStream_t stream) {
  constexpr bool kSame16 = std::is_same<QT, KT>::value && sizeof(QT) == 2;
  constexpr bool kInt8Under16 = std::is_same<KT, int8_t>::value && sizeof(QT) == 2;
  if constexpr (kSame16) {
    if (route == kRouteWgmma)
      return by_head_dim(d, [&](auto kd) {
        return launch_prefill_wgmma<QT, decltype(kd)::value>(
            q, k_pages, v_pages, table, out, hkv, bucket, g, d, bs, max_blocks,
            start, sm_scale, stream);
      });
  }
  if constexpr (kSame16 || kInt8Under16) {
    if (route == kRouteWgmmaGather || route == kRouteWgmmaInt8)
      return by_head_dim(d, [&](auto kd) {
        return launch_prefill_gather<QT, KT, decltype(kd)::value>(
            q, k_pages, v_pages, table, k_scale, v_scale, out, hkv, bucket, g,
            d, bs, max_blocks, start, sm_scale, stream);
      });
  }
  // The TF32 route's pairs: every pair but the two above.
  if constexpr (!kSame16 && !kInt8Under16) {
    if (route == kRouteTf32)
      return by_head_dim(d, [&](auto kd) {
        return launch_prefill_tf32<QT, KT, decltype(kd)::value>(
            q, k_pages, v_pages, table, k_scale, v_scale, out, hkv, bucket, g,
            d, bs, max_blocks, start, sm_scale, stream);
      });
  }
  int tq, tk;
  scalar_tile(hkv, bucket, g, d, bs, &tq, &tk);
  const size_t smem = prefill_smem_bytes(tq, d, tk);
  auto kernel = paged_prefill_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bucket * g + tq - 1) / tq;
  kernel<<<dim3(hkv, tiles), kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int*>(table),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), hkv, bucket, g, d, bs, max_blocks, start, tq, tk,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// Expands BODY once per (query dtype, pool dtype) pair the engine can
// produce: q in f32/f16/bf16, pages in f32/f16/bf16 or int8.
#define TPUHPC_DISPATCH(QCODE, KCODE, BODY)                                 \
  switch ((QCODE) * 4 + (KCODE)) {                                          \
    case kF32 * 4 + kF32: { using QT = float; using KT = float; BODY; }     \
    case kF32 * 4 + kF16: { using QT = float; using KT = __half; BODY; }    \
    case kF32 * 4 + kBF16: { using QT = float; using KT = __nv_bfloat16; BODY; } \
    case kF32 * 4 + kI8: { using QT = float; using KT = int8_t; BODY; }     \
    case kF16 * 4 + kF32: { using QT = __half; using KT = float; BODY; }    \
    case kF16 * 4 + kF16: { using QT = __half; using KT = __half; BODY; }   \
    case kF16 * 4 + kBF16: { using QT = __half; using KT = __nv_bfloat16; BODY; } \
    case kF16 * 4 + kI8: { using QT = __half; using KT = int8_t; BODY; }    \
    case kBF16 * 4 + kF32: { using QT = __nv_bfloat16; using KT = float; BODY; } \
    case kBF16 * 4 + kF16: { using QT = __nv_bfloat16; using KT = __half; BODY; } \
    case kBF16 * 4 + kBF16: { using QT = __nv_bfloat16; using KT = __nv_bfloat16; BODY; } \
    case kBF16 * 4 + kI8: { using QT = __nv_bfloat16; using KT = int8_t; BODY; } \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }

}  // namespace

extern "C" {

// out: (slots, hkv, g, d) in q's dtype. o_part (slots, hkv, n_split, g,
// d) and lse_part (slots, hkv, n_split, g), fp32, are the runs' partials
// (null when n_split is 1); n_split comes from tpuhpc_decode_splits.
int tpuhpc_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                        const void* tables, const void* pos, const void* active,
                        const void* k_scale, const void* v_scale, void* out,
                        void* o_part, void* lse_part, int slots, int hkv, int g,
                        int d, int bs, int table_width, int max_blocks,
                        int n_split, float sm_scale, int q_dtype, int kv_dtype,
                        void* stream) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8 ||
      !decode_takes(d) || bs < 1 || max_blocks < 1 || n_split < 1 ||
      n_split > max_blocks || (n_split > 1 && (o_part == nullptr || lse_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k_pages, v_pages, tables, pos, active, k_scale, v_scale,
                     out, static_cast<float*>(o_part), static_cast<float*>(lse_part),
                     slots, hkv, g, d, bs, table_width, max_blocks, n_split,
                     q_dtype, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32: return launch_decode_shape<float>(a, s);
    case kF16: return launch_decode_shape<__half>(a, s);
    case kBF16: return launch_decode_shape<__nv_bfloat16>(a, s);
    default: return launch_decode_shape<int8_t>(a, s);
  }
}

// Runs per slot a decode launch of this shape takes (the workspace the
// caller allocates has this many partials per (slot, head, row)).
int tpuhpc_decode_splits(int slots, int hkv, int g, int max_blocks) {
  return decode_splits(slots, hkv, g, max_blocks, device_sms());
}

int tpuhpc_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                         const void* table, const void* k_scale,
                         const void* v_scale, void* out, int hkv, int bucket,
                         int g, int d, int bs, int max_blocks, int start,
                         float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8 ||
      bs < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int route = prefill_route(q_dtype, kv_dtype, d, bs);
  TPUHPC_DISPATCH(q_dtype, kv_dtype,
                  return (launch_prefill<QT, KT>(
                      q, k_pages, v_pages, table, k_scale, v_scale, out, hkv,
                      bucket, g, d, bs, max_blocks, start, sm_scale, route,
                      static_cast<cudaStream_t>(stream))))
}

// The route a prefill launch takes (0 the scalar kernel, 1 the 16-bit
// wgmma kernel, 2 the gathering kernel over an int8 pool, 3 the TF32 one,
// 4 the gathering kernel over a 16-bit pool; -1 for a dtype code or page
// size no kernel takes) and the rows of a block on that route:
// chip_smoke.py reports both beside the kernel's time.
int tpuhpc_prefill_route(int d, int bs, int q_dtype, int kv_dtype) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8 || bs < 1)
    return -1;
  return prefill_route(q_dtype, kv_dtype, d, bs);
}

int tpuhpc_prefill_tile_rows(int hkv, int bucket, int g, int d, int bs,
                             int q_dtype, int kv_dtype) {
  return prefill_tile_rows(hkv, bucket, g, d, bs,
                           prefill_route(q_dtype, kv_dtype, d, bs));
}

const char* tpuhpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
