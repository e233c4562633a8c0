// Flash attention forward and backward for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas kernel of the JAX package's
// tpu_hpc/kernels/attention.py:
//
//   forward           replaces _flash_kernel (launched by _flash_forward):
//                     out and the per-row log-sum-exp, online softmax.
//                     flash_fwd_wgmma_kernel for bf16 / fp16,
//                     flash_fwd_tf32_kernel for float32.
//   dq                replaces _flash_dq_kernel (launched by
//                     _flash_backward): dq = scale * dS . K.
//                     flash_dq_wgmma_kernel for bf16 / fp16 up to
//                     kD 128, flash_dq_gqa_kernel at kD 256,
//                     flash_dq_tf32_kernel for float32.
//   dk/dv             replaces _flash_dkv_kernel (launched by
//                     _flash_backward): dV = P^T . dO, dK = scale * dS^T . Q.
//                     flash_dkv_wgmma_kernel for bf16 / fp16 up to
//                     kD 128, flash_dkv_wg2_kernel at kD 256,
//                     flash_dkv_tf32_kernel for float32; where the
//                     query-head group is split over blocks,
//                     flash_dkv_sum_kernel adds their partials.
//
// with P = exp(S - lse) rebuilt from the saved lse and
// dS = P * (dO . V^T - D), D = rowsum(dO * O) - dlse computed by the
// caller. The numerics are the Pallas kernels': fp32 scores and
// accumulators, the finite MASK_VALUE with the m_safe / l_safe rules (a
// fully masked row gives out = 0, lse = MASK_VALUE and zero gradients),
// P cast to v's dtype before P . V and dS cast to k's dtype before the
// dS products (attention.py:211-215, :445-448, :499-511). The layout is
// the card's, not carried over block by block:
//
//   * one block owns one (batch, query head, q tile) in the forward and
//     in dq, and one (batch, KV head, k tile) in dk/dv; the TPU grid's
//     sequential KV (or q) axis becomes a loop inside the block;
//   * the causal limit takes the global offsets q_offset / kv_offset as
//     runtime arguments, so one build serves every ring step; tiles
//     wholly above the diagonal are never visited, and the ragged tail
//     is masked in the kernel instead of padded copies being made;
//   * inputs are read straight from the [B, S, H, D] layout; query head
//     h reads KV head h / g, never a repeated copy;
//   * dk/dv loops over the g query heads of its group inside the block,
//     so the group sum (attention.py:640-644) happens in the fp32
//     accumulator -- or, where a grid of one block a key tile would
//     leave the card idle (Gemma-2B's 8 query heads over 1 KV head),
//     over g / n_split heads in each of n_split blocks, whose fp32
//     partials a second kernel adds in split order: no atomics either
//     way, and dq, dk, dv come out bit-identical from launch to launch.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training path's shape (B 4, S 2048, 8 heads, d 128, causal) the
// forward does 34 GFLOP on 67 MB, dq 52 GFLOP on 84 MB and dk/dv 69
// GFLOP on 101 MB -- all operations-bound, ~0.035 / 0.052 / 0.069 ms:
// the tensor cores' rate, and how much of the time they are fed, set
// the time.
//
// The 16-bit kernels are built for that (PERF.md): every product is a
// warpgroup wgmma (sm_90a) whose fp32 accumulator stays in registers --
// S (and dP) for one tile, O (or dQ, or dK and dV) for the whole walk --
// and P and dS are built in those registers and fed straight back as the
// A operand of the next product, so no score, probability or gradient
// tile touches shared memory. Two warpgroups of 64 rows share a block of
// 128 rows (keys in dk/dv); the streamed tiles (K and V in the forward
// and dq; Q, dO in dk/dv) come by TMA, 128-byte swizzled as wgmma's
// descriptors read them, through a ring of stages; the helpers and the
// forward's online-softmax walk live in hopper.cuh, shared with the
// paged prefill. The head dim is a compile-time 64, 128 or 256 (kD); a
// smaller d reads TMA's zero fill past its columns (kMaxHeadDim16 below).
// At kD 256 a block has 64 rows (FwdShape, BwdShape, DqGqa): O, dQ and
// the Q / K / V tiles double there; the forward and dq have one consumer
// warpgroup, and dk/dv two over the same 64 keys, each computing half of
// S^T and dP^T and holding half of dK's and dV's columns
// (flash_dkv_wg2_kernel).
//
// The forward goes furthest: a producer warp keeps a four-stage K/V
// ring in flight behind per-stage full / empty mbarriers, so the two
// consumer warpgroups never meet at a block barrier, and each issues
// the next tile's Q . K^T before this tile's P . V, so its softmax runs
// while its own products do. The backward kernels up to kD 128 still
// load from a thread of the consumers through a two-stage ring with one
// block barrier per tile, and wait for their own products
// (wgmma.wait_group 0) before each softmax; dk/dv's 240 registers (kD
// 128) leave no room for a second S / dP pair. At kD 256 dq has the
// forward's shape (flash_dq_gqa_kernel: a producer warp, full / empty
// barriers, the next tile's S and dP issued before this tile's dQ
// product), and the forward and dq run the query heads of one KV group
// at one q tile as a thread block cluster that shares each K/V tile:
// one TMA load from L2, multicast into every block of the cluster
// (attention.py's gqa_cluster picks its size).
//
// The float32 kernels run wgmma's TF32 form on split operands (hi + lo,
// three passes a product; hopper.cuh), so they keep the float32 rule of
// checks/tolerance.py. The forward is the TF32 walk of hopper.cuh (its
// design above flash_fwd_tf32_kernel); dq and dk/dv share its roles -- a
// consumer warpgroup that owns 64 rows and issues the products, two
// converter warpgroups that split the streamed float32 tiles into TF32
// hi and lo, K-major or transposed as each product reads them -- with
// the shared memory at d 128 set out above each kernel's layout
// (DqTf32Layout, DkvTf32Layout). Bounds at the timed float32 case (B 1, S
// 1000, 8 heads, d 128, causal): three TF32 passes a product, dq 0.0186
// ms and dk/dv 0.0249 ms; their times beside those are in PERF.md.
//
// Plain C interface, loaded with ctypes by tpu_hpc_torch/kernels/_build.py
// (tpuhpc_error_string lives in paged_attention.cu, in the same
// library). Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

// Head dims the kernels take: every d up to 256 in 16 bits, up to 128
// in float32, each in the 64-, 128- or 256-column instantiation that
// holds it (by_head_dim), padded with zero columns in shared memory --
// TMA's zero fill past the tensor map's d, a 256-column tile's panels
// wholly past d zeroed once (live_panels) -- and only d columns stored.
// A row must be a whole number of 16 bytes (tensor maps stride whole
// chunks; the TF32 kernels load 16 bytes a chunk): the wrapper pads any
// other d to such a width.
constexpr int kMaxHeadDim16 = 256;
constexpr int kMaxHeadDimF32 = 128;

// Whether query row `row` (global position) sees key `col` (local index
// into this KV chunk): inside the chunk, and not in the row's future
// when causal (global positions q_offset + i >= kv_offset + j).
__device__ __forceinline__ bool visible(int row, int col, int sk,
                                        int kv_offset, int causal) {
  return col < sk && (!causal || row >= kv_offset + col);
}

// Number of KV tiles a q tile whose last real row sits at global
// position `last_row` must visit: all of them without a causal mask,
// else those whose first key is not in that row's future.
__device__ __forceinline__ int kv_tiles(int sk, int br, int last_row,
                                        int kv_offset, int causal) {
  const int total = (sk + br - 1) / br;
  if (!causal) return total;
  const int lim = last_row - kv_offset;
  return lim < 0 ? 0 : min(total, lim / br + 1);
}

// =====================================================================
// 16-bit kernels on Hopper: wgmma products with their accumulators in
// registers, TMA tile loads (hopper.cuh).
// =====================================================================

constexpr int kBwdStep = 64;      // keys (dq) or q rows (dk/dv) per streamed tile
// Each warpgroup's score tile against a streamed tile is one wgmma
// m64n64k16 product (wgmma_ss_n64) and its P / dS fragments feed the
// m64nDk16 products kBwdStep / 16 at a time, so the step is the n64
// shape itself: another step needs another tile layout.
static_assert(kBwdStep == 64,
              "kBwdStep: the backward's score tiles are wgmma m64n64 "
              "(wgmma_ss_n64); a step other than 64 needs a new layout");

// 4-byte cp.async; `valid` false writes a zero instead of reading.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A backward kernel's output element: T, or with kAcc an fp32 buffer the
// kernel adds into (a ring's dq and dK/dV accumulators, which then take
// each partial unrounded). put2 writes a thread's column pair: 8-byte
// aligned in fp32, as the column is even and the buffer 16-byte aligned;
// each element is read and written by one thread, so the sum is in
// launch order.
template <typename T, bool kAcc>
using Out = typename std::conditional<kAcc, float, T>::type;

template <typename T, bool kAcc>
__device__ __forceinline__ void put2(Out<T, kAcc>* at, float lo, float hi) {
  if constexpr (kAcc) {
    float2* p = reinterpret_cast<float2*>(at);
    const float2 was = *p;
    *p = make_float2(was.x + lo, was.y + hi);
  } else {
    *reinterpret_cast<uint32_t*>(at) = pack2<T>(lo, hi);
  }
}

// A 16-bit backward kernel's shape at head dim kD. Up to kD 128 two
// warpgroups own a block of kRows = 128 rows (q rows in dq, keys in
// dk/dv); at kD 256 the block owns 64: two own tiles of 128 rows and
// two stages of the two streamed tiles would take 264 KB. dq there has
// one consumer warpgroup (dQ alone is 128 fp32 a thread) and a layout
// of its own (flash_dq_gqa_kernel, DqGqa below); dk/dv, which would hold
// dK and dV, 256 fp32 a thread, has two warpgroups over the same 64 keys
// (flash_dkv_wg2_kernel, Dkv256 below). Shared memory: the two own
// tiles, two rings of two streamed kBwdStep-row tiles, the ring's
// per-row statistics (dk/dv: lse and dm of each stage's q rows), three
// mbarriers, and slack to align the tiles to 1024 bytes.
template <int kD>
struct BwdShape {
  static constexpr int kWgs = kD == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr size_t kSmem = 2 * kRows * kD * 2 + 4 * kBwdStep * kD * 2 +
                                  2 * 2 * kBwdStep * sizeof(float) + 3 * 8 + 1024;
};
static_assert(BwdShape<256>::kSmem <= static_cast<size_t>(kMaxSmem),
              "the backward's tiles exceed 227 KB at head_dim 256");

// ---------------------------------------------------------------------
// dq, 16-bit inputs. Grid (q tiles of BwdShape::kRows, hq, b), heaviest
// causal tiles first. The block's Q and dO tiles stay in shared memory;
// K and V tiles of kBwdStep keys stream through a two-stage TMA ring, the
// next one loading while this one's products run. Warpgroup w owns q
// rows [64 w, 64 w + 64) of the tile and keeps in registers, per tile:
//   S = Q . K^T, dP = dO . V^T            (SS wgmma, 64 x 64 each)
//   dS = P * (dP - dm), P = exp(S - lse)  (in place, then packed to T)
//   dQ += dS . K                           (RS wgmma, K read MN-major)
// dQ stays in registers for the whole walk; the epilogue scales it and
// writes it in T, or with kAcc adds it, unrounded, into an fp32 buffer.
// ---------------------------------------------------------------------
template <typename T, int kD, bool kAcc>
__global__ void __launch_bounds__(BwdShape<kD>::kThreads, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kRows rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kRows rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dq, int sq, int sk, int hq, int hkv, int d,
    int q_offset, int kv_offset, int causal, float scale) {
  static_assert(kD <= 128, "kD 256 takes flash_dq_gqa_kernel");
  using S = BwdShape<kD>;
  constexpr int kOwn = S::kRows * kD * 2;      // bytes of the Q (dO) tile
  constexpr int kStream = kBwdStep * kD * 2;   // bytes of a K (V) tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * S::kRows;
  const int q_rows = min(S::kRows, sq - q0);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_do = s_q + kOwn;
  const uint32_t s_k = s_do + kOwn;             // stage st at + st * kStream
  const uint32_t s_v = s_k + 2 * kStream;
  const uint32_t bars = s_v + 2 * kStream + 2 * 2 * kBwdStep * sizeof(float);
  const uint32_t bar_own = bars, bar_ring = bars + 8;  // ring: + 8 st

  const int n_kt = kv_tiles(sk, kBwdStep, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);
  // Only the panels holding a column below d load (the bytes each barrier
  // expects scale with them); the rest are zeros from here on.
  const int panels = live_panels<kD>(d);
  const int own_bytes = S::kRows * kPanelRowBytes * panels;
  const int stream_bytes = kBwdStep * kPanelRowBytes * panels;
  zero_dead_panels<kD>(s_q, S::kRows, 2, d, S::kThreads);
  zero_dead_panels<kD>(s_k, kBwdStep, 4, d, S::kThreads);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    mbar_init(bar_ring);
    mbar_init(bar_ring + 8);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * own_bytes);
    tma_tile<kD>(s_q, &tm_q, bar_own, h, q0, b, S::kRows, panels);
    tma_tile<kD>(s_do, &tm_do, bar_own, h, q0, b, S::kRows, panels);
    if (n_kt > 0) {
      mbar_expect_tx(bar_ring, 2 * stream_bytes);
      tma_tile<kD>(s_k, &tm_k, bar_ring, kvh, 0, b, kBwdStep, panels);
      tma_tile<kD>(s_v, &tm_v, bar_ring, kvh, 0, b, kBwdStep, panels);
    }
  }

  // This thread's two q rows (global index into sq): row0 and row0 + 8.
  const int wq0 = q0 + 64 * wg;  // the warpgroup's first row
  const int row0 = wq0 + 16 * warp + (lane >> 2);
  float lse2[2], dmr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = (static_cast<size_t>(b) * sq + row) * hq + h;
    lse2[i] = row < sq ? lse[at] * kLog2e : 0.f;
    dmr[i] = row < sq ? dm[at] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_own, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (threadIdx.x == 0 && kt + 1 < n_kt) {
      const uint32_t bar = bar_ring + 8 * (st ^ 1);
      mbar_expect_tx(bar, 2 * stream_bytes);
      tma_tile<kD>(s_k + (st ^ 1) * kStream, &tm_k, bar, kvh,
                   (kt + 1) * kBwdStep, b, kBwdStep, panels);
      tma_tile<kD>(s_v + (st ^ 1) * kStream, &tm_v, bar, kvh,
                   (kt + 1) * kBwdStep, b, kBwdStep, panels);
    }
    mbar_wait(bar_ring + 8 * st, (kt >> 1) & 1);
    const uint32_t k_tile = s_k + st * kStream;
    const uint32_t v_tile = s_v + st * kStream;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(s, kmajor_desc(s_q, S::kRows, 64 * wg, kk),
                      kmajor_desc(k_tile, kBwdStep, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(dp, kmajor_desc(s_do, S::kRows, 64 * wg, kk),
                      kmajor_desc(v_tile, kBwdStep, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // dS in place of dP. Only a tile that crosses the causal diagonal or
    // a ragged end is masked element by element.
    const int k0 = kt * kBwdStep;
    const int k_last = k0 + kBwdStep - 1;
    const bool edge = wq0 + 63 >= sq || k_last >= sk ||
                      (causal && kv_offset + k_last > q_offset + wq0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;  // row0 or row0 + 8
      // A NaN score gives P = 0 (as -inf does): the plain version's
      // select on S, in one instruction. Where lse is NaN too, P stays
      // NaN here and not 0 there, but that row's dS is NaN either way
      // (D is NaN), so dq's non-finite rows are the plain version's.
      float p = exp2f(fmaf(fmaxf(s[i], -INFINITY), scale2, -lse2[r]));
      if (edge) {
        const int row = row0 + 8 * r;
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = row < sq && visible(q_offset + row, key, sk,
                                            kv_offset, causal);
        p = ok ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dmr[r]);
    }
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds[kk][j] = pack2<T>(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdStep / 16; ++kk)
      wgmma_rs_nd<T, kD>(acc, ds[kk], mnmajor_desc(k_tile, kBwdStep, kk),
                         2 * kBwdStep * kPanelRowBytes);  // kD 256: N halves
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(ds);
    __syncthreads();  // stage st is read by no one: the next load may refill it
  }

  // dq = scale * dQ, this thread's column pairs of its two rows.
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < d && row < sq) {
        const size_t at =
            ((static_cast<size_t>(b) * sq + row) * hq + h) * d + col;
        put2<T, kAcc>(dq + at, scale * acc[4 * j + 2 * r],
                      scale * acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// dq at kD 256, 16-bit inputs. Grid (q tiles of 64 rows, hq, b),
// heaviest causal tiles first; as in the forward, the blocks of one q
// tile whose query heads share a KV head run as a cluster of `cluster`
// blocks along the head axis. One consumer warpgroup owns the block's
// 64 q rows; a producer warp loads the block's Q and dO tiles once and
// streams the KV head's K and V tiles of kBwdStep keys through two
// rings -- K in three stages and V in two, since a V tile is read by
// one product and a K tile again by the next step's dQ product -- each
// box loaded once from L2 and multicast into every block of the cluster
// (tma_tile_shared: at Gemma-2B's 8 query heads over 1 KV head, eight
// times fewer K/V bytes into shared memory), each stage refilled once
// every block's consumer has freed it. Per tile, in registers:
//   S = Q . K^T, dP = dO . V^T            (SS wgmma, 64 x 64 each)
//   dS = P * (dP - dm), P = exp(S - lse)  (fp32, in place of dP)
//   dQ += dS . K                           (RS wgmma, K read MN-major)
// pipelined: tile kt's S and dP are issued before tile kt - 1's dS . K
// and waited with wgmma.wait_group 1, so tile kt's exp and dS run while
// the tensor cores do the previous tile's dQ product; dS is packed to T
// only once that product has read the previous one. dQ takes the same
// products in the same order as a step-by-step walk: dq is the same
// bits on every launch, with no atomics. Shared memory: Q and dO 64 KB,
// the K stages 96 KB, the V stages 64 KB; registers: dQ 128 fp32 a
// thread, S and dP 32 each, the packed dS 16.
// ---------------------------------------------------------------------
// What dq_grads needs of a thread's two q rows: the first's index into
// sq (the other is 8 further), the block's first row, and the mask.
struct DqMask {
  int row0, q0, sq, sk, q_offset, kv_offset, causal;
};

// S = Q . K^T and dP = dO . V^T of one 64-key tile for the 64 q rows of
// a Q (dO) tile of 64 rows, committed as one wgmma group.
template <typename T>
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32],
                                          uint32_t s_q, uint32_t s_do,
                                          uint32_t k_tile, uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 256 / 16; ++kk)
    wgmma_ss_n64<T>(s, kmajor_desc(s_q, 64, 0, kk),
                    kmajor_desc(k_tile, kBwdStep, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 256 / 16; ++kk)
    wgmma_ss_n64<T>(dp, kmajor_desc(s_do, 64, 0, kk),
                    kmajor_desc(v_tile, kBwdStep, 0, kk), kk > 0);
  wgmma_commit();
}

// dQ += dS . K for one 64-key tile (K read MN-major, in N halves),
// committed as one wgmma group.
template <typename T>
__device__ __forceinline__ void dq_product(float (&acc)[128],
                                           const uint32_t (&ds)[4][4],
                                           uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kBwdStep / 16; ++kk)
    wgmma_rs_nd<T, 256>(acc, ds[kk], mnmajor_desc(k_tile, kBwdStep, kk),
                        2 * kBwdStep * kPanelRowBytes);
  wgmma_commit();
}

// dS = P * (dP - dm), P = exp(S - lse), in place of dP for tile kt. Only
// a tile that crosses the causal diagonal or a ragged end is masked
// element by element.
__device__ __forceinline__ void dq_grads(const float (&s)[32], float (&dp)[32],
                                         int kt, const DqMask& m,
                                         const float (&lse2)[2],
                                         const float (&dmr)[2], float scale2) {
  const int lane = threadIdx.x & 31;
  const int k0 = kt * kBwdStep;
  const int k_last = k0 + kBwdStep - 1;
  const bool edge = m.q0 + 63 >= m.sq || k_last >= m.sk ||
                    (m.causal && m.kv_offset + k_last > m.q_offset + m.q0);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;  // row0 or row0 + 8
    // A NaN score gives P = 0 (as -inf does): the plain version's
    // select on S, in one instruction. Where lse is NaN too, P stays
    // NaN here and not 0 there, but that row's dS is NaN either way
    // (D is NaN), so dq's non-finite rows are the plain version's.
    float p = exp2f(fmaf(fmaxf(s[i], -INFINITY), scale2, -lse2[r]));
    if (edge) {
      const int row = m.row0 + 8 * r;
      const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool ok = row < m.sq && visible(m.q_offset + row, key, m.sk,
                                            m.kv_offset, m.causal);
      p = ok ? p : 0.f;
    }
    dp[i] = p * (dp[i] - dmr[r]);
  }
}

struct DqGqa {
  static constexpr int kD = 256;
  static constexpr int kRows = 64;                 // q rows of a block
  static constexpr int kThreads = 128 + 32;        // + the producer warp
  static constexpr int kKStages = 3;
  static constexpr int kVStages = 2;
  static constexpr int kTile = kBwdStep * kD * 2;  // Q, dO, a K or V tile
  static constexpr size_t kSmem =
      static_cast<size_t>(2 + kKStages + kVStages) * kTile +
      (1 + 2 * kKStages + 2 * kVStages) * 8 + 1024;
};
static_assert(DqGqa::kRows == kBwdStep && DqGqa::kRows == BwdShape<256>::kRows,
              "kD 256 dq: a block's q rows are one streamed tile's keys");
static_assert(DqGqa::kSmem <= static_cast<size_t>(kMaxSmem),
              "kD 256 dq: Q, dO and the K / V stages exceed 227 KB");

template <typename T, bool kAcc>
__global__ void __launch_bounds__(DqGqa::kThreads, 1) flash_dq_gqa_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of 64 rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dq, int sq, int sk, int hq, int hkv, int d,
    int q_offset, int kv_offset, int causal, float scale, int cluster) {
  using L = DqGqa;
  constexpr int kD = L::kD;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * L::kRows;
  const int q_rows = min(L::kRows, sq - q0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + L::kTile;
  const uint32_t s_k = s_do + L::kTile;                 // stage st at + st * kTile
  const uint32_t s_v = s_k + L::kKStages * L::kTile;
  const uint32_t bar_own = s_v + L::kVStages * L::kTile;
  const uint32_t full_k = bar_own + 8;                  // + 8 st each
  const uint32_t empty_k = full_k + 8 * L::kKStages;
  const uint32_t full_v = empty_k + 8 * L::kKStages;
  const uint32_t empty_v = full_v + 8 * L::kVStages;

  const int n_kt = kv_tiles(sk, kBwdStep, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);
  // Only the panels holding a column below d load; the rest of Q, dO and
  // every stage are zeros from here on.
  const int panels = live_panels<kD>(d);
  zero_dead_panels<kD>(s_q, L::kRows, 2 + L::kKStages + L::kVStages, d,
                       L::kThreads);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    for (int st = 0; st < L::kKStages; ++st) {
      mbar_init(full_k + 8 * st);
      mbar_init(empty_k + 8 * st, cluster);  // each block's consumer
    }
    for (int st = 0; st < L::kVStages; ++st) {
      mbar_init(full_v + 8 * st);
      mbar_init(empty_v + 8 * st, cluster);
    }
    mbar_fence_init();
  }
  if (cluster > 1) {
    cluster_sync();  // the peers' barriers are set before any load
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= 128) {  // the producer warp
    if (lane == 0) {
      const uint32_t tile_bytes = kBwdStep * kPanelRowBytes * panels;
      const uint32_t rank = cluster > 1 ? cluster_rank() : 0;
      mbar_expect_tx(bar_own, 2 * L::kRows * kPanelRowBytes * panels);
      tma_tile<kD>(s_q, &tm_q, bar_own, h, q0, b, L::kRows, panels);
      tma_tile<kD>(s_do, &tm_do, bar_own, h, q0, b, L::kRows, panels);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int sk_ = kt % L::kKStages;
        const int sv = kt % L::kVStages;
        if (kt >= L::kKStages) {
          const uint32_t parity = (kt / L::kKStages - 1) & 1;
          mbar_wait(empty_k + 8 * sk_, parity);
        }
        mbar_expect_tx(full_k + 8 * sk_, tile_bytes);
        tma_tile_shared<kD>(s_k + sk_ * L::kTile, &tm_k, full_k + 8 * sk_, kvh,
                            kt * kBwdStep, b, kBwdStep, panels, cluster, rank, 0);
        if (kt >= L::kVStages) {
          const uint32_t parity = (kt / L::kVStages - 1) & 1;
          mbar_wait(empty_v + 8 * sv, parity);
        }
        mbar_expect_tx(full_v + 8 * sv, tile_bytes);
        tma_tile_shared<kD>(s_v + sv * L::kTile, &tm_v, full_v + 8 * sv, kvh,
                            kt * kBwdStep, b, kBwdStep, panels, cluster, rank,
                            panels);
      }
    }
    if (cluster > 1) cluster_sync();  // no block leaves while peers arrive
    return;
  }

  // This thread's two q rows (global index into sq): row0 and row0 + 8.
  const int row0 = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dmr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = (static_cast<size_t>(b) * sq + row) * hq + h;
    lse2[i] = row < sq ? lse[at] * kLog2e : 0.f;
    dmr[i] = row < sq ? dm[at] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  const DqMask mask{row0, q0, sq, sk, q_offset, kv_offset, causal};
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t ds[4][4];

  mbar_wait(bar_own, 0);
  if (n_kt > 0) {
    // Tile kt's K and V stages, once full.
    auto k_tile = [&](int kt) { return s_k + (kt % L::kKStages) * L::kTile; };
    auto v_tile = [&](int kt) { return s_v + (kt % L::kVStages) * L::kTile; };
    auto wait_full = [&](int kt) {
      mbar_wait(full_k + 8 * (kt % L::kKStages), (kt / L::kKStages) & 1);
      mbar_wait(full_v + 8 * (kt % L::kVStages), (kt / L::kVStages) & 1);
    };
    wait_full(0);
    wgmma_fence();
    dq_scores<T>(s, dp, s_q, s_do, k_tile(0), v_tile(0));
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    free_stage(empty_v, cluster);
    dq_grads(s, dp, 0, mask, lse2, dmr, scale2);
    walk_pack<T>(ds, dp);
    for (int kt = 1; kt < n_kt; ++kt) {
      wait_full(kt);
      wgmma_fence();
      // Q's and dO's descriptors recomputed each step (opaque): hoisted,
      // 32 k-steps of them stay live beside dQ, S, dP and dS and spill.
      dq_scores<T>(s, dp, opaque<true>(s_q), opaque<true>(s_do), k_tile(kt),
                   v_tile(kt));
      dq_product<T>(acc, ds, k_tile(kt - 1));
      wgmma_wait<1>();  // S and dP of tile kt; dQ of tile kt - 1 may still run
      reg_fence(s);
      reg_fence(dp);
      free_stage(empty_v + 8 * (kt % L::kVStages), cluster);
      dq_grads(s, dp, kt, mask, lse2, dmr, scale2);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(ds);
      free_stage(empty_k + 8 * ((kt - 1) % L::kKStages), cluster);
      walk_pack<T>(ds, dp);
    }
    wgmma_fence();
    dq_product<T>(acc, ds, k_tile(n_kt - 1));
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ds);
  }

  // dq = scale * dQ, this thread's column pairs of its two rows.
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < d && row < sq) {
        const size_t at =
            ((static_cast<size_t>(b) * sq + row) * hq + h) * d + col;
        put2<T, kAcc>(dq + at, scale * acc[4 * j + 2 * r],
                      scale * acc[4 * j + 2 * r + 1]);
      }
    }
  }
  if (cluster > 1) cluster_sync();
}

// A dk/dv block's epilogue: dk = scale * dK and dv = dV, this thread's
// column pairs (kN accumulator columns from col0) of its keys key0 and
// key0 + 8 -- into dk and dv, or with n_split > 1 as fp32 into the
// block's split of `part` (dk's partial, then dv's one output further
// on).
template <typename T, bool kAcc, int kN>
__device__ __forceinline__ void dkv_store(
    const float (&dk_acc)[kN / 2], const float (&dv_acc)[kN / 2],
    Out<T, kAcc>* dk, Out<T, kAcc>* dv, float* part, int n_split, int split,
    int col0, int key0, int b, int sk, int hkv, int kvh, int d, float scale) {
  const int lane = threadIdx.x & 31;
  const size_t n_out = static_cast<size_t>(gridDim.z / n_split) * sk * hkv * d;
  float* const part_k = part + 2 * static_cast<size_t>(split) * n_out;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (col < d && key < sk) {
        const size_t at =
            ((static_cast<size_t>(b) * sk + key) * hkv + kvh) * d + col;
        if (n_split > 1) {
          *reinterpret_cast<float2*>(part_k + at) = make_float2(
              scale * dk_acc[4 * j + 2 * r], scale * dk_acc[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(part_k + n_out + at) = make_float2(
              dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        } else {
          put2<T, kAcc>(dk + at, scale * dk_acc[4 * j + 2 * r],
                        scale * dk_acc[4 * j + 2 * r + 1]);
          put2<T, kAcc>(dv + at, dv_acc[4 * j + 2 * r],
                        dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// dk/dv, 16-bit inputs, kD 64 and 128. Grid (k tiles of BwdShape::kRows
// keys, hkv, b x n_split), the first key tiles (the longest causal
// walks) first. The block's K and V tiles stay in shared memory; for
// each of its query heads -- the whole group, or with n_split > 1 the
// split's g / n_split of them (kernels/attention.py::dkv_split_heads) --
// the Q and dO tiles of kBwdStep rows from the first the causal mask
// lets see the block's keys stream through a two-stage TMA ring (their
// lse and dm rows beside them by cp.async). Warpgroup w owns keys
// [64 w, 64 w + 64); with keys as rows, as in the Pallas kernel, it
// keeps in registers, per tile:
//   S^T = K . Q^T, dP^T = V . dO^T            (SS wgmma, 64 x 64 each)
//   P^T = exp(S^T - lse), dS^T = P^T * (dP^T - dm)  (lse, dm per column)
//   dV += P^T . dO, dK += dS^T . Q            (RS wgmma, B MN-major)
// dK and dV stay in registers across every q tile of every head the
// block walks, so the sum over those heads happens in the fp32
// accumulators. With n_split > 1 a block writes its fp32 partials
// (scale * dK and dV) to `part`, [n_split][2][b][sk][hkv][d], and
// flash_dkv_sum_kernel adds them up in split order: a block walks g /
// n_split heads, not g (kernels/attention.py::dkv_splits).
// ---------------------------------------------------------------------
template <typename T, int kD, bool kAcc>
__global__ void __launch_bounds__(BwdShape<kD>::kThreads, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kRows rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kRows rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdStep rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dk, Out<T, kAcc>* __restrict__ dv,
    float* __restrict__ part, int n_split, int sq, int sk, int hq, int hkv,
    int d, int q_offset, int kv_offset, int causal, float scale) {
  static_assert(kD <= 128, "kD 256 takes flash_dkv_wg2_kernel");
  using S = BwdShape<kD>;
  constexpr int kOwn = S::kRows * kD * 2;     // bytes of the K (V) tile
  constexpr int kStream = kBwdStep * kD * 2;  // bytes of a Q (dO) tile
  constexpr int kStats = 2 * kBwdStep * sizeof(float);  // lse, dm of a stage
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / n_split;
  const int split = blockIdx.z - b * n_split;
  const int g = hq / hkv;
  const int heads = g / n_split;             // the query heads it walks
  const int h_first = kvh * g + split * heads;
  const int k0 = kt * S::kRows;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + kOwn;
  const uint32_t s_q = s_v + kOwn;              // stage st at + st * kStream
  const uint32_t s_do = s_q + 2 * kStream;
  const uint32_t s_stats = s_do + 2 * kStream;  // stage st at + st * kStats
  const uint32_t bars = s_stats + 2 * kStats;
  const uint32_t bar_own = bars, bar_ring = bars + 8;
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (s_stats - smem_u32(smem_raw)));

  // q tiles from the first whose last row can see key k0.
  const int n_qt = (sq + kBwdStep - 1) / kBwdStep;
  int qt0 = 0;
  if (causal) {
    const int need = kv_offset + k0 - q_offset - (kBwdStep - 1);
    qt0 = need <= 0 ? 0 : min(n_qt, (need + kBwdStep - 1) / kBwdStep);
  }
  const int per_head = n_qt - qt0;
  const int n_steps = heads * per_head;
  const int panels = live_panels<kD>(d);
  const int stream_bytes = kBwdStep * kPanelRowBytes * panels;

  // Step n's Q and dO tiles (TMA, thread 0) and lse / dm rows (cp.async,
  // threads 0-127) into stage st.
  auto issue = [&](int n, int st) {
    const int hh = n / per_head;
    const int h = h_first + hh;
    const int q0 = (qt0 + n - hh * per_head) * kBwdStep;
    if (threadIdx.x == 0) {
      const uint32_t bar = bar_ring + 8 * st;
      mbar_expect_tx(bar, 2 * stream_bytes);
      tma_tile<kD>(s_q + st * kStream, &tm_q, bar, h, q0, b, kBwdStep, panels);
      tma_tile<kD>(s_do + st * kStream, &tm_do, bar, h, q0, b, kBwdStep,
                   panels);
    }
    if (threadIdx.x < 2 * kBwdStep) {
      const int r = threadIdx.x & (kBwdStep - 1);
      const float* src = threadIdx.x < kBwdStep ? lse : dm;
      const bool valid = q0 + r < sq;
      cp_async4(s_stats + st * kStats + threadIdx.x * sizeof(float),
                valid ? src + (static_cast<size_t>(b) * sq + q0 + r) * hq + h
                      : src,
                valid);
    }
    cp_async_commit();
  };

  zero_dead_panels<kD>(s_k, S::kRows, 2, d, S::kThreads);
  zero_dead_panels<kD>(s_q, kBwdStep, 4, d, S::kThreads);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    mbar_init(bar_ring);
    mbar_init(bar_ring + 8);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * S::kRows * kPanelRowBytes * panels);
    tma_tile<kD>(s_k, &tm_k, bar_own, kvh, k0, b, S::kRows, panels);
    tma_tile<kD>(s_v, &tm_v, bar_own, kvh, k0, b, S::kRows, panels);
  }
  if (n_steps > 0) issue(0, 0);

  // This thread's two keys (index into sk): key0 and key0 + 8.
  const int wk0 = k0 + 64 * wg;  // the warpgroup's first key
  const int key0 = wk0 + 16 * warp + (lane >> 2);
  const float scale2 = scale * kLog2e;
  // The plain versions' P = where(S * scale > MASK_VALUE / 2, exp(..), 0)
  // on every tile, as a bound on the raw score: a NaN score gives P = 0
  // even in a row whose lse is NaN (dV must stay finite there).
  const float s_min = kMaskValue * 0.5f / scale;

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  mbar_wait(bar_own, 0);
  cp_async_wait_all();
  __syncthreads();  // step 0's lse / dm are visible
  for (int n = 0; n < n_steps; ++n) {
    const int st = n & 1;
    if (n + 1 < n_steps) issue(n + 1, st ^ 1);
    mbar_wait(bar_ring + 8 * st, (n >> 1) & 1);
    const int hh = n / per_head;
    const int q0 = (qt0 + n - hh * per_head) * kBwdStep;
    const uint32_t q_tile = s_q + st * kStream;
    const uint32_t do_tile = s_do + st * kStream;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(s, kmajor_desc(s_k, S::kRows, 64 * wg, kk),
                      kmajor_desc(q_tile, kBwdStep, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(dp, kmajor_desc(s_v, S::kRows, 64 * wg, kk),
                      kmajor_desc(do_tile, kBwdStep, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // P^T in place of S^T, dS^T in place of dP^T; lse and dm per column.
    const float* lse_s = stats + st * (kStats / sizeof(float));
    const float* dm_s = lse_s + kBwdStep;
    const bool edge = q0 + kBwdStep - 1 >= sq || wk0 + 63 >= sk ||
                      (causal && kv_offset + wk0 + 63 > q_offset + q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 m2 = *reinterpret_cast<const float2*>(dm_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? l2.y : l2.x;
        const float m = (e & 1) ? m2.y : m2.x;
        float p = exp2f(fmaf(s[i], scale2, -l * kLog2e));
        if (!(s[i] > s_min)) p = 0.f;
        if (edge) {
          const int q = q0 + c + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          const bool ok = q < sq && visible(q_offset + q, key, sk, kv_offset,
                                            causal);
          p = ok ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - m);
      }
    }
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pf[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        dsf[kk][j] = pack2<T>(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdStep / 16; ++kk)
      wgmma_rs_nd<T, kD>(dv_acc, pf[kk], mnmajor_desc(do_tile, kBwdStep, kk));
#pragma unroll
    for (int kk = 0; kk < kBwdStep / 16; ++kk)
      wgmma_rs_nd<T, kD>(dk_acc, dsf[kk], mnmajor_desc(q_tile, kBwdStep, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pf);
    reg_fence(dsf);
    cp_async_wait_all();  // step n + 1's lse / dm
    __syncthreads();      // stage st is read by no one: it may be refilled
  }

  dkv_store<T, kAcc, kD>(dk_acc, dv_acc, dk, dv, part, n_split, split, 0,
                         key0, b, sk, hkv, kvh, d, scale);
}

// ---------------------------------------------------------------------
// dk/dv, 16-bit inputs, kD 256. dK and dV of 64 keys at 256 columns are
// 256 fp32 a thread of one warpgroup, so two warpgroups share the 64
// keys, splitting both kinds of product in two with nothing computed
// twice. Per streamed (Q, dO) tile of 64 q rows, warpgroup w:
//   S^T, dP^T for the tile's q columns [32 w, 32 w + 32)
//                        (SS wgmma m64n32, K and V against Q and dO rows)
//   P^T, dS^T there      (fp32, as the kD 64 / 128 kernel: lse and dm per
//                        column, the mask, s_min), packed to T as the A
//                        fragments of their two k16 steps, which go to
//                        the swap buffer in shared memory: each thread's
//                        are the other warpgroup's same thread's other
//                        two k16 steps, so it reads them back whole
//   dV, dK for columns [128 w, 128 w + 128) over all 64 q rows
//                        (RS wgmma m64n128, the four k16 steps of P^T
//                        and dS^T against dO and Q, MN-major)
// -- the products of one warpgroup holding everything, halved, where the
// kD 64 / 128 kernel's shape at 256 (a block a column half, each
// recomputing S^T and dP^T over all 256 columns) took 1.5x. Grid (key
// tiles of 64, hkv, b x n_split), the ring, the statistics and the
// split as in flash_dkv_wgmma_kernel; a block barrier after the swap
// and one after the products.
// ---------------------------------------------------------------------
struct Dkv256 {
  static constexpr int kD = 256;
  static constexpr int kRows = 64;        // keys of a block (both warpgroups)
  static constexpr int kThreads = 256;
  static constexpr int kOwn = kRows * kD * 2;         // the K (V) tile
  static constexpr int kStream = kBwdStep * kD * 2;   // a Q (dO) tile
  static constexpr int kStats = 2 * kBwdStep * sizeof(float);
  static constexpr int kSwap = 2 * 2 * 8 * 128 * 4;   // [wg][P, dS][8][thread]
  static constexpr size_t kSmem =
      2 * kOwn + 4 * kStream + 2 * kStats + kSwap + 3 * 8 + 1024;
};
static_assert(Dkv256::kSmem <= static_cast<size_t>(kMaxSmem),
              "the kD 256 dk/dv tiles exceed 227 KB");
static_assert(Dkv256::kRows == BwdShape<256>::kRows,
              "flash_tile_rows reports BwdShape's rows for dk/dv");

template <typename T, bool kAcc>
__global__ void __launch_bounds__(Dkv256::kThreads, 1) flash_dkv_wg2_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdStep rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dk, Out<T, kAcc>* __restrict__ dv,
    float* __restrict__ part, int n_split, int sq, int sk, int hq, int hkv,
    int d, int q_offset, int kv_offset, int causal, float scale) {
  using S = Dkv256;
  constexpr int kD = S::kD;
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / n_split;
  const int split = blockIdx.z - b * n_split;
  const int g = hq / hkv;
  const int heads = g / n_split;             // the query heads it walks
  const int h_first = kvh * g + split * heads;
  const int k0 = kt * S::kRows;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base;
  const uint32_t s_v = s_k + S::kOwn;
  const uint32_t s_q = s_v + S::kOwn;              // stage st at + st * kStream
  const uint32_t s_do = s_q + 2 * S::kStream;
  const uint32_t s_stats = s_do + 2 * S::kStream;  // stage st at + st * kStats
  const uint32_t s_swap = s_stats + 2 * S::kStats;
  const uint32_t bars = s_swap + S::kSwap;
  const uint32_t bar_own = bars, bar_ring = bars + 8;
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (s_stats - smem_u32(smem_raw)));
  uint32_t* swap = reinterpret_cast<uint32_t*>(
      smem_raw + (s_swap - smem_u32(smem_raw)));

  // q tiles from the first whose last row can see key k0.
  const int n_qt = (sq + kBwdStep - 1) / kBwdStep;
  int qt0 = 0;
  if (causal) {
    const int need = kv_offset + k0 - q_offset - (kBwdStep - 1);
    qt0 = need <= 0 ? 0 : min(n_qt, (need + kBwdStep - 1) / kBwdStep);
  }
  const int per_head = n_qt - qt0;
  const int n_steps = heads * per_head;
  const int panels = live_panels<kD>(d);
  const int stream_bytes = kBwdStep * kPanelRowBytes * panels;

  // Step n's Q and dO tiles (TMA, thread 0) and lse / dm rows (cp.async,
  // threads 0-127) into stage st.
  auto issue = [&](int n, int st) {
    const int hh = n / per_head;
    const int h = h_first + hh;
    const int q0 = (qt0 + n - hh * per_head) * kBwdStep;
    if (threadIdx.x == 0) {
      const uint32_t bar = bar_ring + 8 * st;
      mbar_expect_tx(bar, 2 * stream_bytes);
      tma_tile<kD>(s_q + st * S::kStream, &tm_q, bar, h, q0, b, kBwdStep,
                   panels);
      tma_tile<kD>(s_do + st * S::kStream, &tm_do, bar, h, q0, b, kBwdStep,
                   panels);
    }
    if (threadIdx.x < 2 * kBwdStep) {
      const int r = threadIdx.x & (kBwdStep - 1);
      const float* src = threadIdx.x < kBwdStep ? lse : dm;
      const bool valid = q0 + r < sq;
      cp_async4(s_stats + st * S::kStats + threadIdx.x * sizeof(float),
                valid ? src + (static_cast<size_t>(b) * sq + q0 + r) * hq + h
                      : src,
                valid);
    }
    cp_async_commit();
  };

  zero_dead_panels<kD>(s_k, S::kRows, 2, d, S::kThreads);
  zero_dead_panels<kD>(s_q, kBwdStep, 4, d, S::kThreads);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    mbar_init(bar_ring);
    mbar_init(bar_ring + 8);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * S::kRows * kPanelRowBytes * panels);
    tma_tile<kD>(s_k, &tm_k, bar_own, kvh, k0, b, S::kRows, panels);
    tma_tile<kD>(s_v, &tm_v, bar_own, kvh, k0, b, S::kRows, panels);
  }
  if (n_steps > 0) issue(0, 0);

  // Both warpgroups hold all 64 keys: this thread's key0 and key0 + 8.
  const int key0 = k0 + 16 * warp + (lane >> 2);
  const int qc0 = 32 * wg;    // its q columns of a tile's S^T and dP^T
  const int col0 = 128 * wg;  // its columns of dK and dV
  const float scale2 = scale * kLog2e;
  const float s_min = kMaskValue * 0.5f / scale;  // as in the kD 64 / 128 kernel
  // The streamed tiles' panel of column col0.
  const uint32_t cols = (col0 / 64) * kBwdStep * kPanelRowBytes;
  // Swap slots: [warpgroup][P^T 0, dS^T 1][k16 step of its two][reg].
  const auto slot = [&](int w, int which, int kk, int j) {
    return ((w * 2 + which) * 8 + kk * 4 + j) * 128 + t;
  };

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  mbar_wait(bar_own, 0);
  cp_async_wait_all();
  __syncthreads();  // step 0's lse / dm are visible
  for (int n = 0; n < n_steps; ++n) {
    const int st = n & 1;
    if (n + 1 < n_steps) issue(n + 1, st ^ 1);
    mbar_wait(bar_ring + 8 * st, (n >> 1) & 1);
    const int hh = n / per_head;
    const int q0 = (qt0 + n - hh * per_head) * kBwdStep;
    const uint32_t q_tile = s_q + st * S::kStream;
    const uint32_t do_tile = s_do + st * S::kStream;

    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n32<T>(s, kmajor_desc(s_k, S::kRows, 0, kk),
                      kmajor_desc(q_tile, kBwdStep, qc0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n32<T>(dp, kmajor_desc(s_v, S::kRows, 0, kk),
                      kmajor_desc(do_tile, kBwdStep, qc0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // P^T in place of S^T, dS^T in place of dP^T on this warpgroup's 32
    // q columns; lse and dm per column.
    const float* lse_s = stats + st * (S::kStats / sizeof(float));
    const float* dm_s = lse_s + kBwdStep;
    const bool edge = q0 + kBwdStep - 1 >= sq || k0 + S::kRows - 1 >= sk ||
                      (causal && kv_offset + k0 + S::kRows - 1 > q_offset + q0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = qc0 + 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 m2 = *reinterpret_cast<const float2*>(dm_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? l2.y : l2.x;
        const float m = (e & 1) ? m2.y : m2.x;
        float p = exp2f(fmaf(s[i], scale2, -l * kLog2e));
        if (!(s[i] > s_min)) p = 0.f;
        if (edge) {
          const int q = q0 + c + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          const bool ok = q < sq && visible(q_offset + q, key, sk, kv_offset,
                                            causal);
          p = ok ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - m);
      }
    }
    // This warpgroup's two k16 steps of P^T and dS^T (k = q rows 32 wg
    // ..): to the swap buffer, then the other warpgroup's two back.
    uint32_t mine_p[2][4], mine_ds[2][4], other_p[2][4], other_ds[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mine_p[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        mine_ds[kk][j] = pack2<T>(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
        swap[slot(wg, 0, kk, j)] = mine_p[kk][j];
        swap[slot(wg, 1, kk, j)] = mine_ds[kk][j];
      }
    __syncthreads();  // both warpgroups' steps are in the swap buffer
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        other_p[kk][j] = swap[slot(wg ^ 1, 0, kk, j)];
        other_ds[kk][j] = swap[slot(wg ^ 1, 1, kk, j)];
      }
    // The four k16 steps in q order: warpgroup 0's two, then 1's.
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pf[kk][j] = wg ? other_p[kk][j] : mine_p[kk][j];
        pf[2 + kk][j] = wg ? mine_p[kk][j] : other_p[kk][j];
        dsf[kk][j] = wg ? other_ds[kk][j] : mine_ds[kk][j];
        dsf[2 + kk][j] = wg ? mine_ds[kk][j] : other_ds[kk][j];
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdStep / 16; ++kk)
      wgmma_rs_nd<T, 128>(dv_acc, pf[kk],
                          mnmajor_desc(do_tile + cols, kBwdStep, kk));
#pragma unroll
    for (int kk = 0; kk < kBwdStep / 16; ++kk)
      wgmma_rs_nd<T, 128>(dk_acc, dsf[kk],
                          mnmajor_desc(q_tile + cols, kBwdStep, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pf);
    reg_fence(dsf);
    cp_async_wait_all();  // step n + 1's lse / dm
    __syncthreads();      // stage st and the swap buffer are free
  }
  dkv_store<T, kAcc, 128>(dk_acc, dv_acc, dk, dv, part, n_split, split, col0,
                          key0, b, sk, hkv, kvh, d, scale);
}

// ---------------------------------------------------------------------
// The split dk/dv's sum: dk = sum over s of part[s][0], dv of
// part[s][1], added in split order s = 0, 1, ... (no atomics: the same
// bits from launch to launch), written in T or, with kAcc, added
// unrounded into the fp32 buffers. n elements an output, a multiple of
// 4 (d is, at the widths the wrapper pads to): one float4 of dk or dv a
// thread a step, grid-strided.
// ---------------------------------------------------------------------
constexpr int kSumThreads = 256;

template <typename T, bool kAcc>
__global__ void __launch_bounds__(kSumThreads) flash_dkv_sum_kernel(
    const float* __restrict__ part, Out<T, kAcc>* __restrict__ dk,
    Out<T, kAcc>* __restrict__ dv, int n_split, size_t n) {
  const size_t quads = n / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(kSumThreads) + threadIdx.x;
       i < 2 * quads; i += static_cast<size_t>(gridDim.x) * kSumThreads) {
    const int which = i >= quads;  // 0 dk, 1 dv
    const size_t at = 4 * (i - which * quads);
    const float* src = part + which * n + at;
    float4 acc = __ldg(reinterpret_cast<const float4*>(src));
    for (int s = 1; s < n_split; ++s) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src + 2 * s * n));
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    Out<T, kAcc>* out = (which ? dv : dk) + at;
    put2<T, kAcc>(out, acc.x, acc.y);
    put2<T, kAcc>(out + 2, acc.z, acc.w);
  }
}

// ---------------------------------------------------------------------
// Forward, 16-bit inputs. Grid (q tiles of FwdShape::kRows, hq, b),
// heaviest causal tiles first. The consumer warpgroups (two up to kD 128,
// one at 256) own rows [64 w, 64 w + 64) of the tile; a producer warp
// loads the Q tile once and streams K and V tiles of kWalkKeys keys
// through the ring, refilling a stage as soon as every warpgroup has
// freed it. Each warpgroup walks the tiles its own last row can see
// (hopper.cuh, walk) and frees the rest (walk_skip): the one below the
// diagonal walks one tile fewer and never waits for the other. The
// epilogue writes out and lse straight from registers.
//
// At kD 256 the blocks of one q tile whose query heads share a KV head
// run as a cluster of `cluster` blocks along the grid's head axis
// (gqa_cluster_ok; kernels/attention.py::gqa_cluster picks it): they
// walk the same K and V tiles, so each stage's boxes are split among
// them and each box is loaded once from L2 and multicast into every
// block's ring (tma_tile_shared), and a stage is refilled once every block's
// consumers have freed it (walk_release arrives on each block's empty
// barrier). Every block of a cluster has the same q tile, so they all
// walk the same number of tiles. At Gemma-2B's 8 query heads over one
// KV head that cuts the K/V bytes moved from L2 into shared memory
// eight-fold (276.8 MB to 34.6 MB a call at S 2048). Every score and
// product is computed as without the cluster: out and lse are the same
// bits.
// ---------------------------------------------------------------------
// Stages of the K/V ring. Overridable with -D (kernels/autotune.py builds
// such variants); the default build takes 4.
#ifndef TPUHPC_FWD_STAGES
#define TPUHPC_FWD_STAGES 4
#endif
constexpr int kFwdStages = TPUHPC_FWD_STAGES;

// The forward's shape at head dim kD: up to kD 128, two consumer
// warpgroups on a 128-row q tile and kFwdStages stages; at kD 256 one
// warpgroup on 64 rows (O alone is 128 fp32 a thread: two warpgroups and
// the producer would leave each thread 168 registers, one of an SM's
// four register banks holding three of the nine warps) and at most three
// stages (Q 32 KB, a stage 64 KB: 230,480 bytes), the paged prefill's
// shape at that width.
template <int kD>
struct FwdShape {
  static constexpr int kWgs = kD == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kThreads = 128 * kWgs + 32;  // + the producer warp
  static constexpr int kStages = kD == 256 && kFwdStages > 3 ? 3 : kFwdStages;
  static constexpr size_t kSmem = kRows * kD * 2 +
                                  2 * kStages * walk_tile_bytes<kD>() +
                                  (1 + 3 * kStages) * 8 + 1024;
};
// The producer refills a stage while the consumers read the other: one
// stage would serialize the load and the products.
static_assert(kFwdStages >= 2, "kFwdStages: the ring needs two stages");
static_assert(FwdShape<64>::kSmem <= static_cast<size_t>(kMaxSmem),
              "kFwdStages: the Q tile and the K/V ring exceed 227 KB of "
              "shared memory at head_dim 64");
static_assert(FwdShape<128>::kSmem <= static_cast<size_t>(kMaxSmem),
              "kFwdStages: the Q tile and the K/V ring exceed 227 KB of "
              "shared memory at head_dim 128");
static_assert(FwdShape<256>::kSmem <= static_cast<size_t>(kMaxSmem),
              "kFwdStages: the Q tile and the K/V ring exceed 227 KB of "
              "shared memory at head_dim 256");

// The forward's mask for one thread: its two rows at global positions
// row[0], row[1]; the warpgroup's first row at `first`.
struct FwdMask {
  int row[2];
  int first;
  int sk, kv_offset, causal;
  __device__ __forceinline__ bool edge(int k_last) const {
    return k_last >= sk || (causal && kv_offset + k_last > first);
  }
  __device__ __forceinline__ bool sees(int r, int key) const {
    return visible(row[r], key, sk, kv_offset, causal);
  }
};

template <typename T, int kD>
__global__ void __launch_bounds__(FwdShape<kD>::kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // boxes of kRows rows
    const __grid_constant__ CUtensorMap tm_k,  // boxes of kWalkKeys rows
    const __grid_constant__ CUtensorMap tm_v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int hq,
    int hkv, int d, int q_offset, int kv_offset, int causal, float scale,
    int cluster) {
  using S = FwdShape<kD>;
  // Blocks sharing the K/V stream (1 below kD 256: no cluster there).
  const int peers = kD == 256 ? cluster : 1;
  constexpr int kStages = S::kStages;
  constexpr int kQ = S::kRows * kD * 2;  // bytes of the Q tile
  constexpr int kTile = walk_tile_bytes<kD>();
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * S::kRows;
  const int q_rows = min(S::kRows, sq - q0);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  WalkRing ring;
  ring.k = s_q + kQ;
  ring.v = ring.k + kStages * kTile;
  const uint32_t bar_q = ring.v + kStages * kTile;
  ring.full_k = bar_q + 8;
  ring.full_v = ring.full_k + 8 * kStages;
  ring.empty = ring.full_v + 8 * kStages;
  ring.stages = kStages;
  ring.peers = peers;

  const int n_kt = kv_tiles(sk, kWalkKeys, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);
  // Only the panels holding a column below d load; the rest of Q and of
  // every K and V stage are zeros from here on.
  const int panels = live_panels<kD>(d);
  zero_dead_panels<kD>(s_q, S::kRows, 1, d, S::kThreads);
  zero_dead_panels<kD>(ring.k, kWalkKeys, 2 * kStages, d, S::kThreads);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    mbar_init(bar_q);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.full_k + 8 * st);
      mbar_init(ring.full_v + 8 * st);
      // Every consumer warpgroup of every block sharing the ring.
      mbar_init(ring.empty + 8 * st, S::kWgs * peers);
    }
    mbar_fence_init();
  }
  if (peers > 1) {
    cluster_sync();  // the peers' barriers are set before any load
  } else {
    __syncthreads();
  }

  if (wg == S::kWgs) {  // the producer warp
    if (lane == 0) {
      const uint32_t tile_bytes = kWalkKeys * kPanelRowBytes * panels;
      const uint32_t rank = peers > 1 ? cluster_rank() : 0;
      mbar_expect_tx(bar_q, S::kRows * kPanelRowBytes * panels);
      tma_tile<kD>(s_q, &tm_q, bar_q, h, q0, b, S::kRows, panels);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) {
          mbar_wait(ring.empty + 8 * st, (kt / kStages - 1) & 1);
        }
        // The whole tiles' bytes, whoever of the cluster loads them; the
        // V tile's boxes from block `panels` on, so they spread over it.
        mbar_expect_tx(ring.full_k + 8 * st, tile_bytes);
        tma_tile_shared<kD>(ring.k + st * kTile, &tm_k, ring.full_k + 8 * st,
                            kvh, kt * kWalkKeys, b, kWalkKeys, panels, peers,
                            rank, 0);
        mbar_expect_tx(ring.full_v + 8 * st, tile_bytes);
        tma_tile_shared<kD>(ring.v + st * kTile, &tm_v, ring.full_v + 8 * st,
                            kvh, kt * kWalkKeys, b, kWalkKeys, panels, peers,
                            rank, panels);
      }
    }
    if (peers > 1) cluster_sync();  // no block leaves while peers arrive
    return;
  }

  // This thread's two q rows (index into sq): row0 and row0 + 8.
  const int wq0 = q0 + 64 * wg;  // the warpgroup's first row
  const int row0 = wq0 + 16 * warp + (lane >> 2);
  const int n_wg = wq0 < sq ? kv_tiles(sk, kWalkKeys,
                                       q_offset + min(wq0 + 63, sq - 1),
                                       kv_offset, causal)
                            : 0;
  const FwdMask mask{{q_offset + row0, q_offset + row0 + 8}, q_offset + wq0,
                     sk, kv_offset, causal};
  WalkRows<kD> rows;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) rows.o[i] = 0.f;
  rows.m[0] = rows.m[1] = kMaskValue;
  rows.l[0] = rows.l[1] = 0.f;

  mbar_wait(bar_q, 0);
  walk<T, kD>(rows, s_q, S::kRows, 64 * wg, ring, n_wg, scale * kLog2e, mask);

  T* row_ptr[2];
  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    row_ptr[r] = row < sq ? out + ((static_cast<size_t>(b) * sq + row) * hq + h) * d
                          : nullptr;
  }
  walk_finish<T, kD>(rows, row_ptr, d, row_lse);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if ((lane & 3) == 0 && row < sq)
      lse[(static_cast<size_t>(b) * sq + row) * hq + h] = row_lse[r];
  }
  walk_skip(ring, n_wg, n_kt);
  if (peers > 1) cluster_sync();
}

// ---------------------------------------------------------------------
// Forward, float32 inputs, on the TF32 tensor cores (hopper.cuh, the
// TF32 walk). Grid (q tiles of kTf32Rows, hq, b), heaviest causal tiles
// first. Two converter warpgroups read the block's 64 q rows once, then
// one each 32-key tile of K and the other of V of the query head's KV
// head (GQA: no repeated copy) with coalesced 16-byte loads, split every
// value into TF32 hi and lo and write them into the ring (V transposed,
// as TF32 P . V reads it); keys past sk come out as zeros. The consumer warpgroup walks the
// tiles its last row can see: S in three TF32 passes (Q hi K hi, then
// the cross terms), P kept in fp32 -- the Pallas kernel's
// p.astype(v.dtype) is the identity here -- and split, P . V in three.
// Shared memory at d 128: Q hi and lo 64 KB, two stages of K and V hi
// and lo, 128 KB (Tf32Layout). The epilogue writes out and the lse from
// registers, with the 16-bit forward's m_safe / l_safe rules.
// ---------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q,  // (b, sq, hq, d)
    const float* __restrict__ k,  // (b, sk, hkv, d)
    const float* __restrict__ v,
    float* __restrict__ out,      // (b, sq, hq, d)
    float* __restrict__ lse,      // (b, sq, hq)
    int sq, int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
    int causal, float scale) {
  using L = Tf32Layout<float, float, kD>;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kTf32Rows;
  const int q_rows = min(kTf32Rows, sq - q0);
  const int warp = threadIdx.x >> 5;  // 0-3 the consumers, 4-11 the converters
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Tf32Ring ring = Tf32Ring::at<L>(base);
  const int n_kt = kv_tiles(sk, kTf32Keys, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);

  if (threadIdx.x == 0) tf32_ring_init<L>(ring);
  __syncthreads();

  if (warp >= 4) {  // the converter warpgroups
    const auto q_row = [&](int r) {
      return q0 + r < sq ? q + ((static_cast<size_t>(b) * sq + q0 + r) * hq + h) * d
                         : nullptr;
    };
    const auto src_of = [&](int key) {
      const size_t off = ((static_cast<size_t>(b) * sk + key) * hkv + kvh) * d;
      return key < sk ? Tf32Src<float>{k + off, v + off, 0.f, 0.f}
                      : Tf32Src<float>{nullptr, nullptr, 0.f, 0.f};
    };
    tf32_converters<float, float, L, kD>(ring, threadIdx.x - 128, n_kt, d, q_row,
                                         src_of);
    return;
  }

  tf32_regs_consumer();
  // This thread's two q rows (index into sq): row0 and row0 + 8.
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const FwdMask mask{{q_offset + row0, q_offset + row0 + 8}, q_offset + q0, sk,
                     kv_offset, causal};
  WalkRows<kD> rows;
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) rows.o[i] = 0.f;
  rows.m[0] = rows.m[1] = kMaskValue;
  rows.l[0] = rows.l[1] = 0.f;
  tf32_walk<float, float, kD>(rows, ring, n_kt, scale * kLog2e, mask);

  float* row_ptr[2];
  float row_lse[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    row_ptr[rr] = row < sq ? out + ((static_cast<size_t>(b) * sq + row) * hq + h) * d
                           : nullptr;
  }
  walk_finish<float, kD>(rows, row_ptr, d, row_lse);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if ((lane & 3) == 0 && row < sq)
      lse[(static_cast<size_t>(b) * sq + row) * hq + h] = row_lse[rr];
  }
}

// =====================================================================
// Backward, float32 inputs, on the TF32 tensor cores: dq and dk/dv in
// the roles of the TF32 walk (hopper.cuh). One consumer warpgroup owns a
// block's 64 rows (q rows in dq, keys in dk/dv) and issues every product;
// two converter warpgroups read the float32 inputs with coalesced 16-byte
// loads, split each value into TF32 hi and lo, and write the tiles the
// products read: K-major, or transposed ([kD][32] with vt_at's row order)
// where a product's k runs over a streamed tile's rows, since TF32 wgmma
// has no transposed operand. Each converter warpgroup takes half of
// every streamed tile's columns (BwdHalf), so both walk the same tiles in
// the same order, each tile's loads issued before the previous tile is
// converted (dk/dv: as soon as the previous tile of the same tensor is).
// Every product of two fp32 operands takes three passes; the cross terms
// of S and dP go to accumulators of their own, added where the main term
// is finite (tf32_add_finite), so an inf in Q, K, V or dO reaches S or dP
// as it does the plain version's. dS, which takes either sign, splits
// with tf32_split; P with tf32_split_p (P . dO's terms agree in sign).
// The element-wise rules of P and dS are the 16-bit kernels'. The
// consumer takes up to 232 registers a thread, the converters 136 (dk/dv:
// 248 and 128). An `accumulate` launch adds its result into the output
// instead of writing it: bit for bit a fresh result added afterwards.
// =====================================================================

// A converter thread's half of a 32-row streamed tile: warpgroup
// ct / 128 takes columns [col0, col0 + kD / 2) with Tf32Share's mapping
// over that half (coalesced loads, conflict-free stores into K-major and
// transposed tiles alike), so each thread holds kD / 8 values of two
// rows, row(0) and row(1).
template <int kD>
struct BwdHalf {
  using X = Tf32Share<float, kD / 2>;
  int c, col0, rot;

  __device__ __forceinline__ explicit BwdHalf(int ct)
      : c(ct & 127), col0((ct >> 7) * (kD / 2)), rot(X::rot(ct & 127)) {}
  __device__ __forceinline__ int row(int j) const { return X::key(c, j); }
  // This thread's chunks of rows row(0) and row(1), from the start of each
  // (null past the end: zeros).
  __device__ __forceinline__ void load(X& x, const float* const (&rows)[2],
                                       int d) const {
    const float* const mine[2] = {rows[0] ? rows[0] + col0 : nullptr,
                                  rows[1] ? rows[1] + col0 : nullptr};
    tf32_load<float, kD / 2>(x, c, mine, d - col0);
  }
  // x split into a K-major tile of 32 rows (hi, lo).
  __device__ __forceinline__ void put_rows(uint32_t hi, uint32_t lo,
                                           const X& x) const {
#pragma unroll
    for (int i = 0; i < X::kPer; ++i)
      put_kmajor<float, true>(hi, lo, kTf32Keys, X::key(c, i),
                              col0 / 4 + X::chunk(c, i), x.x[i]);
    fence_proxy_async();
  }
  // x split into the transposed tile [kD][32] (hi, lo).
  __device__ __forceinline__ void put_cols(uint32_t hi, uint32_t lo,
                                           const X& x) const {
#pragma unroll
    for (int i = 0; i < X::kPer; ++i)
      put_vt<float, true>(hi, lo, X::key(c, i), col0 / 4 + X::chunk(c, i),
                          x.x[i], rot);
    fence_proxy_async();
  }
};

// The block's own 64 rows of two [B, S, H, D] float32 arrays (Q and dO,
// or K and V) from row `first` of head h, split into the K-major tiles
// hi at a and b (lo one `tile` bytes on), then the converters' arrival
// on `bar`.
template <int kD>
__device__ __forceinline__ void bwd_put_own(uint32_t a, uint32_t b_tile,
                                            int tile, uint32_t bar, int ct,
                                            const float* x, const float* y,
                                            int batch, int s, int heads, int h,
                                            int first, int d) {
  const int row = first + (ct & 63);
  const size_t at = ((static_cast<size_t>(batch) * s + row) * heads + h) * d;
  const bool live = row < s;
  tf32_put_rows64<float, true, kD>(a, a + tile, ct, live ? x + at : nullptr, d);
  tf32_put_rows64<float, true, kD>(b_tile, b_tile + tile, ct,
                                   live ? y + at : nullptr, d);
  fence_proxy_async();
  mbar_arrive(bar);
}

// This thread's column pairs of its two rows of a 64 x kD accumulator,
// times `scale`, into an fp32 [B, S, H, D] output at row0 and row0 + 8
// of head h (added into it where `accumulate`).
template <int kD>
__device__ __forceinline__ void bwd_store(float* out, const float (&acc)[kD / 2],
                                          float scale, int batch, int s,
                                          int heads, int h, int row0, int d,
                                          int accumulate) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (col < d && row < s) {
        float2* at = reinterpret_cast<float2*>(
            out + ((static_cast<size_t>(batch) * s + row) * heads + h) * d + col);
        // Rounded multiply and add, never fused into one FMA: an added
        // result has the bits of the written one added afterwards.
        float2 o = make_float2(__fmul_rn(scale, acc[4 * j + 2 * r]),
                               __fmul_rn(scale, acc[4 * j + 2 * r + 1]));
        if (accumulate) {
          const float2 was = *at;
          o = make_float2(__fadd_rn(was.x, o.x), __fadd_rn(was.y, o.y));
        }
        *at = o;
      }
    }
  }
}

// Shared memory of flash_dq_tf32_kernel, from a 1024-byte-aligned base:
// the block's Q and dO (64 rows, hi and lo: 128 KB at kD 128), then
// kStages stages of three streamed tiles of 32 keys, each hi and lo --
// K, V (K-major, for S = Q . K^T and dP = dO . V^T) and K^T (for dQ +=
// dS . K): 96 KB a stage at kD 128, so one stage there, three at kD 64 --
// then the barriers: bar_own (256 converter arrivals), then per stage a
// full (256 arrivals) and an empty (one consumer arrival) barrier for
// each of K, V and K^T. The three are freed apart: K and V once S and dP
// have read them, K^T once dQ has, so the next K and V are written while
// the consumer runs this tile's softmax and dQ.
template <int kD>
struct DqTf32Layout {
  static constexpr int kOwnTile = kTf32Rows * kD * 4;  // Q or dO, hi or lo
  static constexpr int kTile = kTf32Keys * kD * 4;     // K, V or K^T, hi or lo
  static constexpr int kOwn = 4 * kOwnTile;
  static constexpr int kStage = 6 * kTile;
  static constexpr int kFit = (kMaxSmem - 1024 - kOwn - 8) / (kStage + 48);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + kOwn + kStages * kStage + (1 + 6 * kStages) * 8;
  static_assert(kStages >= 1, "dq: Q, dO and one K, V, K^T stage exceed 227 KB");
};

// ---------------------------------------------------------------------
// dq, float32 inputs. Grid (q tiles of kTf32Rows, hq, b), heaviest causal
// tiles first; the consumer walks the 32-key tiles its last row can see:
//   S = Q . K^T, dP = dO . V^T    SS m64n32k8, three passes each
//   P = exp(S - lse), dS = P * (dP - dm)         (in registers)
//   dQ += dS . K                  RS m64nDk8 over K^T, three passes
// dQ stays in registers for the walk; the epilogue writes scale * dQ.
// ---------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ dout,  // (b, sq, hq, d)
    const float* __restrict__ lse,   // (b, sq, hq)
    const float* __restrict__ dm,    // (b, sq, hq): rowsum(dO*O) - dlse
    float* __restrict__ dq,          // (b, sq, hq, d)
    int sq, int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
    int causal, int accumulate, float scale) {
  using L = DqTf32Layout<kD>;
  constexpr int kS = L::kStages;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kTf32Rows;
  const int q_rows = min(kTf32Rows, sq - q0);
  const int warp = threadIdx.x >> 5;  // 0-3 the consumer, 4-11 the converters
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_do = s_q + 2 * L::kOwnTile;
  const uint32_t s_stage = s_q + L::kOwn;
  const uint32_t bar_own = s_stage + kS * L::kStage;
  const uint32_t full = bar_own + 8;
  const uint32_t empty = full + 24 * kS;
  // Part p (0 K, 1 V, 2 K^T) of stage st: its hi tile (lo kTile on), and
  // its barrier in a set (full or empty: one array of kS a part).
  const auto tile = [&](int st, int p) {
    return s_stage + st * L::kStage + 2 * p * L::kTile;
  };
  const auto bar = [&](uint32_t set, int st, int p) {
    return set + 8 * (p * kS + st);
  };

  const int n_kt = kv_tiles(sk, kTf32Keys, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);
  if (threadIdx.x == 0) {
    mbar_init(bar_own, 256);
    for (int st = 0; st < kS; ++st)
      for (int p = 0; p < 3; ++p) {
        mbar_init(bar(full, st, p), 256);
        mbar_init(bar(empty, st, p), 1);
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the converters
    tf32_regs_converter();
    const int ct = threadIdx.x - 128;
    bwd_put_own<kD>(s_q, s_do, L::kOwnTile, bar_own, ct, q, dout, b, sq, hq, h,
                    q0, d);
    const BwdHalf<kD> me(ct);
    using X = typename BwdHalf<kD>::X;
    // Rows row(0), row(1) of key tile kt of K or V (null past sk).
    const auto rows_of = [&](const float* src, int kt, const float* (&r)[2]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kt * kTf32Keys + me.row(j);
        r[j] = key < sk ? src + ((static_cast<size_t>(b) * sk + key) * hkv + kvh) * d
                        : nullptr;
      }
    };
    if (n_kt <= 0) return;
    X xk, xv;
    {
      const float* rk[2];
      const float* rv[2];
      rows_of(k, 0, rk);
      rows_of(v, 0, rv);
      me.load(xk, rk, d);
      me.load(xv, rv, d);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kS;
      const float* rk[2] = {nullptr, nullptr};
      const float* rv[2] = {nullptr, nullptr};
      if (kt + 1 < n_kt) {
        rows_of(k, kt + 1, rk);
        rows_of(v, kt + 1, rv);
      }
      X nk, nv;
      me.load(nk, rk, d);
      me.load(nv, rv, d);
      tf32_acquire(bar(empty, 0, 0), kt, kS);
      me.put_rows(tile(st, 0), tile(st, 0) + L::kTile, xk);
      mbar_arrive(bar(full, st, 0));
      tf32_acquire(bar(empty, 0, 1), kt, kS);
      me.put_rows(tile(st, 1), tile(st, 1) + L::kTile, xv);
      mbar_arrive(bar(full, st, 1));
      tf32_acquire(bar(empty, 0, 2), kt, kS);
      me.put_cols(tile(st, 2), tile(st, 2) + L::kTile, xk);
      mbar_arrive(bar(full, st, 2));
      xk = nk;
      xv = nv;
    }
    return;
  }

  tf32_regs_consumer();
  // This thread's two q rows (index into sq): row0 and row0 + 8.
  const int row0 = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dmr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = (static_cast<size_t>(b) * sq + row) * hq + h;
    lse2[i] = row < sq ? lse[at] * kLog2e : 0.f;
    dmr[i] = row < sq ? dm[at] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  const bool lead = (threadIdx.x & 127) == 0;  // frees tiles for the warpgroup

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_own, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kS;
    const uint32_t par = (kt / kS) & 1;
    float s[16], s2[16], dp[16], dp2[16];
    mbar_wait(bar(full, st, 0), par);
    mbar_wait(bar(full, st, 1), par);
    wgmma_fence();
    tf32_ss_passes<true, true, kD>(s, s2, s_q, s_q + L::kOwnTile, tile(st, 0),
                                   tile(st, 0) + L::kTile);
    tf32_ss_passes<true, true, kD>(dp, dp2, s_do, s_do + L::kOwnTile, tile(st, 1),
                                   tile(st, 1) + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(s2);
    reg_fence(dp);
    reg_fence(dp2);
    if (lead) {
      mbar_arrive(bar(empty, st, 0));
      mbar_arrive(bar(empty, st, 1));
    }
    tf32_add_finite(s, s2);
    tf32_add_finite(dp, dp2);

    // dS in place of dP. Only a tile that crosses the causal diagonal or
    // a ragged end is masked element by element.
    const int k0 = kt * kTf32Keys;
    const int k_last = k0 + kTf32Keys - 1;
    const bool edge = q0 + kTf32Rows - 1 >= sq || k_last >= sk ||
                      (causal && kv_offset + k_last > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;  // row0 or row0 + 8
      // A NaN score gives P = 0, as the plain version's select on S.
      float p = exp2f(fmaf(fmaxf(s[i], -INFINITY), scale2, -lse2[r]));
      if (edge) {
        const int row = row0 + 8 * r;
        const bool ok = row < sq && visible(q_offset + row, k0 + walk_key(i, lane),
                                            sk, kv_offset, causal);
        p = ok ? p : 0.f;
      }
      dp[i] = p * (dp[i] - dmr[r]);
    }
    uint32_t dsh[4][4], dsl[4][4];
    tf32_frags<false>(dsh, dsl, dp);

    mbar_wait(bar(full, st, 2), par);
    wgmma_fence();
    tf32_rs_passes<true, kD>(acc, dsh, dsl, tile(st, 2), tile(st, 2) + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(dsh);
    reg_fence(dsl);
    if (lead) mbar_arrive(bar(empty, st, 2));
  }
  bwd_store<kD>(dq, acc, scale, b, sq, hq, h, row0, d, accumulate);
}

// Shared memory of flash_dkv_tf32_kernel, from a 1024-byte-aligned base:
// the block's K and V (64 keys, hi and lo: 128 KB at kD 128), then a ring
// of kSlots slots, each one streamed tile of 32 q rows (hi and lo, 32 KB
// at kD 128: three slots there, four at kD 64), then each slot's lse and
// dm of those rows (when it holds Q), then bar_own and a full and an
// empty barrier per slot. Step n (a q tile of one query head) takes Q
// into slot 2n % kSlots and dO into slot (2n + 1) % kSlots. A slot holds
// its tile first K-major (for S^T = K . Q^T and dP^T = V . dO^T), then,
// once those products have read it, transposed (for dK += dS^T . Q and
// dV += P^T . dO): its barriers complete twice a use, first at even and
// then at odd parity. Q, dO, Q^T and dO^T of one 32-row tile at once
// would take 128 KB, which does not fit beside K and V at kD 128.
template <int kD>
struct DkvTf32Layout {
  static constexpr int kOwnTile = kTf32Rows * kD * 4;  // K or V, hi or lo
  static constexpr int kTile = kTf32Keys * kD * 4;     // a slot's hi or lo
  static constexpr int kOwn = 4 * kOwnTile;
  static constexpr int kStats = 2 * kTf32Keys * 4;     // lse, dm of a slot
  static constexpr int kFit = (kMaxSmem - 1024 - kOwn - 8) / (2 * kTile + kStats + 16);
  static constexpr int kSlots = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem =
      1024 + kOwn + kSlots * (2 * kTile + kStats) + (1 + 2 * kSlots) * 8;
  static_assert(kSlots >= 2, "dk/dv: K, V and two slots exceed 227 KB");
};

// dk/dv's consumer holds dK and dV (kD fp32 a thread) beside S^T, dP^T and
// their cross terms: its converters drop to 128 registers, so it takes 248.
constexpr int kDkvConvRegs = 128;

// The walk of a dk/dv block, kept by each role on its own (nothing of it
// lives across the roles' register reallocation): for each of the g
// query heads of KV head kvh, the 32-row q tiles from qt0, the first
// whose last row can see the block's first key k0, to the last.
struct DkvWalk {
  int qt0, n_qt, h, qt;  // h, qt: the current step's head and q tile

  __device__ __forceinline__ DkvWalk(int k0, int kvh, int g, int sq,
                                     int q_offset, int kv_offset, int causal)
      : qt0(0), n_qt((sq + kTf32Keys - 1) / kTf32Keys), h(kvh * g) {
    if (causal) {
      const int need = kv_offset + k0 - q_offset - (kTf32Keys - 1);
      qt0 = need <= 0 ? 0 : min(n_qt, (need + kTf32Keys - 1) / kTf32Keys);
    }
    qt = qt0;
  }
  __device__ __forceinline__ int steps(int g) const { return g * (n_qt - qt0); }
  __device__ __forceinline__ int q0() const { return qt * kTf32Keys; }
  __device__ __forceinline__ void next() {
    if (++qt == n_qt) {
      qt = qt0;
      ++h;
    }
  }
};

// ---------------------------------------------------------------------
// dk/dv, float32 inputs. Grid (k tiles of kTf32Rows keys, hkv, b), the
// longest causal walks first. The consumer walks, for each of the g query
// heads of the group, the 32-row q tiles from the first one the mask lets
// see the block's keys, with keys as rows as in the Pallas kernel:
//   S^T = K . Q^T, dP^T = V . dO^T      SS m64n32k8, three passes each
//   P^T = exp(S^T - lse), dS^T = P^T * (dP^T - dm)   (lse, dm per column)
//   dV += P^T . dO, dK += dS^T . Q      RS m64nDk8 over dO^T and Q^T
// dK and dV stay in registers across every q tile of every head of the
// group, so the group sum happens in the fp32 accumulators.
// ---------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dm,
    float* __restrict__ dk,  // (b, sk, hkv, d)
    float* __restrict__ dv, int sq, int sk, int hq, int hkv, int d,
    int q_offset, int kv_offset, int causal, int accumulate, float scale) {
  using L = DkvTf32Layout<kD>;
  constexpr int kN = L::kSlots;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int k0 = blockIdx.x * kTf32Rows;
  const int warp = threadIdx.x >> 5;  // 0-3 the consumer, 4-11 the converters
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_k = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_v = s_k + 2 * L::kOwnTile;
  const uint32_t s_slot = s_k + L::kOwn;  // slot i: hi at + 2 kTile i, lo kTile on
  const uint32_t s_stats = s_slot + 2 * kN * L::kTile;  // slot i: lse, dm at + kStats i
  const uint32_t bar_own = s_stats + kN * L::kStats;
  const uint32_t full = bar_own + 8;  // slot i's at + 8 i
  const uint32_t empty = full + 8 * kN;
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (s_stats - smem_u32(smem_raw)));
  const auto slot = [&](int i) { return s_slot + 2 * i * L::kTile; };

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 256);
    for (int i = 0; i < kN; ++i) {
      mbar_init(full + 8 * i, 256);
      mbar_init(empty + 8 * i, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the converters
    tf32_regs_converter<kDkvConvRegs>();
    const int ct = threadIdx.x - 128;
    bwd_put_own<kD>(s_k, s_v, L::kOwnTile, bar_own, ct, k, v, b, sk, hkv, kvh,
                    k0, d);
    DkvWalk at(k0, kvh, g, sq, q_offset, kv_offset, causal);  // a step ahead
    const int n_steps = at.steps(g);
    if (n_steps <= 0) return;
    const BwdHalf<kD> me(ct);
    using X = typename BwdHalf<kD>::X;
    // Rows row(0), row(1) of the tile of Q or dO at the walk's step
    // (null past sq), and the lse (threads 0-31) or dm (32-63) of its row
    // ct % 32.
    const auto rows_of = [&](const float* (&rq)[2], const float* (&ro)[2]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = at.q0() + me.row(j);
        const size_t off = ((static_cast<size_t>(b) * sq + row) * hq + at.h) * d;
        rq[j] = row < sq ? q + off : nullptr;
        ro[j] = row < sq ? dout + off : nullptr;
      }
    };
    const auto stat_of = [&]() {
      const int row = at.q0() + (ct & 31);
      if (ct >= 64 || row >= sq) return 0.f;
      return (ct < 32 ? lse : dm)[(static_cast<size_t>(b) * sq + row) * hq + at.h];
    };
    // One step's Q and dO in registers, and one of the next step's: its Q
    // is loaded once this step's Q^T is written, its dO once dO^T is.
    X xq, xo;
    const float* rq[2];
    const float* ro[2];
    rows_of(rq, ro);
    me.load(xq, rq, d);
    me.load(xo, ro, d);
    float xs = stat_of();
    at.next();
    for (int n = 0; n < n_steps; ++n) {
      rq[0] = rq[1] = ro[0] = ro[1] = nullptr;
      if (n + 1 < n_steps) rows_of(rq, ro);
      const int iq = 2 * n, io = 2 * n + 1;
      const int sq_ = iq % kN, so = io % kN;
      // K-major: each slot's previous use must be done (its odd phase).
      if (iq >= kN) mbar_wait(empty + 8 * sq_, 1);
      me.put_rows(slot(sq_), slot(sq_) + L::kTile, xq);
      if (ct < 64)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_stats + sq_ * L::kStats +
                                                        4 * ct),
                     "f"(xs)
                     : "memory");
      mbar_arrive(full + 8 * sq_);
      if (io >= kN) mbar_wait(empty + 8 * so, 1);
      me.put_rows(slot(so), slot(so) + L::kTile, xo);
      mbar_arrive(full + 8 * so);
      // Transposed, once S^T and dP^T have read the K-major tiles.
      mbar_wait(empty + 8 * sq_, 0);
      me.put_cols(slot(sq_), slot(sq_) + L::kTile, xq);
      mbar_arrive(full + 8 * sq_);
      me.load(xq, rq, d);
      if (n + 1 < n_steps) xs = stat_of();
      mbar_wait(empty + 8 * so, 0);
      me.put_cols(slot(so), slot(so) + L::kTile, xo);
      mbar_arrive(full + 8 * so);
      me.load(xo, ro, d);
      at.next();
    }
    return;
  }

  tf32_regs_consumer<kDkvConvRegs>();
  // This thread's two keys (index into sk): key0 and key0 + 8.
  const int key0 = k0 + 16 * warp + (lane >> 2);
  const float scale2 = scale * kLog2e;
  // The plain versions' P = where(S * scale > MASK_VALUE / 2, exp(..), 0)
  // on every tile, as a bound on the raw score: a NaN score gives P = 0
  // even in a row whose lse is NaN (dV must stay finite there).
  const float s_min = kMaskValue * 0.5f / scale;
  const bool lead = (threadIdx.x & 127) == 0;  // frees slots for the warpgroup

  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  DkvWalk at(k0, kvh, g, sq, q_offset, kv_offset, causal);
  const int n_steps = at.steps(g);
  mbar_wait(bar_own, 0);
  for (int n = 0; n < n_steps; ++n, at.next()) {
    const int q0 = at.q0();
    const int sq_ = (2 * n) % kN, so = (2 * n + 1) % kN;
    const uint32_t qs = slot(sq_), os = slot(so);
    float s[16], s2[16], dp[16], dp2[16];
    mbar_wait(full + 8 * sq_, 0);
    mbar_wait(full + 8 * so, 0);
    wgmma_fence();
    tf32_ss_passes<true, true, kD>(s, s2, s_k, s_k + L::kOwnTile, qs, qs + L::kTile);
    tf32_ss_passes<true, true, kD>(dp, dp2, s_v, s_v + L::kOwnTile, os,
                                   os + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(s2);
    reg_fence(dp);
    reg_fence(dp2);
    if (lead) {
      mbar_arrive(empty + 8 * sq_);
      mbar_arrive(empty + 8 * so);
    }
    tf32_add_finite(s, s2);
    tf32_add_finite(dp, dp2);

    // P^T and dS^T, lse and dm per column, each column group split into
    // its k8 step of A fragments as soon as it is done.
    const float* lse_s = stats + sq_ * (L::kStats / 4);
    const float* dm_s = lse_s + kTf32Keys;
    const bool edge = q0 + kTf32Keys - 1 >= sq || k0 + kTf32Rows - 1 >= sk ||
                      (causal && kv_offset + k0 + kTf32Rows - 1 > q_offset + q0);
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 m2 = *reinterpret_cast<const float2*>(dm_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? l2.y : l2.x;
        const float m = (e & 1) ? m2.y : m2.x;
        float p = exp2f(fmaf(s[i], scale2, -l * kLog2e));
        if (!(s[i] > s_min)) p = 0.f;
        if (edge) {
          const int qr = q0 + c + (e & 1);
          const int key = key0 + 8 * (e >> 1);
          const bool ok = qr < sq && visible(q_offset + qr, key, sk, kv_offset,
                                             causal);
          p = ok ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - m);
      }
      tf32_frag_step<true>(ph[j], pl[j], s, j);
      tf32_frag_step<false>(dh[j], dl[j], dp, j);
    }

    mbar_wait(full + 8 * sq_, 1);
    mbar_wait(full + 8 * so, 1);
    wgmma_fence();
    tf32_rs_passes<true, kD>(dv_acc, ph, pl, os, os + L::kTile);
    tf32_rs_passes<true, kD>(dk_acc, dh, dl, qs, qs + L::kTile);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(ph);
    reg_fence(pl);
    reg_fence(dh);
    reg_fence(dl);
    if (lead) {
      mbar_arrive(empty + 8 * sq_);
      mbar_arrive(empty + 8 * so);
    }
  }
  bwd_store<kD>(dk, dk_acc, scale, b, sk, hkv, kvh, key0, d, accumulate);
  bwd_store<kD>(dv, dv_acc, 1.f, b, sk, hkv, kvh, key0, d, accumulate);
}

// The head dims a dtype's kernels take (kMaxHeadDim16, kMaxHeadDimF32),
// rows a whole number of 16 bytes.
bool head_dim_ok(int d, int dtype) {
  const bool f32 = dtype == kF32;
  return d > 0 && d * (f32 ? 4 : 2) % 16 == 0 &&
         d <= (f32 ? kMaxHeadDimF32 : kMaxHeadDim16);
}

bool shapes_ok(int b, int sq, int sk, int hq, int hkv, int d, int dtype) {
  return b > 0 && sq > 0 && sk > 0 && hkv > 0 && hq % hkv == 0 &&
         head_dim_ok(d, dtype) && b <= 65535 && hq <= 65535;
}

// A cluster the forward and dq take: 1, or 2, 4 or 8 blocks of query
// heads of one KV group (the size divides the group) on the kD 256
// 16-bit kernels (kernels/attention.py::gqa_cluster picks it).
bool gqa_cluster_ok(int cluster, int hq, int hkv, int d, int dtype) {
  if (cluster == 1) return true;
  return (cluster == 2 || cluster == 4 || cluster == 8) && dtype != kF32 &&
         d > 128 && (hq / hkv) % cluster == 0;
}

// The four maps of a backward launch: q and dO in boxes of `q_rows`
// rows, k and v in boxes of `k_rows`.
template <typename T>
cudaError_t bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                     const void* v, const void* dout, int b, int sq, int sk,
                     int hq, int hkv, int d, int q_rows, int k_rows) {
  cudaError_t err = bshd_map<T>(&m[0], q, b, sq, hq, d, q_rows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[1], k, b, sk, hkv, d, k_rows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[2], v, b, sk, hkv, d, k_rows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[3], dout, b, sq, hq, d, q_rows);
  return err;
}

// Launches `kernel` on `grid` with clusters of `cluster` blocks along
// the grid's head axis (y), after asking the card whether such a
// cluster fits at all (cudaOccupancyMaxActiveClusters): one that does
// not is refused with cudaErrorLaunchOutOfResources, never run without
// the cluster.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           size_t smem, int cluster, cudaStream_t stream,
                           Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fits < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// The largest cluster of 8, 4 or 2 blocks of `kernel` (a kD 256 forward
// or dq) the card can schedule at once, else 1.
template <typename... Params>
int max_cluster(void (*kernel)(Params...), int threads, size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return 1;
  for (int c = 8; c > 1; c /= 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = c;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, c, 1);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int fits = 0;
    if (cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg) != cudaSuccess)
      cudaGetLastError();  // a refused query leaves no error behind
    else if (fits >= 1)
      return c;
  }
  return 1;
}

template <typename T, bool kAcc>
int launch_dq_gqa(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dm, void* dq,
                  int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
                  int kv_offset, int causal, float scale, int cluster,
                  cudaStream_t stream) {
  using L = DqGqa;
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, L::kRows, kBwdStep);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_dq_gqa_kernel<T, kAcc>;
  err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + L::kRows - 1) / L::kRows, hq, b);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dm_f = static_cast<const float*>(dm);
  Out<T, kAcc>* out = static_cast<Out<T, kAcc>*>(dq);
  if (cluster > 1)
    return static_cast<int>(launch_cluster(
        kernel, grid, L::kThreads, L::kSmem, cluster, stream, m[0], m[1], m[2],
        m[3], lse_f, dm_f, out, sq, sk, hq, hkv, d, q_offset, kv_offset,
        causal, scale, cluster));
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], lse_f, dm_f, out, sq, sk, hq, hkv, d, q_offset,
      kv_offset, causal, scale, 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD, bool kAcc>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dm, void* dq,
                    int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
                    int kv_offset, int causal, float scale, cudaStream_t stream) {
  using S = BwdShape<kD>;
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, S::kRows, kBwdStep);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_dq_wgmma_kernel<T, kD, kAcc>;
  err = allow_smem(kernel, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + S::kRows - 1) / S::kRows, hq, b), S::kThreads, S::kSmem,
           stream>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                     static_cast<const float*>(dm),
                     static_cast<Out<T, kAcc>*>(dq), sq, sk, hq, hkv, d,
                     q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD, bool kAcc>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dm,
                     void* dk, void* dv, void* part, int n_split, int b, int sq,
                     int sk, int hq, int hkv, int d, int q_offset,
                     int kv_offset, int causal, float scale,
                     cudaStream_t stream) {
  using S = BwdShape<kD>;
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, kBwdStep, S::kRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  // kD 256: two warpgroups over 64 keys; else BwdShape's block.
  auto kernel = [] {
    if constexpr (kD == 256) {
      return flash_dkv_wg2_kernel<T, kAcc>;
    } else {
      return flash_dkv_wgmma_kernel<T, kD, kAcc>;
    }
  }();
  constexpr size_t kSmem = kD == 256 ? Dkv256::kSmem : S::kSmem;
  constexpr int kThreads = kD == 256 ? Dkv256::kThreads : S::kThreads;
  err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sk + S::kRows - 1) / S::kRows, hkv, b * n_split), kThreads,
           kSmem, stream>>>(m[0], m[1], m[2], m[3],
                            static_cast<const float*>(lse),
                            static_cast<const float*>(dm),
                            static_cast<Out<T, kAcc>*>(dk),
                            static_cast<Out<T, kAcc>*>(dv),
                            static_cast<float*>(part), n_split, sq, sk, hq,
                            hkv, d, q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAcc>
int launch_dkv_sum(const void* part, void* dk, void* dv, int n_split, size_t n,
                   cudaStream_t stream) {
  // A float4 of dk or dv a thread.
  const int blocks =
      static_cast<int>((2 * (n / 4) + kSumThreads - 1) / kSumThreads);
  flash_dkv_sum_kernel<T, kAcc><<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<Out<T, kAcc>*>(dk),
      static_cast<Out<T, kAcc>*>(dv), n_split, n);
  return static_cast<int>(cudaGetLastError());
}

// `cluster` (1 below kD 256): blocks of one q tile sharing the K/V
// stream (gqa_cluster_ok).
template <typename T, int kD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, float scale,
                     int cluster, cudaStream_t stream) {
  using S = FwdShape<kD>;
  CUtensorMap m[3];
  cudaError_t err = bshd_map<T>(&m[0], q, b, sq, hq, d, S::kRows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[1], k, b, sk, hkv, d, kWalkKeys);
  if (err == cudaSuccess) err = bshd_map<T>(&m[2], v, b, sk, hkv, d, kWalkKeys);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_fwd_wgmma_kernel<T, kD>;
  err = allow_smem(kernel, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + S::kRows - 1) / S::kRows, hq, b);
  T* o = static_cast<T*>(out);
  float* l = static_cast<float*>(lse);
  if constexpr (kD == 256) {
    if (cluster > 1)
      return static_cast<int>(launch_cluster(
          kernel, grid, S::kThreads, S::kSmem, cluster, stream, m[0], m[1],
          m[2], o, l, sq, sk, hq, hkv, d, q_offset, kv_offset, causal, scale,
          cluster));
  }
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      m[0], m[1], m[2], o, l, sq, sk, hq, hkv, d, q_offset, kv_offset, causal,
      scale, 1);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* out,
                    void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                    int q_offset, int kv_offset, int causal, float scale,
                    cudaStream_t stream) {
  using L = Tf32Layout<float, float, kD>;
  auto kernel = flash_fwd_tf32_kernel<kD>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kTf32Rows - 1) / kTf32Rows, hq, b), kTf32Threads, L::kSmem,
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     static_cast<float*>(lse), sq, sk, hq, hkv, d, q_offset,
                     kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dm, void* dq, int b, int sq,
                   int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                   int causal, int accumulate, float scale, cudaStream_t stream) {
  using L = DqTf32Layout<kD>;
  auto kernel = flash_dq_tf32_kernel<kD>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kTf32Rows - 1) / kTf32Rows, hq, b), kTf32Threads, L::kSmem,
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(dout),
                     static_cast<const float*>(lse), static_cast<const float*>(dm),
                     static_cast<float*>(dq), sq, sk, hq, hkv, d, q_offset,
                     kv_offset, causal, accumulate, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dm, void* dk, void* dv, int b,
                    int sq, int sk, int hq, int hkv, int d, int q_offset,
                    int kv_offset, int causal, int accumulate, float scale,
                    cudaStream_t stream) {
  using L = DkvTf32Layout<kD>;
  auto kernel = flash_dkv_tf32_kernel<kD>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sk + kTf32Rows - 1) / kTf32Rows, hkv, b), kTf32Threads, L::kSmem,
           stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(dout),
                     static_cast<const float*>(lse), static_cast<const float*>(dm),
                     static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, hq,
                     hkv, d, q_offset, kv_offset, causal, accumulate, scale);
  return static_cast<int>(cudaGetLastError());
}

// 16-bit inputs take the wgmma kernels at kD 64, 128 or 256, float32
// inputs the TF32 ones at kD 64 or 128 (by_head_dim). `accumulate` adds
// the backward's result into fp32 buffers instead of writing it in the
// input dtype.
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
               int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, float scale, int cluster,
               cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return by_head_dim<kMaxHeadDim16>(d, [&](auto kd) {
      return launch_fwd_wgmma<T, decltype(kd)::value>(
          q, k, v, out, lse, b, sq, sk, hq, hkv, d, q_offset, kv_offset, causal,
          scale, cluster, stream);
    });
  } else {
    return by_head_dim<kMaxHeadDimF32>(d, [&](auto kd) {
      return launch_fwd_tf32<decltype(kd)::value>(
          q, k, v, out, lse, b, sq, sk, hq, hkv, d, q_offset, kv_offset, causal,
          scale, stream);
    });
  }
}

// kD 256 takes flash_dq_gqa_kernel (its cluster: gqa_cluster_ok), the
// others flash_dq_wgmma_kernel.
template <typename T, bool kAcc>
int launch_dq_16(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dm, void* dq, int b, int sq,
                 int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                 int causal, float scale, int cluster, cudaStream_t stream) {
  return by_head_dim<kMaxHeadDim16>(d, [&](auto kd) {
    if constexpr (decltype(kd)::value == 256) {
      return launch_dq_gqa<T, kAcc>(q, k, v, dout, lse, dm, dq, b, sq, sk, hq,
                                    hkv, d, q_offset, kv_offset, causal, scale,
                                    cluster, stream);
    } else {
      return launch_dq_wgmma<T, decltype(kd)::value, kAcc>(
          q, k, v, dout, lse, dm, dq, b, sq, sk, hq, hkv, d, q_offset,
          kv_offset, causal, scale, stream);
    }
  });
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dm, void* dq, int b, int sq, int sk,
              int hq, int hkv, int d, int q_offset, int kv_offset, int causal,
              int accumulate, float scale, int cluster, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return accumulate
               ? launch_dq_16<T, true>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                       hq, hkv, d, q_offset, kv_offset, causal,
                                       scale, cluster, stream)
               : launch_dq_16<T, false>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                        hq, hkv, d, q_offset, kv_offset, causal,
                                        scale, cluster, stream);
  } else {
    return by_head_dim<kMaxHeadDimF32>(d, [&](auto kd) {
      return launch_dq_tf32<decltype(kd)::value>(
          q, k, v, dout, lse, dm, dq, b, sq, sk, hq, hkv, d, q_offset, kv_offset,
          causal, accumulate, scale, stream);
    });
  }
}

template <typename T, bool kAcc>
int launch_dkv_16(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dm, void* dk,
                  void* dv, void* part, int n_split, int b, int sq, int sk,
                  int hq, int hkv, int d, int q_offset, int kv_offset,
                  int causal, float scale, cudaStream_t stream) {
  return by_head_dim<kMaxHeadDim16>(d, [&](auto kd) {
    return launch_dkv_wgmma<T, decltype(kd)::value, kAcc>(
        q, k, v, dout, lse, dm, dk, dv, part, n_split, b, sq, sk, hq, hkv, d,
        q_offset, kv_offset, causal, scale, stream);
  });
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dm, void* dk, void* dv, void* part,
               int n_split, int b, int sq, int sk, int hq, int hkv, int d,
               int q_offset, int kv_offset, int causal, int accumulate,
               float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return accumulate
               ? launch_dkv_16<T, true>(q, k, v, dout, lse, dm, dk, dv, part,
                                        n_split, b, sq, sk, hq, hkv, d,
                                        q_offset, kv_offset, causal, scale,
                                        stream)
               : launch_dkv_16<T, false>(q, k, v, dout, lse, dm, dk, dv, part,
                                         n_split, b, sq, sk, hq, hkv, d,
                                         q_offset, kv_offset, causal, scale,
                                         stream);
  } else {
    return by_head_dim<kMaxHeadDimF32>(d, [&](auto kd) {
      return launch_dkv_tf32<decltype(kd)::value>(
          q, k, v, dout, lse, dm, dk, dv, b, sq, sk, hq, hkv, d, q_offset,
          kv_offset, causal, accumulate, scale, stream);
    });
  }
}

#define TPUHPC_FLASH_DISPATCH(CODE, BODY)                    \
  switch (CODE) {                                            \
    case kF32: { using T = float; BODY; }                    \
    case kF16: { using T = __half; BODY; }                   \
    case kBF16: { using T = __nv_bfloat16; BODY; }           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" {

// The forward and dq entries' `cluster`: the blocks of one q tile whose
// query heads share a KV head that run as one cluster, sharing each K/V
// tile (gqa_cluster_ok; 1 for none). A cluster the card cannot schedule
// is refused (cudaErrorLaunchOutOfResources), never run without it.
int tpuhpc_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, int cluster,
                     float scale, int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d, dtype) ||
      !gqa_cluster_ok(cluster, hq, hkv, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_fwd<T>(q, k, v, out, lse, b, sq, sk, hq, hkv,
                                             d, q_offset, kv_offset, causal, scale,
                                             cluster,
                                             static_cast<cudaStream_t>(stream)))
}

// The backward entries' `accumulate`: 1 adds the result into fp32
// buffers, 0 writes it in the input dtype.
int tpuhpc_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dm, void* dq, int b, int sq,
                    int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                    int causal, int accumulate, int cluster, float scale,
                    int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d, dtype) ||
      !gqa_cluster_ok(cluster, hq, hkv, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dq<T>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                            hq, hkv, d, q_offset, kv_offset, causal,
                                            accumulate, scale, cluster,
                                            static_cast<cudaStream_t>(stream)))
}

// The largest cluster (8, 4, 2, else 1) of the kD 256 `kernel` (0 the
// forward, 1 dq) in 16-bit `dtype` the card can schedule at once;
// kernels/attention.py::max_gqa_cluster reads it, gqa_cluster caps its
// pick by it. 0 for an unknown kernel or dtype.
int tpuhpc_flash_max_cluster(int kernel, int dtype) {
  if ((kernel != 0 && kernel != 1) || (dtype != kF16 && dtype != kBF16))
    return 0;
  if (kernel == 0) {
    using S = FwdShape<256>;
    return dtype == kF16
               ? max_cluster(flash_fwd_wgmma_kernel<__half, 256>, S::kThreads,
                             S::kSmem)
               : max_cluster(flash_fwd_wgmma_kernel<__nv_bfloat16, 256>,
                             S::kThreads, S::kSmem);
  }
  return dtype == kF16
             ? max_cluster(flash_dq_gqa_kernel<__half, false>, DqGqa::kThreads,
                           DqGqa::kSmem)
             : max_cluster(flash_dq_gqa_kernel<__nv_bfloat16, false>,
                           DqGqa::kThreads, DqGqa::kSmem);
}

// n_split: blocks a key tile's query-head group is split over (1, or a
// divisor of the group with a 16-bit dtype; the wrapper's dkv_splits),
// each writing its fp32 partials into part, [n_split][2][b][sk][hkv][d]
// (null when n_split is 1); tpuhpc_flash_dkv_sum then adds them into dk
// and dv.
int tpuhpc_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dm, void* dk,
                     void* dv, void* part, int b, int sq, int sk, int hq,
                     int hkv, int d, int q_offset, int kv_offset, int causal,
                     int accumulate, int n_split, float scale, int dtype,
                     void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d, dtype) || n_split < 1 ||
      (hq / hkv) % n_split != 0 ||
      (n_split > 1 && (part == nullptr || dtype == kF32 ||
                       static_cast<long long>(b) * n_split > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dkv<T>(q, k, v, dout, lse, dm, dk, dv, part,
                                             n_split, b, sq, sk, hq, hkv, d,
                                             q_offset, kv_offset, causal,
                                             accumulate, scale,
                                             static_cast<cudaStream_t>(stream)))
}

// dk = sum of part[s][0], dv = sum of part[s][1] over s < n_split, in
// order, n elements each (a multiple of 4): written in dtype (f16 or
// bf16), or with accumulate added into fp32 buffers (dtype unread).
int tpuhpc_flash_dkv_sum(const void* part, void* dk, void* dv, int n_split,
                         long long n, int accumulate, int dtype, void* stream) {
  if (n_split < 1 || n < 4 || n % 4 != 0 ||
      (!accumulate && dtype != kF16 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t un = static_cast<size_t>(n);
  if (accumulate)  // fp32 out: the element type plays no part
    return launch_dkv_sum<__nv_bfloat16, true>(part, dk, dv, n_split, un, s);
  return dtype == kF16
             ? launch_dkv_sum<__half, false>(part, dk, dv, n_split, un, s)
             : launch_dkv_sum<__nv_bfloat16, false>(part, dk, dv, n_split, un, s);
}

// Rows a block of `kernel` (0 forward, 1 dq, 2 dk/dv) owns for a dtype
// code at head dim d -- q rows for the forward and dq, keys for dk/dv --
// or 0 for an unknown code or a head dim the kernels do not take (one a
// whole number of 16 bytes: the wrapper's padded width);
// kernels/attention.py::flash_tile_rows reads it.
int tpuhpc_flash_tile_rows(int kernel, int dtype, int d) {
  if (kernel < 0 || kernel > 2 || dtype < kF32 || dtype > kBF16 ||
      !head_dim_ok(d, dtype))
    return 0;
  if (dtype == kF32) return kTf32Rows;
  return by_head_dim<kMaxHeadDim16>(d, [&](auto kd) {
    constexpr int kD = decltype(kd)::value;
    return kernel == 0 ? FwdShape<kD>::kRows : BwdShape<kD>::kRows;
  });
}

}  // extern "C"
