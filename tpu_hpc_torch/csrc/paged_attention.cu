// Paged attention over the serving engine's KV pool, for Hopper (sm_90a).
//
// Kernels replacing the two Pallas kernels of the JAX package's
// tpu_hpc/kernels/paged_attention.py:
//
//   paged_decode_kernel          replaces _decode_kernel (launched by
//                                paged_decode_attention).
//   paged_prefill_wgmma_kernel   replace _prefill_kernel (launched by
//   paged_prefill_kernel         paged_prefill_attention): the first for
//                                16-bit q and pool of one dtype, the
//                                second for every other pair (float32,
//                                int8 pools, mixed dtypes) and page
//                                sizes outside the first one's rule
//                                (prefill_route below).
//
// They compute what the Pallas kernels compute -- online softmax in
// fp32 with the MASK_VALUE / m_safe / l_safe rules, the causal limit
// taken from data (pos per slot, start per chunk), inactive slots
// written as zeros, optional int8 pages dequantized with one f32 scale
// per page -- but are laid out for the card, not carried over block by
// block. (The wgmma prefill rounds P to the pool's dtype before P . V,
// as the Pallas kernel does; the scalar kernels keep P in fp32, which
// is the Pallas kernel's arithmetic for float32 and int8 pools, and
// differs from it only by that rounding for a 16-bit pool under a q of
// another dtype.)
//
//   * the TPU grid's sequential page axis becomes a loop inside one
//     thread block;
//   * scalar prefetch becomes each block reading its own table row,
//     pos and active flag;
//   * a block issues no read of a page past its causal limit, of a
//     dead table entry, or (decode) of anything at all for an inactive
//     slot. The Pallas kernels redirect those reads to scratch page 0;
//     these kernels simply do not make them.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16):
//
//   decode   bytes. Each live KV page is read once per (slot, kv_head)
//            block and a query row does 4*d FLOPs per key, so the work
//            is ~1 FLOP per byte of KV -- far below the card's ~295
//            FLOP/byte ridge. The bound is the live KV bytes over the
//            memory rate.
//   prefill  at the main path's shapes (Llama-2-7B: 32 heads, d 128, a
//            256-token chunk over up to 512 keys) the causal FLOPs
//            (~1.6 GFLOP) and the bytes (~10 MB) give bounds of
//            ~1.6 us and ~3 us: bytes again, by a small margin.
//
// The 16-bit prefill is built for the tensor cores and the copy engine:
// one block per (KV head, 64 grouped q rows), whose Q tile arrives by
// TMA and whose 64-key K and V tiles are assembled from one TMA box per
// page into a ring that a producer warp keeps ahead of the consumer
// warpgroup; scores, probabilities and the output accumulate in
// registers through the online-softmax walk the training forward uses
// (hopper.cuh). The decode kernel and the other prefill routes keep the
// first, simple design: scalar fp32 FMAs over shared memory, K/V pages
// staged with plain loads, four barriers per page, and (decode) one
// block per (slot, kv_head) with no split over pages, so a long context
// is walked by one SM. PERF.md carries the measured times against the
// bounds.
//
// Plain C interface, loaded with ctypes by
// tpu_hpc_torch/kernels/_build.py. Every entry point launches on the
// stream it is given, allocates nothing, and returns
// cudaGetLastError() so the caller raises on a refused launch.

#include "hopper.cuh"

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// One online-softmax step for row r over the bs scores in s[0:bs]:
// scores become probabilities in place; m, l and the rescale factor
// alpha are updated as in the Pallas kernels (m_safe keeps a fully
// masked row at exp(.) = 0 instead of exp(0) = 1).
__device__ __forceinline__ void softmax_step(float* s, int bs, float* m,
                                             float* l, float* alpha) {
  const float m_prev = *m;
  float mx = m_prev;
  for (int t = 0; t < bs; ++t) mx = fmaxf(mx, s[t]);
  const float m_safe = (mx <= kMaskValue * 0.5f) ? 0.f : mx;
  float sum = 0.f;
  for (int t = 0; t < bs; ++t) {
    const float p = (s[t] > kMaskValue * 0.5f) ? expf(s[t] - m_safe) : 0.f;
    s[t] = p;
    sum += p;
  }
  const float a = expf(m_prev - m_safe);
  *l = a * (*l) + sum;
  *alpha = a;
  *m = mx;
}

// ---------------------------------------------------------------------
// Decode: one query token per slot. Grid (slots, kv_heads); the block
// holds the slot's g grouped query rows and walks pages 0 .. pos // bs.
// ---------------------------------------------------------------------
template <typename QT, typename KT>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const QT* __restrict__ q,          // (slots, hkv, g, d)
    const KT* __restrict__ k_pages,    // (num_blocks, bs, hkv, d)
    const KT* __restrict__ v_pages,
    const int* __restrict__ tables,    // (slots, table_width)
    const int* __restrict__ pos,       // (slots,)
    const int* __restrict__ active,    // (slots,)
    const float* __restrict__ k_scale,  // (num_blocks,) or null
    const float* __restrict__ v_scale,
    QT* __restrict__ out,              // (slots, hkv, g, d)
    int hkv, int g, int d, int bs, int table_width, int max_blocks,
    float sm_scale) {
  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kDecodeThreads / 32;
  const int gd = g * d;
  const size_t qoff = (static_cast<size_t>(slot) * hkv + h) * gd;

  if (active[slot] == 0) {  // no page is read for an inactive slot
    for (int i = tid; i < gd; i += kDecodeThreads) out[qoff + i] = from_f<QT>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;               // [g][d]
  float* acc = qs + gd;           // [g][d]
  float* sc = acc + gd;           // [g][bs]
  float* m = sc + g * bs;         // [g]
  float* l = m + g;               // [g]
  float* alpha = l + g;           // [g]

  for (int i = tid; i < gd; i += kDecodeThreads) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < g; r += kDecodeThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }
  __syncthreads();

  const int p_pos = pos[slot];
  const int n_pages = min(p_pos / bs + 1, max_blocks);
  const int* trow = tables + static_cast<size_t>(slot) * table_width;
  const size_t tok_stride = static_cast<size_t>(hkv) * d;
  const size_t page_stride = static_cast<size_t>(bs) * tok_stride;

  for (int j = 0; j < n_pages; ++j) {
    const int page = trow[j];
    const float ksc = k_scale != nullptr ? k_scale[page] : 1.f;
    const float vsc = v_scale != nullptr ? v_scale[page] : 1.f;
    const KT* kp = k_pages + page * page_stride + static_cast<size_t>(h) * d;
    const KT* vp = v_pages + page * page_stride + static_cast<size_t>(h) * d;
    // Keys past pos in the last page are masked and never loaded.
    const int n_valid = min(bs, p_pos - j * bs + 1);

    // Scores: one warp per (row, key) pair, lanes split head_dim.
    for (int pair = warp; pair < g * bs; pair += kWarps) {
      const int r = pair / bs;
      const int t = pair - r * bs;
      float s = kMaskValue;
      if (t < n_valid) {
        const KT* krow = kp + t * tok_stride;
        const float* qrow = qs + r * d;
        float part = 0.f;
        for (int x = lane; x < d; x += 32) part += qrow[x] * (to_f(krow[x]) * ksc);
        s = warp_sum(part) * sm_scale;
      }
      if (lane == 0) sc[pair] = s;
    }
    __syncthreads();
    for (int r = tid; r < g; r += kDecodeThreads)
      softmax_step(sc + r * bs, bs, m + r, l + r, alpha + r);
    __syncthreads();
    // acc = alpha * acc + P . V, one (row, column) element per thread.
    for (int i = tid; i < gd; i += kDecodeThreads) {
      const int r = i / d;
      const int x = i - r * d;
      const float* p = sc + r * bs;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < n_valid; ++t) a += p[t] * (to_f(vp[t * tok_stride + x]) * vsc);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < gd; i += kDecodeThreads) {
    const float lr = l[i / d];
    out[qoff + i] = from_f<QT>(acc[i] / (lr == 0.f ? 1.f : lr));
  }
}

// ---------------------------------------------------------------------
// Chunked prefill, every pair of dtypes the wgmma route below does not
// take: grid (kv_heads, row tiles). Grouped query row r of head h sits
// at position start + r / g; a block owns tq consecutive rows and walks
// the pages up to its last row's causal limit. Shared-memory rows are
// padded to d + 1 floats so the per-key dot products hit distinct banks.
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
    int tq, float sm_scale) {
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_rows_total = bucket * g;
  const int row0 = blockIdx.y * tq;
  const int nrows = min(tq, n_rows_total - row0);
  const int dp = d + 1;

  extern __shared__ float smem[];
  float* qs = smem;                 // [tq][dp]
  float* acc = qs + tq * dp;        // [tq][dp]
  float* kt = acc + tq * dp;        // [bs][dp]
  float* vt = kt + bs * dp;         // [bs][dp]
  float* sc = vt + bs * dp;         // [tq][bs]
  float* m = sc + tq * bs;          // [tq]
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
    const KT* kp = k_pages + page * page_stride + static_cast<size_t>(h) * d;
    const KT* vp = v_pages + page * page_stride + static_cast<size_t>(h) * d;
    __syncthreads();  // the previous page's tiles are no longer read
    for (int i = tid; i < bs * d; i += kPrefillThreads) {
      const int t = i / d;
      const int x = i - t * d;
      kt[t * dp + x] = to_f(kp[t * tok_stride + x]) * ksc;
      vt[t * dp + x] = to_f(vp[t * tok_stride + x]) * vsc;
    }
    __syncthreads();
    for (int i = tid; i < nrows * bs; i += kPrefillThreads) {
      const int r = i / bs;
      const int t = i - r * bs;
      const int qpos = start + (row0 + r) / g;
      float s = kMaskValue;
      if (j * bs + t <= qpos) {
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
      softmax_step(sc + r * bs, bs, m + r, l + r, alpha + r);
    __syncthreads();
    for (int i = tid; i < nrows * d; i += kPrefillThreads) {
      const int r = i / d;
      const int x = i - r * d;
      const float* p = sc + r * bs;
      float a = acc[r * dp + x] * alpha[r];
      for (int t = 0; t < bs; ++t) a += p[t] * vt[t * dp + x];
      acc[r * dp + x] = a;
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
// Chunked prefill, 16-bit q and pool of one dtype (prefill_route). Grid
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
  __device__ __forceinline__ bool edge(int kt) const {
    const int k_last = kt * kWalkKeys + kWalkKeys - 1;
    return k_last > first || k_last >= n_keys;
  }
  __device__ __forceinline__ bool sees(int r, int key) const {
    return key <= qpos[r] && key < n_keys;
  }
};

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
      mbar_expect_tx(bar_q, kQ);
      tma_tile<kD>(s_q, &tm_q, bar_q, 0, row0, h, kPrefillRows);
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
        const uint32_t bytes = n_live * box * kD * 2;
        const int t0 = bs > kWalkKeys ? kt * kWalkKeys % bs : 0;
        mbar_expect_tx(ring.full_k + 8 * st, bytes);
        for (int i = 0; i < n_live; ++i)
          tma_tile<kD>(k_tile + i * box * kPanelRowBytes, &tm_k,
                       ring.full_k + 8 * st, h, t0, table[first_page + i],
                       kWalkKeys);
        mbar_expect_tx(ring.full_v + 8 * st, bytes);
        for (int i = 0; i < n_live; ++i)
          tma_tile<kD>(v_tile + i * box * kPanelRowBytes, &tm_v,
                       ring.full_v + 8 * st, h, t0, table[first_page + i],
                       kWalkKeys);
      }
    }
    return;
  }

  // This thread's two grouped rows: r0 and r0 + 8.
  const int r0 = row0 + 16 * warp + (lane >> 2);
  const PrefillMask mask{{start + r0 / g, start + (r0 + 8) / g},
                         start + row0 / g, n_keys};
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
  walk_finish<T, kD>(rows, row_ptr, d, row_lse);
}

size_t decode_smem_bytes(int g, int d, int bs) {
  return sizeof(float) * (2 * static_cast<size_t>(g) * d + g * bs + 3 * g);
}

size_t prefill_smem_bytes(int tq, int d, int bs) {
  const size_t dp = d + 1;
  return sizeof(float) *
         (2 * tq * dp + 2 * bs * dp + static_cast<size_t>(tq) * bs + 3 * tq);
}

// Which prefill kernel takes a launch: the wgmma kernel for 16-bit q and
// pool of one dtype, d a multiple of 16 up to 128, and pages that stack
// into 64-key tiles on 8-row boundaries (bs 8, 16, 32 or 64) or split
// into them (bs a multiple of 64); paged_prefill_kernel for every other
// launch (float32, int8 pools dequantized in f32, mixed dtypes, other
// page sizes).
enum PrefillRoute { kRouteScalar = 0, kRouteWgmma = 1 };

int prefill_route(int q_dtype, int kv_dtype, int d, int bs) {
  const bool same16 = q_dtype == kv_dtype && (q_dtype == kF16 || q_dtype == kBF16);
  const bool pages = (bs >= 8 && kWalkKeys % bs == 0) || (bs > 0 && bs % kWalkKeys == 0);
  return same16 && pages && d >= 16 && d % 16 == 0 && d <= 128 ? kRouteWgmma
                                                               : kRouteScalar;
}

// Rows per prefill block. The wgmma route: kPrefillRows. The scalar
// route: 64, halved while the grid would leave SMs of the 132 idle or
// the tile would not fit shared memory.
int prefill_tile_rows(int hkv, int bucket, int g, int d, int bs, int route) {
  if (route == kRouteWgmma) return kPrefillRows;
  const int n_rows = bucket * g;
  int tq = 64;
  while (tq > 16 && hkv * ((n_rows + tq - 1) / tq) < 132) tq >>= 1;
  while (tq > 1 && prefill_smem_bytes(tq, d, bs) > static_cast<size_t>(kMaxSmem)) tq >>= 1;
  return tq;
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const void* tables, const void* pos, const void* active,
                  const void* k_scale, const void* v_scale, void* out, int slots,
                  int hkv, int g, int d, int bs, int table_width, int max_blocks,
                  float sm_scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(g, d, bs);
  auto kernel = paged_decode_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(slots, hkv), kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<const int*>(active),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), hkv, g, d, bs, table_width, max_blocks, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_prefill_wgmma(const void* q, const void* k_pages, const void* v_pages,
                         const void* table, void* out, int hkv, int bucket, int g,
                         int d, int bs, int max_blocks, int start, float sm_scale,
                         cudaStream_t stream) {
  CUtensorMap m[3];
  const int box = bs < kWalkKeys ? bs : kWalkKeys;
  cudaError_t err = bshd_map<T>(&m[0], q, hkv, bucket * g, 1, d, kPrefillRows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[1], k_pages, kPoolPages, bs, hkv, d, box);
  if (err == cudaSuccess) err = bshd_map<T>(&m[2], v_pages, kPoolPages, bs, hkv, d, box);
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

template <typename QT, typename KT>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* table, const void* k_scale, const void* v_scale,
                   void* out, int hkv, int bucket, int g, int d, int bs,
                   int max_blocks, int start, float sm_scale, int route,
                   cudaStream_t stream) {
  if constexpr (std::is_same<QT, KT>::value && sizeof(QT) == 2) {
    if (route == kRouteWgmma)
      return d <= 64 ? launch_prefill_wgmma<QT, 64>(q, k_pages, v_pages, table,
                                                    out, hkv, bucket, g, d, bs,
                                                    max_blocks, start, sm_scale,
                                                    stream)
                     : launch_prefill_wgmma<QT, 128>(q, k_pages, v_pages, table,
                                                     out, hkv, bucket, g, d, bs,
                                                     max_blocks, start, sm_scale,
                                                     stream);
  }
  const int tq = prefill_tile_rows(hkv, bucket, g, d, bs, kRouteScalar);
  const size_t smem = prefill_smem_bytes(tq, d, bs);
  auto kernel = paged_prefill_kernel<QT, KT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bucket * g + tq - 1) / tq;
  kernel<<<dim3(hkv, tiles), kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int*>(table),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<QT*>(out), hkv, bucket, g, d, bs, max_blocks, start, tq,
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

int tpuhpc_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                        const void* tables, const void* pos, const void* active,
                        const void* k_scale, const void* v_scale, void* out,
                        int slots, int hkv, int g, int d, int bs, int table_width,
                        int max_blocks, float sm_scale, int q_dtype, int kv_dtype,
                        void* stream) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_DISPATCH(q_dtype, kv_dtype,
                  return (launch_decode<QT, KT>(
                      q, k_pages, v_pages, tables, pos, active, k_scale,
                      v_scale, out, slots, hkv, g, d, bs, table_width,
                      max_blocks, sm_scale, static_cast<cudaStream_t>(stream))))
}

int tpuhpc_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                         const void* table, const void* k_scale,
                         const void* v_scale, void* out, int hkv, int bucket,
                         int g, int d, int bs, int max_blocks, int start,
                         float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int route = prefill_route(q_dtype, kv_dtype, d, bs);
  TPUHPC_DISPATCH(q_dtype, kv_dtype,
                  return (launch_prefill<QT, KT>(
                      q, k_pages, v_pages, table, k_scale, v_scale, out, hkv,
                      bucket, g, d, bs, max_blocks, start, sm_scale, route,
                      static_cast<cudaStream_t>(stream))))
}

// The route a prefill launch takes (1 the wgmma kernel, 0 the scalar
// one; -1 for a dtype code no kernel takes) and the rows of a block on
// that route: chip_smoke.py reports both beside the kernel's time.
int tpuhpc_prefill_route(int d, int bs, int q_dtype, int kv_dtype) {
  if (q_dtype < 0 || q_dtype > kBF16 || kv_dtype < 0 || kv_dtype > kI8) return -1;
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
