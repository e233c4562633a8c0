// Paged attention over the serving engine's KV pool, for Hopper (sm_90a).
//
// Two kernels, each replacing one Pallas kernel of the JAX package:
//
//   paged_decode_kernel   replaces tpu_hpc/kernels/paged_attention.py
//                         ::_decode_kernel (launched by
//                         paged_decode_attention).
//   paged_prefill_kernel  replaces tpu_hpc/kernels/paged_attention.py
//                         ::_prefill_kernel (launched by
//                         paged_prefill_attention).
//
// They compute what the Pallas kernels compute -- online softmax in
// fp32 with the MASK_VALUE / m_safe / l_safe rules, the causal limit
// taken from data (pos per slot, start per chunk), inactive slots
// written as zeros, optional int8 pages dequantized with one f32 scale
// per page -- but are laid out for the card, not carried over block by
// block:
//
//   * the TPU grid's sequential page axis becomes a loop inside one
//     thread block, with the online-softmax state in shared memory;
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
// What this simple design leaves for later: the dot products and the
// P.V update are scalar fp32 FMAs over shared memory (no mma.sync, no
// wgmma), K/V pages are staged with plain loads (no cp.async or TMA
// pipeline), and decode runs one block per (slot, kv_head) with no
// split over pages (flash-decoding), so a long context is walked by
// one SM. Each of these is a later PR's work; PERF.md carries the
// measured times against the bounds.
//
// Plain C interface, loaded with ctypes by
// tpu_hpc_torch/kernels/_build.py. Every entry point launches on the
// stream it is given, allocates nothing, and returns
// cudaGetLastError() so the caller raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernels/attention.py MASK_VALUE: finite, so a fully masked row keeps
// m = MASK_VALUE and the m_safe rule below zeroes its probabilities.
constexpr float kMaskValue = -1e30f;

// dtype codes shared with kernels/attention.py::DTYPE_CODES.
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3 };

constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
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
// Chunked prefill: grid (kv_heads, row tiles). Grouped query row r of
// head h sits at position start + r / g; a block owns tq consecutive
// rows and walks the pages up to its last row's causal limit.
// Shared-memory rows are padded to d + 1 floats so the per-key dot
// products hit distinct banks.
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

size_t decode_smem_bytes(int g, int d, int bs) {
  return sizeof(float) * (2 * static_cast<size_t>(g) * d + g * bs + 3 * g);
}

size_t prefill_smem_bytes(int tq, int d, int bs) {
  const size_t dp = d + 1;
  return sizeof(float) *
         (2 * tq * dp + 2 * bs * dp + static_cast<size_t>(tq) * bs + 3 * tq);
}

// Rows per prefill block: 64, halved while the grid would leave SMs of
// the 132 idle or the tile would not fit shared memory.
int prefill_tile_rows(int hkv, int bucket, int g, int d, int bs) {
  const int n_rows = bucket * g;
  int tq = 64;
  while (tq > 16 && hkv * ((n_rows + tq - 1) / tq) < 132) tq >>= 1;
  while (tq > 1 && prefill_smem_bytes(tq, d, bs) > static_cast<size_t>(kMaxSmem)) tq >>= 1;
  return tq;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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

template <typename QT, typename KT>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* table, const void* k_scale, const void* v_scale,
                   void* out, int hkv, int bucket, int g, int d, int bs,
                   int max_blocks, int start, float sm_scale, cudaStream_t stream) {
  const int tq = prefill_tile_rows(hkv, bucket, g, d, bs);
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
  TPUHPC_DISPATCH(q_dtype, kv_dtype,
                  return (launch_prefill<QT, KT>(
                      q, k_pages, v_pages, table, k_scale, v_scale, out, hkv,
                      bucket, g, d, bs, max_blocks, start, sm_scale,
                      static_cast<cudaStream_t>(stream))))
}

// The prefill tile the launcher picks for these shapes (reported by
// chip_smoke.py beside the kernel's time).
int tpuhpc_prefill_tile_rows(int hkv, int bucket, int g, int d, int bs) {
  return prefill_tile_rows(hkv, bucket, g, d, bs);
}

const char* tpuhpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
