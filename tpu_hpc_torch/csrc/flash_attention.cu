// Flash attention forward and backward for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas kernel of the JAX package's
// tpu_hpc/kernels/attention.py:
//
//   flash_fwd_kernel  replaces _flash_kernel (launched by _flash_forward):
//                     out and the per-row log-sum-exp, online softmax.
//   flash_dq_kernel   replaces _flash_dq_kernel (launched by
//                     _flash_backward): dq = scale * dS . K.
//   flash_dkv_kernel  replaces _flash_dkv_kernel (launched by
//                     _flash_backward): dV = P^T . dO, dK = scale * dS^T . Q.
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
//     sequential KV (or q) axis becomes a loop inside the block, with
//     the running state in shared memory;
//   * the causal limit takes the global offsets q_offset / kv_offset as
//     runtime arguments, so one build serves every ring step; tiles
//     wholly above the diagonal are never visited, and the ragged tail
//     is masked in the kernel instead of padded copies being made;
//   * inputs are read straight from the [B, S, H, D] layout; query head
//     h reads KV head h / g, never a repeated copy;
//   * dk/dv loops over the g query heads of its group inside the block,
//     so the group sum (attention.py:640-644) happens in the fp32
//     accumulator: no g-times buffer, no atomics.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training path's shape (B 4, S 2048, 8 heads, d 128, causal) the
// forward does 34 GFLOP on 67 MB, dq 52 GFLOP on 84 MB and dk/dv 69
// GFLOP on 101 MB -- all operations-bound, ~0.035 / 0.052 / 0.069 ms.
//
// This first design is simple and right rather than fast: the matrix
// products run on the tensor cores through the WMMA API (16x16x16 bf16
// or fp16 fragments, fp32 accumulators; 8 warps, each holding a part
// of a 16-row strip of a product in registers, while the running
// accumulators live in shared memory between products), tiles are staged with cp.async
// copies that are all in flight at once but not overlapped with the
// previous tile's compute (no double buffering, no TMA), and nothing is
// warp-specialised. Float32 inputs take the same walk with scalar fp32
// FMAs in place of the tensor cores (half-size tiles, so shared memory
// still fits). wgmma, TMA and register-resident accumulators are later
// PRs' work; PERF.md carries the measured times against the bounds.
//
// Plain C interface, loaded with ctypes by tpu_hpc_torch/kernels/_build.py
// (tpuhpc_error_string lives in paged_attention.cu, in the same
// library). Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

// kernels/attention.py MASK_VALUE.
constexpr float kMaskValue = -1e30f;

// dtype codes shared with kernels/attention.py::DTYPE_CODES.
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr int kMaxHeadDim = 128;
constexpr int kFPad = 4;  // fp32 rows: WMMA accumulator ldm % 4 == 0

// Tile rows (q rows and k rows alike) and the shared-memory row padding
// of the input-typed tiles. 16-bit inputs: 64-row tiles, rows padded by
// 8 elements (WMMA wants ldm % 8 == 0; the pad spreads rows over
// banks). Float32: 32-row tiles, rows padded by one element so the
// scalar products' column walks hit distinct banks.
template <typename T>
struct Tile {
  static constexpr int kRows = 64;
  static constexpr int kPad = 8;
};
template <>
struct Tile<float> {
  static constexpr int kRows = 32;
  static constexpr int kPad = 1;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether query row `row` (global position) sees key `col` (local index
// into this KV chunk): inside the chunk, and not in the row's future
// when causal (global positions q_offset + i >= kv_offset + j).
__device__ __forceinline__ bool visible(int row, int col, int sk,
                                        int kv_offset, int causal) {
  return col < sk && (!causal || row >= kv_offset + col);
}

// Copies 16 bytes global -> shared without staging them in registers
// (cp.async, sm_80+); many stay in flight at once. async_wait() waits
// for this thread's copies; a barrier then publishes them to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// dst[r][0:d] = src[r * stride + 0:d] for r < valid; zeros for the
// rows valid <= r < rows, so a ragged tail never feeds garbage (or a
// NaN times a zero probability) into a product. 16-bit tiles are
// issued as cp.async copies: call async_wait() and a barrier before
// reading them. Float32 tiles (rows padded to d + 1, so not 16-byte
// aligned) are plain loads.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          size_t stride, int rows, int valid,
                                          int d) {
  if constexpr (sizeof(T) == 2) {
    const int vpr = d / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr;
      const int c = (i - r * vpr) * 8;
      if (r < valid) {
        cp_async16(dst + r * ld + c, src + r * stride + c);
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.f;
    }
  }
}

// Per-row fp32 values of one head: dst[r] = src[(row0 + r) * hq] for
// r < valid, else 0.
__device__ __forceinline__ void load_row_scalars(float* dst, const float* src,
                                                 int hq, int rows, int valid) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    dst[r] = r < valid ? src[static_cast<size_t>(r) * hq] : 0.f;
}

// C[m][n] (fp32, row-major, ldc) = (accumulate ? C : 0) + A . B over kdim,
// all in shared memory, where A(i, x) = a[i * lda + x] (kARow) or
// a[x * lda + i], and B(x, j) = b[x * ldb + j] (kBRow) or b[j * ldb + x].
// 16-bit inputs: on the tensor cores. The (m / 16) 16-row strips of C
// are split into column groups so every warp has work (a 64-row tile:
// 4 strips x 2 groups for 8 warps); a warp keeps its group's
// accumulator fragments in registers, so each A fragment is loaded once
// per k step (m, n, kdim multiples of 16, n <= 128). Float32: one
// output element per thread.
template <typename T, bool kARow, bool kBRow>
__device__ __forceinline__ void block_gemm(const T* a, int lda, const T* b,
                                           int ldb, float* c, int ldc, int m,
                                           int n, int kdim, bool accumulate) {
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    using LA = typename std::conditional<kARow, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<kBRow, wmma::row_major,
                                         wmma::col_major>::type;
    constexpr int kMaxTn = kMaxHeadDim / 16;
    const int warp = threadIdx.x >> 5;
    const int strips = m / 16;
    const int tn = n / 16;
    const int groups = strips >= kWarps ? 1 : kWarps / strips;
    const int per_group = (tn + groups - 1) / groups;
    for (int unit = warp; unit < strips * groups; unit += kWarps) {
      const int ti = unit % strips;
      const int j0 = (unit / strips) * per_group;
      const int nj = min(per_group, tn - j0);
      float* cp = c + ti * 16 * ldc + j0 * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[kMaxTn];
#pragma unroll
      for (int j = 0; j < kMaxTn; ++j) {
        if (j >= nj) break;
        if (accumulate) {
          wmma::load_matrix_sync(fc[j], cp + j * 16, ldc, wmma::mem_row_major);
        } else {
          wmma::fill_fragment(fc[j], 0.f);
        }
      }
      for (int x = 0; x < kdim; x += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
        wmma::load_matrix_sync(
            fa, kARow ? a + ti * 16 * lda + x : a + x * lda + ti * 16, lda);
#pragma unroll
        for (int j = 0; j < kMaxTn; ++j) {
          if (j >= nj) break;
          const int col = (j0 + j) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
          wmma::load_matrix_sync(
              fb, kBRow ? b + x * ldb + col : b + col * ldb + x, ldb);
          wmma::mma_sync(fc[j], fa, fb, fc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxTn; ++j) {
        if (j >= nj) break;
        wmma::store_matrix_sync(cp + j * 16, fc[j], ldc, wmma::mem_row_major);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < m * n; idx += kThreads) {
      const int i = idx / n;
      const int j = idx - i * n;
      float s = accumulate ? c[i * ldc + j] : 0.f;
      for (int x = 0; x < kdim; ++x) {
        const float av = kARow ? a[i * lda + x] : a[x * lda + i];
        const float bv = kBRow ? b[x * ldb + j] : b[j * ldb + x];
        s = fmaf(av, bv, s);
      }
      c[i * ldc + j] = s;
    }
  }
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

// ---------------------------------------------------------------------
// Forward. Grid (q tiles, hq, b); the heaviest causal tiles launch first.
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,   // (b, sq, hq, d)
    const T* __restrict__ k,   // (b, sk, hkv, d)
    const T* __restrict__ v,
    T* __restrict__ out,       // (b, sq, hq, d)
    float* __restrict__ lse,   // (b, sq, hq)
    int sq, int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
    int causal, float scale) {
  constexpr int BR = Tile<T>::kRows;
  constexpr int ldp = BR + Tile<T>::kPad;
  constexpr int lds = BR + kFPad;
  const int ld = d + Tile<T>::kPad;
  const int lda = d + kFPad;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BR;
  const int q_rows = min(BR, sq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // [BR][ld]
  T* ks = qs + BR * ld;                           // [BR][ld]
  T* vs = ks + BR * ld;                           // [BR][ld]
  T* ps = vs + BR * ld;                           // [BR][ldp]
  float* ss = reinterpret_cast<float*>(ps + BR * ldp);  // [BR][lds]
  float* acc = ss + BR * lds;                     // [BR][lda]
  float* m = acc + BR * lda;                      // [BR]
  float* l = m + BR;                              // [BR]

  const size_t q_stride = static_cast<size_t>(hq) * d;
  const size_t kv_stride = static_cast<size_t>(hkv) * d;
  const size_t q_base = (static_cast<size_t>(b) * sq + q0) * q_stride +
                        static_cast<size_t>(h) * d;
  const size_t kv_base = static_cast<size_t>(b) * sk * kv_stride +
                         static_cast<size_t>(kvh) * d;

  load_rows(qs, ld, q + q_base, q_stride, BR, q_rows, d);
  for (int i = threadIdx.x; i < BR * lda; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < BR; r += kThreads) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }
  async_wait();

  const int n_kt = kv_tiles(sk, BR, q_offset + q0 + q_rows - 1, kv_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BR;
    const int k_rows = min(BR, sk - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_rows(ks, ld, k + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    load_rows(vs, ld, v + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    async_wait();
    __syncthreads();
    block_gemm<T, true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
    __syncthreads();
    // Online softmax, one warp per row; the warp also rescales its
    // row of the accumulator, so no barrier separates the two.
    for (int r = warp; r < BR; r += kWarps) {
      const int row = q_offset + q0 + r;
      float sv[BR / 32];
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < BR / 32; ++j) {
        const int c = lane + 32 * j;
        const float s = visible(row, k0 + c, sk, kv_offset, causal)
                            ? ss[r * lds + c] * scale
                            : kMaskValue;
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float l_prev = l[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kMaskValue * 0.5f ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BR / 32; ++j) {
        const float p = sv[j] > kMaskValue * 0.5f ? expf(sv[j] - m_safe) : 0.f;
        psum += p;
        ps[r * ldp + lane + 32 * j] = from_f<T>(p);
      }
      psum = warp_sum(psum);
      const float alpha = expf(m_prev - m_safe);
      for (int x = lane; x < d; x += 32) acc[r * lda + x] *= alpha;
      if (lane == 0) {
        l[r] = alpha * l_prev + psum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    block_gemm<T, true, true>(ps, ldp, vs, ld, acc, lda, BR, d, BR, true);
  }
  __syncthreads();
  for (int r = warp; r < q_rows; r += kWarps) {
    const float lr = l[r];
    const float l_safe = lr == 0.f ? 1.f : lr;
    T* orow = out + q_base + r * q_stride;
    for (int x = lane; x < d; x += 32) orow[x] = from_f<T>(acc[r * lda + x] / l_safe);
    if (lane == 0)
      lse[(static_cast<size_t>(b) * sq + q0 + r) * hq + h] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------
// dq. Grid (q tiles, hq, b); the same walk as the forward.
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout,     // (b, sq, hq, d)
    const float* __restrict__ lse,  // (b, sq, hq)
    const float* __restrict__ dm,   // (b, sq, hq): rowsum(dO*O) - dlse
    T* __restrict__ dq,             // (b, sq, hq, d)
    int sq, int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
    int causal, float scale) {
  constexpr int BR = Tile<T>::kRows;
  constexpr int ldp = BR + Tile<T>::kPad;
  constexpr int lds = BR + kFPad;
  const int ld = d + Tile<T>::kPad;
  const int lda = d + kFPad;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BR;
  const int q_rows = min(BR, sq - q0);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // [BR][ld]
  T* dos = qs + BR * ld;                          // [BR][ld]
  T* ks = dos + BR * ld;                          // [BR][ld]
  T* vs = ks + BR * ld;                           // [BR][ld]
  T* dss = vs + BR * ld;                          // [BR][ldp]
  float* ss = reinterpret_cast<float*>(dss + BR * ldp);  // [BR][lds]
  float* dps = ss + BR * lds;                     // [BR][lds]
  float* acc = dps + BR * lds;                    // [BR][lda]
  float* lse_s = acc + BR * lda;                  // [BR]
  float* dm_s = lse_s + BR;                       // [BR]

  const size_t q_stride = static_cast<size_t>(hq) * d;
  const size_t kv_stride = static_cast<size_t>(hkv) * d;
  const size_t q_base = (static_cast<size_t>(b) * sq + q0) * q_stride +
                        static_cast<size_t>(h) * d;
  const size_t kv_base = static_cast<size_t>(b) * sk * kv_stride +
                         static_cast<size_t>(kvh) * d;
  const size_t r_base = (static_cast<size_t>(b) * sq + q0) * hq + h;

  load_rows(qs, ld, q + q_base, q_stride, BR, q_rows, d);
  load_rows(dos, ld, dout + q_base, q_stride, BR, q_rows, d);
  load_row_scalars(lse_s, lse + r_base, hq, BR, q_rows);
  load_row_scalars(dm_s, dm + r_base, hq, BR, q_rows);
  for (int i = threadIdx.x; i < BR * lda; i += kThreads) acc[i] = 0.f;
  async_wait();

  const int n_kt = kv_tiles(sk, BR, q_offset + q0 + q_rows - 1, kv_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BR;
    const int k_rows = min(BR, sk - k0);
    __syncthreads();
    load_rows(ks, ld, k + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    load_rows(vs, ld, v + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    async_wait();
    __syncthreads();
    block_gemm<T, true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
    block_gemm<T, true, false>(dos, ld, vs, ld, dps, lds, BR, BR, d, false);
    __syncthreads();
    for (int i = threadIdx.x; i < BR * BR; i += kThreads) {
      const int r = i / BR;
      const int c = i - r * BR;
      const bool ok = r < q_rows &&
                      visible(q_offset + q0 + r, k0 + c, sk, kv_offset, causal);
      const float s = ok ? ss[r * lds + c] * scale : kMaskValue;
      const float p = s > kMaskValue * 0.5f ? expf(s - lse_s[r]) : 0.f;
      dss[r * ldp + c] = from_f<T>(p * (dps[r * lds + c] - dm_s[r]));
    }
    __syncthreads();
    block_gemm<T, true, true>(dss, ldp, ks, ld, acc, lda, BR, d, BR, true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < q_rows * d; i += kThreads) {
    const int r = i / d;
    const int x = i - r * d;
    dq[q_base + r * q_stride + x] = from_f<T>(scale * acc[r * lda + x]);
  }
}

// ---------------------------------------------------------------------
// dk/dv. Grid (k tiles, hkv, b): the block holds its K and V tile and
// walks, for each of the g query heads of its group, the q tiles from
// the first one the causal mask lets see the tile to the last.
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dm,
    T* __restrict__ dk,  // (b, sk, hkv, d)
    T* __restrict__ dv,
    int sq, int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
    int causal, float scale) {
  constexpr int BR = Tile<T>::kRows;
  constexpr int ldp = BR + Tile<T>::kPad;
  constexpr int lds = BR + kFPad;
  const int ld = d + Tile<T>::kPad;
  const int lda = d + kFPad;
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int k0 = kt * BR;
  const int k_rows = min(BR, sk - k0);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);        // [BR][ld]
  T* vs = ks + BR * ld;                           // [BR][ld]
  T* qs = vs + BR * ld;                           // [BR][ld]
  T* dos = qs + BR * ld;                          // [BR][ld]
  T* ps = dos + BR * ld;                          // [BR][ldp]
  T* dss = ps + BR * ldp;                         // [BR][ldp]
  float* ss = reinterpret_cast<float*>(dss + BR * ldp);  // [BR][lds]
  float* dps = ss + BR * lds;                     // [BR][lds]
  float* dk_acc = dps + BR * lds;                 // [BR][lda]
  float* dv_acc = dk_acc + BR * lda;              // [BR][lda]
  float* lse_s = dv_acc + BR * lda;               // [BR]
  float* dm_s = lse_s + BR;                       // [BR]

  const size_t q_stride = static_cast<size_t>(hq) * d;
  const size_t kv_stride = static_cast<size_t>(hkv) * d;
  const size_t kv_base = (static_cast<size_t>(b) * sk + k0) * kv_stride +
                         static_cast<size_t>(kvh) * d;

  load_rows(ks, ld, k + kv_base, kv_stride, BR, k_rows, d);
  load_rows(vs, ld, v + kv_base, kv_stride, BR, k_rows, d);
  for (int i = threadIdx.x; i < BR * lda; i += kThreads) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  async_wait();

  // First q tile whose last row can see this tile's first key.
  const int n_qt = (sq + BR - 1) / BR;
  int qt0 = 0;
  if (causal) {
    const int need = kv_offset + k0 - q_offset - (BR - 1);
    qt0 = need <= 0 ? 0 : (need + BR - 1) / BR;
  }
  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BR;
      const int q_rows = min(BR, sq - q0);
      const size_t q_base = (static_cast<size_t>(b) * sq + q0) * q_stride +
                            static_cast<size_t>(h) * d;
      const size_t r_base = (static_cast<size_t>(b) * sq + q0) * hq + h;
      __syncthreads();  // the previous q tile's operands are no longer read
      load_rows(qs, ld, q + q_base, q_stride, BR, q_rows, d);
      load_rows(dos, ld, dout + q_base, q_stride, BR, q_rows, d);
      load_row_scalars(lse_s, lse + r_base, hq, BR, q_rows);
      load_row_scalars(dm_s, dm + r_base, hq, BR, q_rows);
      async_wait();
      __syncthreads();
      // S [q rows][k cols] and dP = dO . V^T, as in dq.
      block_gemm<T, true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
      block_gemm<T, true, false>(dos, ld, vs, ld, dps, lds, BR, BR, d, false);
      __syncthreads();
      for (int i = threadIdx.x; i < BR * BR; i += kThreads) {
        const int r = i / BR;
        const int c = i - r * BR;
        const bool ok = r < q_rows &&
                        visible(q_offset + q0 + r, k0 + c, sk, kv_offset, causal);
        const float s = ok ? ss[r * lds + c] * scale : kMaskValue;
        const float p = s > kMaskValue * 0.5f ? expf(s - lse_s[r]) : 0.f;
        ps[r * ldp + c] = from_f<T>(p);
        dss[r * ldp + c] = from_f<T>(p * (dps[r * lds + c] - dm_s[r]));
      }
      __syncthreads();
      // dV += P^T . dO and dK += dS^T . Q: P and dS are read transposed
      // (column-major A operands), so no transposed copy is made.
      block_gemm<T, false, true>(ps, ldp, dos, ld, dv_acc, lda, BR, d, BR, true);
      block_gemm<T, false, true>(dss, ldp, qs, ld, dk_acc, lda, BR, d, BR, true);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k_rows * d; i += kThreads) {
    const int r = i / d;
    const int x = i - r * d;
    dk[kv_base + r * kv_stride + x] = from_f<T>(scale * dk_acc[r * lda + x]);
    dv[kv_base + r * kv_stride + x] = from_f<T>(dv_acc[r * lda + x]);
  }
}

// Dynamic shared memory of each kernel, in bytes: input-typed tiles
// first, then the fp32 buffers (both regions are multiples of 128 bytes
// for every supported d, so each buffer stays aligned for WMMA).
template <typename T>
size_t smem_bytes(int which, int d) {
  constexpr int BR = Tile<T>::kRows;
  const size_t ld = d + Tile<T>::kPad;
  const size_t ldp = BR + Tile<T>::kPad;
  const size_t lds = BR + kFPad;
  const size_t lda = d + kFPad;
  size_t t_elems = 0, f_elems = 0;
  switch (which) {
    case 0:  // forward: Q K V, P | S, acc, m, l
      t_elems = BR * (3 * ld + ldp);
      f_elems = BR * (lds + lda + 2);
      break;
    case 1:  // dq: Q dO K V, dS | S, dP, acc, lse, dm
      t_elems = BR * (4 * ld + ldp);
      f_elems = BR * (2 * lds + lda + 2);
      break;
    default:  // dk/dv: K V Q dO, P dS | S, dP, dk, dv, lse, dm
      t_elems = BR * (4 * ld + 2 * ldp);
      f_elems = BR * (2 * lds + 2 * lda + 2);
      break;
  }
  return t_elems * sizeof(T) + f_elems * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool shapes_ok(int b, int sq, int sk, int hq, int hkv, int d) {
  return b > 0 && sq > 0 && sk > 0 && hkv > 0 && hq % hkv == 0 && d > 0 &&
         d % 16 == 0 && d <= kMaxHeadDim && b <= 65535 && hq <= 65535;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
               int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, float scale, cudaStream_t stream) {
  constexpr int BR = Tile<T>::kRows;
  const size_t smem = smem_bytes<T>(0, d);
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + BR - 1) / BR, hq, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), sq, sk, hq, hkv, d,
      q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dm, void* dq, int b, int sq, int sk,
              int hq, int hkv, int d, int q_offset, int kv_offset, int causal,
              float scale, cudaStream_t stream) {
  constexpr int BR = Tile<T>::kRows;
  const size_t smem = smem_bytes<T>(1, d);
  auto kernel = flash_dq_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + BR - 1) / BR, hq, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dm), static_cast<T*>(dq), sq, sk, hq, hkv, d,
      q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dm, void* dk, void* dv, int b,
               int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, float scale, cudaStream_t stream) {
  constexpr int BR = Tile<T>::kRows;
  const size_t smem = smem_bytes<T>(2, d);
  auto kernel = flash_dkv_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sk + BR - 1) / BR, hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dm), static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, hq, hkv, d, q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
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

int tpuhpc_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, float scale,
                     int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_fwd<T>(q, k, v, out, lse, b, sq, sk, hq, hkv,
                                             d, q_offset, kv_offset, causal, scale,
                                             static_cast<cudaStream_t>(stream)))
}

int tpuhpc_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dm, void* dq, int b, int sq,
                    int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                    int causal, float scale, int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dq<T>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                            hq, hkv, d, q_offset, kv_offset, causal,
                                            scale, static_cast<cudaStream_t>(stream)))
}

int tpuhpc_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dm, void* dk,
                     void* dv, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, float scale,
                     int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dkv<T>(q, k, v, dout, lse, dm, dk, dv, b, sq,
                                             sk, hq, hkv, d, q_offset, kv_offset,
                                             causal, scale,
                                             static_cast<cudaStream_t>(stream)))
}

// Rows of the q and k tiles the kernels use for a dtype code (0 for an
// unknown code); kernels/attention.py::flash_tile_rows reads it.
int tpuhpc_flash_tile_rows(int dtype) {
  switch (dtype) {
    case kF32: return Tile<float>::kRows;
    case kF16: return Tile<__half>::kRows;
    case kBF16: return Tile<__nv_bfloat16>::kRows;
    default: return 0;
  }
}

}  // extern "C"
