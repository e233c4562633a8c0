// Flash attention forward and backward for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas kernel of the JAX package's
// tpu_hpc/kernels/attention.py:
//
//   flash_fwd_kernel  replaces _flash_kernel (launched by _flash_forward):
//                     out and the per-row log-sum-exp, online softmax.
//   dq                replaces _flash_dq_kernel (launched by
//                     _flash_backward): dq = scale * dS . K.
//                     flash_dq_wgmma_kernel for bf16 / fp16,
//                     flash_dq_kernel for float32.
//   dk/dv             replaces _flash_dkv_kernel (launched by
//                     _flash_backward): dV = P^T . dO, dK = scale * dS^T . Q.
//                     flash_dkv_wgmma_kernel for bf16 / fp16,
//                     flash_dkv_kernel for float32.
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
//     accumulator: no g-times buffer, no atomics, and dq, dk, dv come
//     out bit-identical from launch to launch.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training path's shape (B 4, S 2048, 8 heads, d 128, causal) the
// forward does 34 GFLOP on 67 MB, dq 52 GFLOP on 84 MB and dk/dv 69
// GFLOP on 101 MB -- all operations-bound, ~0.035 / 0.052 / 0.069 ms:
// the tensor cores' rate, and how much of the time they are fed, set
// the time.
//
// The 16-bit backward kernels are built for that (PERF.md): every
// product is a warpgroup wgmma (sm_90a) whose fp32 accumulator stays in
// registers -- S and dP for one tile, dQ (or dK and dV) for the whole
// walk -- and P and dS are built in those registers and fed straight
// back as the A operand of the next product, so no score, probability
// or gradient tile touches shared memory. Two warpgroups of 64 rows
// share a block of 128 rows (keys in dk/dv); the streamed tiles (K and
// V in dq; Q, dO in dk/dv) come by TMA, 128-byte swizzled as wgmma's
// descriptors read them, through a two-stage ring: the next tile's copy
// is in flight while this tile's products run, and one barrier per tile
// frees its stage. The head dim is a compile-time 64 or 128; a smaller
// d reads TMA's zero fill past its columns. What still holds them back:
// no producer warp and no overlap of one warpgroup's softmax with its
// own products (the other warpgroup's products fill that gap only in
// part), and 64-row streamed tiles.
//
// The forward (WMMA 16x16x16 fragments, running accumulators in shared
// memory between products, cp.async copies not overlapped with compute)
// and every float32 kernel (the same walk on scalar fp32 FMAs, half-size
// tiles: wgmma has no fp32 operand) keep the first, simple design; the
// forward's redesign is queued (ROADMAP queue 2).
//
// Plain C interface, loaded with ctypes by tpu_hpc_torch/kernels/_build.py
// (tpuhpc_error_string lives in paged_attention.cu, in the same
// library). Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link
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
// of the input-typed tiles, for the forward and the float32 backward
// (the 16-bit backward's tiles are kBwdRows / kBwdStep below). 16-bit
// inputs: 64-row tiles, rows padded by 8 elements (WMMA wants ldm % 8
// == 0; the pad spreads rows over banks). Float32: 32-row tiles, rows
// padded by one element so the scalar products' column walks hit
// distinct banks.
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
// dq, float32 inputs. Grid (q tiles, hq, b); the same walk as the
// forward. (16-bit inputs: flash_dq_wgmma_kernel below.)
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
  static_assert(std::is_same<T, float>::value,
                "16-bit dq runs flash_dq_wgmma_kernel");
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
// dk/dv, float32 inputs. Grid (k tiles, hkv, b): the block holds its K
// and V tile and walks, for each of the g query heads of its group, the
// q tiles from the first one the causal mask lets see the tile to the
// last. (16-bit inputs: flash_dkv_wgmma_kernel below.)
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
  static_assert(std::is_same<T, float>::value,
                "16-bit dk/dv runs flash_dkv_wgmma_kernel");
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

// =====================================================================
// Backward for 16-bit inputs on Hopper: wgmma products with their
// accumulators in registers, TMA tile loads in a two-stage ring.
//
// Shared-memory tiles hold 16-bit [rows][kD] operands as kD / 64
// "panels" of 64 columns (128 bytes a row), each panel laid out as TMA's
// 128-byte swizzle writes it and as wgmma's 128-byte-swizzle
// descriptors read it: row r at r * 128 bytes, its 16-byte chunk c at
// chunk c ^ (r % 8). A tile of R rows keeps panel p at p * R * 128.
// =====================================================================

constexpr int kBwdThreads = 256;  // two warpgroups
constexpr int kBwdRows = 128;     // q rows (dq) or keys (dk/dv) a block owns
constexpr int kBwdStep = 64;      // keys (dq) or q rows (dk/dv) per streamed tile
constexpr int kPanelRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes)
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

// Loads rows [s0, s0 + rows) of head h of batch b, all kD columns, from
// a [B, S, H, D] tensor map into `tile`, one TMA box per panel; rows
// past S and columns past D arrive as zeros. Completion is counted on
// `bar` (rows * kD * 2 bytes).
template <int kD>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map,
                                         uint32_t bar, int h, int s0, int b,
                                         int rows) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(tile + p * rows * kPanelRowBytes),
           "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * p), "r"(h), "r"(s0),
           "r"(b), "r"(bar)
        : "memory");
  }
}

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

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
// l / 4 + 8. The A fragment of a register-sourced product (k-step of 16
// columns) is that layout for two groups, packed in pairs: so the
// packed accumulator of one product is the A operand of the next with
// no data movement. SS: A and B from shared memory, both K-major. RS: A
// from registers, B MN-major (imm-trans-b 1).

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

// dQ / dK / dV += A . B with N = kD (the head-dim variant).
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

// Shared memory of a 16-bit backward kernel: two tiles of the block's
// own kBwdRows rows, two rings of two streamed kBwdStep-row tiles, the
// ring's per-row statistics (dk/dv: lse and dm of each stage's q rows),
// three mbarriers, and slack to align the tiles to 1024 bytes.
template <int kD>
constexpr size_t bwd_smem_bytes() {
  return 2 * kBwdRows * kD * 2 + 4 * kBwdStep * kD * 2 +
         2 * 2 * kBwdStep * sizeof(float) + 3 * 8 + 1024;
}

// ---------------------------------------------------------------------
// dq, 16-bit inputs. Grid (q tiles of kBwdRows, hq, b), heaviest causal
// tiles first. The block's Q and dO tiles stay in shared memory; K and
// V tiles of kBwdStep keys stream through a two-stage TMA ring, the next
// one loading while this one's products run. Warpgroup w owns q rows
// [64 w, 64 w + 64) of the tile and keeps in registers, per tile:
//   S = Q . K^T, dP = dO . V^T            (SS wgmma, 64 x 64 each)
//   dS = P * (dP - dm), P = exp(S - lse)  (in place, then packed to T)
//   dQ += dS . K                           (RS wgmma, K read MN-major)
// dQ stays in registers for the whole walk; the epilogue scales it.
// ---------------------------------------------------------------------
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdRows rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    T* __restrict__ dq, int sq, int sk, int hq, int hkv, int d, int q_offset,
    int kv_offset, int causal, float scale) {
  constexpr int kOwn = kBwdRows * kD * 2;      // bytes of the Q (dO) tile
  constexpr int kStream = kBwdStep * kD * 2;   // bytes of a K (V) tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kBwdRows;
  const int q_rows = min(kBwdRows, sq - q0);
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
  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    mbar_init(bar_ring);
    mbar_init(bar_ring + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * kOwn);
    tma_tile<kD>(s_q, &tm_q, bar_own, h, q0, b, kBwdRows);
    tma_tile<kD>(s_do, &tm_do, bar_own, h, q0, b, kBwdRows);
    if (n_kt > 0) {
      mbar_expect_tx(bar_ring, 2 * kStream);
      tma_tile<kD>(s_k, &tm_k, bar_ring, kvh, 0, b, kBwdStep);
      tma_tile<kD>(s_v, &tm_v, bar_ring, kvh, 0, b, kBwdStep);
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
      mbar_expect_tx(bar, 2 * kStream);
      tma_tile<kD>(s_k + (st ^ 1) * kStream, &tm_k, bar, kvh,
                   (kt + 1) * kBwdStep, b, kBwdStep);
      tma_tile<kD>(s_v + (st ^ 1) * kStream, &tm_v, bar, kvh,
                   (kt + 1) * kBwdStep, b, kBwdStep);
    }
    mbar_wait(bar_ring + 8 * st, (kt >> 1) & 1);
    const uint32_t k_tile = s_k + st * kStream;
    const uint32_t v_tile = s_v + st * kStream;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(s, kmajor_desc(s_q, kBwdRows, 64 * wg, kk),
                      kmajor_desc(k_tile, kBwdStep, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(dp, kmajor_desc(s_do, kBwdRows, 64 * wg, kk),
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
      float p = exp2f(fmaf(s[i], scale2, -lse2[r]));
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
      wgmma_rs_nd<T, kD>(acc, ds[kk], mnmajor_desc(k_tile, kBwdStep, kk));
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
        *reinterpret_cast<uint32_t*>(dq + at) =
            pack2<T>(scale * acc[4 * j + 2 * r], scale * acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// dk/dv, 16-bit inputs. Grid (k tiles of kBwdRows keys, hkv, b), the
// first key tiles (the longest causal walks) first. The block's K and V
// tiles stay in shared memory; for each of the g query heads of the
// group, the Q and dO tiles of kBwdStep rows from the first the causal
// mask lets see the block's keys stream through a two-stage TMA ring
// (their lse and dm rows beside them by cp.async). Warpgroup w owns keys
// [64 w, 64 w + 64); with keys as rows, as in the Pallas kernel, it
// keeps in registers, per tile:
//   S^T = K . Q^T, dP^T = V . dO^T            (SS wgmma, 64 x 64 each)
//   P^T = exp(S^T - lse), dS^T = P^T * (dP^T - dm)  (lse, dm per column)
//   dV += P^T . dO, dK += dS^T . Q            (RS wgmma, B MN-major)
// dK and dV stay in registers across every q tile of every head of the
// group, so the group sum happens in the fp32 accumulators.
// ---------------------------------------------------------------------
template <typename T, int kD>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdStep rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq, int hkv,
    int d, int q_offset, int kv_offset, int causal, float scale) {
  constexpr int kOwn = kBwdRows * kD * 2;     // bytes of the K (V) tile
  constexpr int kStream = kBwdStep * kD * 2;  // bytes of a Q (dO) tile
  constexpr int kStats = 2 * kBwdStep * sizeof(float);  // lse, dm of a stage
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const int k0 = kt * kBwdRows;
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
  const int n_steps = g * per_head;

  // Step n's Q and dO tiles (TMA, thread 0) and lse / dm rows (cp.async,
  // threads 0-127) into stage st.
  auto issue = [&](int n, int st) {
    const int hh = n / per_head;
    const int h = kvh * g + hh;
    const int q0 = (qt0 + n - hh * per_head) * kBwdStep;
    if (threadIdx.x == 0) {
      const uint32_t bar = bar_ring + 8 * st;
      mbar_expect_tx(bar, 2 * kStream);
      tma_tile<kD>(s_q + st * kStream, &tm_q, bar, h, q0, b, kBwdStep);
      tma_tile<kD>(s_do + st * kStream, &tm_do, bar, h, q0, b, kBwdStep);
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

  if (threadIdx.x == 0) {
    mbar_init(bar_own);
    mbar_init(bar_ring);
    mbar_init(bar_ring + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_own, 2 * kOwn);
    tma_tile<kD>(s_k, &tm_k, bar_own, kvh, k0, b, kBwdRows);
    tma_tile<kD>(s_v, &tm_v, bar_own, kvh, k0, b, kBwdRows);
  }
  if (n_steps > 0) issue(0, 0);

  // This thread's two keys (index into sk): key0 and key0 + 8.
  const int wk0 = k0 + 64 * wg;  // the warpgroup's first key
  const int key0 = wk0 + 16 * warp + (lane >> 2);
  const float scale2 = scale * kLog2e;

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
      wgmma_ss_n64<T>(s, kmajor_desc(s_k, kBwdRows, 64 * wg, kk),
                      kmajor_desc(q_tile, kBwdStep, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<T>(dp, kmajor_desc(s_v, kBwdRows, 64 * wg, kk),
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

  // dk = scale * dK and dv = dV, this thread's column pairs of its keys.
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (col < d && key < sk) {
        const size_t at =
            ((static_cast<size_t>(b) * sk + key) * hkv + kvh) * d + col;
        *reinterpret_cast<uint32_t*>(dk + at) = pack2<T>(
            scale * dk_acc[4 * j + 2 * r], scale * dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack2<T>(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
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

// cuTensorMapEncodeTiled, found through the runtime so the library needs
// no link against libcuda; null where the installed CUDA lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
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
// rows past S and columns past D read as zeros.
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

template <typename T, int kD>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dm, void* dq,
                    int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
                    int kv_offset, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, kBwdRows, kBwdStep);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem_bytes<kD>();
  auto kernel = flash_dq_wgmma_kernel<T, kD>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kBwdRows - 1) / kBwdRows, hq, b), kBwdThreads, smem,
           stream>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                     static_cast<const float*>(dm), static_cast<T*>(dq), sq, sk,
                     hq, hkv, d, q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dm,
                     void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
                     int d, int q_offset, int kv_offset, int causal,
                     float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, kBwdStep, kBwdRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem_bytes<kD>();
  auto kernel = flash_dkv_wgmma_kernel<T, kD>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sk + kBwdRows - 1) / kBwdRows, hkv, b), kBwdThreads, smem,
           stream>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                     static_cast<const float*>(dm), static_cast<T*>(dk),
                     static_cast<T*>(dv), sq, sk, hq, hkv, d, q_offset,
                     kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
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

// 16-bit inputs take the wgmma kernels (kD 64 for d <= 64, else 128);
// float32 inputs the scalar-FMA walk.
template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dm, void* dq, int b, int sq, int sk,
              int hq, int hkv, int d, int q_offset, int kv_offset, int causal,
              float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return d <= 64 ? launch_dq_wgmma<T, 64>(q, k, v, dout, lse, dm, dq, b, sq,
                                            sk, hq, hkv, d, q_offset, kv_offset,
                                            causal, scale, stream)
                   : launch_dq_wgmma<T, 128>(q, k, v, dout, lse, dm, dq, b, sq,
                                             sk, hq, hkv, d, q_offset,
                                             kv_offset, causal, scale, stream);
  } else {
    constexpr int BR = Tile<T>::kRows;
    const size_t smem = smem_bytes<T>(1, d);
    auto kernel = flash_dq_kernel<T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sq + BR - 1) / BR, hq, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dm),
        static_cast<T*>(dq), sq, sk, hq, hkv, d, q_offset, kv_offset, causal,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dm, void* dk, void* dv, int b,
               int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return d <= 64 ? launch_dkv_wgmma<T, 64>(q, k, v, dout, lse, dm, dk, dv, b,
                                             sq, sk, hq, hkv, d, q_offset,
                                             kv_offset, causal, scale, stream)
                   : launch_dkv_wgmma<T, 128>(q, k, v, dout, lse, dm, dk, dv, b,
                                              sq, sk, hq, hkv, d, q_offset,
                                              kv_offset, causal, scale, stream);
  } else {
    constexpr int BR = Tile<T>::kRows;
    const size_t smem = smem_bytes<T>(2, d);
    auto kernel = flash_dkv_kernel<T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sk + BR - 1) / BR, hkv, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dm),
        static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, hq, hkv, d, q_offset,
        kv_offset, causal, scale);
    return static_cast<int>(cudaGetLastError());
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

// Rows a block of `kernel` (0 forward, 1 dq, 2 dk/dv) owns for a dtype
// code -- q rows for the forward and dq, keys for dk/dv -- or 0 for an
// unknown code; kernels/attention.py::flash_tile_rows reads it.
int tpuhpc_flash_tile_rows(int kernel, int dtype) {
  if (kernel < 0 || kernel > 2) return 0;
  switch (dtype) {
    case kF32: return Tile<float>::kRows;
    case kF16: return kernel == 0 ? Tile<__half>::kRows : kBwdRows;
    case kBF16: return kernel == 0 ? Tile<__nv_bfloat16>::kRows : kBwdRows;
    default: return 0;
  }
}

}  // extern "C"
