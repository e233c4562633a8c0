// Flash attention forward and backward for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas kernel of the JAX package's
// tpu_hpc/kernels/attention.py:
//
//   forward           replaces _flash_kernel (launched by _flash_forward):
//                     out and the per-row log-sum-exp, online softmax.
//                     flash_fwd_wgmma_kernel for bf16 / fp16,
//                     flash_fwd_kernel for float32.
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
// paged prefill. The head dim is a compile-time 64 or 128; a smaller d
// reads TMA's zero fill past its columns.
//
// The forward goes furthest: a producer warp keeps a four-stage K/V
// ring in flight behind per-stage full / empty mbarriers, so the two
// consumer warpgroups never meet at a block barrier, and each issues
// the next tile's Q . K^T before this tile's P . V, so its softmax runs
// while its own products do. The backward kernels still load from a
// thread of the consumers through a two-stage ring with one block
// barrier per tile, and wait for their own products (wgmma.wait_group 0)
// before each softmax; dk/dv's 240 registers leave no room for a second
// S / dP pair.
//
// Float32 inputs keep the first, simple design (the same walks on
// scalar fp32 FMAs over shared memory, 32-row tiles: wgmma has no fp32
// operand).
//
// Plain C interface, loaded with ctypes by tpu_hpc_torch/kernels/_build.py
// (tpuhpc_error_string lives in paged_attention.cu, in the same
// library). Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // float32 kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kFPad = 4;  // fp32 accumulator rows padded to d + 4

// Float32 kernels: tile rows (q rows and k rows alike) and the row
// padding of the input tiles, one element so the scalar products'
// column walks hit distinct banks.
constexpr int kF32Rows = 32;
constexpr int kF32Pad = 1;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether query row `row` (global position) sees key `col` (local index
// into this KV chunk): inside the chunk, and not in the row's future
// when causal (global positions q_offset + i >= kv_offset + j).
__device__ __forceinline__ bool visible(int row, int col, int sk,
                                        int kv_offset, int causal) {
  return col < sk && (!causal || row >= kv_offset + col);
}

// dst[r][0:d] = src[r * stride + 0:d] for r < valid; zeros for the
// rows valid <= r < rows, so a ragged tail never feeds garbage (or a
// NaN times a zero probability) into a product.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          size_t stride, int rows, int valid,
                                          int d) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = r < valid ? src[r * stride + c] : 0.f;
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
// a[x * lda + i], and B(x, j) = b[x * ldb + j] (kBRow) or b[j * ldb + x];
// one output element per thread.
template <bool kARow, bool kBRow>
__device__ __forceinline__ void block_gemm(const float* a, int lda,
                                           const float* b, int ldb, float* c,
                                           int ldc, int m, int n, int kdim,
                                           bool accumulate) {
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
// Forward, float32 inputs. Grid (q tiles, hq, b); the heaviest causal
// tiles launch first. (16-bit inputs: flash_fwd_wgmma_kernel below.)
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
  static_assert(std::is_same<T, float>::value,
                "16-bit forward runs flash_fwd_wgmma_kernel");
  constexpr int BR = kF32Rows;
  constexpr int ldp = BR + kF32Pad;
  constexpr int lds = BR + kFPad;
  const int ld = d + kF32Pad;
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

  const int n_kt = kv_tiles(sk, BR, q_offset + q0 + q_rows - 1, kv_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BR;
    const int k_rows = min(BR, sk - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_rows(ks, ld, k + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    load_rows(vs, ld, v + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    __syncthreads();
    block_gemm<true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
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
        mx = fmax_nan(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float l_prev = l[r];
      const float m_new = fmax_nan(m_prev, mx);
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
    block_gemm<true, true>(ps, ldp, vs, ld, acc, lda, BR, d, BR, true);
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
  constexpr int BR = kF32Rows;
  constexpr int ldp = BR + kF32Pad;
  constexpr int lds = BR + kFPad;
  const int ld = d + kF32Pad;
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

  const int n_kt = kv_tiles(sk, BR, q_offset + q0 + q_rows - 1, kv_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BR;
    const int k_rows = min(BR, sk - k0);
    __syncthreads();
    load_rows(ks, ld, k + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    load_rows(vs, ld, v + kv_base + k0 * kv_stride, kv_stride, BR, k_rows, d);
    __syncthreads();
    block_gemm<true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
    block_gemm<true, false>(dos, ld, vs, ld, dps, lds, BR, BR, d, false);
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
    block_gemm<true, true>(dss, ldp, ks, ld, acc, lda, BR, d, BR, true);
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
  constexpr int BR = kF32Rows;
  constexpr int ldp = BR + kF32Pad;
  constexpr int lds = BR + kFPad;
  const int ld = d + kF32Pad;
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
      __syncthreads();
      // S [q rows][k cols] and dP = dO . V^T, as in dq.
      block_gemm<true, false>(qs, ld, ks, ld, ss, lds, BR, BR, d, false);
      block_gemm<true, false>(dos, ld, vs, ld, dps, lds, BR, BR, d, false);
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
      block_gemm<false, true>(ps, ldp, dos, ld, dv_acc, lda, BR, d, BR, true);
      block_gemm<false, true>(dss, ldp, qs, ld, dk_acc, lda, BR, d, BR, true);
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
// 16-bit kernels on Hopper: wgmma products with their accumulators in
// registers, TMA tile loads (hopper.cuh).
// =====================================================================

constexpr int kBwdThreads = 256;  // two warpgroups
constexpr int kBwdRows = 128;     // q rows (dq) or keys (dk/dv) a block owns
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
// dQ stays in registers for the whole walk; the epilogue scales it and
// writes it in T, or with kAcc adds it, unrounded, into an fp32 buffer.
// ---------------------------------------------------------------------
template <typename T, int kD, bool kAcc>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdRows rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dq, int sq, int sk, int hq, int hkv, int d,
    int q_offset, int kv_offset, int causal, float scale) {
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
    mbar_fence_init();
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
        put2<T, kAcc>(dq + at, scale * acc[4 * j + 2 * r],
                      scale * acc[4 * j + 2 * r + 1]);
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
template <typename T, int kD, bool kAcc>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // boxes of kBwdStep rows
    const __grid_constant__ CUtensorMap tm_k,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_v,   // boxes of kBwdRows rows
    const __grid_constant__ CUtensorMap tm_do,  // boxes of kBwdStep rows
    const float* __restrict__ lse, const float* __restrict__ dm,
    Out<T, kAcc>* __restrict__ dk, Out<T, kAcc>* __restrict__ dv, int sq,
    int sk, int hq, int hkv, int d, int q_offset, int kv_offset, int causal,
    float scale) {
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
    mbar_fence_init();
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
        put2<T, kAcc>(dk + at, scale * dk_acc[4 * j + 2 * r],
                      scale * dk_acc[4 * j + 2 * r + 1]);
        put2<T, kAcc>(dv + at, dv_acc[4 * j + 2 * r],
                      dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Forward, 16-bit inputs. Grid (q tiles of kFwdRows, hq, b), heaviest
// causal tiles first. Two consumer warpgroups own rows [64 w, 64 w + 64)
// of the tile; a producer warp loads the Q tile once and streams K and
// V tiles of kWalkKeys keys through a kFwdStages-stage ring, refilling
// a stage as soon as both warpgroups have freed it. Each warpgroup walks
// the tiles its own last row can see (hopper.cuh, walk) and frees the
// rest (walk_skip): the one below the diagonal walks one tile fewer and
// never waits for the other. The epilogue writes out and lse straight
// from registers.
// ---------------------------------------------------------------------
constexpr int kFwdRows = 128;
constexpr int kFwdThreads = 288;  // two consumer warpgroups + a producer warp
// Stages of the K/V ring. Overridable with -D (kernels/autotune.py builds
// such variants); the default build takes 4.
#ifndef TPUHPC_FWD_STAGES
#define TPUHPC_FWD_STAGES 4
#endif
constexpr int kFwdStages = TPUHPC_FWD_STAGES;

template <int kD>
constexpr size_t fwd_smem_bytes() {
  return kFwdRows * kD * 2 + 2 * kFwdStages * walk_tile_bytes<kD>() +
         (1 + 3 * kFwdStages) * 8 + 1024;
}
// The producer refills a stage while the consumers read the other: one
// stage would serialize the load and the products.
static_assert(kFwdStages >= 2, "kFwdStages: the ring needs two stages");
static_assert(fwd_smem_bytes<128>() <= static_cast<size_t>(kMaxSmem),
              "kFwdStages: the Q tile and the K/V ring exceed 227 KB of "
              "shared memory at head_dim 128");

// The forward's mask for one thread: its two rows at global positions
// row[0], row[1]; the warpgroup's first row at `first`.
struct FwdMask {
  int row[2];
  int first;
  int sk, kv_offset, causal;
  __device__ __forceinline__ bool edge(int kt) const {
    const int k_last = kt * kWalkKeys + kWalkKeys - 1;
    return k_last >= sk || (causal && kv_offset + k_last > first);
  }
  __device__ __forceinline__ bool sees(int r, int key) const {
    return visible(row[r], key, sk, kv_offset, causal);
  }
};

template <typename T, int kD>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // boxes of kFwdRows rows
    const __grid_constant__ CUtensorMap tm_k,  // boxes of kWalkKeys rows
    const __grid_constant__ CUtensorMap tm_v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int hq,
    int hkv, int d, int q_offset, int kv_offset, int causal, float scale) {
  constexpr int kQ = kFwdRows * kD * 2;  // bytes of the Q tile
  constexpr int kTile = walk_tile_bytes<kD>();
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * kFwdRows;
  const int q_rows = min(kFwdRows, sq - q0);
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  WalkRing ring;
  ring.k = s_q + kQ;
  ring.v = ring.k + kFwdStages * kTile;
  const uint32_t bar_q = ring.v + kFwdStages * kTile;
  ring.full_k = bar_q + 8;
  ring.full_v = ring.full_k + 8 * kFwdStages;
  ring.empty = ring.full_v + 8 * kFwdStages;
  ring.stages = kFwdStages;

  const int n_kt = kv_tiles(sk, kWalkKeys, q_offset + q0 + q_rows - 1,
                            kv_offset, causal);
  if (threadIdx.x == 0) {
    mbar_init(bar_q);
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(ring.full_k + 8 * st);
      mbar_init(ring.full_v + 8 * st);
      mbar_init(ring.empty + 8 * st, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(bar_q, kQ);
      tma_tile<kD>(s_q, &tm_q, bar_q, h, q0, b, kFwdRows);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kFwdStages;
        if (kt >= kFwdStages)
          mbar_wait(ring.empty + 8 * st, (kt / kFwdStages - 1) & 1);
        mbar_expect_tx(ring.full_k + 8 * st, kTile);
        tma_tile<kD>(ring.k + st * kTile, &tm_k, ring.full_k + 8 * st, kvh,
                     kt * kWalkKeys, b, kWalkKeys);
        mbar_expect_tx(ring.full_v + 8 * st, kTile);
        tma_tile<kD>(ring.v + st * kTile, &tm_v, ring.full_v + 8 * st, kvh,
                     kt * kWalkKeys, b, kWalkKeys);
      }
    }
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
  walk<T, kD>(rows, s_q, kFwdRows, 64 * wg, ring, n_wg, scale * kLog2e, mask);

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
}

// Dynamic shared memory of each float32 kernel, in bytes: the input
// tiles first, then the fp32 buffers.
size_t f32_smem_bytes(int which, int d) {
  constexpr int BR = kF32Rows;
  const size_t ld = d + kF32Pad;
  const size_t ldp = BR + kF32Pad;
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
  return (t_elems + f_elems) * sizeof(float);
}

bool shapes_ok(int b, int sq, int sk, int hq, int hkv, int d) {
  return b > 0 && sq > 0 && sk > 0 && hkv > 0 && hq % hkv == 0 && d > 0 &&
         d % 16 == 0 && d <= kMaxHeadDim && b <= 65535 && hq <= 65535;
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

template <typename T, int kD, bool kAcc>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dm, void* dq,
                    int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
                    int kv_offset, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err =
      bwd_maps<T>(m, q, k, v, dout, b, sq, sk, hq, hkv, d, kBwdRows, kBwdStep);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = bwd_smem_bytes<kD>();
  auto kernel = flash_dq_wgmma_kernel<T, kD, kAcc>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kBwdRows - 1) / kBwdRows, hq, b), kBwdThreads, smem,
           stream>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                     static_cast<const float*>(dm),
                     static_cast<Out<T, kAcc>*>(dq), sq, sk, hq, hkv, d,
                     q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD, bool kAcc>
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
  auto kernel = flash_dkv_wgmma_kernel<T, kD, kAcc>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sk + kBwdRows - 1) / kBwdRows, hkv, b), kBwdThreads, smem,
           stream>>>(m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
                     static_cast<const float*>(dm),
                     static_cast<Out<T, kAcc>*>(dk),
                     static_cast<Out<T, kAcc>*>(dv), sq, sk, hq, hkv, d,
                     q_offset, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, float scale,
                     cudaStream_t stream) {
  CUtensorMap m[3];
  cudaError_t err = bshd_map<T>(&m[0], q, b, sq, hq, d, kFwdRows);
  if (err == cudaSuccess) err = bshd_map<T>(&m[1], k, b, sk, hkv, d, kWalkKeys);
  if (err == cudaSuccess) err = bshd_map<T>(&m[2], v, b, sk, hkv, d, kWalkKeys);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = fwd_smem_bytes<kD>();
  auto kernel = flash_fwd_wgmma_kernel<T, kD>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((sq + kFwdRows - 1) / kFwdRows, hq, b), kFwdThreads, smem,
           stream>>>(m[0], m[1], m[2], static_cast<T*>(out),
                     static_cast<float*>(lse), sq, sk, hq, hkv, d, q_offset,
                     kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// 16-bit inputs take the wgmma kernels (kD 64 for d <= 64, else 128);
// float32 inputs the scalar-FMA walk. `accumulate` (16-bit backward
// only) adds the result into an fp32 buffer instead of writing it in T.
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
               int b, int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return d <= 64 ? launch_fwd_wgmma<T, 64>(q, k, v, out, lse, b, sq, sk, hq,
                                             hkv, d, q_offset, kv_offset,
                                             causal, scale, stream)
                   : launch_fwd_wgmma<T, 128>(q, k, v, out, lse, b, sq, sk, hq,
                                              hkv, d, q_offset, kv_offset,
                                              causal, scale, stream);
  } else {
    constexpr int BR = kF32Rows;
    const size_t smem = f32_smem_bytes(0, d);
    auto kernel = flash_fwd_kernel<T>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((sq + BR - 1) / BR, hq, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
        sq, sk, hq, hkv, d, q_offset, kv_offset, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, bool kAcc>
int launch_dq_16(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dm, void* dq, int b, int sq,
                 int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                 int causal, float scale, cudaStream_t stream) {
  return d <= 64 ? launch_dq_wgmma<T, 64, kAcc>(q, k, v, dout, lse, dm, dq, b,
                                                sq, sk, hq, hkv, d, q_offset,
                                                kv_offset, causal, scale, stream)
                 : launch_dq_wgmma<T, 128, kAcc>(q, k, v, dout, lse, dm, dq, b,
                                                 sq, sk, hq, hkv, d, q_offset,
                                                 kv_offset, causal, scale,
                                                 stream);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dm, void* dq, int b, int sq, int sk,
              int hq, int hkv, int d, int q_offset, int kv_offset, int causal,
              int accumulate, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return accumulate
               ? launch_dq_16<T, true>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                       hq, hkv, d, q_offset, kv_offset, causal,
                                       scale, stream)
               : launch_dq_16<T, false>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                        hq, hkv, d, q_offset, kv_offset, causal,
                                        scale, stream);
  } else {
    if (accumulate) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int BR = kF32Rows;
    const size_t smem = f32_smem_bytes(1, d);
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

template <typename T, bool kAcc>
int launch_dkv_16(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dm, void* dk,
                  void* dv, int b, int sq, int sk, int hq, int hkv, int d,
                  int q_offset, int kv_offset, int causal, float scale,
                  cudaStream_t stream) {
  return d <= 64 ? launch_dkv_wgmma<T, 64, kAcc>(q, k, v, dout, lse, dm, dk,
                                                 dv, b, sq, sk, hq, hkv, d,
                                                 q_offset, kv_offset, causal,
                                                 scale, stream)
                 : launch_dkv_wgmma<T, 128, kAcc>(q, k, v, dout, lse, dm, dk,
                                                  dv, b, sq, sk, hq, hkv, d,
                                                  q_offset, kv_offset, causal,
                                                  scale, stream);
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dm, void* dk, void* dv, int b,
               int sq, int sk, int hq, int hkv, int d, int q_offset,
               int kv_offset, int causal, int accumulate, float scale,
               cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return accumulate
               ? launch_dkv_16<T, true>(q, k, v, dout, lse, dm, dk, dv, b, sq,
                                        sk, hq, hkv, d, q_offset, kv_offset,
                                        causal, scale, stream)
               : launch_dkv_16<T, false>(q, k, v, dout, lse, dm, dk, dv, b, sq,
                                         sk, hq, hkv, d, q_offset, kv_offset,
                                         causal, scale, stream);
  } else {
    if (accumulate) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int BR = kF32Rows;
    const size_t smem = f32_smem_bytes(2, d);
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

// The backward entries' `accumulate`: 1 adds the result into fp32
// buffers (16-bit inputs only), 0 writes it in the input dtype.
int tpuhpc_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dm, void* dq, int b, int sq,
                    int sk, int hq, int hkv, int d, int q_offset, int kv_offset,
                    int causal, int accumulate, float scale, int dtype,
                    void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dq<T>(q, k, v, dout, lse, dm, dq, b, sq, sk,
                                            hq, hkv, d, q_offset, kv_offset, causal,
                                            accumulate, scale,
                                            static_cast<cudaStream_t>(stream)))
}

int tpuhpc_flash_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dm, void* dk,
                     void* dv, int b, int sq, int sk, int hq, int hkv, int d,
                     int q_offset, int kv_offset, int causal, int accumulate,
                     float scale, int dtype, void* stream) {
  if (!shapes_ok(b, sq, sk, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  TPUHPC_FLASH_DISPATCH(dtype,
                        return launch_dkv<T>(q, k, v, dout, lse, dm, dk, dv, b, sq,
                                             sk, hq, hkv, d, q_offset, kv_offset,
                                             causal, accumulate, scale,
                                             static_cast<cudaStream_t>(stream)))
}

// Rows a block of `kernel` (0 forward, 1 dq, 2 dk/dv) owns for a dtype
// code -- q rows for the forward and dq, keys for dk/dv -- or 0 for an
// unknown code; kernels/attention.py::flash_tile_rows reads it.
int tpuhpc_flash_tile_rows(int kernel, int dtype) {
  if (kernel < 0 || kernel > 2) return 0;
  switch (dtype) {
    case kF32: return kF32Rows;
    case kF16:
    case kBF16: return kernel == 0 ? kFwdRows : kBwdRows;
    default: return 0;
  }
}

}  // extern "C"
