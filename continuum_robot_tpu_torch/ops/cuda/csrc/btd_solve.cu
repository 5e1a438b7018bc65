// Block-tridiagonal (3x3 blocks) solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel btd_solve_pallas of
// continuum_robot_tpu/ops/pallas/btd_solve.py (kernel body _solve_kernel). It solves
// T x = r for B right-hand sides against one shared, prefactored block-tridiagonal T
// (the factors of btd_factor in ops/banded.py):
//   forward   y_0 = r_0,                 y_i = r_i - W_{i-1} y_{i-1}      (W = lw)
//   backward  x_{N-1} = Dinv_{N-1} y_{N-1},  x_i = Dinv_i (y_i - U_i x_{i+1})
//
// Layout: r and x are the env-major (B, 3N) rows of the implicit operator (row b
// holds node 0's three DOFs, then node 1's, ...), straight from its zero padding with
// no transpose; the factors are row-major 3x3 blocks, (N, 9), (N-1, 9), (N-1, 9). The
// TPU kernel's (3N8, TB) transpose, 8-node groups, identity padding and unrolled group
// recursion are Mosaic layout rules with no counterpart here.
//
// Design: one thread per environment walks the nodes; a block holds 32 environments,
// swept by its first warp, and four warps that copy. The node recursion is a dependent
// chain, so the block streams its rows through shared memory in chunks of 128 nodes (64
// in double) with cp.async, double-buffered: the loads of the next chunk (coalesced: a
// warp's lanes read consecutive elements of one row) are in flight while the current
// chunk is swept.
// Each chunk's factors are staged beside it; the sweeping threads read the same factor
// element, a shared-memory broadcast, one node ahead of the chain. The forward sweep
// writes y in place in the staged chunk and stores it to the output; the backward sweep
// reads y back from there (in place, as the TPU kernel does) and overwrites it with x.
// The last chunk's y never leaves shared memory. Staged rows are padded by one element
// so the warp's 32 rows fall in 32 different banks.
//
// Bound: the least traffic is one read of r and one write of x, 2 * B * 3N elements
// (98.4 MB in float32 at B=4096, N=1001: 0.029 ms at 3.35 TB/s); the arithmetic is 51
// operations per node per environment (2.1e8 in all, 3 us at 67 TFLOP/s), so the kernel
// is bound by bytes. At B=4096 there is one sweeping warp per SM: the chain of 2N
// dependent node steps, each a few dozen instructions from that warp, sets the
// time (sweeps alone, without the copies, take two thirds of it on an H100), and y
// moves through device memory once more each way.
//
// Rounding: every multiply and add goes through the _rn intrinsics, which the compiler
// never contracts into a fused multiply-add, and each row of a 3x3 product is summed as
// acc = m0*v0; acc += m1*v1; acc += m2*v2, the order of btd_solve in ops/banded.py, so
// kernel and plain version agree bit for bit in float and double.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream, and checks the returned cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

constexpr int kEnvs = 32;   // environments per block: warp 0 sweeps them
constexpr int kWarps = 4;   // all four warps copy and store
constexpr int kThreads = 32 * kWarps;

// Nodes per staged chunk: as many as two buffers of float rows fit (117 KB of
// shared memory either way); longer chunks mean fewer block-wide barriers.
template <typename T>
struct Chunk {
  static constexpr int kNodes = sizeof(T) == 4 ? 128 : 64;
  static constexpr int kStride = 3 * kNodes + 1;  // staged row, padded against bank conflicts
  static constexpr int kFactors = 18 * kNodes;    // staged factors: 2 x 9 per node
  static constexpr size_t kBytes = (2 * kEnvs * kStride + 2 * kFactors) * sizeof(T);
};

// One row of a 3x3 product: m[0]*v0 + m[1]*v1 + m[2]*v2, summed from the left.
template <typename T>
__device__ __forceinline__ T row(const T* m, T v0, T v1, T v2) {
  return add(add(mul(m[0], v0), mul(m[1], v1)), mul(m[2], v2));
}

// Block-cooperative asynchronous copy of count elements, global -> shared.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
}

// Asynchronous copy of nb rows of count elements (global row stride row_len) into
// staged rows: warp w takes rows w, w + kWarps, ..., its lanes consecutive elements.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* rows, const T* src, int64_t row_len, int nb,
                                                int count) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < nb; e += kWarps)
    for (int i = lane; i < count; i += 32)
      __pipeline_memcpy_async(rows + e * Chunk<T>::kStride + i, src + e * row_len + i,
                              sizeof(T));
}

// Store of nb staged rows of count elements to global, split as copy_rows_async.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_len, const T* rows, int nb,
                                           int count) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < nb; e += kWarps)
    for (int i = lane; i < count; i += 32)
      dst[e * row_len + i] = rows[e * Chunk<T>::kStride + i];
}

template <typename T>
__device__ __forceinline__ void load9(T* dst, const T* src) {
#pragma unroll
  for (int k = 0; k < 9; ++k) dst[k] = src[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    btd_solve_kernel(int B, int N, const T* __restrict__ dinv, const T* __restrict__ lw,
                     const T* __restrict__ up, const T* __restrict__ rhs, T* out) {
  constexpr int kChunk = Chunk<T>::kNodes, kStride = Chunk<T>::kStride;
  constexpr int kFactors = Chunk<T>::kFactors;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const fac0 = smem + 2 * kEnvs * kStride;
  // Buffer s: staged rows at smem + s * kEnvs * kStride, factors at fac0 + s * kFactors.

  const int env0 = blockIdx.x * kEnvs;
  const int nb = min(kEnvs, B - env0);
  const int t = threadIdx.x;
  const int64_t row_len = 3LL * N;
  const T* rhs_blk = rhs + env0 * row_len;
  T* out_blk = out + env0 * row_len;
  const int n_chunks = (N + kChunk - 1) / kChunk;

  // ---- forward sweep: chunk k in buffer k & 1 ----
  // Node n uses lw[n - 1], staged at fac + 9 * (n - n0); node 0 uses none.
  auto stage_fwd = [&](int k) {
    const int s = k & 1, n0 = k * kChunk, cn = min(kChunk, N - n0);
    copy_rows_async(smem + s * kEnvs * kStride, rhs_blk + 3LL * n0, row_len, nb, 3 * cn);
    const int j0 = n0 == 0 ? 1 : 0;
    copy_async(fac0 + s * kFactors + 9 * j0, lw + 9LL * (n0 + j0 - 1), 9 * (cn - j0));
    __pipeline_commit();
  };

  T y0 = T(0), y1 = T(0), y2 = T(0);
  stage_fwd(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage_fwd(k + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int s = k & 1, n0 = k * kChunk, cn = min(kChunk, N - n0);
    T* const rows = smem + s * kEnvs * kStride;
    if (t < nb) {
      T* r = rows + t * kStride;
      const T* w = fac0 + s * kFactors;
      int j = 0;
      if (n0 == 0) {  // y_0 = r_0
        y0 = r[0];
        y1 = r[1];
        y2 = r[2];
        j = 1;
      }
      // Node j's operands are loaded one node ahead, so their shared-memory
      // latency overlaps the dependent chain of the node before.
      T m[9], c0 = T(0), c1 = T(0), c2 = T(0);
      if (j < cn) {
        load9(m, w + 9 * j);
        c0 = r[3 * j];
        c1 = r[3 * j + 1];
        c2 = r[3 * j + 2];
      }
#pragma unroll 2
      for (; j < cn; ++j) {
        T mn[9], n0v = T(0), n1v = T(0), n2v = T(0);
        if (j + 1 < cn) {
          load9(mn, w + 9 * (j + 1));
          n0v = r[3 * j + 3];
          n1v = r[3 * j + 4];
          n2v = r[3 * j + 5];
        }
        const T a0 = sub(c0, row(m, y0, y1, y2));
        const T a1 = sub(c1, row(m + 3, y0, y1, y2));
        const T a2 = sub(c2, row(m + 6, y0, y1, y2));
        r[3 * j] = a0;
        r[3 * j + 1] = a1;
        r[3 * j + 2] = a2;
        y0 = a0;
        y1 = a1;
        y2 = a2;
#pragma unroll
        for (int q = 0; q < 9; ++q) m[q] = mn[q];
        c0 = n0v;
        c1 = n1v;
        c2 = n2v;
      }
    }
    __syncthreads();
    // The last chunk's y stays in shared memory for the backward sweep.
    if (k + 1 < n_chunks) store_rows(out_blk + 3LL * n0, row_len, rows, nb, 3 * cn);
    __syncthreads();
  }

  // ---- backward sweep: iteration it takes chunk n_chunks - 1 - it, in buffer
  // (it + last) & 1, so that iteration 0 finds the forward sweep's last chunk ----
  // Node n uses dinv[n] at fac + 9 * (n - n0) and up[n] (n < N - 1) at
  // fac + 9 * kChunk + 9 * (n - n0).
  const int last = (n_chunks - 1) & 1;
  auto stage_bwd = [&](int it, bool with_rows) {
    const int s = (it + last) & 1, n0 = (n_chunks - 1 - it) * kChunk;
    const int cn = min(kChunk, N - n0);
    if (with_rows)
      copy_rows_async(smem + s * kEnvs * kStride, out_blk + 3LL * n0, row_len, nb, 3 * cn);
    copy_async(fac0 + s * kFactors, dinv + 9LL * n0, 9 * cn);
    copy_async(fac0 + s * kFactors + 9 * kChunk, up + 9LL * n0, 9 * min(cn, N - 1 - n0));
    __pipeline_commit();
  };

  T x0 = T(0), x1 = T(0), x2 = T(0);
  stage_bwd(0, false);
  for (int it = 0; it < n_chunks; ++it) {
    if (it + 1 < n_chunks) {
      stage_bwd(it + 1, true);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int s = (it + last) & 1, n0 = (n_chunks - 1 - it) * kChunk;
    const int cn = min(kChunk, N - n0);
    T* const rows = smem + s * kEnvs * kStride;
    if (t < nb) {
      T* r = rows + t * kStride;
      const T* d = fac0 + s * kFactors;
      const T* u = d + 9 * kChunk;
      int j = cn - 1;
      if (n0 + j == N - 1) {  // x_{N-1} = Dinv_{N-1} y_{N-1}
        const T* m = d + 9 * j;
        const T a0 = r[3 * j], a1 = r[3 * j + 1], a2 = r[3 * j + 2];
        x0 = row(m, a0, a1, a2);
        x1 = row(m + 3, a0, a1, a2);
        x2 = row(m + 6, a0, a1, a2);
        r[3 * j] = x0;
        r[3 * j + 1] = x1;
        r[3 * j + 2] = x2;
        --j;
      }
      // Operands one node ahead, as in the forward sweep.
      T mu[9], md[9], c0 = T(0), c1 = T(0), c2 = T(0);
      if (j >= 0) {
        load9(mu, u + 9 * j);
        load9(md, d + 9 * j);
        c0 = r[3 * j];
        c1 = r[3 * j + 1];
        c2 = r[3 * j + 2];
      }
#pragma unroll 2
      for (; j >= 0; --j) {
        T nu[9], nd[9], n0v = T(0), n1v = T(0), n2v = T(0);
        if (j > 0) {
          load9(nu, u + 9 * (j - 1));
          load9(nd, d + 9 * (j - 1));
          n0v = r[3 * j - 3];
          n1v = r[3 * j - 2];
          n2v = r[3 * j - 1];
        }
        const T a0 = sub(c0, row(mu, x0, x1, x2));
        const T a1 = sub(c1, row(mu + 3, x0, x1, x2));
        const T a2 = sub(c2, row(mu + 6, x0, x1, x2));
        x0 = row(md, a0, a1, a2);
        x1 = row(md + 3, a0, a1, a2);
        x2 = row(md + 6, a0, a1, a2);
        r[3 * j] = x0;
        r[3 * j + 1] = x1;
        r[3 * j + 2] = x2;
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          mu[q] = nu[q];
          md[q] = nd[q];
        }
        c0 = n0v;
        c1 = n1v;
        c2 = n2v;
      }
    }
    __syncthreads();
    store_rows(out_blk + 3LL * n0, row_len, rows, nb, 3 * cn);
    __syncthreads();
  }
}

template <typename T>
int launch(int B, int N, const void* dinv, const void* lw, const void* up, const void* rhs,
           void* out, cudaStream_t stream) {
  constexpr size_t smem = Chunk<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      btd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  btd_solve_kernel<T><<<(B + kEnvs - 1) / kEnvs, kThreads, smem, stream>>>(
      B, N, static_cast<const T*>(dinv), static_cast<const T*>(lw), static_cast<const T*>(up),
      static_cast<const T*>(rhs), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. B >= 1 right-hand sides of N >= 1 nodes; rhs and
// out are (B, 3N), dinv (N, 9), lw and up (N - 1, 9), all contiguous on one device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" {

int btd_solve_launch(int dtype, int B, int N, const void* dinv, const void* lw, const void* up,
                     const void* rhs, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(B, N, dinv, lw, up, rhs, out, st);
  return launch<double>(B, N, dinv, lw, up, rhs, out, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
