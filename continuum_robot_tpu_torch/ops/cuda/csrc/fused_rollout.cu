// Fused small-beam generalized-alpha steps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_gen_alpha_steps of
// continuum_robot_tpu/ops/pallas/fused_rollout.py (kernel body _make_kernel). For a
// linear beam of n reduced DOFs with quadratic fluid drag and a constant input u it
// advances B environments' states [q; v; a] by `steps` generalized-alpha steps, each
// with n_newton modified-Newton iterations on the end-of-step acceleration a1:
//   q_pred = q + h v + (1/2 - beta) h^2 a,   v_pred = v + (1 - gamma) h a,   a1 = a
//   repeat n_newton times:
//     q1 = q_pred + beta h^2 a1,   v1 = v_pred + gamma h a1
//     q_af = (1 - af) q1 + af q,   v_af = (1 - af) v1 + af v,   a_am = (1 - am) a1 + am a
//     f_drag = -c v_af |v_af|,     r = M a_am + K q_af - f_drag - u,   a1 -= Jinv r
//   q = q_pred + beta h^2 a1,   v = v_pred + gamma h a1,   a = a1
// with dense (n, n) M, K and Jinv = ((1 - am) M + (1 - af) beta h^2 K)^-1, prefactored
// on the host. Device memory is read once and written once per launch; every step
// runs on chip.
//
// Layout: x and out are the env-major (B, 3n) rows of the states (row b holds q, then
// v, then a), read straight as they are; M, K, Jinv are row-major (n, n). The TPU
// kernel's padding of n to a multiple of 8 and of B to the tile, and its (3n, B)
// transpose, are Mosaic layout rules with no counterpart here.
//
// Design: one warp per environment, one lane per DOF row (rows lane, lane + 32, ... up
// to R rows a lane, R a template argument, so a lane's per-row values stay in
// registers). A block of kWarps warps stages the three matrices once, transposed, in
// shared memory, so that lane i reads A[i][j] at j * n + i: consecutive lanes read
// consecutive words, with no bank conflict. The three vectors that a matrix product
// reads in full (a_am, q_af, r) go through the warp's own slice of shared memory, where
// x_j is one broadcast read, with __syncwarp() between the phases.
//
// Bound: per environment-step n (10 + n_newton (6n + 17)) operations (4680 at n = 18
// and two Newton iterations), so a launch at B = 4096, 20 steps is 3.8e8 operations
// (5.7 us at 67 TFLOP/s in float32) against 1.77 MB moved (0.5 us at 3.35 TB/s): bound
// by operations. The three matrix products are 3 n (2n - 1) of them; with a lane a row,
// 14 of 32 lanes idle at n = 18, and each product term is two shared-memory reads and
// two dependent instructions. On an H100 (700 W) a launch takes 0.11 ms, 19x the
// bound, and in double only 1.14x as long as in float: the latency of the lanes'
// dependent chains, not shared-memory bytes or the arithmetic rate, sets the time.
//
// Rounding: every multiply and add goes through the _rn intrinsics, which the compiler
// never contracts into a fused multiply-add, each product row is summed from j = 0
// upward, and the step scalars arrive rounded once on the host: the order of
// fused_gen_alpha_steps_plain in ops/cuda/fused_rollout.py, so kernel and plain version
// agree bit for bit in float and double.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream, checks sizes (n up to the shared memory of one block), and
// checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }

constexpr int kWarps = 8;  // environments per block
constexpr int kThreads = 32 * kWarps;
// Rows per lane, n <= 32 R: one block's shared memory caps n at 135 in float and 94
// in double (the wrapper checks), so R stops at 5 and 3.
template <typename T>
constexpr int kMaxRows = sizeof(T) == 4 ? 5 : 3;

// The step's scalars, rounded to T on the host side of the launch.
template <typename T>
struct Coeffs {
  T h, c_qp, c_vp, bh2, gh, w_af1, w_af, w_am1, w_am;
};

// acc[k] = sum_j A[i][j] x[j] for the lane's rows i = lane + 32 k, from j = 0 upward;
// At is A transposed (At[j * n + i] = A[i][j]). Rows past n repeat row n - 1 (a
// broadcast read) and their sums are never stored.
template <typename T, int R>
__device__ __forceinline__ void matvec(const T* At, const T* x, int n, int lane, T (&acc)[R]) {
  int rows[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    rows[k] = min(lane + 32 * k, n - 1);
    acc[k] = mul(At[rows[k]], x[0]);
  }
  for (int j = 1; j < n; ++j) {
    const T xj = x[j];
    const T* col = At + j * n;
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = add(acc[k], mul(col[rows[k]], xj));
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    fused_gen_alpha_kernel(int B, int n, int steps, int n_newton, Coeffs<T> c,
                           const T* __restrict__ M, const T* __restrict__ K,
                           const T* __restrict__ Jinv, const T* __restrict__ drag,
                           const T* __restrict__ u, const T* __restrict__ x,
                           T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Mt = reinterpret_cast<T*>(smem_raw);
  T* const Kt = Mt + n * n;
  T* const Jt = Kt + n * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* const s_am = Jt + n * n + warp * 3 * n;  // the warp's broadcast vectors
  T* const s_af = s_am + n;
  T* const s_r = s_af + n;

  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    Mt[j * n + i] = M[e];
    Kt[j * n + i] = K[e];
    Jt[j * n + i] = Jinv[e];
  }
  __syncthreads();  // the block's only barrier: warps past B may leave after it

  const int env = blockIdx.x * kWarps + warp;
  if (env >= B) return;
  const T* xb = x + static_cast<int64_t>(env) * 3 * n;

  T q[R], v[R], a[R], ncd[R], uu[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + 32 * k;
    const bool on = i < n;
    q[k] = on ? xb[i] : T(0);
    v[k] = on ? xb[n + i] : T(0);
    a[k] = on ? xb[2 * n + i] : T(0);
    ncd[k] = on ? -drag[i] : T(0);
    uu[k] = on ? u[i] : T(0);
  }

  for (int s = 0; s < steps; ++s) {
    T qp[R], vp[R], a1[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      qp[k] = add(add(q[k], mul(c.h, v[k])), mul(c.c_qp, a[k]));
      vp[k] = add(v[k], mul(c.c_vp, a[k]));
      a1[k] = a[k];
    }
    for (int it = 0; it < n_newton; ++it) {
      T fd[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const T q1 = add(qp[k], mul(c.bh2, a1[k]));
        const T v1 = add(vp[k], mul(c.gh, a1[k]));
        const T q_af = add(mul(c.w_af1, q1), mul(c.w_af, q[k]));
        const T v_af = add(mul(c.w_af1, v1), mul(c.w_af, v[k]));
        const T a_am = add(mul(c.w_am1, a1[k]), mul(c.w_am, a[k]));
        fd[k] = mul(mul(ncd[k], v_af), absval(v_af));
        const int i = lane + 32 * k;
        if (i < n) {
          s_am[i] = a_am;
          s_af[i] = q_af;
        }
      }
      __syncwarp();
      T ma[R], kq[R];
      matvec<T, R>(Mt, s_am, n, lane, ma);
      matvec<T, R>(Kt, s_af, n, lane, kq);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = lane + 32 * k;
        if (i < n) s_r[i] = sub(sub(add(ma[k], kq[k]), fd[k]), uu[k]);
      }
      __syncwarp();
      T d[R];
      matvec<T, R>(Jt, s_r, n, lane, d);
#pragma unroll
      for (int k = 0; k < R; ++k) a1[k] = sub(a1[k], d[k]);
      __syncwarp();  // every lane is done reading s_r before the next iteration
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      q[k] = add(qp[k], mul(c.bh2, a1[k]));
      v[k] = add(vp[k], mul(c.gh, a1[k]));
      a[k] = a1[k];
    }
  }

  T* ob = out + static_cast<int64_t>(env) * 3 * n;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + 32 * k;
    if (i < n) {
      ob[i] = q[k];
      ob[n + i] = v[k];
      ob[2 * n + i] = a[k];
    }
  }
}

// Launches the instance with R = ceil(n / 32) rows per lane.
template <typename T, int R = 1>
int launch_rows(int B, int n, int steps, int n_newton, const Coeffs<T>& c, const void* M,
                const void* K, const void* Jinv, const void* drag, const void* u,
                const void* x, void* out, cudaStream_t stream) {
  if ((n + 31) / 32 != R) {
    if constexpr (R < kMaxRows<T>)
      return launch_rows<T, R + 1>(B, n, steps, n_newton, c, M, K, Jinv, drag, u, x, out, stream);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (3 * static_cast<size_t>(n) * n + kWarps * 3 * n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(fused_gen_alpha_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gen_alpha_kernel<T, R><<<(B + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      B, n, steps, n_newton, c, static_cast<const T*>(M), static_cast<const T*>(K),
      static_cast<const T*>(Jinv), static_cast<const T*>(drag), static_cast<const T*>(u),
      static_cast<const T*>(x), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int B, int n, int steps, int n_newton, const double* s, const void* M,
           const void* K, const void* Jinv, const void* drag, const void* u, const void* x,
           void* out, cudaStream_t stream) {
  const Coeffs<T> c{T(s[0]), T(s[1]), T(s[2]), T(s[3]), T(s[4]),
                    T(s[5]), T(s[6]), T(s[7]), T(s[8])};
  return launch_rows<T>(B, n, steps, n_newton, c, M, K, Jinv, drag, u, x, out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. B >= 1 environments of n >= 1 DOFs, the matrices
// within one block's shared memory (n <= 135 in float, 94 in double; larger n returns
// cudaErrorInvalidValue); x and out are (B, 3n), M, K, Jinv (n, n),
// drag and u (n,), all contiguous on one device. The nine step scalars (h, (1/2 - beta)
// h^2, (1 - gamma) h, beta h^2, gamma h, 1 - af, af, 1 - am, am) are exact in the dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" {

int fused_gen_alpha_launch(int dtype, int B, int n, int steps, int n_newton, double h,
                           double c_qp, double c_vp, double bh2, double gh, double w_af1,
                           double w_af, double w_am1, double w_am, const void* M,
                           const void* K, const void* Jinv, const void* drag, const void* u,
                           const void* x, void* out, void* stream) {
  const double s[9] = {h, c_qp, c_vp, bh2, gh, w_af1, w_af, w_am1, w_am};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(B, n, steps, n_newton, s, M, K, Jinv, drag, u, x, out, st);
  return launch<double>(B, n, steps, n_newton, s, M, K, Jinv, drag, u, x, out, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
