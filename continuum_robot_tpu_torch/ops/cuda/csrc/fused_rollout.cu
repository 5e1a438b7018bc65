// Fused small-beam generalized-alpha steps for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_gen_alpha_steps of
// continuum_robot_tpu/ops/pallas/fused_rollout.py (kernel body _make_kernel), and the
// lax.scan over it in that file's fused_rollout. For a linear beam of n reduced DOFs
// with quadratic fluid drag and a constant input u it advances B environments' states
// [q; v; a] by generalized-alpha steps, each with n_newton modified-Newton iterations
// on the end-of-step acceleration a1:
//   q_pred = q + h v + (1/2 - beta) h^2 a,   v_pred = v + (1 - gamma) h a,   a1 = a
//   repeat n_newton times:
//     q1 = q_pred + beta h^2 a1,   v1 = v_pred + gamma h a1
//     q_af = (1 - af) q1 + af q,   v_af = (1 - af) v1 + af v,   a_am = (1 - am) a1 + am a
//     f_drag = -c v_af |v_af|,     r = M a_am + K q_af - f_drag - u,   a1 -= Jinv r
//   q = q_pred + beta h^2 a1,   v = v_pred + gamma h a1,   a = a1
// with dense (n, n) M, K and Jinv = ((1 - am) M + (1 - af) beta h^2 K)^-1, prefactored
// on the host. One launch runs n_frames frames of `substeps` steps with the state on
// chip throughout: it writes the final state (B, 3n) and, if asked, every frame's
// [q; v] into a (n_frames + 1, B, 2n) array whose frame 0 is the start. The per-call
// kernel is one frame of `steps` steps; the whole rollout is one launch.
//
// Layout: x and out are the env-major (B, 3n) rows of the states (row b holds q, then
// v, then a), read straight as they are; M, K, Jinv are row-major (n, n).
//
// Bound: per environment-step n (10 + n_newton (6n + 17)) operations (4680 at n = 18
// and two Newton iterations), most of them the products' multiply-add pairs. A launch
// at B = 4096, 20 steps is 3.83e8 operations: 5.7 us at the float32 peak of 67e12 a
// second (a pair as one FMA), against 1.77 MB moved (0.5 us at 3.35 TB/s), so bound by
// the operations. The _rn intrinsics below are never contracted into FMAs, which keeps
// the kernel bit-equal to its plain version: each operation is one FP32 instruction,
// and the instruction rate (132 SMs x 128 lanes x 1.98 GHz = 3.35e13 a second) puts
// this kernel's own floor at 11.5 us, twice the bound. The whole rollout (250 frames x
// 20 steps) writes 148 MB of frames, 44 us, far below either.
//
// Design, rows instance (n <= 36 in float, 24 in double): one thread owns one DOF row
// i for E environments (E = kEnvs: 2 in float, 3 in double, chosen by measurement,
// chip_variants.py --fused). Its rows of M, K and Jinv sit in registers, loaded once a
// launch, and the products' column loop is unrolled at compile time (the kernel is a
// template on n rounded up to a multiple of 3, NP; the last two columns are skipped
// at run time past n). A block holds `groups` env groups of n threads each, laid out
// thread t -> (row t % n, group t / n), so only the block's tail past groups * n
// lanes idles. The vectors a whole product reads (a_am, q_af, r) go through shared
// memory env-minor, [j][env]: one read (8 bytes in float, 16 + 8 in double) gives a
// thread x_j for its E environments, the threads of one group read one address (a
// broadcast), and a warp's reads touch two or three neighbouring slots, one
// wavefront. Each shared read so feeds E multiply-adds, and the M and K products run
// interleaved, 2E independent add chains. Two block barriers a Newton iteration
// separate the vectors' writes from their reads.
//
// What bounds it (H100, 700 W): at 4096 environments of n = 18 the work is 1152
// warps' worth for 528 schedulers, so the busiest schedulers run three warps'
// instructions while others run two; with one to three warps a scheduler, latency
// is not hidden either. More environments a thread give fewer warps but longer ones;
// at 65536 environments E = 4 would be faster. A warp per environment with the
// operators in shared memory (the lanes instance below) took 2.9x as long at 4096.
//
// Lanes instance (larger n, up to one block's shared memory: 135 in float, 94 in
// double): one warp per environment, one lane per DOF row (rows lane, lane + 32, ...,
// R rows a lane, R a template argument), the three matrices staged once, transposed,
// in shared memory, the vectors through the warp's own slice of it.
//
// Rounding: every multiply and add goes through the _rn intrinsics, each product row
// is summed from j = 0 upward, and the step scalars arrive rounded once on the host:
// the order of fused_gen_alpha_steps_plain in ops/cuda/fused_rollout.py, so kernel and
// plain version agree bit for bit in float and double, in either instance.
//
// The thread map (instance, E, env groups a block and their constants) is
// fused_geometry.h's, stated there once; the launch below follows it.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream, and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

#include "fused_geometry.h"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }

// The step's scalars, rounded to T on the host side of the launch.
template <typename T>
struct Coeffs {
  T h, c_qp, c_vp, bh2, gh, w_af1, w_af, w_am1, w_am;
};

template <typename T>
struct Args {
  int B, n, n_frames, substeps, n_newton;
  Coeffs<T> c;
  const T *M, *K, *Jinv, *drag, *u, *x;
  T* out;     // (B, 3n): the final states, or null
  T* frames;  // (n_frames + 1, B, 2n): every frame's [q; v], or null
};

// Writes [q; v] of row i of environment env into frame f.
template <typename T>
__device__ __forceinline__ void put_frame(const Args<T>& p, int f, int env, int i, T q,
                                          T v) {
  T* fr = p.frames + (static_cast<int64_t>(f) * p.B + env) * 2 * p.n;
  fr[i] = q;
  fr[p.n + i] = v;
}

// A thread's E values of one [j][env] row of a broadcast vector (a slot of kSlot<E>
// values, fused_geometry.h) move in as few shared accesses as the slot's alignment
// allows: 16 bytes each, then 8, then 4 (E = 4 in float: one 16-byte access; E = 5:
// 16 bytes and 4).
template <typename T, int K>
struct alignas(K * sizeof(T)) Piece {
  T v[K];
};

// The size, in values, of the access at offset O of E values.
template <typename T, int E, int O>
constexpr int kPiece = E - O >= int(16 / sizeof(T)) ? int(16 / sizeof(T))
                       : E - O >= int(8 / sizeof(T)) ? int(8 / sizeof(T)) : 1;

template <typename T, int E, int O = 0>
__device__ __forceinline__ void load_slot(const T* p, T (&x)[E]) {
  if constexpr (O < E) {
    constexpr int K = kPiece<T, E, O>;
    const Piece<T, K> v = *reinterpret_cast<const Piece<T, K>*>(p + O);
#pragma unroll
    for (int k = 0; k < K; ++k) x[O + k] = v.v[k];
    load_slot<T, E, O + K>(p, x);
  }
}

template <typename T, int E, int O = 0>
__device__ __forceinline__ void store_slot(T* p, const T (&x)[E]) {
  if constexpr (O < E) {
    constexpr int K = kPiece<T, E, O>;
    Piece<T, K> v;
#pragma unroll
    for (int k = 0; k < K; ++k) v.v[k] = x[O + k];
    *reinterpret_cast<Piece<T, K>*>(p + O) = v;
    store_slot<T, E, O + K>(p, x);
  }
}

// The one step of a Newton iteration that needs no neighbour: q1, v1, the alpha
// point and the drag of one (env, row).
template <typename T>
struct Point {
  T q_af, a_am, fd;
};

template <typename T>
__device__ __forceinline__ Point<T> alpha_point(const Coeffs<T>& c, T qp, T vp, T a1, T q,
                                                T v, T a, T ncd) {
  const T q1 = add(qp, mul(c.bh2, a1));
  const T v1 = add(vp, mul(c.gh, a1));
  const T v_af = add(mul(c.w_af1, v1), mul(c.w_af, v));
  return {add(mul(c.w_af1, q1), mul(c.w_af, q)), add(mul(c.w_am1, a1), mul(c.w_am, a)),
          mul(mul(ncd, v_af), absval(v_af))};
}

// ---------------------------------------------------------------------------
// Rows instance
// ---------------------------------------------------------------------------

// ya[e] = sum_j A[j] xa[j][e] and yc[e] = sum_j C[j] xc[j][e] for the thread's E
// environments, from j = 0 upward, the two sums interleaved; xa, xc point at the
// group's slot of column 0 and step ld a column. Columns past n (the last two of NP
// at most) are skipped.
template <typename T, int NP, int E>
__device__ __forceinline__ void matvec2(const T (&A)[NP], const T (&C)[NP], const T* xa,
                                        const T* xc, int ld, int n, T (&ya)[E],
                                        T (&yc)[E]) {
  T pa[E], pc[E];
  load_slot(xa, pa);
  load_slot(xc, pc);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ya[e] = mul(A[0], pa[e]);
    yc[e] = mul(C[0], pc[e]);
  }
#pragma unroll
  for (int j = 1; j < NP; ++j) {
    if (j >= NP - 2 && j >= n) break;
    load_slot(xa + j * ld, pa);
    load_slot(xc + j * ld, pc);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ya[e] = add(ya[e], mul(A[j], pa[e]));
      yc[e] = add(yc[e], mul(C[j], pc[e]));
    }
  }
}

template <typename T, int NP, int E>
__device__ __forceinline__ void matvec1(const T (&A)[NP], const T* x, int ld, int n,
                                        T (&y)[E]) {
  T p[E];
  load_slot(x, p);
#pragma unroll
  for (int e = 0; e < E; ++e) y[e] = mul(A[0], p[e]);
#pragma unroll
  for (int j = 1; j < NP; ++j) {
    if (j >= NP - 2 && j >= n) break;
    load_slot(x + j * ld, p);
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = add(y[e], mul(A[j], p[e]));
  }
}

template <typename T, int NP, int E>
__global__ void __launch_bounds__(kRowsThreads)
    fused_rows_kernel(Args<T> p, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = kSlot<E>;
  const int n = p.n, ld = groups * S;  // ld: a row of a vector, the block's slots
  T* const s_am = reinterpret_cast<T*>(smem_raw);  // [NP][groups][S] each
  T* const s_af = s_am + NP * ld;
  T* const s_r = s_af + NP * ld;
  const int g = threadIdx.x / n, i = threadIdx.x - g * n;
  const bool on = g < groups;  // lanes past groups * n idle but keep the barriers
  const int env0 = (blockIdx.x * groups + g) * E;
  const int col = g * S, slot = i * ld + col;  // the thread's slot of row 0 and of row i

  T m[NP], k[NP], jr[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const bool in = on && j < n;
    m[j] = in ? p.M[i * n + j] : T(0);
    k[j] = in ? p.K[i * n + j] : T(0);
    jr[j] = in ? p.Jinv[i * n + j] : T(0);
  }
  const T ncd = on ? -p.drag[i] : T(0), uu = on ? p.u[i] : T(0);
  T q[E], v[E], a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int env = env0 + e;
    const bool live = on && env < p.B;
    const T* xb = p.x + static_cast<int64_t>(live ? env : 0) * 3 * n;
    q[e] = live ? xb[i] : T(0);
    v[e] = live ? xb[n + i] : T(0);
    a[e] = live ? xb[2 * n + i] : T(0);
    if (live && p.frames) put_frame(p, 0, env, i, q[e], v[e]);
  }

  const Coeffs<T>& c = p.c;
  for (int f = 0; f < p.n_frames; ++f) {
    for (int s = 0; s < p.substeps; ++s) {
      T qp[E], vp[E], a1[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qp[e] = add(add(q[e], mul(c.h, v[e])), mul(c.c_qp, a[e]));
        vp[e] = add(v[e], mul(c.c_vp, a[e]));
        a1[e] = a[e];
      }
      for (int it = 0; it < p.n_newton; ++it) {
        T fd[E];
        if (on) {
          T am[E], af[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const Point<T> pt = alpha_point(c, qp[e], vp[e], a1[e], q[e], v[e], a[e], ncd);
            am[e] = pt.a_am;
            af[e] = pt.q_af;
            fd[e] = pt.fd;
          }
          store_slot(s_am + slot, am);
          store_slot(s_af + slot, af);
        }
        __syncthreads();
        if (on) {
          T ma[E], kq[E], r[E];
          matvec2<T, NP, E>(m, k, s_am + col, s_af + col, ld, n, ma, kq);
#pragma unroll
          for (int e = 0; e < E; ++e) r[e] = sub(sub(add(ma[e], kq[e]), fd[e]), uu);
          store_slot(s_r + slot, r);
        }
        // Every product of a_am and q_af is done before the next iteration writes
        // them, and every r is written before it is read.
        __syncthreads();
        if (on) {
          T d[E];
          matvec1<T, NP, E>(jr, s_r + col, ld, n, d);
#pragma unroll
          for (int e = 0; e < E; ++e) a1[e] = sub(a1[e], d[e]);
        }
        // The next write of r comes after the next iteration's first barrier, which
        // every thread reaches only when it is done reading r.
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        q[e] = add(qp[e], mul(c.bh2, a1[e]));
        v[e] = add(vp[e], mul(c.gh, a1[e]));
        a[e] = a1[e];
      }
    }
    if (p.frames && on) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (env0 + e < p.B) put_frame(p, f + 1, env0 + e, i, q[e], v[e]);
    }
  }

  if (p.out && on) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (env0 + e >= p.B) continue;
      T* ob = p.out + static_cast<int64_t>(env0 + e) * 3 * n;
      ob[i] = q[e];
      ob[n + i] = v[e];
      ob[2 * n + i] = a[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Lanes instance
// ---------------------------------------------------------------------------

// acc[k] = sum_j A[i][j] x[j] for the lane's rows i = lane + 32 k, from j = 0 upward;
// At is A transposed (At[j * n + i] = A[i][j]). Rows past n repeat row n - 1 (a
// broadcast read) and their sums are never stored.
template <typename T, int R>
__device__ __forceinline__ void matvec_lanes(const T* At, const T* x, int n, int lane,
                                             T (&acc)[R]) {
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
__global__ void __launch_bounds__(kThreads) fused_lanes_kernel(Args<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.n;
  T* const Mt = reinterpret_cast<T*>(smem_raw);
  T* const Kt = Mt + n * n;
  T* const Jt = Kt + n * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* const s_am = Jt + n * n + warp * 3 * n;  // the warp's broadcast vectors
  T* const s_af = s_am + n;
  T* const s_r = s_af + n;

  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int i = e / n, j = e - i * n;
    Mt[j * n + i] = p.M[e];
    Kt[j * n + i] = p.K[e];
    Jt[j * n + i] = p.Jinv[e];
  }
  __syncthreads();  // the block's only barrier: warps past B may leave after it

  const int env = blockIdx.x * kWarps + warp;
  if (env >= p.B) return;
  const T* xb = p.x + static_cast<int64_t>(env) * 3 * n;

  T q[R], v[R], a[R], ncd[R], uu[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = lane + 32 * k;
    const bool on = i < n;
    q[k] = on ? xb[i] : T(0);
    v[k] = on ? xb[n + i] : T(0);
    a[k] = on ? xb[2 * n + i] : T(0);
    ncd[k] = on ? -p.drag[i] : T(0);
    uu[k] = on ? p.u[i] : T(0);
    if (on && p.frames) put_frame(p, 0, env, i, q[k], v[k]);
  }

  const Coeffs<T>& c = p.c;
  for (int f = 0; f < p.n_frames; ++f) {
    for (int s = 0; s < p.substeps; ++s) {
      T qp[R], vp[R], a1[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        qp[k] = add(add(q[k], mul(c.h, v[k])), mul(c.c_qp, a[k]));
        vp[k] = add(v[k], mul(c.c_vp, a[k]));
        a1[k] = a[k];
      }
      for (int it = 0; it < p.n_newton; ++it) {
        T fd[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const Point<T> pt = alpha_point(c, qp[k], vp[k], a1[k], q[k], v[k], a[k], ncd[k]);
          fd[k] = pt.fd;
          const int i = lane + 32 * k;
          if (i < n) {
            s_am[i] = pt.a_am;
            s_af[i] = pt.q_af;
          }
        }
        __syncwarp();
        T ma[R], kq[R];
        matvec_lanes<T, R>(Mt, s_am, n, lane, ma);
        matvec_lanes<T, R>(Kt, s_af, n, lane, kq);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int i = lane + 32 * k;
          if (i < n) s_r[i] = sub(sub(add(ma[k], kq[k]), fd[k]), uu[k]);
        }
        __syncwarp();
        T d[R];
        matvec_lanes<T, R>(Jt, s_r, n, lane, d);
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
    if (p.frames) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (lane + 32 * k < n) put_frame(p, f + 1, env, lane + 32 * k, q[k], v[k]);
    }
  }

  if (p.out) {
    T* ob = p.out + static_cast<int64_t>(env) * 3 * n;
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
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename... A>
int launch_kernel(void (*kernel)(A...), int blocks, int threads, size_t smem,
                  cudaStream_t stream, A... a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(a...);
  return static_cast<int>(cudaGetLastError());
}

// The rows instance for NP = g.np.
template <typename T, int NP = 3>
int launch_rows(const Args<T>& p, const FusedGeometry& g, cudaStream_t stream) {
  if constexpr (NP < kRegRows<T>) {
    if (g.np > NP) return launch_rows<T, NP + 3>(p, g, stream);
  }
  return launch_kernel(fused_rows_kernel<T, NP, kEnvs<T>>, g.blocks, g.threads, g.smem,
                       stream, p, g.groups);
}

// The lanes instance with R = g.rows rows per lane.
template <typename T, int R = 1>
int launch_lanes(const Args<T>& p, const FusedGeometry& g, cudaStream_t stream) {
  if constexpr (R < kMaxRows<T>) {
    if (g.rows > R) return launch_lanes<T, R + 1>(p, g, stream);
  }
  return launch_kernel(fused_lanes_kernel<T, R>, g.blocks, kThreads, g.smem, stream, p);
}

template <typename T>
int launch(Args<T> p, const double* s, cudaStream_t stream) {
  p.c = Coeffs<T>{T(s[0]), T(s[1]), T(s[2]), T(s[3]), T(s[4]),
                  T(s[5]), T(s[6]), T(s[7]), T(s[8])};
  FusedGeometry g;
  if (!fused_geometry<T>(p.n, p.B, &g)) return static_cast<int>(cudaErrorInvalidValue);
  return g.instance == 0 ? launch_rows<T>(p, g, stream) : launch_lanes<T>(p, g, stream);
}

template <typename T>
Args<T> make_args(int B, int n, int n_frames, int substeps, int n_newton, const void* M,
             const void* K, const void* Jinv, const void* drag, const void* u, const void* x,
             void* out, void* frames) {
  return Args<T>{B, n, n_frames, substeps, n_newton, {},
                 static_cast<const T*>(M), static_cast<const T*>(K),
                 static_cast<const T*>(Jinv), static_cast<const T*>(drag),
                 static_cast<const T*>(u), static_cast<const T*>(x),
                 static_cast<T*>(out), static_cast<T*>(frames)};
}

}  // namespace

// dtype: 0 = float32, 1 = float64. B >= 1 environments of n >= 1 DOFs, for an n that
// fused_gen_alpha_geometry (fused_geometry.h) serves: the rows instance for n <= 36 in
// float and 24 in double, the lanes instance past it while the matrices fit in one
// block's shared memory (n <= 135 in float, 94 in double); anything else returns
// cudaErrorInvalidValue. n_frames frames of `substeps` steps. x is (B, 3n); out
// (B, 3n) receives the final states and frames (n_frames + 1, B, 2n) every frame's
// [q; v] (frame 0: x's); either may be null. M, K, Jinv are (n, n), drag and u (n,),
// all contiguous on one device. The nine step scalars (h, (1/2 - beta) h^2,
// (1 - gamma) h, beta h^2, gamma h, 1 - af, af, 1 - am, am) are exact in the dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" {

int fused_gen_alpha_launch(int dtype, int B, int n, int n_frames, int substeps,
                           int n_newton, double h, double c_qp, double c_vp, double bh2,
                           double gh, double w_af1, double w_af, double w_am1, double w_am,
                           const void* M, const void* K, const void* Jinv, const void* drag,
                           const void* u, const void* x, void* out, void* frames,
                           void* stream) {
  const double s[9] = {h, c_qp, c_vp, bh2, gh, w_af1, w_af, w_am1, w_am};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(make_args<float>(B, n, n_frames, substeps, n_newton, M, K, Jinv,
                                          drag, u, x, out, frames),
                         s, st);
  return launch<double>(make_args<double>(B, n, n_frames, substeps, n_newton, M, K, Jinv,
                                          drag, u, x, out, frames),
                        s, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
