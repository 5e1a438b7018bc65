// Modal generalized-alpha kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of continuum_robot_tpu/ops/pallas/modal_rollout.py:
//   modal_steps_kernel   <- fused_modal_steps   (S gen-alpha steps, state resident)
//   modal_frames_kernel  <- fused_modal_frames  (the same steps, keeping each frame)
//   affine_steps_kernel  <- fused_affine_steps  (apps applications of a per-mode 3x3 affine map)
//
// Layout: the state is the natural row-major (B, m) array; one thread owns one
// (env, mode) element, index i = b * m + mode, so neighbouring threads read
// neighbouring addresses. A thread loads its state and its mode's coefficients
// once, runs every step in registers and stores once (once per frame for the
// frames kernel). The TPU version's (modes, envs) transposes and tile padding
// are Mosaic layout rules with no counterpart here.
//
// Bound: at the main path's 2000 steps the step kernels do ~16 float ops per
// element per step against 24 bytes of state traffic per call, so they are
// bound by arithmetic issue, not memory; the affine kernel with 31
// applications is bound by both in similar measure.
//
// Rounding: every multiply and add goes through the _rn intrinsics, which the
// compiler never contracts into a fused multiply-add. Each operation therefore
// rounds exactly as the plain PyTorch version in ops/cuda/modal_rollout.py
// does, in the same order, and the two agree bit for bit in float and double.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream, and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

constexpr int kThreads = 256;

template <typename T>
struct Scalars {
  T h, c_qp, c_vp, bh2, gh;
};

// Per-mode coefficient columns, stored as rows of a (n_cols, m) array:
// p1, p2, p3, p4 (= winv * u), and p5, p6 when damped.
template <typename T, bool DAMPED>
struct Coeffs {
  T p1, p2, p3, p4, p5, p6;
  __device__ __forceinline__ Coeffs(const T* cols, int m, int mode) {
    p1 = cols[mode];
    p2 = cols[m + mode];
    p3 = cols[2 * m + mode];
    p4 = cols[3 * m + mode];
    p5 = DAMPED ? cols[4 * m + mode] : T(0);
    p6 = DAMPED ? cols[5 * m + mode] : T(0);
  }
};

// One substituted gen-alpha step, in the expression order of
// gen_alpha_step in ops/cuda/modal_rollout.py:
//   q_pred = q + h v + c_qp a;  v_pred = v + c_vp a
//   a1 = p4 + p1 a - p2 q_pred - p3 q [- p5 v_pred - p6 v]
//   q' = q_pred + bh2 a1;  v' = v_pred + gh a1;  a' = a1
template <typename T, bool DAMPED>
__device__ __forceinline__ void step(T& q, T& v, T& a, const Coeffs<T, DAMPED>& c,
                                     const Scalars<T>& s) {
  const T q_pred = add(add(q, mul(s.h, v)), mul(s.c_qp, a));
  const T v_pred = add(v, mul(s.c_vp, a));
  T a1 = sub(sub(add(c.p4, mul(c.p1, a)), mul(c.p2, q_pred)), mul(c.p3, q));
  if (DAMPED) a1 = sub(sub(a1, mul(c.p5, v_pred)), mul(c.p6, v));
  q = add(q_pred, mul(s.bh2, a1));
  v = add(v_pred, mul(s.gh, a1));
  a = a1;
}

template <typename T, bool DAMPED>
__global__ void modal_steps_kernel(int64_t n, int m, int steps, const T* __restrict__ cols,
                                   const T* __restrict__ q0, const T* __restrict__ v0,
                                   const T* __restrict__ a0, T* __restrict__ q1,
                                   T* __restrict__ v1, T* __restrict__ a1, Scalars<T> s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Coeffs<T, DAMPED> c(cols, m, static_cast<int>(i % m));
  T q = q0[i], v = v0[i], a = a0[i];
  for (int k = 0; k < steps; ++k) step<T, DAMPED>(q, v, a, c, s);
  q1[i] = q;
  v1[i] = v;
  a1[i] = a;
}

// Frame f (0..n_frames) of qs/vs is the state after f * substeps steps; frame 0
// is the initial state. One launch carries the state in registers across all
// frames.
template <typename T, bool DAMPED>
__global__ void modal_frames_kernel(int64_t n, int m, int n_frames, int substeps,
                                    const T* __restrict__ cols, const T* __restrict__ q0,
                                    const T* __restrict__ v0, const T* __restrict__ a0,
                                    T* __restrict__ qs, T* __restrict__ vs, Scalars<T> s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Coeffs<T, DAMPED> c(cols, m, static_cast<int>(i % m));
  T q = q0[i], v = v0[i], a = a0[i];
  qs[i] = q;
  vs[i] = v;
  for (int f = 1; f <= n_frames; ++f) {
    for (int k = 0; k < substeps; ++k) step<T, DAMPED>(q, v, a, c, s);
    qs[f * n + i] = q;
    vs[f * n + i] = v;
  }
}

// s -> T s + b per mode, in the expression order of affine_steps_plain:
//   q' = ((t00 q + t01 v) + t02 a) + b0, and likewise for v', a'.
// tmat is (m, 3, 3) row-major, bvec is (m, 3).
template <typename T>
__global__ void affine_steps_kernel(int64_t n, int m, int apps, const T* __restrict__ tmat,
                                    const T* __restrict__ bvec, const T* __restrict__ q0,
                                    const T* __restrict__ v0, const T* __restrict__ a0,
                                    T* __restrict__ q1, T* __restrict__ v1, T* __restrict__ a1) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int mode = static_cast<int>(i % m);
  const T* t = tmat + 9 * static_cast<int64_t>(mode);
  const T* b = bvec + 3 * static_cast<int64_t>(mode);
  const T t00 = t[0], t01 = t[1], t02 = t[2];
  const T t10 = t[3], t11 = t[4], t12 = t[5];
  const T t20 = t[6], t21 = t[7], t22 = t[8];
  const T b0 = b[0], b1 = b[1], b2 = b[2];
  T q = q0[i], v = v0[i], a = a0[i];
  for (int k = 0; k < apps; ++k) {
    const T qn = add(add(add(mul(t00, q), mul(t01, v)), mul(t02, a)), b0);
    const T vn = add(add(add(mul(t10, q), mul(t11, v)), mul(t12, a)), b1);
    const T an = add(add(add(mul(t20, q), mul(t21, v)), mul(t22, a)), b2);
    q = qn;
    v = vn;
    a = an;
  }
  q1[i] = q;
  v1[i] = v;
  a1[i] = a;
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
Scalars<T> scalars(double h, double c_qp, double c_vp, double bh2, double gh) {
  return Scalars<T>{static_cast<T>(h), static_cast<T>(c_qp), static_cast<T>(c_vp),
                    static_cast<T>(bh2), static_cast<T>(gh)};
}

template <typename T, bool DAMPED>
int launch_steps(int64_t n, int m, int steps, const void* cols, const void* q0,
                 const void* v0, const void* a0, void* q1, void* v1, void* a1, Scalars<T> s,
                 cudaStream_t stream) {
  modal_steps_kernel<T, DAMPED><<<blocks_for(n), kThreads, 0, stream>>>(
      n, m, steps, static_cast<const T*>(cols), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(q1),
      static_cast<T*>(v1), static_cast<T*>(a1), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DAMPED>
int launch_frames(int64_t n, int m, int n_frames, int substeps, const void* cols,
                  const void* q0, const void* v0, const void* a0, void* qs, void* vs,
                  Scalars<T> s, cudaStream_t stream) {
  modal_frames_kernel<T, DAMPED><<<blocks_for(n), kThreads, 0, stream>>>(
      n, m, n_frames, substeps, static_cast<const T*>(cols), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(qs),
      static_cast<T*>(vs), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine(int64_t n, int m, int apps, const void* tmat, const void* bvec,
                  const void* q0, const void* v0, const void* a0, void* q1, void* v1, void* a1,
                  cudaStream_t stream) {
  affine_steps_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      n, m, apps, static_cast<const T*>(tmat), static_cast<const T*>(bvec),
      static_cast<const T*>(q0), static_cast<const T*>(v0), static_cast<const T*>(a0),
      static_cast<T*>(q1), static_cast<T*>(v1), static_cast<T*>(a1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. n = B * m state elements (n > 0).
// Each function returns the cudaError_t of the launch (0 on success).
extern "C" {

int modal_steps_launch(int dtype, int damped, int64_t n, int m, int steps, const void* cols,
                       const void* q0, const void* v0, const void* a0, void* q1, void* v1,
                       void* a1, double h, double c_qp, double c_vp, double bh2, double gh,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Scalars<float> s = scalars<float>(h, c_qp, c_vp, bh2, gh);
    return damped ? launch_steps<float, true>(n, m, steps, cols, q0, v0, a0, q1, v1, a1, s, st)
                  : launch_steps<float, false>(n, m, steps, cols, q0, v0, a0, q1, v1, a1, s, st);
  }
  const Scalars<double> s = scalars<double>(h, c_qp, c_vp, bh2, gh);
  return damped ? launch_steps<double, true>(n, m, steps, cols, q0, v0, a0, q1, v1, a1, s, st)
                : launch_steps<double, false>(n, m, steps, cols, q0, v0, a0, q1, v1, a1, s, st);
}

int modal_frames_launch(int dtype, int damped, int64_t n, int m, int n_frames, int substeps,
                        const void* cols, const void* q0, const void* v0, const void* a0,
                        void* qs, void* vs, double h, double c_qp, double c_vp, double bh2,
                        double gh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Scalars<float> s = scalars<float>(h, c_qp, c_vp, bh2, gh);
    return damped
        ? launch_frames<float, true>(n, m, n_frames, substeps, cols, q0, v0, a0, qs, vs, s, st)
        : launch_frames<float, false>(n, m, n_frames, substeps, cols, q0, v0, a0, qs, vs, s, st);
  }
  const Scalars<double> s = scalars<double>(h, c_qp, c_vp, bh2, gh);
  return damped
      ? launch_frames<double, true>(n, m, n_frames, substeps, cols, q0, v0, a0, qs, vs, s, st)
      : launch_frames<double, false>(n, m, n_frames, substeps, cols, q0, v0, a0, qs, vs, s, st);
}

int affine_steps_launch(int dtype, int64_t n, int m, int apps, const void* tmat,
                        const void* bvec, const void* q0, const void* v0, const void* a0,
                        void* q1, void* v1, void* a1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine<float>(n, m, apps, tmat, bvec, q0, v0, a0, q1, v1, a1, st);
  return launch_affine<double>(n, m, apps, tmat, bvec, q0, v0, a0, q1, v1, a1, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
