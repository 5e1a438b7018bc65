// Modal generalized-alpha kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of continuum_robot_tpu/ops/pallas/modal_rollout.py:
//   modal_steps_kernel   <- fused_modal_steps   (S gen-alpha steps, state resident)
//   modal_frames_kernel  <- fused_modal_frames  (the same steps, keeping each frame)
//   affine_kernel        <- fused_affine_steps  (apps applications of a per-mode 3x3
//                           affine map; its DRIVE instance is rollout_power's whole
//                           drive: initial acceleration, apps, remainder map)
//
// Layouts. The state is the natural row-major (B, m) array.
// - Step and affine kernels: modes on x (a warp spans kModesX consecutive
//   modes, so each env row is one coalesced access), env groups on y. A
//   thread owns one mode for E envs (kStepEnvs, kAffineEnvs): it loads its
//   mode's coefficients once and carries the envs' independent chains side by
//   side. No 64-bit modulo.
// - Frames kernel (the first port's map): a thread owns one (env, mode)
//   element, index i = b * m + mode.
// The TPU version's (modes, envs) transposes and tile padding are Mosaic
// layout rules with no counterpart here.
//
// Bound. At the main path's 2000 steps the step kernel does 8 FMAs an element
// a step (10 damped) against 24 bytes of state traffic a call: it is bound by
// FMA issue, 8 x 12.288e6 x 2000 at 132 SMs x 128 lanes x 1.98 GHz = 5.88 ms,
// which is also the float32 flop bound (a multiply-add pair as one FMA). About
// five dependent FMAs a step make a chain; the grid keeps 64 warps an SM to
// hide that latency. The affine kernel at 31 applications (9 FMAs each) and
// the drive (32) are bound by operations (0.102, 0.106 ms), their bytes close
// behind (0.088, 0.073 ms): one after the other they would take the sum. So
// the affine grid is persistent (the blocks one wave holds) and a thread
// walks its env groups loading the next group's state before it computes the
// current one, so the loads of one group overlap the arithmetic of another.
//
// Rounding. In float32 every multiply-add is one __fmaf_rn, in the order of
// the plain versions in ops/cuda/modal_rollout.py (fma_step, affine_app); the
// plain version's madd rounds x * y + z once, exactly as an FMA does, so the
// two agree bit for bit. In float64 every multiply and add goes through the
// _rn intrinsics, which the compiler never contracts, in the same order (the
// affine rows in the first port's order), and again kernel and plain version
// agree bit for bit. The drive's initial acceleration rounds each operation
// (_rn) in both dtypes, as initial_accel does; it runs once.
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
// x * y + z as the plain version's madd rounds it: once in float32, the
// product and the sum each in float64.
__device__ __forceinline__ float madd(float x, float y, float z) { return __fmaf_rn(x, y, z); }
__device__ __forceinline__ double madd(double x, double y, double z) {
  return __dadd_rn(__dmul_rn(x, y), z);
}

constexpr int kThreads = 256;   // frames kernel
constexpr int kModesX = 32;     // step and affine kernels: modes a block spans on x
constexpr int kGroupsY = 8;     // env groups a block spans on y
constexpr int kStepEnvs = 4;    // envs a step-kernel thread carries
constexpr int kStepUnroll = 8;  // steps of the step loop unrolled
constexpr int kAffineEnvs = 1;  // envs an affine thread carries
constexpr int kAffineWaves = 4; // affine grid: blocks resident at once x this
constexpr int kMaxGridY = 65535;

template <typename T>
struct Scalars {
  T h, c_qp, c_vp, bh2, gh;
};

// Per-mode coefficient columns, stored as rows of a (n_cols, m) array:
// p1, p2, p3, p4 (= winv * u), and p5, p6 when damped. Kept as p1, -p2,
// -p3, p4, -p5, -p6 (negation is exact).
template <typename T, bool DAMPED>
struct Coeffs {
  T p1, np2, np3, p4, np5, np6;
  __device__ __forceinline__ Coeffs(const T* cols, int m, int mode) {
    p1 = cols[mode];
    np2 = -cols[m + mode];
    np3 = -cols[2 * m + mode];
    p4 = cols[3 * m + mode];
    np5 = DAMPED ? -cols[4 * m + mode] : T(0);
    np6 = DAMPED ? -cols[5 * m + mode] : T(0);
  }
};

// One substituted gen-alpha step, in the order of fma_step in
// ops/cuda/modal_rollout.py:
//   q_pred = madd(c_qp, a, madd(h, v, q));  v_pred = madd(c_vp, a, v)
//   a1 = madd(-p3, q, madd(-p2, q_pred, madd(p1, a, p4)))
//   damped: a1 = madd(-p6, v, madd(-p5, v_pred, a1))
//   q' = madd(bh2, a1, q_pred);  v' = madd(gh, a1, v_pred);  a' = a1
template <typename T, bool DAMPED>
__device__ __forceinline__ void step(T& q, T& v, T& a, const Coeffs<T, DAMPED>& c,
                                     const Scalars<T>& s) {
  const T q_pred = madd(s.c_qp, a, madd(s.h, v, q));
  const T v_pred = madd(s.c_vp, a, v);
  T a1 = madd(c.np3, q, madd(c.np2, q_pred, madd(c.p1, a, c.p4)));
  if (DAMPED) a1 = madd(c.np6, v, madd(c.np5, v_pred, a1));
  q = madd(s.bh2, a1, q_pred);
  v = madd(s.gh, a1, v_pred);
  a = a1;
}

// The (env group, mode) map of the step and affine kernels: this thread's
// mode, and envs g * E .. g * E + E - 1 of group g, for g from first() by
// stride() below groups(B).
template <int E>
struct EnvGroups {
  __device__ __forceinline__ static int mode() {
    return static_cast<int>(blockIdx.x) * kModesX + threadIdx.x;
  }
  __device__ __forceinline__ static int64_t first() {
    return static_cast<int64_t>(blockIdx.y) * kGroupsY + threadIdx.y;
  }
  __device__ __forceinline__ static int64_t stride() {
    return static_cast<int64_t>(gridDim.y) * kGroupsY;
  }
  __host__ __device__ static int64_t groups(int64_t B) { return (B + E - 1) / E; }
};

template <typename T, bool DAMPED>
__global__ void __launch_bounds__(kModesX * kGroupsY)
modal_steps_kernel(int64_t B, int m, int steps, const T* __restrict__ cols,
                   const T* __restrict__ q0, const T* __restrict__ v0,
                   const T* __restrict__ a0, T* __restrict__ q1, T* __restrict__ v1,
                   T* __restrict__ a1, Scalars<T> s) {
  constexpr int E = kStepEnvs;
  using Map = EnvGroups<E>;
  const int mode = Map::mode();
  if (mode >= m) return;
  const Coeffs<T, DAMPED> c(cols, m, mode);
  for (int64_t g = Map::first(); g < Map::groups(B); g += Map::stride()) {
    T q[E], v[E], a[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t b = g * E + j;
      const int64_t i = b * m + mode;
      q[j] = b < B ? q0[i] : T(0);
      v[j] = b < B ? v0[i] : T(0);
      a[j] = b < B ? a0[i] : T(0);
    }
#pragma unroll kStepUnroll
    for (int k = 0; k < steps; ++k) {
#pragma unroll
      for (int j = 0; j < E; ++j) step<T, DAMPED>(q[j], v[j], a[j], c, s);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t b = g * E + j;
      if (b < B) {
        const int64_t i = b * m + mode;
        q1[i] = q[j];
        v1[i] = v[j];
        a1[i] = a[j];
      }
    }
  }
}

// Frame f (0..n_frames) of qs/vs is the state after f * substeps steps; frame 0
// is the initial state. One launch carries the state in registers across all
// frames; one thread an element.
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

// A mode's map: P row-major and b, in registers. apply() advances E envs'
// states by one application, each row in the order of affine_app in
// ops/cuda/modal_rollout.py: float32 madd(t2, a, madd(t1, v, madd(t0, q, b))),
// float64 ((t0 q + t1 v) + t2 a) + b. In float32 it goes term by term across
// the rows and envs (every q term, then every v term, then every a term), so
// an operand feeds several FMAs in a row and can come from the operand reuse
// cache.
template <typename T>
struct AffineMap {
  T p[9], b[3];
  __device__ __forceinline__ AffineMap(const T* tmat, const T* bvec, int mode) {
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = tmat[9 * mode + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = bvec[3 * mode + k];
  }
  template <int E>
  __device__ __forceinline__ void apply(T (&q)[E], T (&v)[E], T (&a)[E]) const {
    T n[3][E];
    if constexpr (sizeof(T) == sizeof(float)) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < E; ++j) n[r][j] = __fmaf_rn(p[3 * r], q[j], b[r]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < E; ++j) n[r][j] = __fmaf_rn(p[3 * r + 1], v[j], n[r][j]);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < E; ++j) n[r][j] = __fmaf_rn(p[3 * r + 2], a[j], n[r][j]);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const T* t = p + 3 * r;
          n[r][j] = add(add(add(mul(t[0], q[j]), mul(t[1], v[j])), mul(t[2], a[j])), b[r]);
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      q[j] = n[0][j];
      v[j] = n[1][j];
      a[j] = n[2][j];
    }
  }
};

// s -> P s + b applied apps times, then (rtmat, rbvec) once if given. DRIVE:
// the state starts from (q0, v0) and the consistent initial acceleration
// a = -lam q [+ u] [- c v] (each operation rounded, as initial_accel); else
// from (q0, v0, a0). tmat is (m, 3, 3) row-major, bvec (m, 3). A thread
// loads group g + stride before it computes group g.
template <typename T, bool DRIVE>
__global__ void __launch_bounds__(kModesX * kGroupsY)
affine_kernel(int64_t B, int m, int apps, const T* __restrict__ lam,
              const T* __restrict__ u, const T* __restrict__ cdamp,
              const T* __restrict__ tmat, const T* __restrict__ bvec,
              const T* __restrict__ rtmat, const T* __restrict__ rbvec,
              const T* __restrict__ q0, const T* __restrict__ v0,
              const T* __restrict__ a0, T* __restrict__ q1, T* __restrict__ v1,
              T* __restrict__ a1) {
  constexpr int E = kAffineEnvs;
  using Map = EnvGroups<E>;
  const int mode = Map::mode();
  int64_t g = Map::first();
  const int64_t groups = Map::groups(B), stride = Map::stride();
  if (mode >= m || g >= groups) return;
  const AffineMap<T> map(tmat, bvec, mode);
  T nq[E], nv[E], na[E];  // the next group's state, loaded ahead
  auto load = [&](int64_t grp) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t b = grp * E + j;
      const int64_t i = b * m + mode;
      nq[j] = b < B ? q0[i] : T(0);
      nv[j] = b < B ? v0[i] : T(0);
      if (!DRIVE) na[j] = b < B ? a0[i] : T(0);
    }
  };
  load(g);
  for (; g < groups; g += stride) {
    T q[E], v[E], a[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      q[j] = nq[j];
      v[j] = nv[j];
      if (DRIVE) {
        a[j] = mul(-lam[mode], q[j]);
        if (u != nullptr) a[j] = add(a[j], u[mode]);
        if (cdamp != nullptr) a[j] = sub(a[j], mul(cdamp[mode], v[j]));
      } else {
        a[j] = na[j];
      }
    }
    if (g + stride < groups) load(g + stride);
    for (int k = 0; k < apps; ++k) map.apply(q, v, a);
    if (rtmat != nullptr) AffineMap<T>(rtmat, rbvec, mode).apply(q, v, a);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t b = g * E + j;
      if (b < B) {
        const int64_t i = b * m + mode;
        q1[i] = q[j];
        v1[i] = v[j];
        a1[i] = a[j];
      }
    }
  }
}

// Grid of the (env group, mode) map: every mode, and rows of kGroupsY groups
// up to max_rows (at most kMaxGridY); the kernel walks any rows beyond.
inline dim3 group_grid(int64_t groups, int m, int64_t max_rows) {
  const int64_t rows = (groups + kGroupsY - 1) / kGroupsY;
  const int64_t cap = max_rows < kMaxGridY ? max_rows : kMaxGridY;
  return dim3((m + kModesX - 1) / kModesX,
              static_cast<unsigned>(rows < cap ? rows : (cap > 0 ? cap : 1)));
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
  const int64_t B = n / m;
  const dim3 grid = group_grid(EnvGroups<kStepEnvs>::groups(B), m, kMaxGridY);
  modal_steps_kernel<T, DAMPED><<<grid, dim3(kModesX, kGroupsY), 0, stream>>>(
      B, m, steps, static_cast<const T*>(cols), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(q1),
      static_cast<T*>(v1), static_cast<T*>(a1), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DAMPED>
int launch_frames(int64_t n, int m, int n_frames, int substeps, const void* cols,
                  const void* q0, const void* v0, const void* a0, void* qs, void* vs,
                  Scalars<T> s, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  modal_frames_kernel<T, DAMPED><<<blocks, kThreads, 0, stream>>>(
      n, m, n_frames, substeps, static_cast<const T*>(cols), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(qs),
      static_cast<T*>(vs), s);
  return static_cast<int>(cudaGetLastError());
}

// Rows of blocks one wave of the card holds for an affine instance, times
// kAffineWaves: a persistent grid, so each thread walks several env groups.
template <typename T, bool DRIVE>
int64_t affine_rows(int gx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, affine_kernel<T, DRIVE>,
                                                kModesX * kGroupsY, 0);
  const int64_t rows = static_cast<int64_t>(sms) * per_sm * kAffineWaves / gx;
  return rows > 0 ? rows : 1;
}

template <typename T, bool DRIVE>
int launch_affine(int64_t B, int m, int apps, const void* lam, const void* u,
                  const void* cdamp, const void* tmat, const void* bvec, const void* rtmat,
                  const void* rbvec, const void* q0, const void* v0, const void* a0, void* q1,
                  void* v1, void* a1, cudaStream_t stream) {
  const int gx = (m + kModesX - 1) / kModesX;
  const dim3 grid = group_grid(EnvGroups<kAffineEnvs>::groups(B), m, affine_rows<T, DRIVE>(gx));
  affine_kernel<T, DRIVE><<<grid, dim3(kModesX, kGroupsY), 0, stream>>>(
      B, m, apps, static_cast<const T*>(lam), static_cast<const T*>(u),
      static_cast<const T*>(cdamp), static_cast<const T*>(tmat), static_cast<const T*>(bvec),
      static_cast<const T*>(rtmat), static_cast<const T*>(rbvec), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(q1),
      static_cast<T*>(v1), static_cast<T*>(a1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. n = B * m state elements (n > 0) for the step
// and frames kernels.
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

// B env rows of m modes (B * m > 0).
int affine_steps_launch(int dtype, int64_t B, int m, int apps, const void* tmat,
                        const void* bvec, const void* q0, const void* v0, const void* a0,
                        void* q1, void* v1, void* a1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine<float, false>(B, m, apps, nullptr, nullptr, nullptr, tmat, bvec,
                                       nullptr, nullptr, q0, v0, a0, q1, v1, a1, st);
  return launch_affine<double, false>(B, m, apps, nullptr, nullptr, nullptr, tmat, bvec,
                                      nullptr, nullptr, q0, v0, a0, q1, v1, a1, st);
}

// u, cdamp, rtmat and rbvec may be null (no force, undamped, no remainder map).
int affine_drive_launch(int dtype, int64_t B, int m, int apps, const void* lam,
                        const void* u, const void* cdamp, const void* tmat, const void* bvec,
                        const void* rtmat, const void* rbvec, const void* q0, const void* v0,
                        void* q1, void* v1, void* a1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine<float, true>(B, m, apps, lam, u, cdamp, tmat, bvec, rtmat, rbvec, q0,
                                      v0, nullptr, q1, v1, a1, st);
  return launch_affine<double, true>(B, m, apps, lam, u, cdamp, tmat, bvec, rtmat, rbvec, q0,
                                     v0, nullptr, q1, v1, a1, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
