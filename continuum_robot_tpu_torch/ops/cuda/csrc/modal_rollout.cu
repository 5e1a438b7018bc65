// Modal generalized-alpha kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of continuum_robot_tpu/ops/pallas/modal_rollout.py:
//   modal_steps_kernel   <- fused_modal_steps   (S gen-alpha steps, state resident)
//   modal_frames_kernel  <- fused_modal_frames  (the same steps, keeping each frame)
//   affine_kernel        <- fused_affine_steps  (apps applications of a per-mode 3x3
//                           affine map; its DRIVE instance is rollout_power's whole
//                           drive: initial acceleration, apps, remainder map)
//   affine_frames_kernel <- fused_affine_steps  (rollout_frames_power's whole drive:
//                           initial acceleration, then one application of a run's
//                           map a frame, every frame written)
//
// Layouts. The state is the natural row-major (B, m) array. Every kernel puts
// modes on x (a warp spans kModesX consecutive modes, so each env row, and
// each frame's row, is one coalesced access) and env groups on y. A thread
// owns one mode for E envs (kStepEnvs; kAffineEnvs; modal_frames' E = 1, 2
// or 4 by the batch, frames_envs; the frames drive one env): it loads its
// mode's coefficients once and carries the envs' independent chains side by
// side. No 64-bit modulo. The TPU version's (modes, envs) transposes and tile
// padding are Mosaic layout rules with no counterpart here.
//
// Bound. At the main path's 2000 steps the step kernel does 8 FMAs an element
// a step (10 damped) against 24 bytes of state traffic a call: it is bound by
// FMA issue, 8 x 12.288e6 x 2000 at 132 SMs x 128 lanes x 1.98 GHz = 5.88 ms,
// which is also the float32 flop bound (a multiply-add pair as one FMA). About
// five dependent FMAs a step make a chain; the grid keeps 64 warps an SM to
// hide that latency. The frames kernel does the same steps and writes each
// frame's q and v: at 10 frames x 20 substeps over 4096 x 3000 it is bound by
// FMA issue (0.587 ms) with its 1.08 GB of frame stores (0.35 ms) behind it;
// at 64 envs the card is a sixth full and the launch is latency-bound. The
// affine kernel at 31 applications (9 FMAs each) and the drive (32) are bound
// by operations (0.102, 0.106 ms), their bytes close behind (0.088, 0.073 ms):
// one after the other they would take the sum. So the affine grid is
// persistent (the blocks one wave holds) and a thread walks its env groups
// loading the next group's state before it computes the current one, so the
// loads of one group overlap the arithmetic of another. The frames drive
// applies one map a frame (9 FMAs) and writes two states a frame: it is bound
// by its stores (1.08 GB, 0.35 ms, at 10 frames of 4096 x 3000), so its grid
// is a plain one and a thread carries one env and stores each frame as soon
// as it has it (a persistent grid and 2 or 4 envs a thread measured slower).
//
// Rounding. In float32 every multiply-add is one __fmaf_rn, in the order of
// the plain versions in ops/cuda/modal_rollout.py (fma_step, affine_app); the
// plain version's madd rounds x * y + z once, exactly as an FMA does, so the
// two agree bit for bit. In float64 every multiply and add goes through the
// _rn intrinsics, which the compiler never contracts, in the same order (the
// affine rows in the first port's order), and again kernel and plain version
// agree bit for bit. The consistent initial acceleration (the drives and
// modal_frames compute it in the launch) rounds each operation (_rn) in both
// dtypes, as initial_accel does; it runs once.
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

constexpr int kModesX = 32;     // modes a block spans on x
constexpr int kGroupsY = 8;     // env groups a block spans on y
constexpr int kStepEnvs = 4;    // envs a step-kernel thread carries
constexpr int kStepUnroll = 8;  // steps of the step loop unrolled
constexpr int kFramesUnroll = 10;  // substeps of the frames kernel's loop unrolled
constexpr int kAffineEnvs = 1;  // envs an affine thread carries
constexpr int kAffineWaves = 4; // affine grid: blocks resident at once x this
constexpr int kFrameBlocksPerSm = 2;  // modal_frames: blocks an SM gets before E > 1
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

// The consistent initial acceleration -lam q [+ u] [- c v] of one env, each
// operation rounded, in the order of initial_accel in ops/cuda/modal_rollout.py.
// u and cdamp may be null (no force, undamped).
template <typename T>
__device__ __forceinline__ T initial_accel(T q, T v, const T* __restrict__ lam,
                                           const T* __restrict__ u,
                                           const T* __restrict__ cdamp, int mode) {
  T a = mul(-lam[mode], q);
  if (u != nullptr) a = add(a, u[mode]);
  if (cdamp != nullptr) a = sub(a, mul(cdamp[mode], v));
  return a;
}

// The (env group, mode) map of every kernel: this thread's
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
// is (q0, v0), and the state starts from the consistent initial acceleration
// (lam, u, cdamp: initial_accel). One launch carries E envs' states in
// registers across all frames and stores each frame's rows as it reaches them.
template <typename T, bool DAMPED, int E>
__global__ void __launch_bounds__(kModesX * kGroupsY)
modal_frames_kernel(int64_t B, int m, int n_frames, int substeps, const T* __restrict__ cols,
                    const T* __restrict__ lam, const T* __restrict__ u,
                    const T* __restrict__ cdamp, const T* __restrict__ q0,
                    const T* __restrict__ v0, T* __restrict__ qs, T* __restrict__ vs,
                    Scalars<T> s) {
  using Map = EnvGroups<E>;
  const int mode = Map::mode();
  if (mode >= m) return;
  const Coeffs<T, DAMPED> c(cols, m, mode);
  const int64_t n = B * m;
  for (int64_t g = Map::first(); g < Map::groups(B); g += Map::stride()) {
    T q[E], v[E], a[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t b = g * E + j;
      const int64_t i = b * m + mode;
      q[j] = b < B ? q0[i] : T(0);
      v[j] = b < B ? v0[i] : T(0);
      a[j] = initial_accel(q[j], v[j], lam, u, cdamp, mode);
      if (b < B) {
        qs[i] = q[j];
        vs[i] = v[j];
      }
    }
    for (int f = 1; f <= n_frames; ++f) {
#pragma unroll kFramesUnroll
      for (int k = 0; k < substeps; ++k) {
#pragma unroll
        for (int j = 0; j < E; ++j) step<T, DAMPED>(q[j], v[j], a[j], c, s);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int64_t b = g * E + j;
        if (b < B) {
          const int64_t i = f * n + b * m + mode;
          qs[i] = q[j];
          vs[i] = v[j];
        }
      }
    }
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
      a[j] = DRIVE ? initial_accel(q[j], v[j], lam, u, cdamp, mode) : na[j];
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

// rollout_frames_power's drive: frame 0 of qs/vs is (q0, v0); the state starts
// from the consistent initial acceleration (as the DRIVE instance's), and
// frame f (1..n_frames) is frame f - 1 advanced by one application of the map
// of run frame_run[f - 1] (run 0 throughout when frame_run is null). tmat is
// (R, m, 3, 3) row-major, bvec (R, m, 3): a thread reloads its mode's map
// only when the run changes (frame_run is the same for every thread).
template <typename T>
__global__ void __launch_bounds__(kModesX * kGroupsY)
affine_frames_kernel(int64_t B, int m, int n_frames, const int* __restrict__ frame_run,
                     const T* __restrict__ lam, const T* __restrict__ u,
                     const T* __restrict__ cdamp, const T* __restrict__ tmat,
                     const T* __restrict__ bvec, const T* __restrict__ q0,
                     const T* __restrict__ v0, T* __restrict__ qs, T* __restrict__ vs) {
  using Map = EnvGroups<1>;
  const int mode = Map::mode();
  if (mode >= m) return;
  const int64_t n = B * m;
  for (int64_t b = Map::first(); b < B; b += Map::stride()) {
    const int64_t i = b * m + mode;
    T q[1] = {q0[i]}, v[1] = {v0[i]};
    T a[1] = {initial_accel(q[0], v[0], lam, u, cdamp, mode)};
    qs[i] = q[0];
    vs[i] = v[0];
    int run = 0;
    AffineMap<T> map(tmat, bvec, mode);
    for (int f = 1; f <= n_frames; ++f) {
      const int r = frame_run != nullptr ? frame_run[f - 1] : 0;
      if (r != run) {
        run = r;
        map = AffineMap<T>(tmat + int64_t{9} * m * r, bvec + int64_t{3} * m * r, mode);
      }
      map.apply(q, v, a);
      qs[f * n + i] = q[0];
      vs[f * n + i] = v[0];
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

// Rows of blocks one wave of the card holds for gx blocks a row of kernel,
// times waves: the affine kernel's persistent grid, so each thread walks
// several env groups.
template <typename K>
int64_t wave_rows(K kernel, int gx, int waves) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kModesX * kGroupsY, 0);
  const int64_t rows = static_cast<int64_t>(sms) * per_sm * waves / gx;
  return rows > 0 ? rows : 1;
}

template <typename T, bool DAMPED, int E>
int launch_frames(int64_t B, int m, int n_frames, int substeps, const void* cols,
                  const void* lam, const void* u, const void* cdamp, const void* q0,
                  const void* v0, void* qs, void* vs, Scalars<T> s, cudaStream_t stream) {
  const dim3 grid = group_grid(EnvGroups<E>::groups(B), m, kMaxGridY);
  modal_frames_kernel<T, DAMPED, E><<<grid, dim3(kModesX, kGroupsY), 0, stream>>>(
      B, m, n_frames, substeps, static_cast<const T*>(cols), static_cast<const T*>(lam),
      static_cast<const T*>(u), static_cast<const T*>(cdamp), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<T*>(qs), static_cast<T*>(vs), s);
  return static_cast<int>(cudaGetLastError());
}

// modal_frames' envs a thread for B env rows of m modes on the current card:
// the most of 4 and 2 whose grid still gives every SM kFrameBlocksPerSm
// blocks, else 1. A thread's envs are independent chains that share its
// coefficient loads and hide each other's latency; a grid that leaves SMs
// idle or unevenly loaded loses more. On the H100 at 3000 modes: 4 at 4096
// envs, 2 at 64.
inline int frames_envs(int64_t B, int m) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t gx = (m + kModesX - 1) / kModesX;
  for (int e = 4; e > 1; e /= 2) {
    const int64_t rows = ((B + e - 1) / e + kGroupsY - 1) / kGroupsY;
    if (gx * rows >= static_cast<int64_t>(kFrameBlocksPerSm) * sms) return e;
  }
  return 1;
}

// modal_frames' instance for E = envs (1, 2 or 4) envs a thread; 0: the
// batch's choice (frames_envs).
template <typename T, bool DAMPED, typename... A>
int launch_frames_envs(int envs, int64_t B, int m, A... args) {
  if (envs == 0) envs = frames_envs(B, m);
  switch (envs) {
    case 1: return launch_frames<T, DAMPED, 1>(B, m, args...);
    case 2: return launch_frames<T, DAMPED, 2>(B, m, args...);
    case 4: return launch_frames<T, DAMPED, 4>(B, m, args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool DRIVE>
int launch_affine(int64_t B, int m, int apps, const void* lam, const void* u,
                  const void* cdamp, const void* tmat, const void* bvec, const void* rtmat,
                  const void* rbvec, const void* q0, const void* v0, const void* a0, void* q1,
                  void* v1, void* a1, cudaStream_t stream) {
  const int gx = (m + kModesX - 1) / kModesX;
  const dim3 grid = group_grid(EnvGroups<kAffineEnvs>::groups(B), m,
                               wave_rows(affine_kernel<T, DRIVE>, gx, kAffineWaves));
  affine_kernel<T, DRIVE><<<grid, dim3(kModesX, kGroupsY), 0, stream>>>(
      B, m, apps, static_cast<const T*>(lam), static_cast<const T*>(u),
      static_cast<const T*>(cdamp), static_cast<const T*>(tmat), static_cast<const T*>(bvec),
      static_cast<const T*>(rtmat), static_cast<const T*>(rbvec), static_cast<const T*>(q0),
      static_cast<const T*>(v0), static_cast<const T*>(a0), static_cast<T*>(q1),
      static_cast<T*>(v1), static_cast<T*>(a1));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_affine_frames(int64_t B, int m, int n_frames, const void* frame_run,
                         const void* lam, const void* u, const void* cdamp, const void* tmat,
                         const void* bvec, const void* q0, const void* v0, void* qs, void* vs,
                         cudaStream_t stream) {
  const dim3 grid = group_grid(B, m, kMaxGridY);
  affine_frames_kernel<T><<<grid, dim3(kModesX, kGroupsY), 0, stream>>>(
      B, m, n_frames, static_cast<const int*>(frame_run), static_cast<const T*>(lam),
      static_cast<const T*>(u), static_cast<const T*>(cdamp), static_cast<const T*>(tmat),
      static_cast<const T*>(bvec), static_cast<const T*>(q0), static_cast<const T*>(v0),
      static_cast<T*>(qs), static_cast<T*>(vs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. n = B * m state elements (n > 0) for the step
// kernel.
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

// B env rows of m modes (B * m > 0); envs: E, the envs a thread carries (1, 2
// or 4; 0: the batch's choice, modal_frames_envs). cols holds p1, p2, p3, p4
// (and p5, p6 when damped) as rows of m; u and cdamp may be null (no force;
// undamped, which damped must then say too).
int modal_frames_launch(int dtype, int damped, int envs, int64_t B, int m, int n_frames,
                        int substeps, const void* cols, const void* lam, const void* u,
                        const void* cdamp, const void* q0, const void* v0, void* qs, void* vs,
                        double h, double c_qp, double c_vp, double bh2, double gh,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Scalars<float> s = scalars<float>(h, c_qp, c_vp, bh2, gh);
    return damped ? launch_frames_envs<float, true>(envs, B, m, n_frames, substeps, cols, lam,
                                                    u, cdamp, q0, v0, qs, vs, s, st)
                  : launch_frames_envs<float, false>(envs, B, m, n_frames, substeps, cols, lam,
                                                     u, cdamp, q0, v0, qs, vs, s, st);
  }
  const Scalars<double> s = scalars<double>(h, c_qp, c_vp, bh2, gh);
  return damped ? launch_frames_envs<double, true>(envs, B, m, n_frames, substeps, cols, lam,
                                                   u, cdamp, q0, v0, qs, vs, s, st)
                : launch_frames_envs<double, false>(envs, B, m, n_frames, substeps, cols, lam,
                                                    u, cdamp, q0, v0, qs, vs, s, st);
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

// B env rows of m modes (B * m > 0); qs and vs (n_frames + 1, B, m). frame_run
// (n_frames ints on the card) may be null (one run); u and cdamp may be null.
int affine_frames_launch(int dtype, int64_t B, int m, int n_frames, const void* frame_run,
                         const void* lam, const void* u, const void* cdamp, const void* tmat,
                         const void* bvec, const void* q0, const void* v0, void* qs, void* vs,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine_frames<float>(B, m, n_frames, frame_run, lam, u, cdamp, tmat, bvec,
                                       q0, v0, qs, vs, st);
  return launch_affine_frames<double>(B, m, n_frames, frame_run, lam, u, cdamp, tmat, bvec, q0,
                                      v0, qs, vs, st);
}

// The envs a modal_frames thread carries when its launch passes envs = 0.
int modal_frames_envs(int64_t B, int m) { return frames_envs(B, m); }

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
