// Block-tridiagonal (3x3 blocks) solve for Hopper (sm_90a), and its adjoint.
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
// no transpose, with a row pitch of a multiple of 16 bytes (the operator pads its rows
// to a multiple of 4 elements; the wrapper copies other rows into such a buffer). The
// factors are packed once, at upload (btd_solve.py: pack_factors), into 16-byte
// aligned blocks of 12 elements, each 3x3 row padded by a zero: fwd (N, 12) holds
// W_{n-1} at node n (zero at node 0), bwd (N, 24) holds Dinv_n then U_n (zero at node
// N-1). With the zero blocks y_0 = r_0 - 0 and x_{N-1} = Dinv (y - 0), so every node
// takes the same step; subtracting a zero that is +0 leaves every value bit for bit.
// The TPU kernel's (3N8, TB) transpose, 8-node groups, identity padding and unrolled
// group recursion are Mosaic layout rules with no counterpart here.
//
// Design: one thread per environment walks the nodes, 32 environments per block
// (4096 envs: 128 blocks, one per SM). The node recursion is a dependent chain, so the
// block streams chunks of 64 nodes (32 in double) through a ring of 7 shared-memory
// slots, and its three warps have one job each:
//   warp 0, the sweep: waits for a chunk, sweeps it in place (y over r going forward,
//     x over y going back), and signals it done; nothing else;
//   warp 1, the loads: one thread issues bulk copies (cp.async.bulk, 16-byte
//     granules) of the chunk's rows, one per environment, and of its packed factors,
//     completing on the slot's "full" mbarrier;
//   warp 2, the stores: one thread waits for a swept chunk and bulk-copies its rows
//     out, then frees the slot ("empty").
// Per-slot mbarriers (full, done, empty) replace block-wide barriers, so the load of
// chunk k + 1 .. k + 6 and the store of chunk k - 1 overlap the sweep of chunk k, and
// the sweeping warp (on its own SM sub-partition) never stops for a copy. Job j sweeps
// chunk j forward for j < n and chunk 2n - 1 - j backward after; chunk k always sits
// in slot k % 7, so the forward sweep's last 7 chunks (448 of 1001 nodes) are never
// stored: the backward sweep finds their y in shared memory. Earlier chunks store y to
// the output rows and load it back. The sweep reads its rows as 16-byte vectors (a
// group of 4 nodes in float, 2 in double: three loads) and each 3x3 factor as three
// 16-byte rows, broadcast to the warp; staged rows are 196 (98) elements apart, an odd
// number of 16-byte units, so the warp's vector accesses meet no bank conflict.
//
// Bound: the least traffic is one read of r and one write of x, 2 * B * 3N elements
// (98.4 MB in float32 at B=4096, N=1001: 0.029 ms at 3.35 TB/s; y's round trip for
// the stored chunks adds traffic, on the copying warps); the arithmetic is 51
// operations per node per environment (2.1e8 in all, 3 us at 67 TFLOP/s). With one
// environment per thread and 31 environments per SM, the sweeping warp bounds the
// kernel: about 24 instructions a node forward and 42 back (3 + 6 vector factor
// loads, 3/G vector row loads and stores, 18 + 36 unfused float operations), some
// 66,000 issue cycles for the 1001-node chain (~0.037 ms at 1.8 GHz), with the
// dependent latency of a node (4 + 8 chained operations) under it; the copies hide
// behind it. On an H100 the kernel takes 0.069 ms on the device (chip_smoke.py,
// phase 17): 2.4x its byte bound, 1.9x that issue estimate.
//
// Rounding: every multiply and add goes through the _rn intrinsics, which the compiler
// never contracts into a fused multiply-add, and each row of a 3x3 product is summed as
// acc = m0*v0; acc += m1*v1; acc += m2*v2, the order of btd_solve in ops/banded.py, so
// kernel and plain version agree bit for bit in float and double.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream, and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---- arithmetic: begin ------------------------------------------------------
// Plain device code: no copies, no barriers, no CUDA types but float4 and
// double2. tests/test_torch_banded.py builds the lines from this mark to
// "arithmetic: end" with the host compiler and runs the adjoint's jobs on them.

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

constexpr int kEnvs = 32;            // environments per block: a sweeping warp's lanes
constexpr int kThreads = 3 * 32;     // the sweep, the loads, the stores
constexpr int kSlots = 7;            // ring slots of one chunk each

// Per type: nodes per chunk, the staged row's length (elements), the nodes a
// 16-byte vector of rows covers.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kNodes = 64;
  static constexpr int kStride = 3 * 64 + 4;  // 49 16-byte units: odd
  static constexpr int kGroup = 4;            // 12 floats = three float4
};
template <>
struct Cfg<double> {
  static constexpr int kNodes = 32;
  static constexpr int kStride = 3 * 32 + 2;  // 49 16-byte units: odd
  static constexpr int kGroup = 2;            // 6 doubles = three double2
};

// A slot: kEnvs staged rows, then 24 factor elements per node.
template <typename T>
struct Slot {
  static constexpr int kRows = kEnvs * Cfg<T>::kStride;
  static constexpr int kElems = kRows + 24 * Cfg<T>::kNodes;
  static constexpr int kBytes = kElems * static_cast<int>(sizeof(T));
  static constexpr int kSmem = kSlots * kBytes + 3 * kSlots * 8;  // + the mbarriers
};
static_assert(Slot<float>::kBytes % 16 == 0 && Slot<double>::kBytes % 16 == 0, "slots");
static_assert(Slot<float>::kSmem <= 232448 && Slot<double>::kSmem <= 232448, "smem");

// 16-byte vector loads and stores of consecutive elements.
__device__ __forceinline__ void unpack(const float4& v, float* d) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* d) {
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* s, float) {
  return make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ double2 pack(const double* s, double) {
  return make_double2(s[0], s[1]);
}
template <typename T>
struct V16;
template <>
struct V16<float> {
  using type = float4;
};
template <>
struct V16<double> {
  using type = double2;
};
template <typename T>
using Vec16 = typename V16<T>::type;

template <int K, typename T>
__device__ __forceinline__ void ld16(T* dst, const T* src) {
  constexpr int n = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < K / n; ++i) unpack(reinterpret_cast<const Vec16<T>*>(src)[i], dst + n * i);
}
template <int K, typename T>
__device__ __forceinline__ void st16(T* dst, const T* src) {
  constexpr int n = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < K / n; ++i) reinterpret_cast<Vec16<T>*>(dst)[i] = pack(src + n * i, T(0));
}

// A chunk's rows as copied: 3 cn elements rounded up to 16 bytes (the row
// pitches leave room for them).
template <typename T>
__device__ __forceinline__ uint32_t row_bytes(int cn) {
  return (3u * cn * static_cast<uint32_t>(sizeof(T)) + 15u) & ~15u;
}

// One row of a 3x3 product: m[0]*v0 + m[1]*v1 + m[2]*v2, summed from the left.
template <typename T>
__device__ __forceinline__ T row(const T* m, T v0, T v1, T v2) {
  return add(add(mul(m[0], v0), mul(m[1], v1)), mul(m[2], v2));
}

// One entry of a transposed 3x3 product: m[0][j]*v0 + m[1][j]*v1 + m[2][j]*v2
// (rows of four, as packed), summed from the left.
template <typename T>
__device__ __forceinline__ T col(const T* m, int j, T v0, T v1, T v2) {
  return add(add(mul(m[j], v0), mul(m[4 + j], v1)), mul(m[8 + j], v2));
}

// The node steps. Each sweeps one node's three rows c in place, carrying its
// chain in v0..v2, and reads F factor elements a node (the packed block(s)
// of that node); the sweeps below take a step as their template argument.
//   Forward   (btd_solve):  y = c - W y, W the node's fwd block (W_{n-1}).
//   Backward  (btd_solve):  x = Dinv (c - U x), the node's bwd blocks.
//   SStep     (adjoint):    s = Dinv^T (c - q), then q = U^T s for the next
//                           node (q = +0 before node 0: c - 0 is c).
//   BbarStep  (adjoint):    b = c - p, then p = W^T b for the node before
//                           (p = +0 past node N-1: b_bar_{N-1} = s_{N-1}).
struct Forward {
  static constexpr int F = 12;
  template <typename T>
  static __device__ __forceinline__ void step(const T* w, T* c, T& y0, T& y1, T& y2) {
    const T a0 = sub(c[0], row(w, y0, y1, y2));
    const T a1 = sub(c[1], row(w + 4, y0, y1, y2));
    const T a2 = sub(c[2], row(w + 8, y0, y1, y2));
    c[0] = y0 = a0;
    c[1] = y1 = a1;
    c[2] = y2 = a2;
  }
};
struct Backward {  // f holds Dinv then U
  static constexpr int F = 24;
  template <typename T>
  static __device__ __forceinline__ void step(const T* f, T* c, T& x0, T& x1, T& x2) {
    const T a0 = sub(c[0], row(f + 12, x0, x1, x2));
    const T a1 = sub(c[1], row(f + 16, x0, x1, x2));
    const T a2 = sub(c[2], row(f + 20, x0, x1, x2));
    c[0] = x0 = row(f, a0, a1, a2);
    c[1] = x1 = row(f + 4, a0, a1, a2);
    c[2] = x2 = row(f + 8, a0, a1, a2);
  }
};
struct SStep {  // f holds Dinv then U
  static constexpr int F = 24;
  template <typename T>
  static __device__ __forceinline__ void step(const T* f, T* c, T& q0, T& q1, T& q2) {
    const T a0 = sub(c[0], q0), a1 = sub(c[1], q1), a2 = sub(c[2], q2);
    const T s0 = col(f, 0, a0, a1, a2), s1 = col(f, 1, a0, a1, a2), s2 = col(f, 2, a0, a1, a2);
    c[0] = s0;
    c[1] = s1;
    c[2] = s2;
    q0 = col(f + 12, 0, s0, s1, s2);
    q1 = col(f + 12, 1, s0, s1, s2);
    q2 = col(f + 12, 2, s0, s1, s2);
  }
};
struct BbarStep {  // w: the node's fwd block, W_{n-1}
  static constexpr int F = 12;
  template <typename T>
  static __device__ __forceinline__ void step(const T* w, T* c, T& p0, T& p1, T& p2) {
    const T b0 = sub(c[0], p0), b1 = sub(c[1], p1), b2 = sub(c[2], p2);
    c[0] = b0;
    c[1] = b1;
    c[2] = b2;
    p0 = col(w, 0, b0, b1, b2);
    p1 = col(w, 1, b0, b1, b2);
    p2 = col(w, 2, b0, b1, b2);
  }
};

// The sweeps over one staged row r (3 elements per node, swept in place) of
// a chunk of cn nodes with factors f (Step::F per node): sweep_up from node
// 0, sweep_down from node cn - 1. They are a sweeping warp's whole critical
// path, so every load runs ahead of the arithmetic that needs it and no
// branch splits the steady state: nodes go in pairs of groups of G nodes (a
// group's rows are three 16-byte vectors), the next group's rows and the
// next node's factors load while a node is computed, into two register sets
// used in turn (so no register copies), and look-ahead indices are clamped
// inside the slot rather than tested. The nodes past the last whole pair of
// groups (the chunk's ragged end) take a plain loop.
template <typename Step, typename T>
__device__ __forceinline__ void sweep_up(T* r, const T* f, int cn, T& v0, T& v1, T& v2) {
  constexpr int G = Cfg<T>::kGroup, F = Step::F;
  const int whole = cn - cn % (2 * G);
  T fa[F], fb[F], ca[3 * G], cb[3 * G];
  ld16<F>(fa, f);
  ld16<3 * G>(ca, r);
  for (int j0 = 0; j0 < whole; j0 += 2 * G) {
    // Group a: nodes j0 .. j0 + G - 1; group b's rows load meanwhile.
    ld16<3 * G>(cb, r + 3 * (j0 + G));
#pragma unroll
    for (int q = 0; q < G; q += 2) {
      ld16<F>(fb, f + F * (j0 + q + 1));
      Step::step(fa, ca + 3 * q, v0, v1, v2);
      ld16<F>(fa, f + F * (j0 + q + 2));
      Step::step(fb, ca + 3 * q + 3, v0, v1, v2);
    }
    st16<3 * G>(r + 3 * j0, ca);
    // Group b: the next pair's first rows load meanwhile (past the chunk's
    // last pair they are unused: the reads stay in the slot).
    ld16<3 * G>(ca, r + 3 * (j0 + 2 * G));
#pragma unroll
    for (int q = 0; q < G; q += 2) {
      ld16<F>(fb, f + F * min(j0 + G + q + 1, cn - 1));
      Step::step(fa, cb + 3 * q, v0, v1, v2);
      ld16<F>(fa, f + F * min(j0 + G + q + 2, cn - 1));
      Step::step(fb, cb + 3 * q + 3, v0, v1, v2);
    }
    st16<3 * G>(r + 3 * (j0 + G), cb);
  }
  for (int j = whole; j < cn; ++j) {
    ld16<F>(fa, f + F * j);
    T c[3] = {r[3 * j], r[3 * j + 1], r[3 * j + 2]};
    Step::step(fa, c, v0, v1, v2);
    r[3 * j] = c[0];
    r[3 * j + 1] = c[1];
    r[3 * j + 2] = c[2];
  }
}

template <typename Step, typename T>
__device__ __forceinline__ void sweep_down(T* r, const T* f, int cn, T& v0, T& v1, T& v2) {
  constexpr int G = Cfg<T>::kGroup, F = Step::F;
  const int whole = cn - cn % (2 * G);
  T fa[F], fb[F], ca[3 * G], cb[3 * G];
  for (int j = cn - 1; j >= whole; --j) {
    ld16<F>(fa, f + F * j);
    T c[3] = {r[3 * j], r[3 * j + 1], r[3 * j + 2]};
    Step::step(fa, c, v0, v1, v2);
    r[3 * j] = c[0];
    r[3 * j + 1] = c[1];
    r[3 * j + 2] = c[2];
  }
  if (whole == 0) return;
  ld16<F>(fa, f + F * (whole - 1));
  ld16<3 * G>(ca, r + 3 * (whole - G));
  for (int j0 = whole - 2 * G; j0 >= 0; j0 -= 2 * G) {
    // Group a: nodes j0 + 2G - 1 .. j0 + G; group b's rows load meanwhile.
    ld16<3 * G>(cb, r + 3 * j0);
#pragma unroll
    for (int q = G - 1; q > 0; q -= 2) {
      ld16<F>(fb, f + F * (j0 + G + q - 1));
      Step::step(fa, ca + 3 * q, v0, v1, v2);
      ld16<F>(fa, f + F * (j0 + G + q - 2));
      Step::step(fb, ca + 3 * q - 3, v0, v1, v2);
    }
    st16<3 * G>(r + 3 * (j0 + G), ca);
    // Group b: nodes j0 + G - 1 .. j0; the next pair's first rows load
    // meanwhile (clamped at node 0: unused there).
    ld16<3 * G>(ca, r + 3 * max(j0 - G, 0));
#pragma unroll
    for (int q = G - 1; q > 0; q -= 2) {
      ld16<F>(fb, f + F * (j0 + q - 1));
      Step::step(fa, cb + 3 * q, v0, v1, v2);
      ld16<F>(fa, f + F * max(j0 + q - 2, 0));
      Step::step(fb, cb + 3 * q - 3, v0, v1, v2);
    }
    st16<3 * G>(r + 3 * j0, cb);
  }
}

// ---------------------------------------------------------------------------
// btd_solve_adjoint: the reverse-mode derivative of the solve. It replaces
// no TPU kernel: the JAX package differentiates the TPU kernel's plain twin
// (the jnp scans of ops/banded.py) with its own transposes, and this kernel
// is the counterpart of those transposed scans. For the cotangent g = dL/dx
// of B right-hand sides b it runs, per row, the three sequential sweeps of
// btd_adjoint_sweeps in ops/banded.py against the packed fwd and bwd factors
// of btd_solve_kernel:
//   y     y_0 = b_0,              y_i = b_i - W_{i-1} y_{i-1}   (the forward sweep again)
//   s     s_0 = Dinv_0^T g_0,     s_i = Dinv_i^T (g_i - U_{i-1}^T s_{i-1})
//   bbar  bbar_{N-1} = s_{N-1},   bbar_i = s_i - W_i^T bbar_{i+1}
// and writes y, s and bbar; the factor cotangents (batch sums of outer
// products) are torch products over these (btd_adjoint_factors).
//
// Design: btd_solve_kernel's, for three chains. A block owns 32 rows and
// streams chunks of 32 nodes (16 in double) through a ring of 7 shared-memory
// slots; a slot holds the chunk's b and g rows of the 32 rows and its packed
// fwd and bwd factors. Four warps, one job each:
//   warp 0, the y sweep: each ascending chunk's b rows into y (Forward), a
//     lane a row, the factors broadcast;
//   warp 1, the s sweep and then the bbar sweep: each ascending chunk's g
//     rows into s (SStep), then from the last chunk down each chunk's s rows
//     into bbar (BbarStep). The y and s chains share no data, so they run at
//     once on two SM sub-partitions; the s chain's 33 operations a node
//     (against y's 18) set the ascending pass's pace;
//   warp 2, the loads: one thread bulk-copies (cp.async.bulk, 16-byte
//     granules) a job's rows and factors into its slot, completing on the
//     slot's "full" mbarrier;
//   warp 3, the stores: one thread waits for a swept job ("done": both
//     sweeping warps ascending, warp 1 descending) and bulk-copies its rows
//     out (y and s, then bbar), then frees the slot ("empty").
// Job j < n sweeps chunk j ascending, job n + i chunk n - 1 - i descending;
// chunk k always sits in slot k % 7, so the last 7 chunks (224 of 1001 nodes;
// 112 in double) are resident: the descending job finds their s and their
// fwd factors in the slot and loads nothing. Their s is still stored (the
// factor sums read it). Earlier chunks load s back from the output rows.
// A slot holds two row sets, so its chunk is half the forward kernel's 64
// nodes (32 in double) at the same 7 slots: 2 x 32 rows x 100 elements (50
// in double) and 36 factor elements a node make 30,208 bytes, 7 slots 211 KB
// of the 227 KB a block may have. Three slots of 64 nodes would fit as well,
// but a three-slot ring cannot keep a load ahead of the sweep while a store
// drains, and would keep 192 nodes resident instead of 224. Staged rows are
// 100 (50) elements apart, 25 16-byte units, an odd number, so the sweeping
// warps' vector accesses meet no bank conflict.
//
// Bound: the least traffic reads b and g once and writes y, s and bbar once,
// 5 x B x 3N elements (246 MB in float32 at B = 4096, N = 1001, with the
// factors: 0.0735 ms at 3.35 TB/s); the arithmetic is 18 + 33 + 18 operations
// a node (2.8e8 in all, 4 us at 67 TFLOP/s). The round trip of s for the
// chunks that are not resident adds 777 / 1001 of one array's read (38 MB,
// 0.011 ms), on the copying warps. Instruction issue: the ascending pass is the s warp's,
// about 41 instructions a node (6 vector factor loads, 3/G vector row loads
// and stores, 33 unfused float operations), beside the y warp's 24; the
// descending pass about 23 (3 + 3/G + 18): some 64,000 issue cycles for the
// 1001-node chains (~0.036 ms at 1.8 GHz), under the copies' floor of about
// 5.8 arrays (0.085 ms). On an H100 the kernel takes 0.136 ms on the device
// at B = 4096, N = 1001 in float32 (0.270 in float64; chip_smoke.py, phase
// 45): 1.85x its byte bound, 1.6x the copies' floor. The simple kernel
// before it (a thread walking its row's three sweeps in global memory) took
// 0.96-1.04 ms.
//
// Rounding: every product row summed from the left with the _rn intrinsics,
// as in btd_solve and in the plain version, so the two agree bit for bit;
// the carried products start from +0, and c - (+0) is c.
// ---------------------------------------------------------------------------

// Per type: nodes per chunk and the staged row's length (elements).
template <typename T>
struct AdjCfg;
template <>
struct AdjCfg<float> {
  static constexpr int kNodes = 32;
  static constexpr int kStride = 3 * 32 + 4;  // 25 16-byte units: odd
};
template <>
struct AdjCfg<double> {
  static constexpr int kNodes = 16;
  static constexpr int kStride = 3 * 16 + 2;  // 25 16-byte units: odd
};
constexpr int kAdjSlots = 7;
constexpr int kAdjThreads = 4 * 32;  // the y sweep, the s and bbar sweeps, the loads, the stores

// A slot: the b rows (swept into y), the g rows (swept into s; descending,
// the s rows swept into bbar), the chunk's fwd (12 a node) and bwd (24 a
// node) factors.
template <typename T>
struct AdjSlot {
  static constexpr int kRows = kEnvs * AdjCfg<T>::kStride;  // one row set
  static constexpr int kFwd = 2 * kRows;
  static constexpr int kBwd = kFwd + 12 * AdjCfg<T>::kNodes;
  static constexpr int kElems = kBwd + 24 * AdjCfg<T>::kNodes;
  static constexpr int kBytes = kElems * static_cast<int>(sizeof(T));
  static constexpr int kSmem = kAdjSlots * kBytes + 3 * kAdjSlots * 8;  // + the mbarriers
};
static_assert(AdjSlot<float>::kBytes % 16 == 0 && AdjSlot<double>::kBytes % 16 == 0, "slots");
static_assert(AdjSlot<float>::kSmem <= 232448 && AdjSlot<double>::kSmem <= 232448, "smem");

// 0: nodes a chunk, 1: ring slots (the C query btd_solve_adjoint_geometry).
template <typename T>
int adjoint_geometry(int what) {
  return what == 0 ? AdjCfg<T>::kNodes : kAdjSlots;
}

// The launch's operands: (B, 3N) rows of pitch ld_* elements (ld_g = 0: one
// g row shared by the whole batch).
template <typename T>
struct AdjArgs {
  int B, N;
  int64_t ld_b, ld_g, ld_out;
  const T* fwd;
  const T* bwd;
  const T* b;
  const T* g;
  T* y;
  T* s;
  T* bbar;
};

template <typename T>
AdjArgs<T> adjoint_args(int B, int N, int64_t ld_b, int64_t ld_g, int64_t ld_out,
                        const void* fwd, const void* bwd, const void* b, const void* g,
                        void* y, void* s, void* bbar) {
  return AdjArgs<T>{B, N, ld_b, ld_g, ld_out, static_cast<const T*>(fwd),
                    static_cast<const T*>(bwd), static_cast<const T*>(b),
                    static_cast<const T*>(g), static_cast<T*>(y), static_cast<T*>(s),
                    static_cast<T*>(bbar)};
}

// The schedule of a block's jobs: job j < n sweeps chunk j ascending (y and
// s), job n + i chunk n - 1 - i descending (bbar); chunk k sits in slot
// k % kAdjSlots, and the last kAdjSlots chunks stay resident.
template <typename T>
struct AdjPlan {
  static constexpr int C = AdjCfg<T>::kNodes;
  int N, n_chunks;
  __device__ explicit AdjPlan(int n) : N(n), n_chunks((n + C - 1) / C) {}
  __device__ int jobs() const { return 2 * n_chunks; }
  __device__ bool up(int j) const { return j < n_chunks; }
  __device__ int chunk(int j) const { return up(j) ? j : 2 * n_chunks - 1 - j; }
  __device__ int slot(int j) const { return chunk(j) % kAdjSlots; }
  __device__ int nodes(int k) const { return min(C, N - k * C); }
  __device__ bool resident(int k) const { return k >= n_chunks - kAdjSlots; }
};

// The copies that fill job j's slot for the block's rows env0 .. env0 + nb
// - 1, as copy(shared dst, global src, bytes) calls (16-byte multiples);
// returns their bytes. Ascending: the chunk's fwd and bwd factors, its b
// and g rows. Descending: nothing for a resident chunk, else its fwd
// factors and the s rows the ascending stores left in the output.
template <typename T, typename Copy>
__device__ __forceinline__ uint32_t adjoint_loads(const AdjArgs<T>& a, const AdjPlan<T>& plan,
                                                  int env0, int nb, int j, T* slot, Copy copy) {
  using S = AdjSlot<T>;
  const int k = plan.chunk(j), n0 = k * AdjCfg<T>::kNodes, cn = plan.nodes(k);
  const bool up = plan.up(j);
  if (!up && plan.resident(k)) return 0;
  const uint32_t fb = 12u * cn * static_cast<uint32_t>(sizeof(T)), rb = row_bytes<T>(cn);
  copy(slot + S::kFwd, a.fwd + 12LL * n0, fb);
  if (up) copy(slot + S::kBwd, a.bwd + 24LL * n0, 2 * fb);
  for (int r = 0; r < nb; ++r) {
    T* const dst = slot + r * AdjCfg<T>::kStride;
    if (up) {
      copy(dst, a.b + (env0 + r) * a.ld_b + 3LL * n0, rb);
      copy(dst + S::kRows, a.g + (env0 + r) * a.ld_g + 3LL * n0, rb);
    } else {
      copy(dst + S::kRows, a.s + (env0 + r) * a.ld_out + 3LL * n0, rb);
    }
  }
  return (up ? 3 * fb + 2 * nb * rb : fb + nb * rb);
}

// The copies that empty job j's slot, as copy(global dst, shared src,
// bytes) calls: ascending y and s (a resident chunk's s too: the factor
// sums read it), descending bbar.
template <typename T, typename Copy>
__device__ __forceinline__ void adjoint_stores(const AdjArgs<T>& a, const AdjPlan<T>& plan,
                                               int env0, int nb, int j, const T* slot,
                                               Copy copy) {
  using S = AdjSlot<T>;
  const int k = plan.chunk(j);
  const uint32_t rb = row_bytes<T>(plan.nodes(k));
  for (int r = 0; r < nb; ++r) {
    const T* const src = slot + r * AdjCfg<T>::kStride;
    const int64_t at = (env0 + r) * a.ld_out + 3LL * k * AdjCfg<T>::kNodes;
    if (plan.up(j)) {
      copy(a.y + at, src, rb);
      copy(a.s + at, src + S::kRows, rb);
    } else {
      copy(a.bbar + at, src + S::kRows, rb);
    }
  }
}

// One lane's sweep of job j's staged chunk, its chain carried in v0..v2:
// role 0 (ascending jobs only) y over the b rows with fwd; role 1 s over the
// g rows with bwd ascending, then bbar over the s rows with fwd descending
// (the carry restarts from +0 at the last chunk).
template <int Role, typename T>
__device__ __forceinline__ void adjoint_sweep(const AdjPlan<T>& plan, int j, T* slot, int lane,
                                              T& v0, T& v1, T& v2) {
  using S = AdjSlot<T>;
  T* const rows = slot + lane * AdjCfg<T>::kStride;
  const int cn = plan.nodes(plan.chunk(j));
  if constexpr (Role == 0) {
    sweep_up<Forward>(rows, slot + S::kFwd, cn, v0, v1, v2);
  } else if (plan.up(j)) {
    sweep_up<SStep>(rows + S::kRows, slot + S::kBwd, cn, v0, v1, v2);
  } else {
    if (j == plan.n_chunks) v0 = v1 = v2 = T(0);
    sweep_down<BbarStep>(rows + S::kRows, slot + S::kFwd, cn, v0, v1, v2);
  }
}

// ---- arithmetic: end --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copies (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    btd_solve_kernel(int B, int N, int64_t ld_in, int64_t ld_out, const T* __restrict__ fwd,
                     const T* __restrict__ bwd, const T* __restrict__ rhs, T* out) {
  constexpr int C = Cfg<T>::kNodes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const uint32_t slots_u32 = smem_u32(smem_raw);
  const uint32_t bars = slots_u32 + kSlots * Slot<T>::kBytes;
  // full[s] (the loads landed), done[s] (the sweep finished), empty[s] (the
  // stores have read the slot): one phase per use of slot s.
  auto full = [&](int s) { return bars + 8 * s; };
  auto done = [&](int s) { return bars + 8 * (kSlots + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kSlots + s); };
  auto rows = [&](int s) { return slots + s * Slot<T>::kElems; };
  auto factors = [&](int s) { return slots + s * Slot<T>::kElems + Slot<T>::kRows; };

  const int env0 = blockIdx.x * kEnvs;
  const int nb = min(kEnvs, B - env0);
  const int n_chunks = (N + C - 1) / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(done(s), 32);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Job j: chunk k forward (j < n) or backward, in slot k % kSlots. A chunk
  // of the forward sweep's last kSlots stays resident: its y is neither
  // stored nor loaded back. Each role waits on every phase of its barriers in
  // job order, so one parity bit per slot follows them.
  const int n_jobs = 2 * n_chunks;
  auto chunk_of = [&](int j) { return j < n_chunks ? j : n_jobs - 1 - j; };
  auto resident = [&](int k) { return k >= n_chunks - kSlots; };

  if (warp == 0) {  // the sweep
    uint32_t parity = 0;
    T y0 = T(0), y1 = T(0), y2 = T(0), x0 = T(0), x1 = T(0), x2 = T(0);
    for (int j = 0; j < n_jobs; ++j) {
      const int k = chunk_of(j), s = k % kSlots;
      const int cn = min(C, N - k * C);
      mbar_wait(full(s), (parity >> s) & 1u);
      parity ^= 1u << s;
      if (lane < nb) {
        T* const r = rows(s) + lane * Cfg<T>::kStride;
        if (j < n_chunks) {
          sweep_up<Forward>(r, factors(s), cn, y0, y1, y2);
        } else {
          sweep_down<Backward>(r, factors(s), cn, x0, x1, x2);
        }
      }
      // The stores read this slot through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(done(s));
    }
  } else if (warp == 1 && lane == 0) {  // the loads
    uint32_t parity = 0, used = 0;
    for (int j = 0; j < n_jobs; ++j) {
      const bool forward = j < n_chunks;
      const int k = chunk_of(j), s = k % kSlots;
      const int n0 = k * C, cn = min(C, N - n0);
      if ((used >> s) & 1u) {  // the slot's last job has been swept and stored
        mbar_wait(empty(s), (parity >> s) & 1u);
        parity ^= 1u << s;
      }
      used |= 1u << s;
      const bool with_rows = forward || !resident(k);
      const uint32_t fac_bytes = (forward ? 12u : 24u) * cn * sizeof(T);
      const uint32_t rb = row_bytes<T>(cn);
      mbar_expect_tx(full(s), fac_bytes + (with_rows ? nb * rb : 0u));
      bulk_load(smem_u32(factors(s)), forward ? fwd + 12LL * n0 : bwd + 24LL * n0, fac_bytes,
                full(s));
      if (with_rows) {
        // Backward: y as the stores left it in the output rows.
        if (!forward) asm volatile("fence.proxy.async.global;" ::: "memory");
        const T* src = forward ? rhs : out;
        const int64_t ld = forward ? ld_in : ld_out;
        for (int b = 0; b < nb; ++b)
          bulk_load(smem_u32(rows(s) + b * Cfg<T>::kStride), src + (env0 + b) * ld + 3LL * n0,
                    rb, full(s));
      }
    }
  } else if (warp == 2 && lane == 0) {  // the stores
    uint32_t parity = 0;
    for (int j = 0; j < n_jobs; ++j) {
      const bool forward = j < n_chunks;
      const int k = chunk_of(j), s = k % kSlots;
      const int n0 = k * C, cn = min(C, N - n0);
      mbar_wait(done(s), (parity >> s) & 1u);
      parity ^= 1u << s;
      if (!forward || !resident(k)) {
        const uint32_t rb = row_bytes<T>(cn);
        for (int b = 0; b < nb; ++b)
          bulk_store(out + (env0 + b) * ld_out + 3LL * n0,
                     smem_u32(rows(s) + b * Cfg<T>::kStride), rb);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        // Done writing, not only reading: a stored y is loaded back later.
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      }
      mbar_arrive(empty(s));
    }
  }
}

// The adjoint (see its note above): the jobs of adjoint_loads, adjoint_sweep
// and adjoint_stores on per-slot mbarriers, as btd_solve_kernel's roles.
template <typename T>
__global__ void __launch_bounds__(kAdjThreads, 1) btd_adjoint_kernel(const AdjArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const uint32_t bars = smem_u32(smem_raw) + kAdjSlots * AdjSlot<T>::kBytes;
  // full[s] (the loads landed), done[s] (the job's sweeps finished: 64
  // arrivals), empty[s] (the stores have finished with the slot): one phase
  // per use of slot s.
  auto full = [&](int s) { return bars + 8 * s; };
  auto done = [&](int s) { return bars + 8 * (kAdjSlots + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kAdjSlots + s); };
  auto slot = [&](int s) { return slots + s * AdjSlot<T>::kElems; };

  const AdjPlan<T> plan(a.N);
  const int env0 = blockIdx.x * kEnvs;
  const int nb = min(kEnvs, a.B - env0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAdjSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(done(s), 64);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Each role waits on every phase of its barriers in job order, so one
  // parity bit per slot follows them.
  if (warp < 2) {  // the sweeps: warp 0 the ascending jobs, warp 1 every job
    const int n_jobs = warp == 0 ? plan.n_chunks : plan.jobs();
    uint32_t parity = 0;
    T v0 = T(0), v1 = T(0), v2 = T(0);
    for (int j = 0; j < n_jobs; ++j) {
      const int s = plan.slot(j);
      mbar_wait(full(s), (parity >> s) & 1u);
      parity ^= 1u << s;
      if (lane < nb) {
        if (warp == 0) {
          adjoint_sweep<0>(plan, j, slot(s), lane, v0, v1, v2);
        } else {
          adjoint_sweep<1>(plan, j, slot(s), lane, v0, v1, v2);
        }
      }
      // The stores read this slot through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      // Descending, warp 1 arrives for both.
      mbar_arrive(done(s), plan.up(j) ? 1u : 2u);
    }
  } else if (warp == 2 && lane == 0) {  // the loads
    uint32_t parity = 0, used = 0;
    for (int j = 0; j < plan.jobs(); ++j) {
      const int s = plan.slot(j);
      if ((used >> s) & 1u) {  // the slot's last job has been swept and stored
        mbar_wait(empty(s), (parity >> s) & 1u);
        parity ^= 1u << s;
      }
      used |= 1u << s;
      const uint32_t bytes =
          adjoint_loads(a, plan, env0, nb, j, slot(s), [](T*, const T*, uint32_t) {});
      if (bytes == 0) {  // a resident chunk, descending
        mbar_arrive(full(s));
        continue;
      }
      mbar_expect_tx(full(s), bytes);
      // Descending: s as the stores left it in the output rows.
      if (!plan.up(j)) asm volatile("fence.proxy.async.global;" ::: "memory");
      adjoint_loads(a, plan, env0, nb, j, slot(s), [&](T* dst, const T* src, uint32_t n) {
        bulk_load(smem_u32(dst), src, n, full(s));
      });
    }
  } else if (warp == 3 && lane == 0) {  // the stores
    uint32_t parity = 0;
    for (int j = 0; j < plan.jobs(); ++j) {
      const int s = plan.slot(j);
      mbar_wait(done(s), (parity >> s) & 1u);
      parity ^= 1u << s;
      adjoint_stores(a, plan, env0, nb, j, slot(s), [](T* dst, const T* src, uint32_t n) {
        bulk_store(dst, smem_u32(src), n);
      });
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (plan.up(j)) {
        // Done writing, not only reading: a stored s is loaded back later.
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      mbar_arrive(empty(s));
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// Per device and instance, whether a kernel may use its dynamic shared
// memory (set once, read on every launch): btd_solve_kernel float, double,
// btd_adjoint_kernel float, double.
constexpr int kMaxDevices = 64;
bool g_smem_set[4][kMaxDevices];

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* set) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set[dev]) {
    rc = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (rc != 0) return rc;
    set[dev] = true;
  }
  return 0;
}

template <typename T>
int launch(int B, int N, int64_t ld_in, int64_t ld_out, const void* fwd, const void* bwd,
           const void* rhs, void* out, cudaStream_t stream) {
  const int rc =
      allow_smem(btd_solve_kernel<T>, Slot<T>::kSmem, g_smem_set[sizeof(T) == 4 ? 0 : 1]);
  if (rc != 0) return rc;
  btd_solve_kernel<T><<<(B + kEnvs - 1) / kEnvs, kThreads, Slot<T>::kSmem, stream>>>(
      B, N, ld_in, ld_out, static_cast<const T*>(fwd), static_cast<const T*>(bwd),
      static_cast<const T*>(rhs), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adjoint(const AdjArgs<T>& a, cudaStream_t stream) {
  const int rc = allow_smem(btd_adjoint_kernel<T>, AdjSlot<T>::kSmem,
                            g_smem_set[sizeof(T) == 4 ? 2 : 3]);
  if (rc != 0) return rc;
  btd_adjoint_kernel<T><<<(a.B + kEnvs - 1) / kEnvs, kAdjThreads, AdjSlot<T>::kSmem, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. B >= 1 right-hand sides of N >= 1 nodes; rhs and
// out are (B, 3N) rows with pitches ld_in and ld_out (elements; 16-byte multiples,
// with room for 3N rounded up to 16 bytes), 16-byte aligned; fwd (N, 12) and bwd
// (N, 24) the packed factors; all on one device. Returns the cudaError_t of the
// launch (0 on success).
extern "C" {

int btd_solve_launch(int dtype, int B, int N, int64_t ld_in, int64_t ld_out, const void* fwd,
                     const void* bwd, const void* rhs, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(B, N, ld_in, ld_out, fwd, bwd, rhs, out, st);
  return launch<double>(B, N, ld_in, ld_out, fwd, bwd, rhs, out, st);
}

// dtype as above. B >= 1 rows of N >= 1 nodes: b (the solve's right-hand
// sides), g (the cotangent of its result; ld_g = 0 for one row shared by the
// batch) and the outputs y, s, bbar are (B, 3N) rows of pitches ld_b, ld_g
// and ld_out, laid out as btd_solve_launch's rows; fwd and bwd the packed
// factors. Returns the cudaError_t of the launch.
int btd_solve_adjoint_launch(int dtype, int B, int N, int64_t ld_b, int64_t ld_g, int64_t ld_out,
                             const void* fwd, const void* bwd, const void* b, const void* g,
                             void* y, void* s, void* bbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_adjoint(
        adjoint_args<float>(B, N, ld_b, ld_g, ld_out, fwd, bwd, b, g, y, s, bbar), st);
  return launch_adjoint(
      adjoint_args<double>(B, N, ld_b, ld_g, ld_out, fwd, bwd, b, g, y, s, bbar), st);
}

// The adjoint's chunk (what = 0: nodes a chunk) and ring (1: slots) for dtype.
int btd_solve_adjoint_geometry(int dtype, int what) {
  return dtype == 0 ? adjoint_geometry<float>(what) : adjoint_geometry<double>(what);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
