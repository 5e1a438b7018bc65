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

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

constexpr int kEnvs = 32;            // environments per block: warp 0's lanes
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

// One row of a 3x3 product: m[0]*v0 + m[1]*v1 + m[2]*v2, summed from the left.
template <typename T>
__device__ __forceinline__ T row(const T* m, T v0, T v1, T v2) {
  return add(add(mul(m[0], v0), mul(m[1], v1)), mul(m[2], v2));
}

// One forward node: y = c - W y, written over the node's three rows c.
template <typename T>
__device__ __forceinline__ void forward_node(const T* w, T* c, T& y0, T& y1, T& y2) {
  const T a0 = sub(c[0], row(w, y0, y1, y2));
  const T a1 = sub(c[1], row(w + 4, y0, y1, y2));
  const T a2 = sub(c[2], row(w + 8, y0, y1, y2));
  c[0] = y0 = a0;
  c[1] = y1 = a1;
  c[2] = y2 = a2;
}

// One backward node: x = Dinv (y - U x), written over the node's rows y;
// f holds Dinv then U.
template <typename T>
__device__ __forceinline__ void backward_node(const T* f, T* c, T& x0, T& x1, T& x2) {
  const T a0 = sub(c[0], row(f + 12, x0, x1, x2));
  const T a1 = sub(c[1], row(f + 16, x0, x1, x2));
  const T a2 = sub(c[2], row(f + 20, x0, x1, x2));
  c[0] = x0 = row(f, a0, a1, a2);
  c[1] = x1 = row(f + 4, a0, a1, a2);
  c[2] = x2 = row(f + 8, a0, a1, a2);
}

// The sweeps over one staged row r (3 elements per node, swept in place)
// of a chunk of cn nodes, factors f (F = 12 forward, 24 backward per node).
// They are the warp's whole critical path, so every load runs ahead of the
// arithmetic that needs it and no branch splits the steady state: nodes go
// in pairs of groups of G nodes (a group's rows are three 16-byte vectors),
// the next group's rows and the next node's factors load while a node is
// computed, into two register sets used in turn (so no register copies),
// and look-ahead indices are clamped inside the slot rather than tested.
// The nodes past the last whole pair of groups (the chunk's ragged end)
// take a plain loop.
template <typename T>
__device__ __forceinline__ void sweep_forward(T* r, const T* f, int cn, T& y0, T& y1, T& y2) {
  constexpr int G = Cfg<T>::kGroup, F = 12;
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
      forward_node(fa, ca + 3 * q, y0, y1, y2);
      ld16<F>(fa, f + F * (j0 + q + 2));
      forward_node(fb, ca + 3 * q + 3, y0, y1, y2);
    }
    st16<3 * G>(r + 3 * j0, ca);
    // Group b: the next pair's first rows load meanwhile (past the chunk's
    // last pair they are unused: the reads stay in the slot).
    ld16<3 * G>(ca, r + 3 * (j0 + 2 * G));
#pragma unroll
    for (int q = 0; q < G; q += 2) {
      ld16<F>(fb, f + F * min(j0 + G + q + 1, cn - 1));
      forward_node(fa, cb + 3 * q, y0, y1, y2);
      ld16<F>(fa, f + F * min(j0 + G + q + 2, cn - 1));
      forward_node(fb, cb + 3 * q + 3, y0, y1, y2);
    }
    st16<3 * G>(r + 3 * (j0 + G), cb);
  }
  for (int j = whole; j < cn; ++j) {
    ld16<F>(fa, f + F * j);
    T c[3] = {r[3 * j], r[3 * j + 1], r[3 * j + 2]};
    forward_node(fa, c, y0, y1, y2);
    r[3 * j] = c[0];
    r[3 * j + 1] = c[1];
    r[3 * j + 2] = c[2];
  }
}

template <typename T>
__device__ __forceinline__ void sweep_backward(T* r, const T* f, int cn, T& x0, T& x1, T& x2) {
  constexpr int G = Cfg<T>::kGroup, F = 24;
  const int whole = cn - cn % (2 * G);
  T fa[F], fb[F], ca[3 * G], cb[3 * G];
  for (int j = cn - 1; j >= whole; --j) {
    ld16<F>(fa, f + F * j);
    T c[3] = {r[3 * j], r[3 * j + 1], r[3 * j + 2]};
    backward_node(fa, c, x0, x1, x2);
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
      backward_node(fa, ca + 3 * q, x0, x1, x2);
      ld16<F>(fa, f + F * (j0 + G + q - 2));
      backward_node(fb, ca + 3 * q - 3, x0, x1, x2);
    }
    st16<3 * G>(r + 3 * (j0 + G), ca);
    // Group b: nodes j0 + G - 1 .. j0; the next pair's first rows load
    // meanwhile (clamped at node 0: unused there).
    ld16<3 * G>(ca, r + 3 * max(j0 - G, 0));
#pragma unroll
    for (int q = G - 1; q > 0; q -= 2) {
      ld16<F>(fb, f + F * (j0 + q - 1));
      backward_node(fa, cb + 3 * q, x0, x1, x2);
      ld16<F>(fa, f + F * max(j0 + q - 2, 0));
      backward_node(fb, cb + 3 * q - 3, x0, x1, x2);
    }
    st16<3 * G>(r + 3 * j0, cb);
  }
}

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
  // A chunk's rows: 3 cn elements rounded up to 16 bytes (the row pitches
  // leave room for them).
  auto row_bytes = [&](int cn) { return (3u * cn * sizeof(T) + 15u) & ~15u; };

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
          sweep_forward(r, factors(s), cn, y0, y1, y2);
        } else {
          sweep_backward(r, factors(s), cn, x0, x1, x2);
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
      const uint32_t rb = row_bytes(cn);
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
        const uint32_t rb = row_bytes(cn);
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

// ---------------------------------------------------------------------------
// btd_solve_adjoint: the reverse-mode derivative of the solve above. The
// JAX package differentiates the TPU kernel's plain twin (the jnp scans of
// ops/banded.py) with its own transposes; this kernel is the counterpart of
// those transposed scans. For the cotangent g = dL/dx of B right-hand sides
// it runs, per row, the three sequential sweeps of btd_adjoint_sweeps in
// ops/banded.py:
//   y     y_0 = b_0,              y_i = b_i - W_{i-1} y_{i-1}   (the forward sweep again)
//   s     s_0 = Dinv_0^T g_0,     s_i = Dinv_i^T (g_i - U_{i-1}^T s_{i-1})
//   bbar  bbar_{N-1} = s_{N-1},   bbar_i = s_i - W_i^T bbar_{i+1}
// and writes y, s and bbar; the factor cotangents (batch sums of outer
// products) are torch products over these (btd_adjoint_factors).
//
// Design: the simple one. One thread walks one row's nodes through the
// three sweeps, 32 rows a block, reading its rows and the packed factors
// (the forward kernel's fwd and bwd layouts, broadcast to the warp) from
// global memory, the next node's values loaded ahead; s is read back by
// the thread that wrote it. Rows are dense (B, 3N). The sweeps are
// dependent chains of 3x3 products, so the kernel is latency-bound; its
// times stand beside the bound in PERF.md.
// Rounding: every product row summed from the left with _rn intrinsics, as
// in btd_solve above and in the plain version, so the two agree bit for bit.
// ---------------------------------------------------------------------------

// One entry of a transposed 3x3 product: m[0][j]*v0 + m[1][j]*v1 + m[2][j]*v2
// (rows of four, as packed), summed from the left.
template <typename T>
__device__ __forceinline__ T col(const T* m, int j, T v0, T v1, T v2) {
  return add(add(mul(m[j], v0), mul(m[4 + j], v1)), mul(m[8 + j], v2));
}

constexpr int kAdjointThreads = 32;
constexpr int kAhead = 16;  // nodes the rows' L1 prefetch runs ahead of the sweep

// A hint to bring the line holding p into L1 (nothing off the device).
__device__ __forceinline__ void prefetch_l1(const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

template <int K, typename T>
__device__ __forceinline__ void copy_n(T* d, const T* s) {
#pragma unroll
  for (int k = 0; k < K; ++k) d[k] = s[k];
}

// Each sweep loads the next node's row values and factor blocks into a
// second register set before computing the current node, so the loads'
// latency overlaps the dependent chain of 3x3 products; the lines of the
// rows and of the factor blocks are prefetched into L1 kAhead nodes ahead
// (one warp an SM reads each factor line once: without the hint every
// node waited on L2).
template <typename T>
__global__ void __launch_bounds__(kAdjointThreads)
    btd_adjoint_kernel(int B, int N, int64_t ld, const T* __restrict__ fwd,
                       const T* __restrict__ bwd, const T* __restrict__ b,
                       const T* __restrict__ g, T* __restrict__ y, T* s, T* __restrict__ bbar) {
  const int r = blockIdx.x * kAdjointThreads + threadIdx.x;
  if (r >= B) return;
  const T* br = b + r * ld;
  const T* gr = g + r * ld;
  T* yr = y + r * ld;
  T* sr = s + r * ld;
  T* bb = bbar + r * ld;
  // y: the forward sweep (node 0's multiplier block is zero).
  T y0 = T(0), y1 = T(0), y2 = T(0);
  T c[3], w[12];
  copy_n<3>(c, br);
  copy_n<12>(w, fwd);
  for (int i = 0; i < N; ++i) {
    const int j = min(i + 1, N - 1);
    T cn[3], wn[12];
    copy_n<3>(cn, br + 3LL * j);
    copy_n<12>(wn, fwd + 12LL * j);
    prefetch_l1(br + 3LL * min(i + kAhead, N - 1));
    prefetch_l1(fwd + 12LL * min(i + kAhead, N - 1));
    forward_node(w, c, y0, y1, y2);
    yr[3 * i] = c[0];
    yr[3 * i + 1] = c[1];
    yr[3 * i + 2] = c[2];
    copy_n<3>(c, cn);
    copy_n<12>(w, wn);
  }
  // s: the ascending sweep; node i reads g_i, U_{i-1} and Dinv_i.
  T gc[3], dc[12], uc[12];
  copy_n<3>(gc, gr);
  copy_n<12>(dc, bwd);
  T s0 = col(dc, 0, gc[0], gc[1], gc[2]);
  T s1 = col(dc, 1, gc[0], gc[1], gc[2]);
  T s2 = col(dc, 2, gc[0], gc[1], gc[2]);
  sr[0] = s0;
  sr[1] = s1;
  sr[2] = s2;
  if (N > 1) {
    copy_n<3>(gc, gr + 3);
    copy_n<12>(uc, bwd + 12);
    copy_n<12>(dc, bwd + 24);
  }
  for (int i = 1; i < N; ++i) {
    const int j = min(i + 1, N - 1);
    T gn[3], un[12], dn[12];
    copy_n<3>(gn, gr + 3LL * j);
    copy_n<12>(un, bwd + 24LL * (j - 1) + 12);
    copy_n<12>(dn, bwd + 24LL * j);
    prefetch_l1(gr + 3LL * min(i + kAhead, N - 1));
    prefetch_l1(bwd + 24LL * min(i + kAhead, N - 1));
    prefetch_l1(bwd + 24LL * min(i + kAhead, N - 1) + 12);
    const T x0 = sub(gc[0], col(uc, 0, s0, s1, s2));
    const T x1 = sub(gc[1], col(uc, 1, s0, s1, s2));
    const T x2 = sub(gc[2], col(uc, 2, s0, s1, s2));
    s0 = col(dc, 0, x0, x1, x2);
    s1 = col(dc, 1, x0, x1, x2);
    s2 = col(dc, 2, x0, x1, x2);
    sr[3 * i] = s0;
    sr[3 * i + 1] = s1;
    sr[3 * i + 2] = s2;
    copy_n<3>(gc, gn);
    copy_n<12>(uc, un);
    copy_n<12>(dc, dn);
  }
  // bbar: the descending sweep, from s_{N-1} (still in registers); node i
  // reads s_i and W_i.
  bb[3 * (N - 1)] = s0;
  bb[3 * (N - 1) + 1] = s1;
  bb[3 * (N - 1) + 2] = s2;
  if (N < 2) return;
  T sc[3], wc[12];
  copy_n<3>(sc, sr + 3LL * (N - 2));
  copy_n<12>(wc, fwd + 12LL * (N - 1));
  for (int i = N - 2; i >= 0; --i) {
    const int j = max(i - 1, 0);
    T sn[3], wn[12];
    copy_n<3>(sn, sr + 3LL * j);
    copy_n<12>(wn, fwd + 12LL * (j + 1));
    prefetch_l1(sr + 3LL * max(i - kAhead, 0));
    prefetch_l1(fwd + 12LL * max(i - kAhead, 0));
    const T n0 = sub(sc[0], col(wc, 0, s0, s1, s2));
    const T n1 = sub(sc[1], col(wc, 1, s0, s1, s2));
    const T n2 = sub(sc[2], col(wc, 2, s0, s1, s2));
    s0 = n0;
    s1 = n1;
    s2 = n2;
    bb[3 * i] = n0;
    bb[3 * i + 1] = n1;
    bb[3 * i + 2] = n2;
    copy_n<3>(sc, sn);
    copy_n<12>(wc, wn);
  }
}

template <typename T>
int launch_adjoint(int B, int N, int64_t ld, const void* fwd, const void* bwd, const void* b,
                   const void* g, void* y, void* s, void* bbar, cudaStream_t stream) {
  btd_adjoint_kernel<T><<<(B + kAdjointThreads - 1) / kAdjointThreads, kAdjointThreads, 0,
                          stream>>>(
      B, N, ld, static_cast<const T*>(fwd), static_cast<const T*>(bwd),
      static_cast<const T*>(b), static_cast<const T*>(g), static_cast<T*>(y),
      static_cast<T*>(s), static_cast<T*>(bbar));
  return static_cast<int>(cudaGetLastError());
}

// Per device, whether each instance may use its dynamic shared memory (set
// once, read on every launch).
constexpr int kMaxDevices = 64;
bool g_smem_set[2][kMaxDevices];

template <typename T>
int launch(int B, int N, int64_t ld_in, int64_t ld_out, const void* fwd, const void* bwd,
           const void* rhs, void* out, cudaStream_t stream) {
  constexpr int which = sizeof(T) == 4 ? 0 : 1;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_smem_set[which][dev]) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        btd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Slot<T>::kSmem));
    if (rc != 0) return rc;
    g_smem_set[which][dev] = true;
  }
  btd_solve_kernel<T><<<(B + kEnvs - 1) / kEnvs, kThreads, Slot<T>::kSmem, stream>>>(
      B, N, ld_in, ld_out, static_cast<const T*>(fwd), static_cast<const T*>(bwd),
      static_cast<const T*>(rhs), static_cast<T*>(out));
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
// sides), g (the cotangent of its result) and the outputs y, s, bbar are
// dense (B, 3N) rows of pitch ld elements; fwd and bwd the packed factors.
// Returns the cudaError_t of the launch.
int btd_solve_adjoint_launch(int dtype, int B, int N, int64_t ld, const void* fwd,
                             const void* bwd, const void* b, const void* g, void* y, void* s,
                             void* bbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_adjoint<float>(B, N, ld, fwd, bwd, b, g, y, s, bbar, st);
  return launch_adjoint<double>(B, N, ld, fwd, bwd, b, g, y, s, bbar, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
