// Fused modal-ROM generalized-alpha kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of continuum_robot_tpu/ops/pallas/rom_rollout.py
// (_make_kernel, called through _fused_rom_call / _fused_rom_frames): S steps
// of modified-Newton generalized-alpha in modal coordinates, each Newton
// iteration expanding the alpha-point modal state through the planar trial
// basis, evaluating the von Karman correction per element, projecting it
// through the test basis and updating the iterate.
//
// What bounds it: per Newton iteration the two basis transforms are
// 2 * B * m * N float operations each (B envs, m modes, N = 3 n_sub planar
// window rows or 6 s gathered sample rows); at 4096 envs, 256 modes and
// 3003 rows that is 1.26e10 operations against ~0.15 GB of traffic, so the
// card's float32 arithmetic rate bounds it. The TPU kernel keeps both bases
// resident in VMEM for the whole span; on Hopper the two bases (6.2 MB at
// that size) exceed a block's 227 KB of shared memory, so the design here is
// one launch per piece and Newton iteration, with the bases and the (B, N)
// intermediates streaming through the 50 MB L2:
//
//   alpha_point_kernel     eta_af from (eta, etad, etadd, a1), elementwise
//   rom_expand (GEMM)      x = eta_af @ PhiT          (tiled GEMM, register
//                          blocked, two blocks per SM)
//   correction_*_kernel    the six correction slots per (env, element),
//                          masked, summed into node planes without atomics
//   rom_project (GEMM)     partial products of g_m = g @ W over S slices of
//                          the long (3 n_sub) reduction
//   update_kernel          g_m = the S partials summed in slice order, then
//                          the residual and the diagonal Newton update (+ the
//                          state update on the last iteration), or the
//                          residual for a dense Sinv
//   rom_newton_dense (GEMM)  a1 - r @ SinvT with the same update
//
// eta_af is formed by its own small kernel rather than inside the expand's
// operand loads: measured on the H100, the fused form recomputed it for every
// column block of the output and ran the expand at 0.44-0.51 ms against
// 0.22 ms for the pure GEMM on a precomputed operand. The project's output
// (B x m) is narrow: as 64x64 tiles it kept 4x4 register blocks that are
// bound by shared-memory reads (0.36-0.39 ms); as 128x128 tiles it has only
// 64 of them, so the reduction is split into S slices (S chosen to fill two
// blocks per SM) whose partial products a small kernel sums in a fixed order
// (0.23 ms with the sum, measured on the H100). No atomics: deterministic.
//
// The GEMMs are one template: BM x BN output tiles, BK-deep slices of A and
// B staged through double-buffered shared memory (global loads for the next
// slice go to registers while the current one is multiplied), each thread
// accumulating a TM x TN block in registers, all in float32 FMAs. Static
// shared memory stays under 48 KB per block, so no opt-in attribute is
// needed. Sums run in another order than cuBLAS: results agree with the
// plain PyTorch twin to float32 roundoff, not bit for bit.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers and the stream and checks the returned cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// (h, c_qp, c_vp, bh2, gh, af, 1-af, am, 1-am) of the gen-alpha step.
struct Scalars {
  float h, c_qp, c_vp, bh2, gh, af, omaf, am, omam;
};

// ---------------------------------------------------------------------------
// Tiled float32 GEMM: C(i, j) = sum_k A(i, k) B(k, j), B row-major (K, N).
// ---------------------------------------------------------------------------

// Block z of the grid's third dimension sums k in [z k_chunk, (z+1) k_chunk).
template <int BM, int BN, int BK, int TM, int TN, int MIN_BLOCKS, class AOp, class Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
gemm_kernel(int M, int N, int K, int k_chunk, AOp a, const float* __restrict__ b, Epi epi) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kALoads = BM * BK / kThreads;
  constexpr int kBLoads = BK * BN / kThreads;
  constexpr int kRowStride = BM / (TM / 4);  // rows of one thread: 4-runs this far apart
  constexpr int kColStride = BN / (TN / 4);
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles are float4 runs");
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tile loads");

  __shared__ __align__(16) float As[2][BK][BM + 4];  // +4: conflict-free transposed stores
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float ra[kALoads];
  float rb[kBLoads];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / BK, kk = idx % BK;
      const int gi = row0 + r, gk = k0 + kk;
      ra[l] = (gi < M && gk < k_end) ? a(gi, gk) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gj = col0 + c;
      rb[l] = (gk < k_end && gj < N) ? b[static_cast<int64_t>(gk) * N + gj] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int idx = tid + l * kThreads;
      As[buf][idx % BK][idx / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int idx = tid + l * kThreads;
      Bs[buf][idx / BN][idx % BN] = rb[l];
    }
  };

  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  load(k_begin);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) load(k_begin + (t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int c = 0; c < TM / 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][kk][c * kRowStride + ty * 4]);
        av[4 * c + 0] = v.x;
        av[4 * c + 1] = v.y;
        av[4 * c + 2] = v.z;
        av[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][kk][c * kColStride + tx * 4]);
        bv[4 * c + 0] = v.x;
        bv[4 * c + 1] = v.y;
        bv[4 * c + 2] = v.z;
        bv[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read in iteration t-1, which every thread has
    // left (barrier below), so it can be refilled while others read `cur`.
    if (t + 1 < n_tiles) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + (i / 4) * kRowStride + ty * 4 + (i % 4);
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + (j / 4) * kColStride + tx * 4 + (j % 4);
      if (gj < N) epi(gi, gj, acc[i][j]);
    }
  }
}

// Expand and project: 128x128 tiles of 8x8 register blocks, two blocks per SM
// (at most 128 registers a thread) to hide the barrier of each slice.
constexpr int kBigBM = 128, kBigBN = 128, kBigBK = 8, kBigTM = 8, kBigTN = 8, kBigMinBlocks = 2;
// Dense Newton: (B x m) output with a short (m) reduction; 64x64 tiles keep
// every SM busy without splitting it.
constexpr int kSmlBM = 64, kSmlBN = 64, kSmlBK = 8, kSmlTM = 4, kSmlTN = 4, kSmlMinBlocks = 1;

// ---------------------------------------------------------------------------
// Operand loaders and epilogues
// ---------------------------------------------------------------------------

// The gen-alpha predictor: eta_pred = eta + h etad + c_qp etadd.
__device__ __forceinline__ float eta_pred_of(const Scalars& s, float eta, float etad,
                                             float etadd) {
  return eta + s.h * etad + s.c_qp * etadd;
}

// The alpha-point state: eta_af = (1-af) (eta_pred + bh2 a1) + af eta.
__global__ void alpha_point_kernel(int64_t n, const float* __restrict__ eta,
                                   const float* __restrict__ etad,
                                   const float* __restrict__ etadd,
                                   const float* __restrict__ a1, float* __restrict__ out,
                                   Scalars s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float e = eta[i];
  out[i] = s.omaf * (eta_pred_of(s, e, etad[i], etadd[i]) + s.bh2 * a1[i]) + s.af * e;
}

struct RowMajorOperand {
  const float* __restrict__ p;
  int ld;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return p[static_cast<int64_t>(i) * ld + k];
  }
};

struct StoreEpilogue {
  float* __restrict__ out;
  int ld;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    out[static_cast<int64_t>(i) * ld + j] = v;
  }
};

// Partial product of slice blockIdx.z into out (S, M, N).
struct PartialEpilogue {
  float* __restrict__ out;
  int M, N;
  __device__ __forceinline__ void operator()(int i, int j, float v) const {
    out[(static_cast<int64_t>(blockIdx.z) * M + i) * N + j] = v;
  }
};

// The state at one (env, mode) element, and the output pointers of an update.
struct Update {
  const float* eta;
  const float* etad;
  const float* etadd;
  const float* a1;  // the Newton iterate (may alias etadd)
  float* out0;      // a1_new, the residual, or eta_new on the last iteration
  float* out1;      // etad_new (last iteration)
  float* out2;      // etadd_new (last iteration)
  int m;
  int last;
  Scalars s;

  // a1_new, and on the last iteration the new state triple.
  __device__ __forceinline__ void finish(int64_t idx, float a1n, float eta_pred,
                                         float etad_pred) const {
    if (last) {
      out0[idx] = eta_pred + s.bh2 * a1n;
      out1[idx] = etad_pred + s.gh * a1n;
      out2[idx] = a1n;
    } else {
      out0[idx] = a1n;
    }
  }
};

// Residual update: r = a_am + (lam eta_af + g_m) - u [+ cd etad_af]; then
// a1 - sinv r (diagonal), or r itself when sinv is null (dense Sinv).
struct ResidualUpdate {
  Update up;
  const float* __restrict__ lam;
  const float* __restrict__ u;
  const float* __restrict__ cd;    // null: undamped
  const float* __restrict__ sinv;  // null: write the residual
  __device__ __forceinline__ void operator()(int i, int j, float gm) const {
    const Scalars& s = up.s;
    const int64_t idx = static_cast<int64_t>(i) * up.m + j;
    const float eta = up.eta[idx], etad = up.etad[idx], etadd = up.etadd[idx];
    const float a1 = up.a1[idx];
    const float eta_pred = eta_pred_of(s, eta, etad, etadd);
    const float etad_pred = etad + s.c_vp * etadd;
    const float eta_af = s.omaf * (eta_pred + s.bh2 * a1) + s.af * eta;
    float r = s.omam * a1 + s.am * etadd + (lam[j] * eta_af + gm) - u[j];
    if (cd != nullptr) r = r + cd[j] * (s.omaf * (etad_pred + s.gh * a1) + s.af * etad);
    if (sinv == nullptr) {
      up.out0[idx] = r;
      return;
    }
    up.finish(idx, a1 - sinv[j] * r, eta_pred, etad_pred);
  }
};

// Dense Newton epilogue: a1_new = a1 - (r SinvT)(i, j).
struct NewtonEpilogue {
  Update up;
  __device__ __forceinline__ void operator()(int i, int j, float dr) const {
    const Scalars& s = up.s;
    const int64_t idx = static_cast<int64_t>(i) * up.m + j;
    const float eta = up.eta[idx], etad = up.etad[idx], etadd = up.etadd[idx];
    up.finish(idx, up.a1[idx] - dr, eta_pred_of(s, eta, etad, etadd), etad + s.c_vp * etadd);
  }
};

// ---------------------------------------------------------------------------
// The von Karman correction (elements.nonlinear_correction_planes, float32)
// ---------------------------------------------------------------------------

// Slots in the order (g1, g3, g4, g2, g5, g6): node 1 axial, transverse,
// moment, then node 2. Each multiplied by the element's mask.
__device__ __forceinline__ void correction(float u1, float w1, float t1, float u2, float w2,
                                           float t2, float L, float A, float mask,
                                           float g[6]) {
  const float dw = w1 - w2;
  const float du = u1 - u2;
  const float s = t1 + t2;
  const float t1t2 = t1 * t2;
  const float tsq = t1 * t1 + t2 * t2;
  const float dw2 = dw * dw;
  const float dw3 = dw2 * dw;
  const float invL = 1.0f / L;
  const float invL2 = invL * invL;
  const float invL3 = invL2 * invL;

  const float g1 = A * (-tsq / 15.0f + t1t2 / 30.0f + s * u2 * (invL / 20.0f) +
                        s * dw * (invL / 10.0f) - 0.6f * u2 * dw * invL2 -
                        0.6f * dw2 * invL2);
  const float g2 = A * (tsq / 15.0f - t1t2 / 30.0f - s * dw * (invL / 10.0f) +
                        0.6f * dw2 * invL2);
  const float t3sum = t1 * t1 * t1 + t2 * t2 * t2;
  const float g3 = A * (t3sum / 280.0f - 3.0f * t1t2 * s / 280.0f +
                        (9.0f / 70.0f) * tsq * dw * invL + du * s * (invL / 10.0f) -
                        (27.0f / 70.0f) * s * dw2 * invL2 - 1.2f * du * dw * invL2 +
                        (36.0f / 35.0f) * dw3 * invL3);
  const float g4 = A * (L * (t1 * t1 * t1) / 35.0f - 3.0f * L * t1 * t1 * t2 / 280.0f +
                        L * t1 * t2 * t2 / 140.0f - L * (t2 * t2 * t2) / 280.0f +
                        (3.0f / 280.0f) * dw * (t1 * t1 - 2.0f * t1t2 - t2 * t2) -
                        (2.0f / 15.0f) * t1 * du + t2 * du / 30.0f +
                        (9.0f / 70.0f) * t1 * dw2 * invL + du * dw * (invL / 10.0f) -
                        (9.0f / 70.0f) * dw3 * invL2);
  const float g6 = A * (-L * (t1 * t1 * t1) / 280.0f + L * t1 * t1 * t2 / 140.0f -
                        3.0f * L * t1 * t2 * t2 / 280.0f + L * (t2 * t2 * t2) / 35.0f +
                        (3.0f / 280.0f) * dw * (-t1 * t1 - 2.0f * t1t2 + t2 * t2) +
                        t1 * du / 30.0f - (2.0f / 15.0f) * t2 * du +
                        (9.0f / 70.0f) * t2 * dw2 * invL + du * dw * (invL / 10.0f) -
                        (9.0f / 70.0f) * dw3 * invL2);
  g[0] = mask * g1;
  g[1] = mask * g3;
  g[2] = mask * g4;
  g[3] = mask * g2;
  g[4] = mask * -g3;
  g[5] = mask * g6;
}

constexpr int kCorrThreads = 256;

// Window layout: x and g are (B, 3 n_sub) node planes [u; w; theta]. A block
// of 256 threads covers 255 nodes of one env: thread t evaluates element
// base + t - 1 and, after a barrier, writes node base + t - 1 as its own
// node-1 slots plus the node-2 slots of the element before it, read from
// shared memory. Node 0 takes no node-2 slot and the last node no node-1
// slot (their elements do not exist); no atomics, deterministic sums.
__global__ void __launch_bounds__(kCorrThreads)
correction_window_kernel(int n_sub, const float* __restrict__ x, const float* __restrict__ L,
                         const float* __restrict__ A, const float* __restrict__ mask,
                         float* __restrict__ g) {
  __shared__ float next_slots[3][kCorrThreads];
  const int t = threadIdx.x;
  const int e = blockIdx.x * (kCorrThreads - 1) + t - 1;  // element, and node written
  const int n_el = n_sub - 1;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * 3 * n_sub;
  const float* xu = x + row;
  const float* xw = xu + n_sub;
  const float* xt = xw + n_sub;
  float slot[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (e >= 0 && e < n_el)
    correction(xu[e], xw[e], xt[e], xu[e + 1], xw[e + 1], xt[e + 1], L[e], A[e], mask[e], slot);
  next_slots[0][t] = slot[3];
  next_slots[1][t] = slot[4];
  next_slots[2][t] = slot[5];
  __syncthreads();
  if (t >= 1 && e < n_sub) {
    float* gu = g + row;
    gu[e] = slot[0] + next_slots[0][t - 1];
    gu[n_sub + e] = slot[1] + next_slots[1][t - 1];
    gu[2 * n_sub + e] = slot[2] + next_slots[2][t - 1];
  }
}

// Gathered (ECSW) layout: x and g are (B, 6 s) blocks [u1, w1, t1, u2, w2, t2]
// of the s sampled elements; one thread per (env, element), no adjacency.
__global__ void __launch_bounds__(kCorrThreads)
correction_gathered_kernel(int s, const float* __restrict__ x, const float* __restrict__ L,
                           const float* __restrict__ A, const float* __restrict__ mask,
                           float* __restrict__ g) {
  const int j = blockIdx.x * kCorrThreads + threadIdx.x;
  if (j >= s) return;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * 6 * s;
  const float* xb = x + row;
  float slot[6];
  correction(xb[j], xb[s + j], xb[2 * s + j], xb[3 * s + j], xb[4 * s + j], xb[5 * s + j],
             L[j], A[j], mask[j], slot);
  float* gb = g + row;
#pragma unroll
  for (int k = 0; k < 6; ++k) gb[k * s + j] = slot[k];
}

// g_m(i, j) = the S partial products summed in slice order, then the update.
__global__ void update_kernel(int M, int N, int splits, const float* __restrict__ partials,
                              ResidualUpdate upd) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n = static_cast<int64_t>(M) * N;
  if (idx >= n) return;
  float gm = partials[idx];
  for (int z = 1; z < splits; ++z) gm += partials[z * n + idx];
  upd(static_cast<int>(idx / N), static_cast<int>(idx % N), gm);
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }
inline unsigned cdiv64(int64_t a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

inline Scalars scalars_of(const float* sc) {
  return Scalars{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7], sc[8]};
}

template <int BM, int BN, int BK, int TM, int TN, int MIN_BLOCKS, class AOp, class Epi>
int launch_gemm(int M, int N, int K, AOp a, const float* b, Epi epi, cudaStream_t stream,
                int splits = 1) {
  const int k_chunk = static_cast<int>(cdiv(static_cast<int>(cdiv(K, splits)), BK)) * BK;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), static_cast<unsigned>(splits));
  gemm_kernel<BM, BN, BK, TM, TN, MIN_BLOCKS, AOp, Epi>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(M, N, K, k_chunk, a, b, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B envs, m modes, N basis rows. Each function returns the cudaError_t of its
// launch (0 on success). sc: the nine step scalars (see Scalars).
extern "C" {

int rom_alpha_point_launch(int B, int m, const float* eta, const float* etad,
                           const float* etadd, const float* a1, float* out, const float* sc,
                           void* stream) {
  const int64_t n = static_cast<int64_t>(B) * m;
  alpha_point_kernel<<<cdiv64(n, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(n, eta, etad, etadd, a1, out,
                                                            scalars_of(sc));
  return static_cast<int>(cudaGetLastError());
}

int rom_expand_launch(int B, int m, int N, const float* eta_af, const float* phiT, float* x,
                      void* stream) {
  return launch_gemm<kBigBM, kBigBN, kBigBK, kBigTM, kBigTN, kBigMinBlocks>(
      B, N, m, RowMajorOperand{eta_af, m}, phiT, StoreEpilogue{x, N},
      static_cast<cudaStream_t>(stream));
}

int rom_correction_window_launch(int B, int n_sub, const float* x, const float* L,
                                 const float* A, const float* mask, float* g, void* stream) {
  const dim3 grid(cdiv(n_sub, kCorrThreads - 1), static_cast<unsigned>(B));
  correction_window_kernel<<<grid, kCorrThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_sub, x, L, A, mask, g);
  return static_cast<int>(cudaGetLastError());
}

int rom_correction_gathered_launch(int B, int s, const float* x, const float* L,
                                   const float* A, const float* mask, float* g, void* stream) {
  const dim3 grid(cdiv(s, kCorrThreads), static_cast<unsigned>(B));
  correction_gathered_kernel<<<grid, kCorrThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, x, L, A, mask, g);
  return static_cast<int>(cudaGetLastError());
}

// partials: (splits, B, m) products of S slices of the N-long reduction.
int rom_project_launch(int B, int m, int N, int splits, const float* g, const float* w,
                       float* partials, void* stream) {
  return launch_gemm<kBigBM, kBigBN, kBigBK, kBigTM, kBigTN, kBigMinBlocks>(
      B, m, N, RowMajorOperand{g, N}, w, PartialEpilogue{partials, B, m},
      static_cast<cudaStream_t>(stream), splits);
}

// sinv null: out0 receives the residual (dense Sinv follows). Otherwise the
// diagonal Newton update: out0 = a1_new, or with last != 0 out0..2 = the new
// (eta, etad, etadd).
int rom_update_launch(int B, int m, int splits, const float* partials, const float* eta,
                      const float* etad, const float* etadd, const float* a1,
                      const float* lam, const float* u, const float* cd, const float* sinv,
                      int last, float* out0, float* out1, float* out2, const float* sc,
                      void* stream) {
  const Update up{eta, etad, etadd, a1, out0, out1, out2, m, last, scalars_of(sc)};
  const int64_t n = static_cast<int64_t>(B) * m;
  update_kernel<<<cdiv64(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      B, m, splits, partials, ResidualUpdate{up, lam, u, cd, sinv});
  return static_cast<int>(cudaGetLastError());
}

int rom_newton_dense_launch(int B, int m, const float* r, const float* sinvT, const float* eta,
                            const float* etad, const float* etadd, const float* a1, int last,
                            float* out0, float* out1, float* out2, const float* sc,
                            void* stream) {
  const Update up{eta, etad, etadd, a1, out0, out1, out2, m, last, scalars_of(sc)};
  return launch_gemm<kSmlBM, kSmlBN, kSmlBK, kSmlTM, kSmlTN, kSmlMinBlocks>(
      B, m, m, RowMajorOperand{r, m}, sinvT, NewtonEpilogue{up},
      static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
