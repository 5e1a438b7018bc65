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
// 3003 rows that is 1.26e10 operations against ~0.15 GB of traffic. The TPU
// kernel keeps both bases resident in VMEM for the whole span; on Hopper the
// two bases (6.2 MB at that size) exceed a block's 227 KB of shared memory,
// so the design here is one launch per piece and Newton iteration, with the
// bases and the (B, N) intermediates streaming through the 50 MB L2:
//
//   alpha_point_kernel     eta_af from (eta, etad, etadd, a1), elementwise
//   rom_expand_kernel      x = eta_af @ Phi^T         (tensor cores, 3xTF32)
//   correction_*_kernel    the six correction slots per (env, element) from
//                          a per-element factor table (no division), summed
//                          into node planes without atomics; bound by their
//                          bytes (see the correction section)
//   rom_project_kernel     partial products of g_m = g @ W over S slices of
//                          the long (3 n_sub) reduction (tensor cores, 3xTF32)
//   update_kernel          g_m = the S partials summed in slice order, then
//                          the residual and the diagonal Newton update (+ the
//                          state update on the last iteration)
//   newton_dense_kernel    the same g_m and residual, kept in shared memory,
//                          then a1 - r @ SinvT with the same update (a dense
//                          Sinv: one launch in place of rom_update's)
//   rom_expand_f32_kernel, float32 FFMA instances of expand and project for
//   rom_project_f32_kernel nl_precision="highest"
//
// The two basis transforms: 3xTF32 on wgmma. The TPU kernel does not form
// them in plain float32 either: by default it splits each operand into bf16
// hi/lo halves and sums three matrix-unit products (hi.hi + hi.lo + lo.hi,
// float32 accumulation), the basis halves split once on the host and the
// per-step operand on the VPU. Here the same idea runs on Hopper's tensor
// cores in TF32: hi = tf32_rna(x), lo = tf32_rna(x - hi), and
// A_hi B_hi + A_hi B_lo + A_lo B_hi accumulated in float32, each term
// accurate to ~2^-21 (bf16 hi/lo: ~2^-16). In float32 FMAs on the CUDA
// cores (67 TFLOP/s) either product is bound at 0.094 ms at the main
// path's size; three TF32 passes at 495 TFLOP/s bound it at 0.038 ms.
// nl_precision="highest" asks for full float32, as the TPU kernel's
// Precision.HIGHEST gives it: float32 products, float32 sums in K order,
// no TF32 and no tensor cores (whose float32 accumulation truncates, see
// Tf32Consumer). For that tier the same GEMM body runs an FFMA consumer on
// the unsplit bases: that tier is bound by the 0.094 ms above.
//
// Both are one "TN" GEMM, C(i, j) = sum_k A(i, k) Bt(j, k), with both
// operands K-major as TF32 wgmma requires:
//   expand   A = eta_af (B, m), Bt = Phi (N, m),   C = x (B, N)
//   project  A = g (B, N),      Bt = W^T (m, N),   C = partials (S, B, m)
// The basis halves (Bt hi and lo), or for "highest" the unsplit bases, are
// laid out once where the operators are uploaded (rom_rollout.py:
// split_basis), with their TMA descriptors. The per-step operand is split
// here, in registers: wgmma takes A from registers, so each 3xTF32 consumer
// thread loads its fragment of the A tile from shared memory, rounds it to
// hi and lo, and issues the three products.
//
// One block per SM, persistent over (row tile, column tile, K slice) units:
// 128 x 128 output tiles, a producer warpgroup (one thread issues the TMA
// loads; setmaxnreg hands its registers to the consumers) feeding a ring of
// 32-deep K slices (one 128-byte swizzle row per tile row) through
// mbarriers, and two consumer warpgroups of a kind chosen at compile time
// (gemm_persistent<Consumer>):
// - Tf32Consumer: a 4-stage ring of the A tile, the Bt hi tile and the Bt
//   lo tile (48 KB a stage); each warpgroup issues wgmma m64n128k8 on 64 of
//   the tile's rows. The tensor cores' float32 accumulation truncates, so
//   each slice's 8 lo products and its 4 hi.hi products are summed apart
//   and each group is added to the tile's sum in float32 with rounding to
//   nearest. Kernel and twin (float32 torch.matmul) agree to ~1e-6 of the
//   output's scale, not bit for bit.
// - F32Consumer: a 6-stage ring of the A tile and the Bt tile (32 KB a
//   stage); each thread owns 8 x 8 outputs in registers and reads its
//   operands as bank-conflict-free 16-byte shared loads along K (the map is
//   at the struct), loading the next 4 k while the current 256 FMAs issue;
//   16-byte stores in the epilogue. Float32 roundoff of a K-ordered sum.
//   On an H100 its FMAs run at ~0.67 of an SM's float32 peak, bound by the
//   compiled FFMA stream, not by its loads or the ring: variants without
//   the shared loads or without the waits are no faster, and a third of
//   the FFMAs read two registers of one bank (chip_variants.py).
// The producer runs ahead into the next unit while the consumers store a
// finished tile, so loads overlap the epilogue. TMA reads the global
// tensors with 16-byte row pitches (the wrappers pad rows to a multiple of
// 4 floats) and their true extents, so it zero-fills past the last row and
// column and pad columns are never read into a sum. The project splits its
// N-long reduction into S slices whose partial products update_kernel sums
// in a fixed order (no atomics, deterministic): for 3xTF32 S fills the SMs
// in one round (S = 2 at the main path); in float32, where a slice is one
// sequential float32 sum whose roundoff grows with its length, S gives two
// rounds (S = 4 slices of 768 rows at the main path).
//
// The dense Newton update (newton_dense_kernel): (B x m) outputs over a
// short (m) reduction, 2 B m^2 float32 FMA operations (0.54 GFLOP at B =
// 4096, m = 256: 8 us at the float32 peak) against 9 B m + m^2 floats of
// traffic (S = 2 partials, four state inputs, three outputs on the last
// iteration: 11.3 us at 3.35 TB/s), so both bounds are close. It stays float32 for every tier: the TPU kernel's
// Newton dot is Precision.HIGHEST unless the caller asks for "default". A
// block owns 32 envs x 256 modes (128 blocks at B = 4096: one wave on 132
// SMs, r formed once). It streams SinvT (m x m, L2-resident) in 32-row
// slices through a 3-stage cp.async ring while 256 threads each accumulate
// 8 x 4 outputs in registers (per k: 3 shared loads, the two of r
// broadcast, for 32 FMAs); it forms r (in update_kernel's order) a 32-mode
// slice at a time into shared memory, transposed, one slice ahead of the
// product, so the loads of r's inputs overlap the FMAs; and it applies the
// Newton update from registers with 16-byte accesses. r never reaches
// device memory. On an H100 it takes 0.031 ms on the device, 2.8x its byte
// bound (chip_smoke.py phase 12). Forming r at each thread's own outputs
// before the product, so that the state is read once, was no faster: that
// formation cannot overlap the FMAs.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw device
// pointers, 128-byte tensor maps and the stream and checks the returned code.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

// (h, c_qp, c_vp, bh2, gh, af, 1-af, am, 1-am) of the gen-alpha step.
struct Scalars {
  float h, c_qp, c_vp, bh2, gh, af, omaf, am, omam;
};

__host__ __device__ inline unsigned cdiv(int a, int b) {
  return static_cast<unsigned>((a + b - 1) / b);
}
inline unsigned cdiv64(int64_t a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// The persistent TN GEMM, C(i, j) = sum_k A(i, k) Bt(j, k): one body (the
// mbarrier ring, the producer's TMA loop, the unit scheduler), two consumers
// chosen at compile time (3xTF32 on wgmma; float32 FFMA)
// ---------------------------------------------------------------------------

constexpr int kTile = 128;          // output tile rows and columns
constexpr int kSliceK = 32;         // K per stage: one 128-byte swizzle row
constexpr int kConsumers = 2;       // warpgroups
constexpr int kGemmThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
// Registers a thread of each role keeps (setmaxnreg): per SM sub-partition
// one producer warp and two consumer warps fit 16384 registers.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTileBytes = kTile * kSliceK * 4;      // 16 KB
// Codes above every cudaError_t: the tensor-map encoder failed or is missing.
constexpr int kEncodeError = 100000;

// Dynamic shared memory of a ring of `stages` stages of `tiles` tiles each:
// the 1024-byte alignment slack and a full and an empty mbarrier a stage.
constexpr int gemm_smem(int stages, int tiles) {
  return stages * tiles * kTileBytes + 1024 + 2 * stages * 8;
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

// TMA: the box at (c0 = K coordinate, c1 = row) of `map` into shared memory.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Round to TF32, nearest with ties away from zero: the low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Shared-memory descriptor of a K-major tile whose rows are 128-byte swizzle
// rows (the TMA 128B swizzle, tile base 1024-byte aligned): start address,
// leading offset unused (1), stride 1024 bytes between 8-row groups, layout
// 128B swizzle. Advancing K by 8 TF32 values adds 32 bytes to the start.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 8, TF32 in registers) * B (8 x 128, K-major TF32 in shared
// memory at `desc`) + (accumulate ? d : 0), one warpgroup.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The 3xTF32 consumer: a stage holds the A tile, the Bt hi tile and the Bt lo
// tile (48 KB); each consumer warpgroup issues wgmma m64n128k8 on 64 of the
// tile's rows. Warpgroup wg, warp wq of it: tile rows r0 = 64 wg + 16 wq +
// lane/4 and r0 + 8. Its A fragment of a k8 step kk holds A(r0, c), A(r0 +
// 8, c), A(r0, c + 4), A(r0 + 8, c + 4) at c = 8 kk + lane % 4; its
// accumulator d[4 j + {0, 1, 2, 3}] is C at rows (r0, r0, r0 + 8, r0 + 8)
// and columns 8 j + 2 (lane % 4) + {0, 1, 0, 1}.
struct Tf32Consumer {
  static constexpr int kBTiles = 2;
  static constexpr int kStages = 4;
  int t, r0, swz;
  // d: the tile's sum, added in float32 (round to nearest); p: a group of a
  // slice's tensor-core products, first its 8 lo terms (hi.lo and lo.hi),
  // then its 4 hi.hi terms. The tensor cores align each k8 step's products
  // and the accumulator to the largest and truncate to float32, so summing
  // all of K in them is biased (the project at the main path's shape:
  // 2.1e-6 of the output's scale, against 4.4e-7 with per-slice sums;
  // measured) and lo terms summed with hi.hi ones lose their low bits (the
  // card-only ROM test's ECSW span: 7.1e-6 of the scale, over its 5e-6
  // limit, until they were split); hence the two groups, each added to d on
  // its own.
  float d[64], p[64];

  __device__ __forceinline__ Tf32Consumer(int warp, int lane)
      : t(lane % 4), r0(64 * (warp / 4) + 16 * (warp % 4) + lane / 4), swz(r0 & 7) {}

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = p[i] = 0.f;
  }

  // One 32-deep K slice: `stage` (generic) and `tile` (shared) address it.
  __device__ __forceinline__ void slice(const uint8_t* stage, uint32_t tile) {
    const float* As = reinterpret_cast<const float*>(stage);
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 8 * (q & 1);
        const int c4 = 2 * kk + (q >> 1);  // 16-byte chunk of column 8 kk + t (+ 4)
        const float x = As[r * kSliceK + ((c4 ^ swz) << 2) + t];  // chunk c4 sits at c4 ^ swz
        a_hi[kk][q] = tf32_rna(x);
        a_lo[kk][q] = tf32_rna(x - __uint_as_float(a_hi[kk][q]));
      }
    }
#pragma unroll
    for (int group = 0; group < 2; ++group) {
      fence_acc(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b_hi = tile + kTileBytes + 32 * kk;
        if (group == 0) {
          wgmma_tf32(p, a_hi[kk], smem_desc(b_hi + kTileBytes), kk > 0);  // hi.lo
          wgmma_tf32(p, a_lo[kk], smem_desc(b_hi));                        // lo.hi
        } else {
          wgmma_tf32(p, a_hi[kk], smem_desc(b_hi), kk > 0);               // hi.hi
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(p);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] += p[i];
    }
  }

  // The tile at (row0, col0) of o (row pitch ld): rows past M and columns
  // past Nc are not stored.
  __device__ __forceinline__ void store(float* o, int64_t ld, int row0, int col0, int M,
                                        int Nc) const {
    const bool pairs = (ld % 2) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + r0 + 8 * h;
      if (i >= M) continue;
      float* row = o + static_cast<int64_t>(i) * ld;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (pairs && c + 1 < Nc) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          if (c < Nc) row[c] = v0;
          if (c + 1 < Nc) row[c + 1] = v1;
        }
      }
    }
  }
};

// The float32 FFMA consumer: a stage holds the A tile and the unsplit Bt
// tile (32 KB). Each of the 8 consumer warps owns 32 x 64 outputs, each
// thread 8 x 8 in registers, summed with fmaf in float32, in K order.
//
// Thread map (consumer warp w = 0..7, lane l): rows R + 4 i (i < 8), R =
// 32 (w % 4) + l / 8; columns C + 32 h + q (h < 2, q < 4), C = 64 (w / 4) +
// 4 (l % 8), so an output row's 4-runs are 16-byte stores. Operands are
// read as 16-byte shared loads of one row and 4 k (a k-chunk c; under the
// 128B swizzle chunk c of tile row r sits at chunk c ^ (r & 7), in bank
// quad c ^ (r & 7)):
// - a warp's load of A reads rows R + 4 i of its 4 row groups l / 8, whose
//   r & 7 differ, each row broadcast to 8 lanes: 4 bank quads;
// - a warp's load of Bt reads, in its q-th load, row C + 32 h + ((q + rot)
//   & 3) with rot = (l % 8) / 2, so r & 7 = 4 (l % 2) + ((q + rot) & 3)
//   takes each of its 8 values once over the 8 column groups, each row
//   broadcast to 4 lanes: 8 bank quads. Without the rotation the rows 4
//   (l % 8) + q would take two values of r & 7 (a 4-way conflict).
// So no load has a bank conflict. Accumulator
// acc[i][4 h + q] is column C + 32 h + ((q + rot) & 3); the epilogue undoes
// the rotation with selects. The next k-chunk's 16 fragments load while the
// current chunk's 256 FMAs issue.
struct F32Consumer {
  static constexpr int kBTiles = 1;
  // A stage is 1.05 MFLOP, ~2 us of FMAs an SM: 6 stages keep 5 slices in
  // flight against L2 latency and let the producer load 6 of the expand's 8
  // slices of the next unit while the consumers store a tile (192 KB, the
  // 3xTF32 ring's footprint).
  static constexpr int kStages = 6;
  int R, C, rot;
  // Byte offsets in a tile, the swizzle bits included, of A rows R and R + 4
  // (rows R + 4 i: + 1024 (i / 2)) and of Bt rows C + ((q + rot) & 3)
  // (+ 4096 h): chunk c of each is at offset ^ (c << 4).
  uint32_t a_off[2], b_off[4];
  float acc[8][8];

  __device__ __forceinline__ F32Consumer(int warp, int lane)
      : R(32 * (warp % 4) + lane / 8), C(64 * (warp / 4) + 4 * (lane % 8)), rot((lane % 8) / 2) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = R + 4 * e;
      a_off[e] = static_cast<uint32_t>(r * 128 + ((r & 7) << 4));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = C + ((q + rot) & 3);
      b_off[q] = static_cast<uint32_t>(r * 128 + ((r & 7) << 4));
    }
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void load(const uint8_t* stage, int c, float4 (&a)[8],
                                       float4 (&b)[8]) const {
    const uint8_t* Bs = stage + kTileBytes;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(stage + ((a_off[i & 1] ^ (c << 4)) + 1024 * (i >> 1)));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + ((b_off[j & 3] ^ (c << 4)) + 4096 * (j >> 2)));
  }

  __device__ __forceinline__ void fma4(const float4 (&a)[8], const float4 (&b)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }

  __device__ __forceinline__ void slice(const uint8_t* stage, uint32_t) {
    float4 a[2][8], b[2][8];
    load(stage, 0, a[0], b[0]);
#pragma unroll
    for (int c = 0; c < kSliceK / 4; ++c) {
      if (c + 1 < kSliceK / 4) load(stage, c + 1, a[(c + 1) & 1], b[(c + 1) & 1]);
      fma4(a[c & 1], b[c & 1]);
    }
  }

  // The tile at (row0, col0) of o (row pitch ld): 16-byte stores where the
  // pitch and base allow, scalar ones at a ragged edge; rows past M and
  // columns past Nc are not stored.
  __device__ __forceinline__ void store(float* o, int64_t ld, int row0, int col0, int M,
                                        int Nc) const {
    const bool vec = (ld % 4) == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + R + 4 * i;
      if (r >= M) continue;
      float* row = o + static_cast<int64_t>(r) * ld;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + C + 32 * h;
        // Column c + q sits in acc[i][4 h + ((q - rot) & 3)].
        const float* s = acc[i] + 4 * h;
        float u[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = (rot & 1) ? s[(q + 3) & 3] : s[q];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = (rot & 2) ? u[(q + 2) & 3] : u[q];
        if (vec && c + 3 < Nc) {
          *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < Nc) row[c + q] = v[q];
        }
      }
    }
  }
};

// The shape of one GEMM launch: C is M x Nc over a K-long reduction cut
// into `splits` slices of k_chunk (a multiple of kSliceK); slice z writes
// out + z * split_stride, rows ld_out floats apart.
struct GemmShape {
  int M, Nc, K, k_chunk, splits;
  float* out;
  int64_t ld_out, split_stride;
};

// The work of one block: units u = blockIdx.x, blockIdx.x + gridDim.x, ...
// of (column tile, row tile, K split). A producer warpgroup (one lane issues
// the TMA loads; setmaxnreg hands its registers to the consumers) fills a
// ring of Consumer::kStages stages of 32-deep K slices, one 128-byte swizzle
// row per tile row: the A tile and Consumer::kBTiles Bt tiles, through
// full/empty mbarriers; it runs ahead into the next unit while the consumers
// store a finished tile, so loads overlap the epilogue. TMA reads the global
// tensors with 16-byte row pitches and their true extents, so it zero-fills
// past the last row and column and pad columns are never read into a sum.
template <class Consumer>
__device__ __forceinline__ void gemm_persistent(const CUtensorMap* map_a,
                                                const CUtensorMap* map_b,
                                                const CUtensorMap* map_b_lo,
                                                const GemmShape& s) {
  constexpr int kStages = Consumer::kStages;
  constexpr int kStageBytes = (1 + Consumer::kBTiles) * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128B swizzle needs 1024-byte tiles
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kStages * kStageBytes;  // kStages mbarriers of 8 bytes
  const uint32_t empty0 = full0 + kStages * 8;

  const int tiles_n = static_cast<int>(cdiv(s.Nc, kTile));
  const int tiles_m = static_cast<int>(cdiv(s.M, kTile));
  const int units = tiles_n * tiles_m * s.splits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);                    // the producer's expect_tx
      mbar_init(empty0 + 8 * st, 4 * kConsumers);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: one lane issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != 4 * kConsumers || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tn = u % tiles_n;
      const int tm = (u / tiles_n) % tiles_m;
      const int z = u / (tiles_n * tiles_m);
      const int k_end = min(s.K, (z + 1) * s.k_chunk);
      for (int k0 = z * s.k_chunk; k0 < k_end; k0 += kSliceK) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t tile = base + stage * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load(map_a, tile, full, k0, tm * kTile);
        tma_load(map_b, tile + kTileBytes, full, k0, tn * kTile);
        if constexpr (Consumer::kBTiles == 2)
          tma_load(map_b_lo, tile + 2 * kTileBytes, full, k0, tn * kTile);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  Consumer c(warp, lane);
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tn = u % tiles_n;
    const int tm = (u / tiles_n) % tiles_m;
    const int z = u / (tiles_n * tiles_m);
    const int k_end = min(s.K, (z + 1) * s.k_chunk);
    c.clear();
    for (int k0 = z * s.k_chunk; k0 < k_end; k0 += kSliceK) {
      mbar_wait(full0 + 8 * stage, phase);
      c.slice(smem + stage * kStageBytes, base + stage * kStageBytes);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    c.store(s.out + z * s.split_stride, s.ld_out, tm * kTile, tn * kTile, s.M, s.Nc);
  }
}

// The expand covers all of K (m) in one unit; the project splits its N-long
// reduction into `splits` slices of k_chunk.
__host__ __device__ inline int whole_k(int K) { return (K + kSliceK - 1) / kSliceK * kSliceK; }

__global__ void __launch_bounds__(kGemmThreads, 1)
rom_expand_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_bhi,
                  const __grid_constant__ CUtensorMap map_blo, int B, int N, int m,
                  float* __restrict__ x, int64_t ld_x) {
  gemm_persistent<Tf32Consumer>(&map_a, &map_bhi, &map_blo,
                                GemmShape{B, N, m, whole_k(m), 1, x, ld_x, 0});
}

__global__ void __launch_bounds__(kGemmThreads, 1)
rom_project_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_bhi,
                   const __grid_constant__ CUtensorMap map_blo, int B, int m, int N,
                   int k_chunk, int splits, float* __restrict__ partials) {
  gemm_persistent<Tf32Consumer>(
      &map_a, &map_bhi, &map_blo,
      GemmShape{B, m, N, k_chunk, splits, partials, m, static_cast<int64_t>(B) * m});
}

__global__ void __launch_bounds__(kGemmThreads, 1)
rom_expand_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, int B, int N, int m,
                      float* __restrict__ x, int64_t ld_x) {
  gemm_persistent<F32Consumer>(&map_a, &map_b, nullptr,
                               GemmShape{B, N, m, whole_k(m), 1, x, ld_x, 0});
}

__global__ void __launch_bounds__(kGemmThreads, 1)
rom_project_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, int B, int m, int N,
                       int k_chunk, int splits, float* __restrict__ partials) {
  gemm_persistent<F32Consumer>(
      &map_a, &map_b, nullptr,
      GemmShape{B, m, N, k_chunk, splits, partials, m, static_cast<int64_t>(B) * m});
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint(ByVersion)
// so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major float32 (rows, cols) matrix with row pitch
// `ld` floats (a multiple of 4), read as (128 rows x 32 columns) boxes with
// the 128B swizzle; zero fill past the extents.
int encode_map(CUtensorMap* map, const float* p, int rows, int cols, int64_t ld) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kEncodeError;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kSliceK, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// Per device: its SM count, and whether each GEMM kernel (0 expand, 1
// project, 3 expand_f32, 4 project_f32) may use its ring's dynamic shared
// memory and the dense Newton kernel (2) all of a block's (set once, read
// on every launch).
constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices];
bool g_smem_set[5][kMaxDevices];

// Launch a GEMM kernel persistently, one block per SM and at most one per
// unit: A's tensor map encoded here, the basis maps (map_b_lo: the 3xTF32
// consumer's second) copied from the caller's 128-byte blobs.
template <class Consumer, class Kernel, class... Args>
int launch_gemm(Kernel kernel, int which, int units, const float* a, int a_rows, int a_cols,
                int64_t ld_a, const void* map_b, const void* map_b_lo, cudaStream_t stream,
                Args... args) {
  constexpr int kSmem = gemm_smem(Consumer::kStages, 1 + Consumer::kBTiles);
  CUtensorMap ma, mb;
  int rc = encode_map(&ma, a, a_rows, a_cols, ld_a);
  if (rc != 0) return rc;
  std::memcpy(&mb, map_b, sizeof(CUtensorMap));
  int dev = 0;
  rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sm_count[dev] == 0) {
    rc = static_cast<int>(
        cudaDeviceGetAttribute(&g_sm_count[dev], cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
  }
  if (!g_smem_set[which][dev]) {
    rc = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
    if (rc != 0) return rc;
    g_smem_set[which][dev] = true;
  }
  const int blocks = units < g_sm_count[dev] ? units : g_sm_count[dev];
  if constexpr (Consumer::kBTiles == 2) {
    CUtensorMap mlo;
    std::memcpy(&mlo, map_b_lo, sizeof(CUtensorMap));
    kernel<<<blocks, kGemmThreads, kSmem, stream>>>(ma, mb, mlo, args...);
  } else {
    kernel<<<blocks, kGemmThreads, kSmem, stream>>>(ma, mb, args...);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Elementwise pieces and epilogues
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

// The state at one (env, mode) element, and the output pointers of an update.
struct Update {
  const float* eta;
  const float* etad;
  const float* etadd;
  const float* a1;  // the Newton iterate (may alias etadd)
  float* out0;      // a1_new, or eta_new on the last iteration
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

// g_m at element idx of (B, m) = n: the S partial products summed in slice
// order.
__device__ __forceinline__ float slice_sum(const float* __restrict__ partials, int splits,
                                           int64_t n, int64_t idx) {
  float gm = partials[idx];
#pragma unroll 4
  for (int z = 1; z < splits; ++z) gm += partials[z * n + idx];
  return gm;
}

// The state (eta, etad, etadd, a1) at one element.
struct State4 {
  float eta, etad, etadd, a1;
};

// The residual r = a_am + (lam eta_af + g_m) - u [+ cd etad_af] at element
// idx (mode j) of the state, and the predictors it passes through.
struct Residual {
  Update up;
  const float* __restrict__ lam;
  const float* __restrict__ u;
  const float* __restrict__ cd;  // null: undamped

  __device__ __forceinline__ State4 load(int64_t idx) const {
    return State4{up.eta[idx], up.etad[idx], up.etadd[idx], up.a1[idx]};
  }
  __device__ __forceinline__ float of(const State4& x, int j, float gm, float& eta_pred,
                                      float& etad_pred) const {
    const Scalars& s = up.s;
    eta_pred = eta_pred_of(s, x.eta, x.etad, x.etadd);
    etad_pred = x.etad + s.c_vp * x.etadd;
    const float eta_af = s.omaf * (eta_pred + s.bh2 * x.a1) + s.af * x.eta;
    float r = s.omam * x.a1 + s.am * x.etadd + (lam[j] * eta_af + gm) - u[j];
    if (cd != nullptr) r = r + cd[j] * (s.omaf * (etad_pred + s.gh * x.a1) + s.af * x.etad);
    return r;
  }
  __device__ __forceinline__ float operator()(int64_t idx, int j, float gm, float& eta_pred,
                                              float& etad_pred) const {
    return of(load(idx), j, gm, eta_pred, etad_pred);
  }
};

// ---------------------------------------------------------------------------
// The von Karman correction (elements.nonlinear_correction_planes, float32)
// ---------------------------------------------------------------------------
//
// Both kernels are bound by their bytes: each (env, node) reads 3 floats of
// x and writes 3 of g (window: 2 x 4096 x 3003 floats, 0.029 ms at 3.35
// TB/s on an H100), against about 70 float operations an element. The
// first port evaluated the polynomial with its divisions (L, and the
// constants 15, 30, 280, ...): without fast math each is an IEEE division
// sequence, which kept the window kernel at 0.079 ms on the device. Here the
// polynomial's 17 per-element factors (A/15, A/(20L), (36/35) A/L^3, ...
// each times the mask) are formed once, in float64 on the host, and read
// from a (17, E) float32 table (rom_rollout.py: correction_table), so a
// kernel does only multiplies and FMAs over the monomials of
// nonlinear_correction_planes, in its order (constants folded, no other
// reassociation). A masked or padded element has all-zero factors, so its
// slots are exactly 0, as mask * g gives. On an H100 (700 W) at the main
// path's shapes the window kernel takes 0.044 ms on the device and the
// gathered one (s = 41) 0.0038 ms: at their memory floor, which a variant
// that only copies (0.0405 / 0.0033 ms) and torch's copy_ of the same
// bytes (0.0427 / 0.0039 ms) also show (chip_variants.py --correction);
// the dividing body on the same thread map takes 0.116 ms.

constexpr int kCorrCoefs = 17;   // rows of the factor table, in the order below
constexpr int kCorrThreads = 256;

// The six slots (g1, g3, g4, g2, g5, g6) of one element from its node states
// and its factors c: node 1 axial, transverse, moment, then node 2.
__device__ __forceinline__ void correction(const float (&c)[kCorrCoefs], float u1, float w1,
                                           float t1, float u2, float w2, float t2,
                                           float g[6]) {
  const float dw = w1 - w2;
  const float du = u1 - u2;
  const float s = t1 + t2;
  const float t1t2 = t1 * t2;
  const float tsq = t1 * t1 + t2 * t2;
  const float dw2 = dw * dw;
  const float dw3 = dw2 * dw;
  const float t1c = t1 * t1 * t1;
  const float t2c = t2 * t2 * t2;
  const float t112 = t1 * t1 * t2;
  const float t122 = t1 * t2 * t2;
  // c: A/15, A/30, A/(20L), A/(10L), 0.6A/L^2, A/280, 3A/280, (9/70)A/L,
  // (27/70)A/L^2, 1.2A/L^2, (36/35)A/L^3, AL/35, AL/140, AL/280, 3AL/280,
  // (2/15)A, (9/70)A/L^2
  const float g1 = -c[0] * tsq + c[1] * t1t2 + c[2] * (s * u2) + c[3] * (s * dw) -
                   c[4] * (u2 * dw) - c[4] * dw2;
  const float g2 = c[0] * tsq - c[1] * t1t2 - c[3] * (s * dw) + c[4] * dw2;
  const float g3 = c[5] * (t1c + t2c) - c[6] * (t1t2 * s) + c[7] * (tsq * dw) +
                   c[3] * (du * s) - c[8] * (s * dw2) - c[9] * (du * dw) + c[10] * dw3;
  const float g4 = c[11] * t1c - c[14] * t112 + c[12] * t122 - c[13] * t2c +
                   c[6] * (dw * (t1 * t1 - 2.0f * t1t2 - t2 * t2)) - c[15] * (t1 * du) +
                   c[1] * (t2 * du) + c[7] * (t1 * dw2) + c[3] * (du * dw) - c[16] * dw3;
  const float g6 = -c[13] * t1c + c[12] * t112 - c[14] * t122 + c[11] * t2c +
                   c[6] * (dw * (-t1 * t1 - 2.0f * t1t2 + t2 * t2)) + c[1] * (t1 * du) -
                   c[15] * (t2 * du) + c[7] * (t2 * dw2) + c[3] * (du * dw) - c[16] * dw3;
  g[0] = g1;
  g[1] = g3;
  g[2] = g4;
  g[3] = g2;
  g[4] = -g3;
  g[5] = g6;
}

// Element e's factors, or zeros where there is no element e.
__device__ __forceinline__ void load_factors(const float* __restrict__ coef, int n_el, int e,
                                             bool valid, float (&c)[kCorrCoefs]) {
#pragma unroll
  for (int k = 0; k < kCorrCoefs; ++k) c[k] = valid ? coef[k * n_el + e] : 0.0f;
}

// Window layout: x and g are (B, 3 n_sub) node planes [u; w; theta], rows
// ldx and ldg floats apart. A warp owns 32 consecutive nodes and
// kCorrRows consecutive env rows: lane l holds node n = 31 wx + l and
// element n (nodes n and n + 1), keeps the element's factors in registers,
// and for each row takes node n + 1 from lane l + 1 (__shfl_down_sync;
// lane 31 loads it itself) and passes its node-2 slots to lane l + 1
// (__shfl_up_sync). Warps overlap by one node: lane 0's element supplies
// only the node-2 slots of lane 1's node, so each warp writes 31 nodes and
// no two threads write one node. Node n = its element's node-1 slots plus
// element n - 1's node-2 slots, as the twin sums them; node 0 takes no
// node-2 slot and the last node no node-1 slot. No shared memory, no
// barrier, no atomics: deterministic. A thread issues the loads of
// kCorrBatch rows before their arithmetic. Device ms on an H100 at the
// main path's shapes, rows x batch: 16 x 4 0.044, 4 x 4 0.047, 8 x 4
// 0.044, 32 x 4 0.046, 16 x 1 0.047, 16 x 2 0.045, 16 x 8 0.052.
constexpr int kCorrRows = 16;    // env rows a window thread walks
constexpr int kCorrBatch = 4;    // rows whose loads a thread issues together
constexpr int kCorrNodes = 31;   // nodes a warp writes

__global__ void __launch_bounds__(kCorrThreads)
correction_window_kernel(int B, int n_sub, int warps_x, const float* __restrict__ x,
                         int64_t ldx, const float* __restrict__ coef, float* __restrict__ g,
                         int64_t ldg) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kCorrThreads + threadIdx.x) >> 5;
  const int wx = static_cast<int>(warp % warps_x);
  const int64_t row0 = warp / warps_x * kCorrRows;
  if (row0 >= B) return;  // a whole warp
  const int n_el = n_sub - 1;
  const int n = wx * kCorrNodes + lane;
  const bool has_node = n < n_sub;
  const bool has_el = n < n_el;
  const bool halo = lane == 31 && has_el;  // loads node n + 1 itself
  const bool writes = has_node && (lane > 0 || wx == 0);
  float c[kCorrCoefs];
  load_factors(coef, n_el, n, has_el, c);
  const int rows = B - row0 < kCorrRows ? static_cast<int>(B - row0) : kCorrRows;
  const float* xr = x + row0 * ldx;
  float* gr = g + row0 * ldg;

  for (int r0 = 0; r0 < rows; r0 += kCorrBatch) {
    float v[kCorrBatch][3], h[kCorrBatch][3];  // node n and, on lane 31, node n + 1
#pragma unroll
    for (int i = 0; i < kCorrBatch; ++i) {
      const bool ok = r0 + i < rows;
      const float* xi = xr + static_cast<int64_t>(r0 + i) * ldx;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v[i][q] = ok && has_node ? xi[q * n_sub + n] : 0.0f;
        h[i][q] = ok && halo ? xi[q * n_sub + n + 1] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kCorrBatch; ++i) {
      if (r0 + i >= rows) break;  // the same for the whole warp
      float b[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        b[q] = __shfl_down_sync(kAll, v[i][q], 1);
        if (lane == 31) b[q] = h[i][q];
      }
      float sl[6];
      correction(c, v[i][0], v[i][1], v[i][2], b[0], b[1], b[2], sl);
      float* gi = gr + static_cast<int64_t>(r0 + i) * ldg;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float prev = __shfl_up_sync(kAll, sl[3 + q], 1);
        const float own = has_el ? sl[q] : 0.0f;
        if (writes) gi[q * n_sub + n] = n > 0 ? own + prev : own;
      }
    }
  }
}

// Gathered (ECSW) layout: x and g are (B, 6 s) blocks [u1, w1, t1, u2, w2, t2]
// of the s sampled elements, rows ldx and ldg floats apart; no adjacency. A
// block covers min(s, 256) elements of 256 / min(s, 256) env rows at a time
// (246 of its 256 threads at s = 41), so no warp idles on a short sample;
// each thread keeps its element's factors and walks kGathRows such passes
// (1: 0.0038 ms on an H100 at 4096 envs, s = 41, one thread per (env,
// element); 2: 0.0038; 4: 0.0044; 8: 0.0051).
constexpr int kGathRows = 1;  // env-row passes a gathered thread walks

__global__ void __launch_bounds__(kCorrThreads)
correction_gathered_kernel(int B, int s, const float* __restrict__ x, int64_t ldx,
                           const float* __restrict__ coef, float* __restrict__ g,
                           int64_t ldg) {
  const int sj = min(s, kCorrThreads);
  const int per = kCorrThreads / sj;
  const int t = threadIdx.x;
  const int j = blockIdx.y * sj + t % sj;
  if (t >= per * sj || j >= s) return;
  float c[kCorrCoefs];
  load_factors(coef, s, j, true, c);
  int64_t row = static_cast<int64_t>(blockIdx.x) * per * kGathRows + t / sj;
#pragma unroll
  for (int r = 0; r < kGathRows; ++r, row += per) {
    if (row >= B) return;
    const float* xb = x + row * ldx + j;
    float sl[6];
    correction(c, xb[0], xb[s], xb[2 * s], xb[3 * s], xb[4 * s], xb[5 * s], sl);
    float* gb = g + row * ldg + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) gb[k * s] = sl[k];
  }
}

// g_m(i, j) = the S partial products summed in slice order, the residual,
// then the diagonal Newton update a1 - sinv r.
__global__ void update_kernel(int M, int N, int splits, const float* __restrict__ partials,
                              Residual res, const float* __restrict__ sinv) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n = static_cast<int64_t>(M) * N;
  if (idx >= n) return;
  const int j = static_cast<int>(idx % N);
  float eta_pred, etad_pred;
  const float r = res(idx, j, slice_sum(partials, splits, n, idx), eta_pred, etad_pred);
  res.up.finish(idx, res.up.a1[idx] - sinv[j] * r, eta_pred, etad_pred);
}

// ---------------------------------------------------------------------------
// Dense Newton: a1 - r SinvT with r formed in the block (see the header)
// ---------------------------------------------------------------------------

constexpr int kNdRows = 32;        // envs per block
constexpr int kNdCols = 256;       // modes (output columns) per block
constexpr int kNdK = 32;           // rows of SinvT per ring stage
constexpr int kNdStages = 3;
constexpr int kNdThreads = 256;    // 4 groups of 8 rows x 64 groups of 4 columns
constexpr int kNdRStride = kNdRows + 4;  // floats per k of the transposed r tile
constexpr int kNdStageFloats = kNdK * kNdCols;
constexpr int kNdMaxSmem = 232448;  // a block's shared memory on sm_90

__host__ __device__ inline int nd_k_rows(int m) { return (m + kNdK - 1) / kNdK * kNdK; }
inline size_t nd_smem(int m) {
  return 4 * (static_cast<size_t>(nd_k_rows(m)) * kNdRStride + kNdStages * kNdStageFloats);
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The inputs of r at 4 elements of a k slice: the state and the first 4
// partial products (a fifth and later are read when r is formed).
struct SliceInputs {
  State4 x[4];
  float p[4][4];
};

// Block (bx, by): envs 32 bx.., modes 256 by... SinvT is (m, m) with row
// pitch ld_s floats (a multiple of 4, 16-byte aligned rows). r is formed a
// 32-mode slice at a time, one slice ahead of the product: the inputs of
// slice kt + 1 load while slice kt is multiplied, so their latency hides
// behind the FMAs. Thread t forms modes 32 kt + t % 32 of rows t / 32 + 8 q.
__global__ void __launch_bounds__(kNdThreads, 1)
newton_dense_kernel(int B, int m, int splits, const float* __restrict__ partials, Residual res,
                    const float* __restrict__ sinvT, int64_t ld_s) {
  extern __shared__ __align__(16) float nd_smem_f[];
  const int k_rows = nd_k_rows(m);
  float* const rT = nd_smem_f;                          // (k_rows, kNdRStride): r transposed
  float* const ring = nd_smem_f + k_rows * kNdRStride;  // kNdStages x (kNdK, kNdCols)
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kNdRows;
  const int col0 = blockIdx.y * kNdCols;
  const int n_kt = k_rows / kNdK;
  const int64_t n = static_cast<int64_t>(B) * m;
  const Update& up = res.up;

  // Stage kt: rows 32 kt.. of SinvT, columns col0..; rows past m and columns
  // past the row pitch are zero-filled.
  auto load_stage = [&](int kt) {
    float* const dst = ring + (kt % kNdStages) * kNdStageFloats;
    for (int c = tid; c < kNdStageFloats / 4; c += kNdThreads) {
      const int kk = c / (kNdCols / 4), j4 = 4 * (c % (kNdCols / 4));
      const int k = kt * kNdK + kk, j = col0 + j4;
      const bool in = k < m && j < ld_s;
      cp_async16(smem_u32(dst + kk * kNdCols + j4),
                 in ? sinvT + static_cast<int64_t>(k) * ld_s + j : sinvT, in ? 16 : 0);
    }
  };
  // Slice kt of r: element q of this thread is row i = tid / 32 + 8 q, mode k.
  const int lane_k = tid % 32, row_q = tid / 32;
  auto slice_in = [&](int kt, int q) {
    const int k = kt * kNdK + lane_k, i = row_q + 8 * q;
    return k < m && row0 + i < B;
  };
  auto slice_idx = [&](int kt, int q) {
    return static_cast<int64_t>(row0 + row_q + 8 * q) * m + kt * kNdK + lane_k;
  };
  auto form_load = [&](int kt, SliceInputs& in) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = slice_in(kt, q);
      const int64_t idx = ok ? slice_idx(kt, q) : 0;
      in.x[q] = ok ? res.load(idx) : State4{0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int z = 0; z < 4; ++z) in.p[q][z] = ok && z < splits ? partials[z * n + idx] : 0.f;
    }
  };
  // r in update_kernel's order: the partials summed in slice order, then
  // the residual; rows past B and modes past m are zero.
  auto form_store = [&](int kt, const SliceInputs& in) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float r = 0.f;
      if (slice_in(kt, q)) {
        const int64_t idx = slice_idx(kt, q);
        float gm = in.p[q][0];
#pragma unroll
        for (int z = 1; z < 4; ++z)
          if (z < splits) gm += in.p[q][z];
        for (int z = 4; z < splits; ++z) gm += partials[z * n + idx];
        float eta_pred, etad_pred;
        r = res.of(in.x[q], kt * kNdK + lane_k, gm, eta_pred, etad_pred);
      }
      rT[(kt * kNdK + lane_k) * kNdRStride + row_q + 8 * q] = r;
    }
  };

  for (int kt = 0; kt < kNdStages - 1; ++kt) {
    if (kt < n_kt) load_stage(kt);
    cp_async_commit();
  }
  SliceInputs next;
  form_load(0, next);
  form_store(0, next);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int tx = tid % (kNdCols / 4), ty = tid / (kNdCols / 4);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kNdStages - 2>();
    // Slice kt of SinvT has landed for every thread, every thread is done
    // with slice kt - 1 (whose stage is refilled next), and slice kt of r is
    // formed.
    __syncthreads();
    if (kt + kNdStages - 1 < n_kt) load_stage(kt + kNdStages - 1);
    cp_async_commit();
    if (kt + 1 < n_kt) form_load(kt + 1, next);
    const float* const S = ring + (kt % kNdStages) * kNdStageFloats + 4 * tx;
    const float* const R = rT + kt * kNdK * kNdRStride + 8 * ty;
#pragma unroll 8
    for (int kk = 0; kk < kNdK; ++kk) {
      const float4 r0 = *reinterpret_cast<const float4*>(R + kk * kNdRStride);
      const float4 r1 = *reinterpret_cast<const float4*>(R + kk * kNdRStride + 4);
      const float4 b4 = *reinterpret_cast<const float4*>(S + kk * kNdCols);
      const float av[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // Slice kt + 1 of r goes to rows of rT no thread reads before the next
    // barrier.
    if (kt + 1 < n_kt) form_store(kt + 1, next);
  }

  // The Newton update from registers: this thread's outputs are rows 8 ty ..
  // 8 ty + 7, modes 4 tx .. 4 tx + 3; their state is loaded before any
  // output is stored (the compiler may not move loads across stores), as
  // 16-byte vectors when the rows allow it (m a multiple of 4, aligned
  // arrays): a warp then reads and writes 512 contiguous bytes an
  // instruction, where scalar accesses 16 bytes apart waste sectors.
  const int gj0 = col0 + 4 * tx;
  auto aligned = [](const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = (m & 3) == 0 && aligned(up.eta) && aligned(up.etad) && aligned(up.etadd) &&
                   aligned(up.a1) && aligned(up.out0) &&
                   (!up.last || (aligned(up.out1) && aligned(up.out2)));
  State4 x[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + 8 * ty + i;
    if (vec) {
      float4 v[4] = {};
      if (gi < B && gj0 < m) {
        const int64_t idx = static_cast<int64_t>(gi) * m + gj0;
        v[0] = *reinterpret_cast<const float4*>(up.eta + idx);
        v[1] = *reinterpret_cast<const float4*>(up.etad + idx);
        v[2] = *reinterpret_cast<const float4*>(up.etadd + idx);
        v[3] = *reinterpret_cast<const float4*>(up.a1 + idx);
      }
      x[i][0] = State4{v[0].x, v[1].x, v[2].x, v[3].x};
      x[i][1] = State4{v[0].y, v[1].y, v[2].y, v[3].y};
      x[i][2] = State4{v[0].z, v[1].z, v[2].z, v[3].z};
      x[i][3] = State4{v[0].w, v[1].w, v[2].w, v[3].w};
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = gi < B && gj0 + j < m;
        x[i][j] = in ? res.load(static_cast<int64_t>(gi) * m + gj0 + j)
                     : State4{0.f, 0.f, 0.f, 0.f};
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + 8 * ty + i;
    if (gi >= B || gj0 >= m) continue;
    float o[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const State4& v = x[i][j];
      const float a1n = v.a1 - acc[i][j];
      o[0][j] = up.last ? eta_pred_of(up.s, v.eta, v.etad, v.etadd) + up.s.bh2 * a1n : a1n;
      o[1][j] = v.etad + up.s.c_vp * v.etadd + up.s.gh * a1n;
      o[2][j] = a1n;
    }
    const int64_t idx = static_cast<int64_t>(gi) * m + gj0;
    if (vec) {
      *reinterpret_cast<float4*>(up.out0 + idx) = make_float4(o[0][0], o[0][1], o[0][2], o[0][3]);
      if (up.last) {
        *reinterpret_cast<float4*>(up.out1 + idx) =
            make_float4(o[1][0], o[1][1], o[1][2], o[1][3]);
        *reinterpret_cast<float4*>(up.out2 + idx) =
            make_float4(o[2][0], o[2][1], o[2][2], o[2][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gj0 + j >= m) continue;
        up.out0[idx + j] = o[0][j];
        if (up.last) {
          up.out1[idx + j] = o[1][j];
          up.out2[idx + j] = o[2][j];
        }
      }
    }
  }
}

inline Scalars scalars_of(const float* sc) {
  return Scalars{sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7], sc[8]};
}

}  // namespace

// B envs, m modes, N basis rows. Each function returns the cudaError_t of its
// launch (0 on success), or kEncodeError + the CUresult of a failed tensor
// map. sc: the nine step scalars (see Scalars).
extern "C" {

// The 128-byte tensor map of a (rows, cols) float32 basis half with row
// pitch ld (a multiple of 4 floats) into `out`.
int rom_tensor_map(void* out, const float* p, int rows, int cols, int64_t ld) {
  CUtensorMap map;
  const int rc = encode_map(&map, p, rows, cols, ld);
  if (rc == 0) std::memcpy(out, &map, sizeof(CUtensorMap));
  return rc;
}

int rom_alpha_point_launch(int B, int m, const float* eta, const float* etad,
                           const float* etadd, const float* a1, float* out, const float* sc,
                           void* stream) {
  const int64_t n = static_cast<int64_t>(B) * m;
  alpha_point_kernel<<<cdiv64(n, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(n, eta, etad, etadd, a1, out,
                                                            scalars_of(sc));
  return static_cast<int>(cudaGetLastError());
}

// eta_af (B, m) with row pitch ld_a; phi_hi/phi_lo: the maps of Phi's
// halves (N, m); x (B, N) with row pitch ld_x.
int rom_expand_launch(int B, int m, int N, const float* eta_af, int64_t ld_a,
                      const void* phi_hi, const void* phi_lo, float* x, int64_t ld_x,
                      void* stream) {
  const int units = static_cast<int>(cdiv(B, kTile) * cdiv(N, kTile));
  return launch_gemm<Tf32Consumer>(rom_expand_kernel, 0, units, eta_af, B, m, ld_a, phi_hi,
                                   phi_lo, static_cast<cudaStream_t>(stream), B, N, m, x, ld_x);
}

// The correction kernels: x (B, 3 n_sub) window planes or (B, 6 s) gathered
// blocks with row pitch ldx; coef: the (17, E) factor table (E = n_sub - 1
// or s); g with row pitch ldg.
int rom_correction_window_launch(int B, int n_sub, const float* x, int64_t ldx,
                                 const float* coef, float* g, int64_t ldg, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int warps_x = n_sub > 1 ? static_cast<int>(cdiv(n_sub - 1, kCorrNodes)) : 1;
  const int64_t warps = static_cast<int64_t>(warps_x) * cdiv(B, kCorrRows);
  correction_window_kernel<<<cdiv64(warps * 32, kCorrThreads), kCorrThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(B, n_sub, warps_x, x, ldx,
                                                                   coef, g, ldg);
  return static_cast<int>(cudaGetLastError());
}

int rom_correction_gathered_launch(int B, int s, const float* x, int64_t ldx,
                                   const float* coef, float* g, int64_t ldg, void* stream) {
  if (B <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  const int sj = s < kCorrThreads ? s : kCorrThreads;
  const dim3 grid(cdiv64(B, kCorrThreads / sj * kGathRows), cdiv(s, sj));
  correction_gathered_kernel<<<grid, kCorrThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      B, s, x, ldx, coef, g, ldg);
  return static_cast<int>(cudaGetLastError());
}

// g (B, N) with row pitch ld_g; wt_hi/wt_lo: the maps of W^T's halves
// (m, N); partials: (splits, B, m) products of S slices of the N-long
// reduction.
int rom_project_launch(int B, int m, int N, int splits, const float* g, int64_t ld_g,
                       const void* wt_hi, const void* wt_lo, float* partials, void* stream) {
  const int k_chunk =
      static_cast<int>(cdiv(static_cast<int>(cdiv(N, splits)), kSliceK)) * kSliceK;
  const int units = static_cast<int>(cdiv(B, kTile) * cdiv(m, kTile)) * splits;
  return launch_gemm<Tf32Consumer>(rom_project_kernel, 1, units, g, B, N, ld_g, wt_hi, wt_lo,
                                   static_cast<cudaStream_t>(stream), B, m, N, k_chunk, splits,
                                   partials);
}

// The diagonal Newton update: out0 = a1_new, or with last != 0 out0..2 =
// the new (eta, etad, etadd).
int rom_update_launch(int B, int m, int splits, const float* partials, const float* eta,
                      const float* etad, const float* etadd, const float* a1,
                      const float* lam, const float* u, const float* cd, const float* sinv,
                      int last, float* out0, float* out1, float* out2, const float* sc,
                      void* stream) {
  const Update up{eta, etad, etadd, a1, out0, out1, out2, m, last, scalars_of(sc)};
  const int64_t n = static_cast<int64_t>(B) * m;
  update_kernel<<<cdiv64(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      B, m, splits, partials, Residual{up, lam, u, cd}, sinv);
  return static_cast<int>(cudaGetLastError());
}

// The dense Newton update from the project's (splits, B, m) partials: out0 =
// a1 - r SinvT, or with last != 0 out0..2 = the new (eta, etad, etadd).
// sinvT: (m, m) with row pitch ld_s (a multiple of 4 floats).
int rom_newton_dense_launch(int B, int m, int splits, const float* partials, const float* eta,
                            const float* etad, const float* etadd, const float* a1,
                            const float* lam, const float* u, const float* cd,
                            const float* sinvT, int64_t ld_s, int last, float* out0,
                            float* out1, float* out2, const float* sc, void* stream) {
  const size_t smem = nd_smem(m);
  if (smem > static_cast<size_t>(kNdMaxSmem) || ld_s % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_smem_set[2][dev]) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        newton_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNdMaxSmem));
    if (rc != 0) return rc;
    g_smem_set[2][dev] = true;
  }
  const Update up{eta, etad, etadd, a1, out0, out1, out2, m, last, scalars_of(sc)};
  const dim3 grid(cdiv(B, kNdRows), cdiv(m, kNdCols));
  newton_dense_kernel<<<grid, kNdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      B, m, splits, partials, Residual{up, lam, u, cd}, sinvT, ld_s);
  return static_cast<int>(cudaGetLastError());
}

// nl_precision="highest": the float32 FFMA GEMMs on the unsplit bases.
// Expand: eta_af (B, m) with row pitch ld_a, phi: the map of Phi (N, m); x
// (B, N) with row pitch ld_x.
int rom_expand_f32_launch(int B, int m, int N, const float* eta_af, int64_t ld_a,
                          const void* phi, float* x, int64_t ld_x, void* stream) {
  const int units = static_cast<int>(cdiv(B, kTile) * cdiv(N, kTile));
  return launch_gemm<F32Consumer>(rom_expand_f32_kernel, 3, units, eta_af, B, m, ld_a, phi,
                                  nullptr, static_cast<cudaStream_t>(stream), B, N, m, x, ld_x);
}

// Project: g (B, N) with row pitch ld_g, wt: the map of W^T (m, N);
// partials: (splits, B, m) products of S slices of the N-long reduction.
int rom_project_f32_launch(int B, int m, int N, int splits, const float* g, int64_t ld_g,
                           const void* wt, float* partials, void* stream) {
  const int k_chunk =
      static_cast<int>(cdiv(static_cast<int>(cdiv(N, splits)), kSliceK)) * kSliceK;
  const int units = static_cast<int>(cdiv(B, kTile) * cdiv(m, kTile)) * splits;
  return launch_gemm<F32Consumer>(rom_project_f32_kernel, 4, units, g, B, N, ld_g, wt, nullptr,
                                  static_cast<cudaStream_t>(stream), B, m, N, k_chunk, splits,
                                  partials);
}

const char* cuda_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed or is unavailable";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
