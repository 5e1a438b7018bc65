// Thread map of the fused small-beam kernel (fused_rollout.cu): which instance serves
// n DOFs in a dtype, and how its threads and blocks cover B environments.
//
// Plain C++17, no CUDA: fused_rollout.cu includes it and launches by it, and the host
// compiler builds it alone for the map's emulation on the CPU, so the map is stated
// once. fused_gen_alpha_geometry is its C query.
#pragma once

// Environments a thread of the rows instance owns (chosen by measurement,
// chip_variants.py --fused).
template <typename T>
constexpr int kEnvs = sizeof(T) == 4 ? 2 : 3;
// The rows instance serves n up to kRegRows (3 n registers of operator rows a thread).
template <typename T>
constexpr int kRegRows = sizeof(T) == 4 ? 36 : 24;
constexpr int kPairs = 128;        // (row, env group) pairs a rows-instance block aims at
constexpr int kRowsThreads = 256;  // most threads of a rows-instance block

constexpr int kWarps = 8;  // lanes instance: environments (one a warp) per block
constexpr int kThreads = 32 * kWarps;
// Lanes instance, rows per lane, n <= 32 R: one block's shared memory caps n at 135
// in float and 94 in double, so R stops at 5 and 3.
template <typename T>
constexpr int kMaxRows = sizeof(T) == 4 ? 5 : 3;
constexpr long kSmemBytes = 232448;  // shared memory one block of an H100 can use

// A thread's E values of one [j][env] row of a broadcast vector lie in a slot of
// kSlot<E> (E rounded up to a power of two) values, so a slot starts on a multiple
// of its size.
template <int E>
constexpr int kSlot = E <= 1 ? 1 : E <= 2 ? 2 : E <= 4 ? 4 : E <= 8 ? 8 : 16;

// instance 0 (rows): thread t of a block owns row t % n of env group t / n, `groups`
// env groups of `envs` environments a block; the kernel is a template on np, n rounded
// up to a multiple of 3. instance 1 (lanes): warp w owns environment w of the block,
// lane l rows l, l + 32, ... (`rows` of them), the three matrices in shared memory.
struct FusedGeometry {
  int instance, envs, groups, threads, blocks, rows, np, smem;
};

// The map for n DOFs of T and B environments; false for an n that neither instance
// serves (n < 1, or the lanes instance's matrices beyond one block's shared memory).
template <typename T>
inline bool fused_geometry(int n, int B, FusedGeometry* g) {
  if (n < 1 || B < 0) return false;
  if (n <= kRegRows<T>) {
    const int groups = kPairs / n > 1 ? kPairs / n : 1;
    const int envs = kEnvs<T>;
    const int np = (n + 2) / 3 * 3;
    *g = {0, envs, groups, (groups * n + 31) / 32 * 32,
          (B + groups * envs - 1) / (groups * envs), 0, np,
          static_cast<int>(3L * np * groups * kSlot<kEnvs<T>> * sizeof(T))};
    return g->threads <= kRowsThreads;
  }
  const long smem = (3L * n * n + kWarps * 3L * n) * static_cast<long>(sizeof(T));
  if (smem > kSmemBytes) return false;
  *g = {1, 1, kWarps, kThreads, (B + kWarps - 1) / kWarps, (n + 31) / 32, 0,
        static_cast<int>(smem)};
  return g->rows <= kMaxRows<T>;
}

// dtype 0 = float32, 1 = float64. Writes instance, envs, groups, threads, blocks, rows,
// np and smem (bytes of dynamic shared memory) into out[0..7] and returns 0, or returns
// 1 for an n that neither instance serves.
extern "C" int fused_gen_alpha_geometry(int dtype, int n, int B, int* out) {
  FusedGeometry g;
  if (!(dtype == 0 ? fused_geometry<float>(n, B, &g) : fused_geometry<double>(n, B, &g)))
    return 1;
  const int v[8] = {g.instance, g.envs, g.groups, g.threads, g.blocks, g.rows, g.np, g.smem};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}
