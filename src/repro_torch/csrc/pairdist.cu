// Pairwise squared Euclidean distances D_ij = max(‖u_i‖² + ‖u_j‖² − 2 u_i·u_j, 0)
// for row patterns U (C, P) row-major; the RSA pattern-RDM product
// (condition-mean RDMs, single-trial RDMs, model RDMs from embeddings).
//
// Replaces the TPU kernel pairdist_pallas
// (src/repro/kernels/pairdist/pairdist.py, body _pairdist_kernel), which is
// the gram tile with a distance epilogue: the cross product accumulated over
// a sequential feature-chunk grid axis in VMEM, lane-replicated norms as a
// second input, and the distances assembled on the last chunk.
//
// What bounds it here depends on C, so there are two routes, chosen by
// shape (kernels/pairdist/pairdist.py::pairdist_route):
//
//   * route S, few conditions (the RSA path's condition means, C = 8,
//     P = 76,000, f32): C(C+1)P = 5.5e6 operations against 2.4 MB of U, so
//     bytes, by far (0.73 µs at 3.35 TB/s). The read of U is spread over
//     every SM: block b takes columns [b·cols, (b+1)·cols) of all C rows
//     (cols: pairdist.py::s_grid), copied once by cp.async into a ring of
//     16 KB stages, as 16-byte pieces where every row starts 16-byte
//     aligned, else element by element. Each thread sums an 8 x 8 tile of
//     pair products (pairs of 8-row groups a <= b; a diagonal tile only its
//     upper half) over its columns, in registers; the lanes of a tile are an
//     aligned power-of-two run of threads, summed by a fixed shuffle tree
//     (and across warps in a fixed order) into the block's partial; a
//     second pass, a programmatic dependent launch, sums the blocks'
//     partials in a fixed order, a warp per pair, and writes the clamped
//     distances. Rows are never padded: the rows of a tile past C read row
//     C − 1 and their sums are dropped. C <= 128;
//   * route T, many patterns (single-trial RDMs, C = 787): 4.7e10
//     operations against 239 MB, so operations. It is gram's tensor-core
//     first pass unchanged (3×TF32 or bf16 wgmma, upper_gram_tc.cuh; DMMA
//     for f64, upper_gram_dmma.cuh; their split counts) and gram's reduce
//     with the distance epilogue (gram_reduce.cuh): each reduce block sums
//     the diagonal entries of its two 32-row tiles first, then reads every
//     G_ij from the element upper triangle (3×TF32 is not symmetric inside
//     a diagonal tile) and mirrors the distance through shared memory.
//
// On both routes the norms are not a separate input: ‖u_i‖² is G_ii summed
// as every G_ij is, in the accumulator type, so D_ii = 2G_ii − 2G_ii is
// exactly 0, each D_ij and D_ji come from one computed value (D is exactly
// symmetric), and a bf16 input's norms are f32 (the TPU wrapper rounds them
// to bf16). Every sum has a fixed order and there are no atomics, so
// results are bitwise repeatable.
//
// Types: f32 and f64 accumulate and write in their own type; bf16 input
// accumulates and writes in f32.
#include "gram_reduce.cuh"

namespace repro {

constexpr int kRouteS = 0;
constexpr int kRouteT = 1;

constexpr int kRowsThreads = 256;
constexpr int kRowsGroup = 8;        // rows of a register tile: 8 x 8 pairs a thread
constexpr int kRowsStage = 16384;    // bytes of one stage: a chunk of columns of every row
constexpr int kRowsRing = 3;         // stages: two chunks in flight while one is summed
constexpr int kRowsMaxC = 128;       // 136 upper tiles of 8-row groups: a thread each at least
constexpr size_t kRowsSmem = static_cast<size_t>(kRowsRing) * kRowsStage;

// Copy the first `count` (1 .. E) elements of the 16-byte piece at `src` to
// shared memory at `dst`. `vec`: the piece is 16-byte aligned (zeros after
// `count`); else element by element (f32 and f64 by cp.async, bf16 through
// registers), nothing after `count`.
template <typename T>
__device__ __forceinline__ void rows_piece(unsigned char* dst, const T* src, int count, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    sm90::cp_async16(sm90::smem_u32(dst), src, count * static_cast<int>(sizeof(T)));
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < count) sm90::cp_async4(sm90::smem_u32(dst) + 4 * e, src + e, 4);
  } else if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < count) dmma::cp_async8(sm90::smem_u32(dst) + 8 * e, src + e, 8);
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(src);
    uint16_t* to = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < count) to[e] = bits[e];
  }
}

// Route S, first pass: block b's partial sums of every pair product over
// its column range, to ws[b] (tiles x 64 entries: tile t's entry 8r + s is
// the pair (8a + r, 8b + s) of its row groups (a, b)).
template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kRowsThreads, 1)
pairdist_rows_kernel(const TIn* __restrict__ u, TAcc* __restrict__ ws, int c, int p, int cols) {
  constexpr int E = 16 / static_cast<int>(sizeof(TIn));   // elements per 16-byte piece
  constexpr int G = kRowsGroup;
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const int groups = (c + G - 1) / G;
  const int tiles = groups * (groups + 1) / 2;
  int lanes = kRowsThreads;   // threads a tile: a power of two, tiles x lanes <= 256
  while (lanes * tiles > kRowsThreads) lanes >>= 1;
  int ppr = 128;              // pieces of a staged row: a power of two, >= 8
  while (ppr * groups > 128) ppr >>= 1;
  const int kc = ppr * E;     // columns a chunk (and elements a staged row)
  const int k_begin = blockIdx.x * cols;
  const int k_end = min(p, k_begin + cols);
  const int steps = (k_end - k_begin + kc - 1) / kc;
  const bool vec = p % E == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0;

  const int tid = threadIdx.x, tile = tid / lanes, lane = tid % lanes;
  const bool active = tile < tiles;
  int a = 0, v = active ? tile : 0;   // tile → row groups (a, b), a <= b, row by row
  while (v >= groups - a) {
    v -= groups - a;
    ++a;
  }
  const int b = a + v;
  const bool diag = a == b;
  // the last row of each group inside C: rows past it read it instead
  const int last_a = min(G, c - a * G) - 1, last_b = min(G, c - b * G) - 1;

  // Piece q of row r goes to slot q ^ (r/8 mod 8) of the row: the 8-row
  // groups a tile's lanes read at one column then fall in different banks.
  auto issue = [&](int ch, int stage) {
    unsigned char* base = rows_smem + stage * kRowsStage;
    const int k0 = k_begin + ch * kc;
    for (int e = tid; e < c * ppr; e += kRowsThreads) {
      const int r = e / ppr, q = e % ppr;
      const int col = k0 + q * E;
      const int count = min(E, k_end - col);
      if (count > 0)
        rows_piece(base + (r * ppr + (q ^ ((r / G) & 7))) * 16,
                   u + static_cast<size_t>(r) * p + col, count, vec);
    }
  };

  TAcc acc[G][G];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int s = 0; s < G; ++s) acc[r][s] = TAcc(0);

  // Chunk ch is copied kRowsRing − 1 chunks ahead; the barrier after its
  // wait publishes every thread's copies and retires the stage summed in
  // the previous iteration, which the next copy then refills.
#pragma unroll
  for (int ch = 0; ch < kRowsRing - 1; ++ch) {
    if (ch < steps) issue(ch, ch);
    sm90::cp_async_commit();
  }
  for (int ch = 0; ch < steps; ++ch) {
    sm90::cp_async_wait<kRowsRing - 2>();
    __syncthreads();
    const int next = ch + kRowsRing - 1;
    if (next < steps) issue(next, next % kRowsRing);
    sm90::cp_async_commit();
    if (!active) continue;
    const TIn* s = reinterpret_cast<const TIn*>(rows_smem + (ch % kRowsRing) * kRowsStage);
    const TIn* rows_a = s + a * G * kc;
    const TIn* rows_b = s + b * G * kc;
    const int nk = min(kc, k_end - (k_begin + ch * kc));
    for (int k = lane; k < nk; k += lanes) {
      const int q = k / E, w = k % E;
      const TIn* pa = rows_a + (q ^ (a & 7)) * E + w;
      TAcc va[G];
#pragma unroll
      for (int r = 0; r < G; ++r) va[r] = to_acc(pa[min(r, last_a) * kc]);
      if (diag) {
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int t = r; t < G; ++t) acc[r][t] += va[r] * va[t];
      } else {
        const TIn* pb = rows_b + (q ^ (b & 7)) * E + w;
        TAcc vb[G];
#pragma unroll
        for (int t = 0; t < G; ++t) vb[t] = to_acc(pb[min(t, last_b) * kc]);
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int t = 0; t < G; ++t) acc[r][t] += va[r] * vb[t];
      }
    }
  }
  // let the reduce pass launch (programmatic dependent launch); it still
  // waits for this grid's stores before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // A tile's lanes: a fixed shuffle tree inside the warp ...
  for (int off = min(lanes, 32) / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int t = 0; t < G; ++t) acc[r][t] += __shfl_xor_sync(0xffffffffu, acc[r][t], off);
  TAcc* out = ws + static_cast<size_t>(blockIdx.x) * tiles * G * G;
  if (lanes <= 32) {
    if (active && lane == 0)
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int t = 0; t < G; ++t) out[tile * G * G + r * G + t] = acc[r][t];
    return;
  }
  // ... and, for a tile of several warps, their sums added in warp order
  // (the ring is free: every copy has landed and been summed)
  sm90::cp_async_wait<0>();
  __syncthreads();
  TAcc* red = reinterpret_cast<TAcc*>(rows_smem);   // [warp][64]
  const int warp = tid / 32;
  if (tid % 32 == 0)
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int t = 0; t < G; ++t) red[warp * G * G + r * G + t] = acc[r][t];
  __syncthreads();
  const int per = lanes / 32;   // warps a tile
  if (tid < tiles * G * G) {
    const int first = tid / (G * G) * per, e = tid % (G * G);
    TAcc sum = red[first * G * G + e];
    for (int w = 1; w < per; ++w) sum += red[(first + w) * G * G + e];
    out[tid] = sum;
  }
}

// Σ over the route-S blocks of ws[·][entry], in a fixed order: lane l adds
// blocks l, l + 32, ..., then a fixed shuffle tree; every lane gets lane 0's.
template <typename TAcc>
__device__ __forceinline__ TAcc rows_block_sum(const TAcc* __restrict__ ws, int entry,
                                               int entries, int blocks, int lane) {
  TAcc s = TAcc(0);
#pragma unroll 4
  for (int blk = lane; blk < blocks; blk += 32) s += ws[static_cast<size_t>(blk) * entries + entry];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return __shfl_sync(0xffffffffu, s, 0);
}

// Route S, second pass: a warp per pair i <= j sums G_ij, G_ii and G_jj
// over the blocks and writes D_ij and D_ji. Launched as a programmatic
// dependent of the first pass: it waits here until that pass has finished
// and its stores are visible.
template <typename TAcc>
__global__ void __launch_bounds__(kRowsThreads)
pairdist_rows_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ d, int c,
                            int blocks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int G = kRowsGroup;
  const int groups = (c + G - 1) / G, entries = groups * (groups + 1) / 2 * G * G;
  const int lane = threadIdx.x % 32;
  int v = blockIdx.x * (kRowsThreads / 32) + threadIdx.x / 32;
  if (v >= c * (c + 1) / 2) return;
  int i = 0;   // pair v → (i, j), i <= j, row by row
  while (v >= c - i) {
    v -= c - i;
    ++i;
  }
  const int j = i + v;
  auto entry = [&](int r, int s) {
    const int ga = r / G, gb = s / G;
    return (ga * groups - ga * (ga - 1) / 2 + gb - ga) * G * G + (r % G) * G + s % G;
  };
  const TAcc g = rows_block_sum(ws, entry(i, j), entries, blocks, lane);
  const TAcc n_i = rows_block_sum(ws, entry(i, i), entries, blocks, lane);
  const TAcc n_j = rows_block_sum(ws, entry(j, j), entries, blocks, lane);
  if (lane == 0) {
    const TAcc dist = DistanceOut::apply(g, n_i, n_j);
    d[static_cast<size_t>(i) * c + j] = dist;
    d[static_cast<size_t>(j) * c + i] = dist;
  }
}

template <typename TIn, typename TAcc>
int pairdist_launch(const void* u, void* ws, void* d, int c, int p, int route, int parts,
                    void* stream) {
  if (c <= 0 || p <= 0 || parts <= 0 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (route == kRouteT)
    return static_cast<int>(launch_gram_passes<TIn, TAcc, DistanceOut>(u, ws, d, c, p, parts, st));
  if (route != kRouteS || c > kRowsMaxC || parts % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p + parts - 1) / parts;
  pairdist_rows_kernel<TIn, TAcc><<<blocks, kRowsThreads, kRowsSmem, st>>>(
      static_cast<const TIn*>(u), static_cast<TAcc*>(ws), c, p, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = c * (c + 1) / 2, warps = kRowsThreads / 32;
  return static_cast<int>(launch_dependent(pairdist_rows_reduce_kernel<TAcc>,
                                           dim3((pairs + warps - 1) / warps), dim3(kRowsThreads),
                                           st, static_cast<const TAcc*>(ws),
                                           static_cast<TAcc*>(d), c, blocks));
}

}  // namespace repro

extern "C" {

// d: (c, c) output of the accumulator type. route 0 (S): parts = columns per
// block, a multiple of 16, ws (blocks, tiles · 64) with blocks = ⌈p / parts⌉
// and tiles = g(g + 1)/2 for g = ⌈c / 8⌉, c <= 128. route 1 (T): parts =
// splits, ws (splits, c, c). Both: kernels/pairdist/pairdist.py.
int pairdist_f32(const void* u, void* ws, void* d, int c, int p, int route, int parts,
                 void* stream) {
  return repro::pairdist_launch<float, float>(u, ws, d, c, p, route, parts, stream);
}
int pairdist_f64(const void* u, void* ws, void* d, int c, int p, int route, int parts,
                 void* stream) {
  return repro::pairdist_launch<double, double>(u, ws, d, c, p, route, parts, stream);
}
int pairdist_bf16(const void* u, void* ws, void* d, int c, int p, int route, int parts,
                  void* stream) {
  return repro::pairdist_launch<__nv_bfloat16, float>(u, ws, d, c, p, route, parts, stream);
}

}  // extern "C"
