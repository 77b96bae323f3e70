// Split-contraction partials of the upper 128 x 128 tiles of G = X Xᵀ on the
// FP64 tensor cores (DMMA, mma.sync m16n8k8 .f64, sm_90; primitives in
// dmma.cuh, shared with hat_apply's f64 route); gram's first pass for f64
// input.
//
// Each block computes one upper tile (bi, bj), bj >= bi, over the s-th range
// of `chunk` contraction columns (the grid is upper tiles x splits). It
// writes the tile to ws[s] (N x N), and gram.cu's second pass sums the
// partials in a fixed order, reading every G_ij from the upper triangle, so
// G is exactly symmetric and bitwise repeatable.
//
// f64 has no wgmma: Hopper's f64 tensor-core path is mma.sync, one warp a
// product. A block is eight warps, each owning a 64 x 32 sub-tile of the
// tile: 4 x 4 products of m16n8, 64 f64 accumulators a thread. Products
// whose rows all lie below the diagonal, or past N, are skipped (a per-warp
// mask, the same for every chunk), so the diagonal tiles and the ragged
// edge cost what they hold.
//
// No split of the values: products and sums are f64 throughout, so there
// is no big + small split and no fresh accumulator per chunk (the f32 route
// needs both: TF32 products are short and the tensor cores' f32
// accumulation truncates). One accumulator runs over the split's range.
//
// Staging: chunks of kDmmaK = 16 contraction columns (128 bytes of a row),
// copied by cp.async into a ring of kDmmaRing stages, three chunks in
// flight while the current one is multiplied; one __syncthreads a chunk.
// Rows are copied as 16-byte pieces where every row is 16-byte aligned (P
// even and X's start aligned), else as 8-byte pieces: the route takes any
// contiguous f64 tensor, at any element offset. Rows past N and columns
// past the range are zero-filled, so X is never padded or copied on the
// card. A diagonal tile copies its rows once and reads them as both
// operands.
//
// Store: the finished tile goes through shared memory, so that every warp
// writes 32 consecutive entries of a row of the partial; only the entries on
// or above the diagonal, which are all the reduce pass reads.
#pragma once

#include <cstdint>

#include "dmma.cuh"

namespace repro {

constexpr int kDmmaTile = 128;      // output tile rows and columns
constexpr int kDmmaThreads = 256;   // eight warps of 64 x 32
constexpr int kDmmaRing = 4;        // stages: chunks c + 1 .. c + 3 in flight
// one stage: the A rows, then the B rows (unused by a diagonal tile)
constexpr int kDmmaStage = 2 * kDmmaTile * kDmmaLd;
constexpr size_t kDmmaGramSmem = static_cast<size_t>(kDmmaRing) * kDmmaStage * sizeof(double);
// the output tile staged for the store: rows of 136 doubles (1,088 bytes, 64
// mod 128), so a quarter warp's 16-byte writes of two rows hit eight groups
constexpr int kDmmaOutLd = kDmmaTile + 8;
static_assert(kDmmaTile * kDmmaOutLd <= kDmmaRing * kDmmaStage, "the tile must fit the stages");

__global__ void __launch_bounds__(kDmmaThreads, 1)
upper_gram_dmma_kernel(const double* __restrict__ x, double* __restrict__ ws, int n, int p,
                       int chunk) {
  extern __shared__ __align__(16) double dmma_smem[];
  const int tiles = (n + kDmmaTile - 1) / kDmmaTile, s = blockIdx.y;
  int bi = 0, u = blockIdx.x;   // upper tile u → (bi, bj), row by row
  while (u >= tiles - bi) {
    u -= tiles - bi;
    ++bi;
  }
  const int bj = bi + u;
  const bool diag = bi == bj;
  const int k_begin = s * chunk;
  const int k_end = min(p, k_begin + chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + kDmmaK - 1) / kDmmaK : 0;
  const bool vec = p % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int wr = 64 * (warp / 4), wc = 32 * (warp % 4);   // this warp's sub-tile
  const int r_base = bi * kDmmaTile + wr, c_base = bj * kDmmaTile + wc;
  // products (mi, ni) that hold an entry with row <= column, inside N
  uint32_t live = 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = r_base + 16 * mi, c = c_base + 8 * ni;
      if (r < n && c < n && r <= c + 7) live |= 1u << (4 * mi + ni);
    }

  auto issue = [&](int c, int stage) {
    double* sa = dmma_smem + stage * kDmmaStage;
    const int kc = k_begin + c * kDmmaK;
    dmma::stage_rows<kDmmaTile, kDmmaThreads>(sa, x, p, n, bi * kDmmaTile, kc, k_end, vec, tid);
    if (!diag)
      dmma::stage_rows<kDmmaTile, kDmmaThreads>(sa + kDmmaTile * kDmmaLd, x, p, n,
                                                bj * kDmmaTile, kc, k_end, vec, tid);
  };

  double acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

  auto compute = [&](int stage) {
    const double* sa = dmma_smem + stage * kDmmaStage;
    const double* sb = diag ? sa : sa + kDmmaTile * kDmmaLd;
#pragma unroll
    for (int kk = 0; kk < kDmmaK / 8; ++kk) {
      // B = the tile's column rows of X, k-major like A: (k, n) at row n;
      // A's fragments one m-tile at a time, to spare registers
      double b[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const double2 v = *reinterpret_cast<const double2*>(
            sb + (wc + 8 * ni + g) * kDmmaLd + 8 * kk + 2 * q);
        b[ni][0] = v.x;
        b[ni][1] = v.y;
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        double a[4];
        dmma::load_a(a, sa, wr + 16 * mi, kk, g, q);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          if (live >> (4 * mi + ni) & 1u) dmma::mma_m16n8k8(acc[mi][ni], a, b[ni]);
      }
    }
  };

  // Chunk c is copied kDmmaRing − 1 chunks ahead. The barrier after a
  // chunk's wait publishes every thread's copies and retires the stage read
  // in the previous iteration, which the next copy then refills.
#pragma unroll
  for (int c = 0; c < kDmmaRing - 1; ++c) {
    if (c < steps) issue(c, c);
    sm90::cp_async_commit();
  }
  for (int c = 0; c < steps; ++c) {
    sm90::cp_async_wait<kDmmaRing - 2>();   // this thread's copies of chunk c have landed
    __syncthreads();
    const int next = c + kDmmaRing - 1;
    if (next < steps) issue(next, next % kDmmaRing);
    sm90::cp_async_commit();
    compute(c % kDmmaRing);
  }
  // let the reduce pass launch (programmatic dependent launch); it still
  // waits for this grid's stores before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The tile goes out through shared memory (the stages are free now), so
  // that the partial's rows are written whole, a warp to 32 consecutive entries:
  // acc[mi][ni][2h + e] is entry (wr + 16·mi + g + 8h, wc + 8·ni + 2q + e).
  __syncthreads();
  double* tile = dmma_smem;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<double2*>(tile + (wr + 16 * mi + g + 8 * h) * kDmmaOutLd + wc +
                                    8 * ni + 2 * q) =
            make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
  // The upper entries (row <= column) to ws[s]; the reduce pass reads
  // nothing else.
  double* out = ws + static_cast<size_t>(s) * n * n;
  const int r0 = bi * kDmmaTile, c0 = bj * kDmmaTile;
  const int rows = min(kDmmaTile, n - r0), cols = min(kDmmaTile, n - c0);
  for (int e = tid; e < kDmmaTile * kDmmaTile; e += kDmmaThreads) {
    const int r = e / kDmmaTile, c = e % kDmmaTile;
    if (r < rows && c < cols && r0 + r <= c0 + c)
      out[static_cast<size_t>(r0 + r) * n + c0 + c] = tile[r * kDmmaOutLd + c];
  }
}

// Launch the first pass on `stream`; returns the first CUDA error. The
// shared-memory opt-in is made once per device.
inline cudaError_t launch_upper_gram_dmma(const void* x, void* ws, int n, int p, int splits,
                                          cudaStream_t stream) {
  static std::atomic<uint32_t> opted{0};
  const cudaError_t err = set_smem_once(opted, upper_gram_dmma_kernel, kDmmaGramSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kDmmaTile - 1) / kDmmaTile;
  const int chunk = ((p + splits - 1) / splits + kDmmaK - 1) / kDmmaK * kDmmaK;
  dim3 grid(tiles * (tiles + 1) / 2, splits);
  upper_gram_dmma_kernel<<<grid, kDmmaThreads, kDmmaGramSmem, stream>>>(
      static_cast<const double*>(x), static_cast<double*>(ws), n, p, chunk);
  return cudaGetLastError();
}

}  // namespace repro
