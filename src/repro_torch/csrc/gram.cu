// Gram matrix G = X Xᵀ for X (N, P) row-major; the plan build's O(N²P) term.
//
// Replaces the TPU kernel gram_pallas (src/repro/kernels/gram/gram.py,
// body _gram_kernel), which walked the contraction as the innermost,
// sequential grid axis with the accumulator in VMEM.
//
// What bounds it here: operations. At the main size (N = 787, P = 76,000)
// the upper triangle is N(N+1)P = 4.7e10 FLOP (f32: 1.4e11 issued as three
// TF32 products) against 239 MB of X in f32, 478 MB in f64, far above the
// card's ridge. What the design does about it:
//   * f32 and bf16 run on the tensor cores (upper_gram_tc.cuh): f32 as
//     three TF32 products per k8 step from a big + small split of each value
//     (f32-grade; the card's TF32 rate is ~7x its f32 SIMT rate), bf16 as one
//     bf16 product; 128 x 128 output tiles, two warpgroups each;
//   * f64 runs on the FP64 tensor cores (upper_gram_dmma.cuh): mma.sync
//     m16n8k8 in f64 (DMMA, twice the f64 SIMT rate; f64 has no wgmma),
//     128 x 128 tiles of eight warps, products past the diagonal or N
//     skipped; f64 products and sums need no split. It runs well below the
//     DMMA peak: the staging (each chunk's cp.async copies and the
//     fragments' shared-memory reads) and the products share the SM and
//     overlap only in part (PERF.md);
//   * only the tiles with j >= i are computed; the reduce pass mirrors them,
//     which halves the operations (and makes G exactly symmetric). Both
//     passes are in gram_reduce.cuh, which pairdist's many-pattern route
//     runs with a distance epilogue;
//   * with N this small there are only 28 upper tiles for 132 SMs, so the
//     contraction is split into `splits` ranges run by separate blocks
//     (blockIdx.y), each writing a partial tile to a workspace; a second
//     kernel sums the partials in a fixed order, so results do not depend
//     on scheduling. It is a programmatic dependent launch: its blocks start
//     while the first pass ends and wait for it;
//   * ragged N and P are masked in the loader, so X is never padded or
//     copied on the card.
//
// Types: f32 and f64 accumulate in their own type; bf16 input accumulates
// and writes in f32 (the precision="bf16_gram" build).
#include "gram_reduce.cuh"

namespace repro {

template <typename TIn, typename TAcc>
int gram_launch(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  if (n <= 0 || p <= 0 || splits <= 0 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gram_passes<TIn, TAcc, GramOut>(
      x, ws, g, n, p, splits, static_cast<cudaStream_t>(stream)));
}

}  // namespace repro

extern "C" {

// ws: (splits, n, n) workspace of the accumulator type; g: (n, n) output. splits: kernels/gram/gram.py
// (tc_gram_splits for f32 and bf16, dmma_gram_splits for f64).
int gram_f32(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<float, float>(x, ws, g, n, p, splits, stream);
}
int gram_f64(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<double, double>(x, ws, g, n, p, splits, stream);
}
int gram_bf16(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<__nv_bfloat16, float>(x, ws, g, n, p, splits, stream);
}

}  // extern "C"
