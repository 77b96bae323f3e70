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
// What bounds it here: it depends on C. At the RSA path's condition means
// (C = 8, P = 76,000, f32) the product is C(C+1)P = 5.5e6 operations against
// 2.4 MB of U: bytes, by far (0.73 µs at 3.35 TB/s). At a single-trial RDM
// (C = 787) it is 4.7e10 operations against 239 MB: operations (0.70 ms at
// 67 TFLOP/s). What the design does about it:
//   * the first pass is gram's (upper_gram.cuh): upper 64 x 64 tiles only,
//     the contraction split over blockIdx.z into a workspace, ragged C and P
//     masked in the loader (U is never padded or copied);
//   * the split count is gram_splits' (kernels/gram/gram.py). It matters more
//     here than for gram: at C = 8 there is a single tile, and without a split
//     one block would walk all 76,000 columns; with ~75 splits the read of U
//     spreads over 75 SMs;
//   * the second pass sums the partials in a fixed order and writes the
//     distance. The norms are not a separate input: ‖u_i‖² is the summed
//     diagonal G_ii of the same partials, in the accumulator type. So
//     D_ii = G_ii + G_ii − 2 G_ii is exactly 0, D is exactly symmetric, and
//     a bf16 input's norms are f32 (the TPU wrapper rounds them to bf16).
// A 64 x 64 tile wastes most of its work at C = 8; a small-C design, wgmma
// and TMA are later work.
//
// Types: f32 and f64 accumulate and write in their own type; bf16 input
// accumulates and writes in f32.
#include "upper_gram.cuh"

namespace repro {

template <typename TAcc>
__global__ void __launch_bounds__(kThreads)
pairdist_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ d, int c, int splits) {
  const size_t total = static_cast<size_t>(c) * c;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / c), j = static_cast<int>(idx % c);
    const TAcc g_ij = split_sum(ws, upper_src(i, j, c), total, splits);
    const TAcc n_i = split_sum(ws, static_cast<size_t>(i) * c + i, total, splits);
    const TAcc n_j = split_sum(ws, static_cast<size_t>(j) * c + j, total, splits);
    const TAcc v = (n_i + n_j) - TAcc(2) * g_ij;
    d[idx] = v < TAcc(0) ? TAcc(0) : v;  // clamp; a NaN passes through
  }
}

template <typename TIn, typename TAcc>
int pairdist_launch(const void* u, void* ws, void* d, int c, int p, int splits, void* stream) {
  if (c <= 0 || p <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_upper_gram_partials<TIn, TAcc>(u, ws, c, p, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(c) * c;
  pairdist_reduce_kernel<TAcc><<<stride_blocks(total), kThreads, 0, st>>>(
      static_cast<const TAcc*>(ws), static_cast<TAcc*>(d), c, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// ws: (splits, c, c) workspace of the accumulator type; d: (c, c) output.
int pairdist_f32(const void* u, void* ws, void* d, int c, int p, int splits, void* stream) {
  return repro::pairdist_launch<float, float>(u, ws, d, c, p, splits, stream);
}
int pairdist_f64(const void* u, void* ws, void* d, int c, int p, int splits, void* stream) {
  return repro::pairdist_launch<double, double>(u, ws, d, c, p, splits, stream);
}
int pairdist_bf16(const void* u, void* ws, void* d, int c, int p, int splits, void* stream) {
  return repro::pairdist_launch<__nv_bfloat16, float>(u, ws, d, c, p, splits, stream);
}

}  // extern "C"
