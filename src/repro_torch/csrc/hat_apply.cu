// Full-fit errors E = Y − H·Y for the hat matrix H (N, N) and a label batch
// Y (N, B); Algorithm 1's inner step and the train-block eval route's Ê.
//
// Replaces the TPU kernel hat_apply_pallas
// (src/repro/kernels/hat_apply/hat_apply.py, body _hat_apply_kernel), which
// accumulated H·Y over a sequential contraction grid axis and fused the
// subtraction into the store.
//
// What bounds it here: at the main size (N = 787, a permutation chunk of
// B = 250, f32) it is 2N²B = 3.1e8 FLOP against 2.5 MB of H and 0.8 MB each
// of Y and E, about 90 FLOP per byte: operations, barely. The whole problem
// is a few microseconds of work, so launch overhead and the ~13 x 4 tiles'
// parallelism dominate; the design only avoids the extra (N, B) round trip
// by subtracting in the epilogue (Y − acc is written, H·Y never is), and
// masks the ragged edges instead of padding H.
//
// Types: f32 and f64, each accumulated in its own type.
#include "tile.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
hat_apply_kernel(const T* __restrict__ h, const T* __restrict__ y, T* __restrict__ e, int n, int b) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  T acc[4][4];
  tile_product<T, T, false>(h, n, y, b, n, b, bi * kTile, bj * kTile, 0, n, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = bi * kTile + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = bj * kTile + tx + 16 * j;
      if (r < n && c < b) {
        const size_t at = static_cast<size_t>(r) * b + c;
        e[at] = y[at] - acc[i][j];
      }
    }
  }
}

template <typename T>
int hat_apply_launch(const void* h, const void* y, void* e, int n, int b, void* stream) {
  if (n <= 0 || b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((b + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  hat_apply_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(y), static_cast<T*>(e), n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

int hat_apply_f32(const void* h, const void* y, void* e, int n, int b, void* stream) {
  return repro::hat_apply_launch<float>(h, y, e, n, b, stream);
}
int hat_apply_f64(const void* h, const void* y, void* e, int n, int b, void* stream) {
  return repro::hat_apply_launch<double>(h, y, e, n, b, stream);
}

}  // extern "C"
