// Fused fold evaluation ė_Te = (I − H_Te)⁻¹ (y_Te − H[te_k, :]·Y), which also
// writes ê_Te, for plans without train blocks (ridge CV, adjust_bias=False).
//
// Replaces the TPU kernel fold_eval_pallas
// (src/repro/kernels/fold_eval/fold_eval.py, body _fold_eval_kernel), which
// streamed each fold's hat rows over a sequential contraction grid axis into
// a VMEM accumulator and ran the fold solve as the epilogue of the last
// chunk.
//
// One block per (fold, tile of bb columns of Y). Its threads each own
// (row, column) entries of the fold's (m, bb) block and loop over all N,
// reading the hat row (one address per warp, a broadcast) and Y's column
// tile (neighbouring threads, neighbouring columns); the sum is written
// straight into the right-hand half of [I − H_Te | ê] and the shared
// gauss_jordan.cuh solve runs in the same block, so ê never makes a round
// trip through device memory before the solve. What bounds it here: the
// contraction reads the fold's hat rows once per group of rows (m x N, from
// L2 after the first pass) and at the main size is a few hundred MFLOP;
// the m dependent elimination steps are the larger part, as in foldsolve.
// Large m takes the same global-memory scratch as foldsolve.
//
// Types: f32 and f64, each accumulated and solved in its own type.
#include "gauss_jordan.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_eval_kernel(const T* __restrict__ h_rows, const T* __restrict__ h_te, const T* __restrict__ y,
                 const T* __restrict__ y_te, T* __restrict__ t_out, T* __restrict__ e_out,
                 T* __restrict__ scratch, int m, int n, int b, int bb) {
  const int k = blockIdx.x, tile = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int w = m + bb;
  T* row_buf = smem;
  T* fac = smem + w;
  T* aug = scratch != nullptr
               ? scratch + (static_cast<size_t>(k) * gridDim.y + tile) * m * w
               : smem + w + m;
  fill_identity_minus(aug, w, h_te + static_cast<size_t>(k) * m * m, m, T(0));
  const int col0 = tile * bb;
  const size_t fold = static_cast<size_t>(k) * m;
  for (int idx = threadIdx.x; idx < m * bb; idx += blockDim.x) {
    const int r = idx / bb, c = idx - r * bb;
    const int col = col0 + c;
    T val = T(0);
    if (col < b) {
      const T* h_r = h_rows + (fold + r) * n;
      T acc = T(0);
      for (int q = 0; q < n; ++q) acc += h_r[q] * y[static_cast<size_t>(q) * b + col];
      const size_t at = (fold + r) * b + col;
      val = y_te[at] - acc;
      e_out[at] = val;
    }
    aug[static_cast<size_t>(r) * w + m + c] = val;
  }
  __syncthreads();
  gauss_jordan_solve(aug, m, w, w, row_buf, fac);
  for (int idx = threadIdx.x; idx < m * bb; idx += blockDim.x) {
    const int r = idx / bb, c = idx - r * bb;
    if (col0 + c < b) t_out[(fold + r) * b + col0 + c] = aug[static_cast<size_t>(r) * w + m + c];
  }
}

template <typename T>
int fold_eval_launch(const void* h_rows, const void* h_te, const void* y, const void* y_te,
                     void* t, void* e, void* scratch, int k, int m, int n, int b, int bb,
                     void* stream) {
  if (k <= 0 || m <= 0 || n <= 0 || b <= 0 || bb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bufs = static_cast<size_t>(2 * m + bb);
  const size_t aug = scratch != nullptr ? 0 : static_cast<size_t>(m) * (m + bb);
  const size_t smem = (bufs + aug) * sizeof(T);
  cudaError_t err = set_smem(fold_eval_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(k, (b + bb - 1) / bb);
  fold_eval_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h_rows), static_cast<const T*>(h_te), static_cast<const T*>(y),
      static_cast<const T*>(y_te), static_cast<T*>(t), static_cast<T*>(e),
      static_cast<T*>(scratch), m, n, b, bb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// h_rows (k, m, n), h_te (k, m, m), y (n, b), y_te/t/e (k, m, b);
// scratch (k, tiles, m, m + bb) or null.
int fold_eval_f32(const void* h_rows, const void* h_te, const void* y, const void* y_te, void* t,
                  void* e, void* scratch, int k, int m, int n, int b, int bb, void* stream) {
  return repro::fold_eval_launch<float>(h_rows, h_te, y, y_te, t, e, scratch, k, m, n, b, bb,
                                        stream);
}
int fold_eval_f64(const void* h_rows, const void* h_te, const void* y, const void* y_te, void* t,
                  void* e, void* scratch, int k, int m, int n, int b, int bb, void* stream) {
  return repro::fold_eval_launch<double>(h_rows, h_te, y, y_te, t, e, scratch, k, m, n, b, bb,
                                         stream);
}

}  // extern "C"
