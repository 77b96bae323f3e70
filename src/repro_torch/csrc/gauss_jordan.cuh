// Pivot-free Gauss–Jordan solve of A X = E on the augmented block [A | E];
// the body shared by the foldsolve kernel and fold_eval's epilogue.
//
// Replaces gauss_jordan_solve (src/repro/kernels/foldsolve/foldsolve.py),
// which ran each elimination step as a masked rank-1 update of the whole
// (m, m + B) block on the TPU's vector unit. Here the block's threads share
// each step: they first copy the normalised pivot row and the factor column
// into shared buffers, synchronise, then apply the rank-1 update, and
// synchronise again. The copies are what keep threads from racing on the
// pivot row and column while other threads overwrite them.
//
// Like the reference, no pivot is searched: A = I − H_Te is SPD for a
// ridge-regularised plan, and the wrapper's residual-checked retry catches
// the λ → 0 edge. Columns left of the pivot are already unit vectors and
// the pivot column is never read again, so each step touches only the
// columns right of the pivot; the values of the solution columns are those
// of the full update. Products are rounded on their own (mul_rn), so each
// step rounds as the plain PyTorch version does.
#pragma once

#include "common.cuh"

namespace repro {

// aug: m rows of w = m + bb columns at row stride ld, in shared or global
// memory; row_buf (w) and fac (m) are shared scratch. Every thread of the
// block must call this. On return columns [m, w) hold X.
template <typename T>
__device__ void gauss_jordan_solve(T* aug, int m, int w, int ld, T* row_buf, T* fac) {
  for (int i = 0; i < m; ++i) {
    T* row_i = aug + static_cast<size_t>(i) * ld;
    const T pivot = row_i[i];
    for (int c = i + 1 + threadIdx.x; c < w; c += blockDim.x) row_buf[c] = row_i[c] / pivot;
    for (int r = threadIdx.x; r < m; r += blockDim.x)
      fac[r] = (r == i) ? T(0) : aug[static_cast<size_t>(r) * ld + i];
    __syncthreads();
    const int width = w - i - 1;
    const int count = m * width;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
      const int r = idx / width;
      const int c = i + 1 + (idx - r * width);
      T* at = aug + static_cast<size_t>(r) * ld + c;
      *at = (r == i) ? row_buf[c] : *at - mul_rn(fac[r], row_buf[c]);
    }
    __syncthreads();
  }
}

// Fill the A half of [A | E] with I − (H_Te − shift·I), as the reference's
// retry builds it; shift = 0 gives I − H_Te.
template <typename T>
__device__ void fill_identity_minus(T* aug, int ld, const T* __restrict__ h_te, int m, T shift) {
  for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
    const int r = idx / m, c = idx - r * m;
    const T hv = h_te[idx];
    aug[static_cast<size_t>(r) * ld + c] = (r == c) ? T(1) - (hv - shift) : T(0) - hv;
  }
}

}  // namespace repro
