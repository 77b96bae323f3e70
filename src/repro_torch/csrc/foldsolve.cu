// Batched fold solve ė_Te = (I − H_Te)⁻¹ ê_Te (Eq. 14) for every fold at once.
//
// Replaces the TPU kernel foldsolve_pallas
// (src/repro/kernels/foldsolve/foldsolve.py, body _foldsolve_kernel, solve
// gauss_jordan_solve), which put one fold's (m, m) system and (m, B)
// right-hand sides in VMEM per grid step.
//
// One block per (fold, tile of bb right-hand-side columns). The block builds
// [I − H_Te | E_tile] and runs the m elimination steps of gauss_jordan.cuh.
// What bounds it here: neither bytes nor operations but the m dependent
// steps, each a block-wide barrier; at the main size (K = 10, m = 78,
// B = 250) it is 40 blocks of 78 steps. Keeping the augmented block in
// shared memory makes each step's rank-1 update a shared-memory pass. For
// large m (K = 2 gives m up to N/2) the block no longer fits in 227 KB;
// the wrapper then passes a global-memory scratch of (K, tiles, m, m + bb)
// and the same kernel runs its steps there (mostly out of L2).
//
// The residual-checked jitter retry is the same kernel launched again with
// the per-fold shift and the per-fold `bad` flags: blocks of healthy folds
// return at once and leave the first solve's output in place, so the retry
// needs no host synchronisation.
//
// Types: f32 and f64, each solved in its own type.
#include "gauss_jordan.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
foldsolve_kernel(const T* __restrict__ h_te, const T* __restrict__ e, const T* __restrict__ shift,
                 const bool* __restrict__ bad, T* __restrict__ out, T* __restrict__ scratch,
                 int m, int b, int bb) {
  const int k = blockIdx.x, tile = blockIdx.y;
  if (bad != nullptr && !bad[k]) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int w = m + bb;
  T* row_buf = smem;
  T* fac = smem + w;
  T* aug = scratch != nullptr
               ? scratch + (static_cast<size_t>(k) * gridDim.y + tile) * m * w
               : smem + w + m;
  fill_identity_minus(aug, w, h_te + static_cast<size_t>(k) * m * m, m,
                      shift != nullptr ? shift[k] : T(0));
  const int col0 = tile * bb;
  const T* e_k = e + static_cast<size_t>(k) * m * b;
  for (int idx = threadIdx.x; idx < m * bb; idx += blockDim.x) {
    const int r = idx / bb, c = idx - r * bb;
    aug[static_cast<size_t>(r) * w + m + c] =
        (col0 + c < b) ? e_k[static_cast<size_t>(r) * b + col0 + c] : T(0);
  }
  __syncthreads();
  gauss_jordan_solve(aug, m, w, w, row_buf, fac);
  T* out_k = out + static_cast<size_t>(k) * m * b;
  for (int idx = threadIdx.x; idx < m * bb; idx += blockDim.x) {
    const int r = idx / bb, c = idx - r * bb;
    if (col0 + c < b) out_k[static_cast<size_t>(r) * b + col0 + c] = aug[static_cast<size_t>(r) * w + m + c];
  }
}

template <typename T>
int foldsolve_launch(const void* h_te, const void* e, const void* shift, const void* bad,
                     void* out, void* scratch, int k, int m, int b, int bb, void* stream) {
  if (k <= 0 || m <= 0 || b <= 0 || bb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bufs = static_cast<size_t>(2 * m + bb);
  const size_t aug = scratch != nullptr ? 0 : static_cast<size_t>(m) * (m + bb);
  const size_t smem = (bufs + aug) * sizeof(T);
  cudaError_t err = set_smem(foldsolve_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(k, (b + bb - 1) / bb);
  foldsolve_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h_te), static_cast<const T*>(e), static_cast<const T*>(shift),
      static_cast<const bool*>(bad), static_cast<T*>(out), static_cast<T*>(scratch), m, b, bb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// h_te (k, m, m), e and out (k, m, b); shift (k) and bad (k) are null on the
// first solve and set on the retry; scratch (k, tiles, m, m + bb) or null.
int foldsolve_f32(const void* h_te, const void* e, const void* shift, const void* bad, void* out,
                  void* scratch, int k, int m, int b, int bb, void* stream) {
  return repro::foldsolve_launch<float>(h_te, e, shift, bad, out, scratch, k, m, b, bb, stream);
}
int foldsolve_f64(const void* h_te, const void* e, const void* shift, const void* bad, void* out,
                  void* scratch, int k, int m, int b, int bb, void* stream) {
  return repro::foldsolve_launch<double>(h_te, e, shift, bad, out, scratch, k, m, b, bb, stream);
}

}  // extern "C"
