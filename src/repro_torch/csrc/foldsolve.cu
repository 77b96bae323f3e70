// Batched fold solve ė_Te = (I − H_Te)⁻¹ ê_Te (Eq. 14) for every fold at once,
// with the residual-checked jitter retry in the same launch.
//
// Replaces the TPU kernel foldsolve_pallas
// (src/repro/kernels/foldsolve/foldsolve.py, body _foldsolve_kernel, solve
// gauss_jordan_solve), which put one fold's (m, m) system and (m, B)
// right-hand sides in VMEM per grid step, and the retry of its wrapper
// (src/repro/kernels/foldsolve/ops.py).
//
// Grid (tiles of the fold, up to 8; K), one thread block cluster per fold.
// Each block builds [I − H_Te | E_tile] for its tile of bb right-hand-side
// columns and runs gauss_jordan.cuh's solve, check and retry.
// What bounds it here: neither bytes nor operations but the m dependent
// steps, each a block-wide barrier; the design keeps one barrier and a few
// register operations per entry in each step (gauss_jordan.cuh), and
// narrower tiles spread a fold over more SMs at the cost of repeating the
// m × m half of the elimination in each. Large m (K = 2 gives m up to N/2) keeps the
// augmented block in shared memory, or in a global scratch of
// (K, cluster blocks, m, m + bb) once it passes 227 KB.
//
// Types: f32 and f64, each solved in its own type.
#include "gauss_jordan.cuh"

namespace repro {

// The register route: 5 × 5 entries a thread, 16 warps.
constexpr RegShape kRegShape{5, 5, 16};

template <typename T, typename E, int RS>
__global__ void __launch_bounds__(E::kMaxThreads)
foldsolve_kernel(const T* __restrict__ h_te, const T* __restrict__ e, T* __restrict__ out,
                 bool* __restrict__ bad, T* __restrict__ scratch, int m, int b, int bb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y;
  FoldTask<T> f = fold_task<T, E>(smem_raw, scratch, k, m, b, bb, false);
  f.h = h_te + static_cast<size_t>(k) * m * m;
  f.e = e + static_cast<size_t>(k) * m * b;
  f.out = out + static_cast<size_t>(k) * m * b;
  f.bad = bad;
  solve_fold<T, E, RS>(f, [&](int col0, int) { return Source<T>{f.e + col0, b}; });
}

template <typename T, typename E, int RS>
cudaError_t foldsolve_route(const FoldShape& s, dim3 grid, const void* h_te, const void* e,
                            void* out, void* bad, void* scratch, int b, cudaStream_t stream) {
  static std::atomic<uint32_t> opted{0};
  return launch_fold_cluster(foldsolve_kernel<T, E, RS>, opted, grid, dim3(32, s.tr),
                             s.smem_elems * sizeof(T), stream, static_cast<const T*>(h_te),
                             static_cast<const T*>(e), static_cast<T*>(out),
                             static_cast<bool*>(bad), static_cast<T*>(scratch), s.m, b, s.bb);
}

template <typename T>
int foldsolve_launch(const void* h_te, const void* e, void* out, void* bad, void* scratch, int k,
                     int m, int b, int bb, void* stream) {
  FoldShape s;
  dim3 grid;
  cudaError_t err = fold_launch_shape(k, m, b, bb, scratch != nullptr, kRegShape, sizeof(T),
                                      false, &s, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.route == FoldRoute::kRegisters)
    err = foldsolve_route<T, RegEntries<T, 5, 5, 16>, 5>(
        s, grid, h_te, e, out, bad, scratch, b, st);
  else
    err = foldsolve_route<T, MemEntries<T>, 4>(s, grid, h_te, e, out, bad, scratch, b, st);
  return static_cast<int>(err);
}

}  // namespace repro

extern "C" {

// h_te (k, m, m), e and out (k, m, b); bad (k) bool, or null to solve
// without the check and retry; scratch (k, min(tiles, 8), m, m + bb) or null.
int foldsolve_f32(const void* h_te, const void* e, void* out, void* bad, void* scratch, int k,
                  int m, int b, int bb, void* stream) {
  return repro::foldsolve_launch<float>(h_te, e, out, bad, scratch, k, m, b, bb, stream);
}
int foldsolve_f64(const void* h_te, const void* e, void* out, void* bad, void* scratch, int k,
                  int m, int b, int bb, void* stream) {
  return repro::foldsolve_launch<double>(h_te, e, out, bad, scratch, k, m, b, bb, stream);
}

}  // extern "C"
