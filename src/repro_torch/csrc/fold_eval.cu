// Fused fold evaluation ė_Te = (I − H_Te)⁻¹ (y_Te − H[te_k, :]·Y), which also
// writes ê_Te, for plans without train blocks (ridge CV, adjust_bias=False),
// with the residual-checked jitter retry in the same launch.
//
// Replaces the TPU kernel fold_eval_pallas
// (src/repro/kernels/fold_eval/fold_eval.py, body _fold_eval_kernel), which
// streamed each fold's hat rows over a sequential contraction grid axis into
// a VMEM accumulator and ran the fold solve as the epilogue of the last
// chunk, and the retry of its wrapper (src/repro/kernels/fold_eval/ops.py).
//
// Grid and clusters as foldsolve's: the blocks of one fold are one cluster,
// each takes tiles of bb columns of Y. Per tile, the contraction
// H[te_k, :]·Y_tile goes through shared memory a chunk of q at a time:
// the fold's hat rows are read with neighbouring lanes on neighbouring
// addresses (16-byte loads where the rows are 16-byte aligned, else one
// element, 8 or 4 bytes) and Y's tile transposed; then each warp sums four of its rows,
// its lanes split between columns and q, 16 bytes a read, and shuffles
// combine the lanes that split q. At the paths' B = 1 (ridge CV) this is a
// GEMV over (K·m, N) with the lanes along the hat row; at B = 28 (RSA
// contrasts) the lanes take a column each. ê goes to the ê output and, on
// the register route, to the shared staging that the owners of the
// block's right-hand half load it from; then the block runs
// gauss_jordan.cuh's solve, check and retry. Only the solve stage re-runs
// for a failing fold, against the ê this block wrote; the contraction is
// never repeated.
// What bounds it here: the contraction reads the fold's hat rows once
// (K·m·N elements, 2.5 MB at the main size, f32) and is a few MFLOP; the m
// dependent elimination steps are the larger part, as in foldsolve.
//
// Types: f32 and f64, each accumulated and solved in its own type.
#include "gauss_jordan.cuh"

namespace repro {

// The register route: 7 × 4 entries a thread, 12 warps (168 registers a
// thread), leaving room for the state the contraction keeps beside them.
constexpr RegShape kRegShape{7, 4, 12};

template <typename T, int VW>
struct VecOf {
  using type = T;
};
template <>
struct VecOf<float, 2> {
  using type = float2;
};
template <>
struct VecOf<float, 4> {
  using type = float4;
};
template <>
struct VecOf<double, 2> {
  using type = double2;
};

template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[VW]) {
  const typename VecOf<T, VW>::type v = *reinterpret_cast<const typename VecOf<T, VW>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int u = 0; u < VW; ++u) out[u] = e[u];
}

// ê[r, c] = y_te[r, c] − Σ_q h[r, q]·y[q, col0 + c] for the tile's bbe
// columns, in chunks of qc values of q. Each chunk is staged in shared
// memory first: the fold's hat rows (hs, m × qc, copied with GVW-element
// loads, neighbouring lanes on neighbouring addresses) and Y's tile
// transposed (ys, bbe rows padded to an odd number of 16-byte units, so
// that lanes on neighbouring columns meet no bank conflict). A warp then
// takes four of its rows at a time: its lanes split into lc lanes across
// the columns (the tile's width up to 32, a power of two) and 32 / lc
// across q, each reading 16 bytes of a hat row and of a Y column at a
// time; shuffles add the lanes that split q (five at B = 1, none from
// B = 17 on). A (row, column) sum is always kept by the same lane, in sums
// (row stride lds): the block's shared staging of ê, or the ê output; the
// last chunk turns it into ê and writes e_out (row stride b) and xs.
template <typename T, int GVW>
__device__ void contract_tile(const T* __restrict__ h, const T* __restrict__ y,
                              const T* __restrict__ y_te, T* e_out, T* xs, T* stage,
                              size_t stage_cap, int m, int n, int b, int bb, int col0, int bbe,
                              int tr) {
  constexpr int VW = 16 / static_cast<int>(sizeof(T));
  constexpr int RB = 4;
  const int lane = threadIdx.x, tid = threadIdx.y * 32 + lane, nthreads = 32 * tr;
  int lc = 1;
  while (lc < bbe && lc < 32) lc <<= 1;
  const int cl = lane & (lc - 1), qs = lane / lc, lq = 32 / lc;
  int qc = static_cast<int>((stage_cap - static_cast<size_t>(VW) * bbe) / (m + bbe)) & ~3;
  qc = min(qc, (n + 3) & ~3);
  const int ys_ld = qc + ((qc / VW) % 2 == 0 ? VW : 0);
  T* hs = stage;
  T* ys = stage + static_cast<size_t>(m) * qc;
  T* sums = xs != nullptr ? xs : e_out + col0;
  const int lds = xs != nullptr ? bb : b;
  for (int q0 = 0; q0 < n; q0 += qc) {
    const int qn = min(qc, n - q0);
    const int qv = (qn + VW - 1) / VW * VW;  // zero-padded to whole vectors
    __syncthreads();  // the previous chunk's readers are done
    // a warp to a hat row, the lanes on neighbouring vectors; Y's chunk by
    // element, four loads in flight before their stores
#pragma unroll 1
    for (int r = threadIdx.y; r < m; r += tr) {
      const T* src = h + static_cast<size_t>(r) * n + q0;
      T* dst = hs + static_cast<size_t>(r) * qc;
#pragma unroll 4
      for (int j = lane * GVW; j < qv; j += 32 * GVW) {
        T v[GVW];
        if (j < qn) {
          load_vec<T, GVW>(src + j, v);
        } else {
#pragma unroll
          for (int u = 0; u < GVW; ++u) v[u] = T(0);
        }
#pragma unroll
        for (int u = 0; u < GVW; ++u) dst[j + u] = v[u];
      }
    }
    constexpr int kBatchY = 4;
    const int ny = qv * bbe;
    for (int base = tid; base < ny; base += kBatchY * nthreads) {
      T v[kBatchY];
      int at[kBatchY];
#pragma unroll
      for (int u = 0; u < kBatchY; ++u) {
        const int idx = base + u * nthreads;
        const int j = idx / bbe, c = idx - j * bbe;
        at[u] = idx < ny ? c * ys_ld + j : -1;
        v[u] = idx < ny && j < qn ? y[static_cast<size_t>(q0 + j) * b + col0 + c] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatchY; ++u)
        if (at[u] >= 0) ys[at[u]] = v[u];
    }
    __syncthreads();
    for (int r0 = threadIdx.y; r0 < m; r0 += RB * tr) {
      int rr[RB];  // the warp's rows, clamped to the fold (the copies are dropped)
#pragma unroll
      for (int s = 0; s < RB; ++s) rr[s] = min(r0 + tr * s, m - 1);
      for (int c0 = 0; c0 < bbe; c0 += lc) {
        const int c = c0 + cl;
        const T* yc = ys + static_cast<size_t>(min(c, bbe - 1)) * ys_ld;
        T acc[RB];
#pragma unroll
        for (int s = 0; s < RB; ++s) acc[s] = T(0);
#pragma unroll 1
        for (int j = qs * VW; j < qv; j += lq * VW) {
          T yv[VW];
          load_vec<T, VW>(yc + j, yv);
#pragma unroll
          for (int s = 0; s < RB; ++s) {
            T hv[VW];
            load_vec<T, VW>(hs + static_cast<size_t>(rr[s]) * qc + j, hv);
#pragma unroll
            for (int u = 0; u < VW; ++u) acc[s] = fma(hv[u], yv[u], acc[s]);
          }
        }
#pragma unroll
        for (int s = 0; s < RB; ++s)
          for (int off = lc; off < 32; off <<= 1)
            acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
        if (qs != 0 || c >= bbe) continue;
#pragma unroll
        for (int s = 0; s < RB; ++s) {
          const int r = r0 + tr * s;
          if (r >= m) continue;
          T* at = sums + static_cast<size_t>(r) * lds + c;
          const T total = q0 == 0 ? acc[s] : *at + acc[s];
          if (q0 + qn < n) {
            *at = total;
            continue;
          }
          const size_t g = static_cast<size_t>(r) * b + col0 + c;
          const T val = y_te[g] - total;
          e_out[g] = val;
          if (xs != nullptr) xs[static_cast<size_t>(r) * bb + c] = val;
        }
      }
    }
  }
}

// The staging copy's loads: 16 bytes where every hat row is 16-byte
// aligned, else one element (8 bytes in f64, 4 in f32).
template <typename T>
__device__ __forceinline__ void contract(const T* h_k, const T* h_rows, const T* y,
                                         const T* y_te_k, T* e_k, const FoldTask<T>& f, int n,
                                         int col0, int bbe) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(h_rows);
  const int tr = blockDim.y;
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (n % kV == 0 && base % 16 == 0)
    contract_tile<T, kV>(h_k, y, y_te_k, e_k, f.xs, f.stage, f.stage_cap, f.m, n, f.b, f.bb,
                         col0, bbe, tr);
  else
    contract_tile<T, 1>(h_k, y, y_te_k, e_k, f.xs, f.stage, f.stage_cap, f.m, n, f.b, f.bb,
                        col0, bbe, tr);
}

template <typename T, typename E, int RS>
__global__ void __launch_bounds__(E::kMaxThreads)
fold_eval_kernel(const T* __restrict__ h_rows, const T* __restrict__ h_te,
                 const T* __restrict__ y, const T* __restrict__ y_te, T* __restrict__ t_out,
                 T* __restrict__ e_out, bool* __restrict__ bad, T* __restrict__ scratch, int m,
                 int n, int b, int bb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y;
  FoldTask<T> f = fold_task<T, E>(smem_raw, scratch, k, m, b, bb, true);
  const size_t fold = static_cast<size_t>(k) * m;
  T* e_k = e_out + fold * b;
  f.h = h_te + fold * m;
  f.e = e_k;
  f.out = t_out + fold * b;
  f.bad = bad;
  const T* h_k = h_rows + fold * n;
  const T* y_te_k = y_te + fold * b;
  solve_fold<T, E, RS>(f, [&](int col0, int bbe) {
    contract(h_k, h_rows, y, y_te_k, e_k, f, n, col0, bbe);
    __syncthreads();
    return f.xs != nullptr ? Source<T>{f.xs, bb} : Source<T>{e_k + col0, b};
  });
}

template <typename T, typename E, int RS>
cudaError_t fold_eval_route(const FoldShape& s, dim3 grid, const void* h_rows, const void* h_te,
                            const void* y, const void* y_te, void* t, void* e, void* bad,
                            void* scratch, int n, int b, cudaStream_t stream) {
  static std::atomic<uint32_t> opted{0};
  return launch_fold_cluster(fold_eval_kernel<T, E, RS>, opted, grid, dim3(32, s.tr),
                             s.smem_elems * sizeof(T), stream, static_cast<const T*>(h_rows),
                             static_cast<const T*>(h_te), static_cast<const T*>(y),
                             static_cast<const T*>(y_te), static_cast<T*>(t), static_cast<T*>(e),
                             static_cast<bool*>(bad), static_cast<T*>(scratch), s.m, n, b, s.bb);
}

template <typename T>
int fold_eval_launch(const void* h_rows, const void* h_te, const void* y, const void* y_te,
                     void* t, void* e, void* bad, void* scratch, int k, int m, int n, int b,
                     int bb, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FoldShape s;
  dim3 grid;
  cudaError_t err = fold_launch_shape(k, m, b, bb, scratch != nullptr, kRegShape, sizeof(T),
                                      true, &s, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.route == FoldRoute::kRegisters)
    err = fold_eval_route<T, RegEntries<T, 7, 4, 12>, 5>(
        s, grid, h_rows, h_te, y, y_te, t, e, bad, scratch, n, b, st);
  else
    err = fold_eval_route<T, MemEntries<T>, 4>(s, grid, h_rows, h_te, y, y_te, t, e, bad,
                                               scratch, n, b, st);
  return static_cast<int>(err);
}

}  // namespace repro

extern "C" {

// h_rows (k, m, n), h_te (k, m, m), y (n, b), y_te/t/e (k, m, b); bad (k)
// bool, or null to solve without the check and retry; scratch
// (k, min(tiles, 8), m, m + bb) or null.
int fold_eval_f32(const void* h_rows, const void* h_te, const void* y, const void* y_te, void* t,
                  void* e, void* bad, void* scratch, int k, int m, int n, int b, int bb,
                  void* stream) {
  return repro::fold_eval_launch<float>(h_rows, h_te, y, y_te, t, e, bad, scratch, k, m, n, b,
                                        bb, stream);
}
int fold_eval_f64(const void* h_rows, const void* h_te, const void* y, const void* y_te, void* t,
                  void* e, void* bad, void* scratch, int k, int m, int n, int b, int bb,
                  void* stream) {
  return repro::fold_eval_launch<double>(h_rows, h_te, y, y_te, t, e, bad, scratch, k, m, n, b,
                                         bb, stream);
}

}  // extern "C"
