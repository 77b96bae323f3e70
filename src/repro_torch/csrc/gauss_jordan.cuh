// Pivot-free Gauss–Jordan solve of (I − H_Te[k]) X = E[k] for one fold, with
// the reference's residual-checked jitter retry, inside one launch; the core
// shared by the foldsolve kernel and fold_eval's solve stage.
//
// Replaces gauss_jordan_solve (src/repro/kernels/foldsolve/foldsolve.py),
// which ran each elimination step as a masked rank-1 update of the whole
// (m, m + B) block on the TPU's vector unit, and the wrapper's retry
// (src/repro/kernels/foldsolve/ops.py), which checked the residual in the
// same jitted program and re-entered the kernel under lax.cond.
//
// What bounds it here: the m dependent steps, each a block-wide barrier and
// a rank-1 update of the block's [A | E_tile]. So each step costs one
// __syncthreads and, per entry, one multiply and one subtract on a value
// already in a register:
//
// * Ownership. The block is 32 × TR threads. Thread (tx, ty) owns the
//   entries of rows ty + TR·s and columns tx + 32·j, fixed for the whole
//   solve, so no index is divided inside the step loop. On the register
//   route the entries live in registers (foldsolve: 5 × 5 a thread, TR ≤ 16,
//   so m ≤ 80 and m + bb ≤ 160; fold_eval: 7 × 4, TR ≤ 12, m ≤ 84 and
//   m + bb ≤ 128); above that they stay in a fixed slot of the augmented
//   block in shared memory, or in a global scratch once that passes
//   227 KB (K = 2 at N = 787: m = 393).
// * Broadcast. In step i the warp holding pivot row i takes the pivot from
//   its owner by a shuffle and writes the normalised row, and the lanes
//   holding column i write the factor column; both buffers alternate with
//   the step's parity, so one barrier separates a step's writes from its
//   reads and the next step's writes.
// * Columns ≤ i keep their values: the memory routes skip the column
//   slots wholly left of the pivot; the register route updates every slot
//   (no per-entry branch) with a normalised row that is zero there. The
//   solution columns are those of the full update.
// * Arithmetic: a true division row_i[c] / pivot and a − mul_rn(f, r) with no
//   FMA contraction, so each step rounds as the plain PyTorch version
//   kernels/foldsolve/ref.py::gauss_jordan_solve does, entry for entry.
//
// No pivot is searched: A = I − H_Te is SPD for a ridge-regularised plan.
// The λ → 0 edge is caught in the same launch: with the check on, each
// block computes ‖(I − H_Te)·ė − ê‖_∞ of its columns in the kernel's type
// (H_Te re-read from L2), max |ê| and whether anything is non-finite; a
// fold fails if any of its columns does (≤ √ε·(1 + ‖ê‖_∞) is the pass
// mark), and a failing fold is solved again, whole, against
// I − (H_Te − ε_k I) with ε_k = √ε·(1 + ‖I − H_Te‖_max). A healthy fold keeps
// its first solve bit for bit.
//
// The fold's decision. Its column tiles are the blocks of one thread block
// cluster (up to 8, the portable size; a block walks its tiles rank,
// rank + 8, … beyond that), and the blocks agree by exchanging (max |r|,
// max |ê|, non-finite) through distributed shared memory between two
// cluster barriers. The other design, one block walking all of its fold's
// tiles, runs its tiles in turn: in chip_smoke.py's tile sweep on the H100
// (PERF.md §6), 16-column tiles, which make a block walk two, take about
// twice the time of 32-column ones, and the whole B in one block about
// four times that of four 64-column blocks.
#pragma once

#include <cooperative_groups.h>

#include <atomic>
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace repro {

namespace cg = cooperative_groups;

// The register route's shape, a kernel's choice: row slots R and column
// slots C a thread holds, and row groups G (warps) of its block. It takes
// m ≤ R·G and m + bb ≤ 32·C; foldsolve holds 5 × 5 with 16 warps,
// fold_eval, which keeps its contraction's state beside the entries, 7 × 4
// with 12 (168 registers a thread).
struct RegShape {
  int rows, cols, groups;
};
// The memory routes: one row group per warp, up to 16 warps.
constexpr int kMemThreads = 512;
constexpr int kMaxClusterBlocks = 8;
// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;
// Reduction scratch, in elements: three per warp, and the block's own
// (max |r|, max |ê|, non-finite, decision) read by the cluster's blocks.
constexpr int kRedElems = 3 * 32 + 4;

enum class FoldRoute { kRegisters, kShared, kGlobal };

// Dynamic shared memory of a block, in elements from its start: the two
// normalised rows (wpad each), the two factor columns (mpad each), the
// reduction scratch, then the register route's (m, bb) staging of ê and ė
// or the shared route's (m, w) augmented block; fold_eval adds a staging
// area for chunks of its contraction's operands (96 KB on the register
// route, the rest of the 227 KB on the global route; the shared route
// lends it the augmented block, which is free until the solve loads it).
// Regions start 4-element aligned.
constexpr size_t kStageBytes = 96 * 1024;

struct FoldLayout {
  int wpad, mpad;
  size_t fac, red, rest, stage, stage_cap, total;
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

__host__ __device__ inline FoldLayout fold_layout(FoldRoute route, int m, int bb, int tr,
                                                  RegShape reg_shape, size_t itemsize,
                                                  bool stage) {
  FoldLayout l;
  const int w = m + bb;
  const bool reg = route == FoldRoute::kRegisters;
  l.wpad = reg ? 32 * reg_shape.cols : w;
  l.mpad = reg ? tr * reg_shape.rows : m;
  l.fac = round4(2 * static_cast<size_t>(l.wpad));
  l.red = l.fac + round4(2 * static_cast<size_t>(l.mpad));
  l.rest = l.red + round4(kRedElems);
  const size_t rest_len = reg                           ? static_cast<size_t>(m) * bb
                          : route == FoldRoute::kShared ? static_cast<size_t>(m) * w
                                                        : 0;
  l.stage = l.rest + round4(rest_len);
  l.stage_cap = 0;
  if (stage && route == FoldRoute::kShared) {
    l.stage = l.rest;
    l.stage_cap = rest_len;
  } else if (stage && route == FoldRoute::kRegisters) {
    l.stage_cap = kStageBytes / itemsize;
  } else if (stage) {  // the global route: the rest of the 227 KB
    l.stage_cap = (kMaxSmemBytes / itemsize - l.stage) & ~static_cast<size_t>(3);
  }
  l.total = route == FoldRoute::kShared ? l.rest + round4(rest_len) : l.stage + l.stage_cap;
  return l;
}

// The launch shape of a fold solve, decided on the host: the route (the
// global scratch is the wrapper's choice), the block's row groups, and its
// shared memory in elements.
struct FoldShape {
  int m, w, bb, tr;
  FoldRoute route;
  size_t smem_elems;
};

inline FoldShape fold_shape(int m, int bb, bool global_scratch, RegShape reg_shape,
                            size_t itemsize, bool stage) {
  FoldShape s{m, m + bb, bb, m < 16 ? m : 16, FoldRoute::kShared, 0};
  if (global_scratch) {
    s.route = FoldRoute::kGlobal;
  } else if (m <= reg_shape.rows * reg_shape.groups && s.w <= 32 * reg_shape.cols) {
    const int rows_per_thread = (m + reg_shape.groups - 1) / reg_shape.groups;
    s.route = FoldRoute::kRegisters;
    s.tr = (m + rows_per_thread - 1) / rows_per_thread;
  }
  s.smem_elems = fold_layout(s.route, m, bb, s.tr, reg_shape, itemsize, stage).total;
  return s;
}

// √ε of the type: the residual check's pass mark and the jitter's scale, as
// the plain version's float(finfo(dtype).eps) ** 0.5 rounded to the type.
template <typename T>
__device__ __forceinline__ T residual_tol();
template <>
__device__ __forceinline__ float residual_tol<float>() {
  return static_cast<float>(sqrt(static_cast<double>(FLT_EPSILON)));
}
template <>
__device__ __forceinline__ double residual_tol<double>() {
  return sqrt(DBL_EPSILON);
}

template <typename T>
struct Source {
  const T* p;  // row 0, column 0 of the tile's right-hand sides
  int ld;
};

// Entry (r, c) of [I − (H_Te − shift·I) | E_tile] (shift = 0 gives I − H_Te;
// columns past the tile's bbe are zero).
template <typename T>
__device__ __forceinline__ T load_entry(const T* __restrict__ h, T shift, Source<T> src, int r,
                                        int c, int m, int bbe) {
  if (c < m) {
    const T hv = h[static_cast<size_t>(r) * m + c];
    return (r == c) ? T(1) - (hv - shift) : T(0) - hv;
  }
  return c - m < bbe ? src.p[static_cast<size_t>(r) * src.ld + (c - m)] : T(0);
}

// Solution entry (r, c) of the tile to out (row stride ldo) and, where the
// residual check reads it, to the shared staging xs (row stride ldx).
template <typename T>
__device__ __forceinline__ void store_entry(T* __restrict__ out, int ldo, T* xs, int ldx, int r,
                                            int c, T v) {
  out[static_cast<size_t>(r) * ldo + c] = v;
  if (xs != nullptr) xs[static_cast<size_t>(r) * ldx + c] = v;
}

// Entries of [A | E_tile] held in registers: v[s][j] is row ty + TR·s,
// column tx + 32·j. Every slot is updated, the block's edge included: the
// padding rows and columns start at zero and stay zero, the row and factor
// buffers are padded to match, and so a step has no per-entry branch and
// every index is a constant once the loops unroll. Columns ≤ i meet a zero
// in the normalised row and keep their values.
template <typename T, int R, int C, int G>
struct RegEntries {
  static constexpr int kMaxThreads = 32 * G;
  static constexpr bool kInRegisters = true;
  static constexpr int kRows = R, kCols = C, kGroups = G;
  T v[R][C];

  __device__ __forceinline__ RegEntries(T*, int, int, int) {}

  __device__ __forceinline__ void load(const T* __restrict__ h, T shift, Source<T> src, int m,
                                       int w, int bbe, int tr) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = threadIdx.y + tr * s;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = threadIdx.x + 32 * j;
        v[s][j] = r < m && c < w ? load_entry(h, shift, src, r, c, m, bbe) : T(0);
      }
    }
  }
  __device__ __forceinline__ void store(T* __restrict__ out, int ldo, T* xs, int ldx, int m,
                                        int bbe, int tr) const {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = threadIdx.y + tr * s;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = threadIdx.x + 32 * j - m;
        if (r < m && c >= 0 && c < bbe) store_entry(out, ldo, xs, ldx, r, c, v[s][j]);
      }
    }
  }
  // Step i, by the warp holding pivot row i in slot s0: the pivot from its
  // owner by a shuffle, the normalised row (zero left of i) into rb.
  __device__ __forceinline__ void pivot_row(int i, int s0, T* rb) const {
    const int j0 = i >> 5;
    T own = T(0);
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int j = 0; j < C; ++j) own = (s == s0 && j == j0) ? v[s][j] : own;
    const T pivot = __shfl_sync(0xffffffffu, own, i & 31);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = threadIdx.x + 32 * j;
      T row = v[0][j];
#pragma unroll
      for (int s = 1; s < R; ++s) row = (s == s0) ? v[s][j] : row;
      T q = T(0);
      if (c > i) q = row / pivot;
      rb[c] = q;
    }
  }
  // Step i, by lane i mod 32 of every warp: column i of its rows into fc.
  __device__ __forceinline__ void factor_col(int i, T* fc, int tr) const {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = threadIdx.y + tr * s;
      T col = v[s][0];
#pragma unroll
      for (int j = 1; j < C; ++j) col = (j == (i >> 5)) ? v[s][j] : col;
      fc[r] = (r == i) ? T(0) : col;
    }
  }
  __device__ __forceinline__ void update(int i, const T* rb, const T* fc, int tr) {
    T f[R];
#pragma unroll
    for (int s = 0; s < R; ++s) f[s] = fc[threadIdx.y + tr * s];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const T rn = rb[threadIdx.x + 32 * j];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const bool pivot_row = static_cast<int>(threadIdx.y) + tr * s == i;
        v[s][j] = pivot_row ? rn : v[s][j] - mul_rn(f[s], rn);
      }
    }
  }
};

// The same ownership over an (m, w) augmented block in shared or global
// memory, each thread touching only its own slots; slots wholly left of the
// pivot are skipped.
template <typename T>
struct MemEntries {
  static constexpr int kMaxThreads = kMemThreads;
  static constexpr bool kInRegisters = false;
  static constexpr int kRows = 0, kCols = 0, kGroups = 0;
  T* base;
  size_t row_step;
  int rows, cols;

  __device__ __forceinline__ MemEntries(T* aug, int m, int w, int tr)
      : base(aug + static_cast<size_t>(threadIdx.y) * w + threadIdx.x),
        row_step(static_cast<size_t>(tr) * w),
        rows((m - static_cast<int>(threadIdx.y) + tr - 1) / tr),
        cols((w - static_cast<int>(threadIdx.x) + 31) / 32) {}
  __device__ __forceinline__ T& at(int s, int j) const { return base[s * row_step + 32 * j]; }

  __device__ __forceinline__ void load(const T* __restrict__ h, T shift, Source<T> src, int m,
                                       int, int bbe, int tr) const {
    for (int s = 0; s < rows; ++s)
      for (int j = 0; j < cols; ++j)
        at(s, j) = load_entry(h, shift, src, threadIdx.y + tr * s, threadIdx.x + 32 * j, m, bbe);
  }
  __device__ __forceinline__ void store(T* __restrict__ out, int ldo, T* xs, int ldx, int m,
                                        int bbe, int tr) const {
    for (int s = 0; s < rows; ++s)
      for (int j = 0; j < cols; ++j) {
        const int c = threadIdx.x + 32 * j - m;
        if (c >= 0 && c < bbe) store_entry(out, ldo, xs, ldx, threadIdx.y + tr * s, c, at(s, j));
      }
  }
  __device__ __forceinline__ void pivot_row(int i, int s0, T* rb) const {
    const int lane = i & 31;
    const T own = (static_cast<int>(threadIdx.x) == lane) ? at(s0, i >> 5) : T(0);
    const T pivot = __shfl_sync(0xffffffffu, own, lane);
    for (int j = (i + 1) >> 5; j < cols; ++j) {
      const int c = threadIdx.x + 32 * j;
      rb[c] = c > i ? at(s0, j) / pivot : T(0);
    }
  }
  __device__ __forceinline__ void factor_col(int i, T* fc, int tr) const {
    for (int s = 0; s < rows; ++s) {
      const int r = threadIdx.y + tr * s;
      fc[r] = (r == i) ? T(0) : at(s, i >> 5);
    }
  }
  __device__ __forceinline__ void update(int i, const T* rb, const T* fc, int tr) const {
    for (int j = (i + 1) >> 5; j < cols; ++j) {
      const T rn = rb[threadIdx.x + 32 * j];
      for (int s = 0; s < rows; ++s) {
        const int r = threadIdx.y + tr * s;
        T& a = at(s, j);
        a = (r == i) ? rn : a - mul_rn(fc[r], rn);
      }
    }
  }
};

// The m elimination steps. rowbuf holds two normalised rows of `wpad` and
// fac two factor columns of `mpad`, used by step parity: one barrier a step.
template <typename T, typename E>
__device__ __forceinline__ void eliminate(E& ent, T* rowbuf, int wpad, T* fac, int mpad, int m,
                                          int tr) {
  int pivot_warp = 0, pivot_slot = 0;  // row i = pivot_warp + tr·pivot_slot
  for (int i = 0; i < m; ++i) {
    T* rb = rowbuf + (i & 1) * wpad;
    T* fc = fac + (i & 1) * mpad;
    if (static_cast<int>(threadIdx.y) == pivot_warp) ent.pivot_row(i, pivot_slot, rb);
    if (static_cast<int>(threadIdx.x) == (i & 31)) ent.factor_col(i, fc, tr);
    __syncthreads();
    ent.update(i, rb, fc, tr);
    if (++pivot_warp == tr) {
      pivot_warp = 0;
      ++pivot_slot;
    }
  }
}

template <typename T>
struct FoldStats {
  T max_r, max_e;
  int nonfinite;
};

// The tile's part of the check: r = (I − H_Te)·x − e over its bbe columns,
// a thread computing RS rows × 2 columns at once (independent sums, row and
// column indices clamped to the tile so the loop has no branch; the clamped
// copies are dropped), I − H_Te from h re-read from L2. x and e may have
// been written earlier in the launch (fold_eval's ê), so neither is read
// through the non-coherent path.
template <typename T, int RS>
__device__ __forceinline__ void residual_tile(const T* __restrict__ h, const T* x, int ldx,
                                              const T* e, int lde, int m, int bbe, int tr,
                                              FoldStats<T>& st) {
  constexpr int CS = 2;
  for (int r0 = threadIdx.y; r0 < m; r0 += RS * tr) {
    int rr[RS];
#pragma unroll
    for (int s = 0; s < RS; ++s) rr[s] = min(r0 + tr * s, m - 1);
    for (int c0 = threadIdx.x; c0 < bbe; c0 += CS * 32) {
      int cc[CS];
#pragma unroll
      for (int j = 0; j < CS; ++j) cc[j] = min(c0 + 32 * j, bbe - 1);
      T acc[RS][CS];
#pragma unroll
      for (int s = 0; s < RS; ++s)
#pragma unroll
        for (int j = 0; j < CS; ++j) acc[s][j] = T(0);
#pragma unroll 2
      for (int q = 0; q < m; ++q) {
        T xv[CS];
#pragma unroll
        for (int j = 0; j < CS; ++j) xv[j] = x[static_cast<size_t>(q) * ldx + cc[j]];
#pragma unroll
        for (int s = 0; s < RS; ++s) {
          const T a = (rr[s] == q ? T(1) : T(0)) - h[static_cast<size_t>(rr[s]) * m + q];
#pragma unroll
          for (int j = 0; j < CS; ++j) acc[s][j] = fma(a, xv[j], acc[s][j]);
        }
      }
#pragma unroll
      for (int s = 0; s < RS; ++s) {
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          if (r0 + tr * s >= m || c0 + 32 * j >= bbe) continue;
          const T ev = e[static_cast<size_t>(rr[s]) * lde + cc[j]];
          const T xr = x[static_cast<size_t>(rr[s]) * ldx + cc[j]];
          const T res = acc[s][j] - ev;
          st.max_r = fmax(st.max_r, fabs(res));
          st.max_e = fmax(st.max_e, fabs(ev));
          st.nonfinite |= !(isfinite(res) && isfinite(ev) && isfinite(xr));
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Whether the fold failed its check, the same answer in every block of the
// cluster; the cluster's first block writes it to bad[k]. Every thread of
// every block of the cluster calls this.
template <typename T>
__device__ bool fold_fails(FoldStats<T> st, T* red, bool* bad, int k) {
  st.max_r = warp_max(st.max_r);
  st.max_e = warp_max(st.max_e);
  st.nonfinite = __any_sync(0xffffffffu, st.nonfinite);
  const int lane = threadIdx.x, warp = threadIdx.y;
  T* mine = red + 3 * 32;
  if (lane == 0) {
    red[3 * warp] = st.max_r;
    red[3 * warp + 1] = st.max_e;
    red[3 * warp + 2] = st.nonfinite ? T(1) : T(0);
  }
  __syncthreads();
  if (warp == 0 && lane == 0) {
    T r = T(0), e = T(0), nf = T(0);
    for (int i = 0; i < static_cast<int>(blockDim.y); ++i) {
      r = fmax(r, red[3 * i]);
      e = fmax(e, red[3 * i + 1]);
      nf = fmax(nf, red[3 * i + 2]);
    }
    mine[0] = r;
    mine[1] = e;
    mine[2] = nf;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (warp == 0 && lane == 0) {
    T r = T(0), e = T(0), nf = T(0);
    for (unsigned rank = 0; rank < cluster.num_blocks(); ++rank) {
      const T* peer = cluster.map_shared_rank(mine, rank);
      r = fmax(r, peer[0]);
      e = fmax(e, peer[1]);
      nf = fmax(nf, peer[2]);
    }
    const bool failed = nf != T(0) || !(r <= residual_tol<T>() * (T(1) + e));
    mine[3] = failed ? T(1) : T(0);
    if (cluster.block_rank() == 0) bad[k] = failed;
  }
  cluster.sync();  // also keeps every block's `mine` alive until its peers have read it
  return mine[3] != T(0);
}

// ε_k = √ε·(1 + ‖I − H_Te‖_max), as the plain fold_jitter rounds it.
template <typename T>
__device__ T fold_shift(const T* __restrict__ h, int m, int tr, T* red) {
  T mx = T(0);
  for (int r = threadIdx.y; r < m; r += tr)
    for (int c = threadIdx.x; c < m; c += 32)
      mx = fmax(mx, fabs((r == c ? T(1) : T(0)) - h[static_cast<size_t>(r) * m + c]));
  mx = warp_max(mx);
  if (threadIdx.x == 0) red[threadIdx.y] = mx;
  __syncthreads();
  for (int i = 0; i < static_cast<int>(blockDim.y); ++i) mx = fmax(mx, red[i]);
  return residual_tol<T>() * (T(1) + mx);
}

// One fold's work for this block: its column tiles blockIdx.x,
// blockIdx.x + gridDim.x, …; h is H_Te[k] (m, m), e the fold's (m, b)
// right-hand sides as the retry and the check read them, out its solution.
template <typename T>
struct FoldTask {
  const T* h;
  const T* e;
  T* out;
  bool* bad;      // (K,) flags; null: no check, no retry
  T* xs;          // register route: shared (m, bb) staging; else null
  T* aug;         // memory routes: (m, m + bb) in shared or global memory
  T* stage;       // fold_eval's staging of Y, stage_cap elements
  size_t stage_cap;
  T* rowbuf;
  T* fac;
  T* red;
  int wpad, mpad, k, m, b, bb;
};

// FirstSource(col0, bbe) gives the first solve's right-hand sides of a tile
// (fold_eval computes them there); every thread of the block calls it.
template <typename T, typename E, int RS, typename FirstSource>
__device__ __forceinline__ void solve_fold(const FoldTask<T>& f, FirstSource first_source) {
  const int w = f.m + f.bb, tr = blockDim.y;
  const int tiles = (f.b + f.bb - 1) / f.bb;
  E ent(f.aug, f.m, w, tr);
  T shift = T(0);
  for (int pass = 0; pass < 2; ++pass) {
    const bool check = pass == 0 && f.bad != nullptr;
    FoldStats<T> st{T(0), T(0), 0};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int col0 = t * f.bb;
      const int bbe = min(f.bb, f.b - col0);
      __syncthreads();  // the previous tile's readers of the buffers are done
      const Source<T> src = pass == 0 ? first_source(col0, bbe) : Source<T>{f.e + col0, f.b};
      ent.load(f.h, shift, src, f.m, w, bbe, tr);
      eliminate(ent, f.rowbuf, f.wpad, f.fac, f.mpad, f.m, tr);
      ent.store(f.out + col0, f.b, check ? f.xs : nullptr, f.bb, f.m, bbe, tr);
      if (check) {
        __syncthreads();
        const T* x = f.xs != nullptr ? f.xs : f.aug + f.m;
        residual_tile<T, RS>(f.h, x, f.xs != nullptr ? f.bb : w, f.e + col0, f.b, f.m, bbe, tr,
                             st);
      }
    }
    if (!check || !fold_fails(st, f.red, f.bad, f.k)) return;
    shift = fold_shift(f.h, f.m, tr, f.red);
  }
}

// Carve the block's dynamic shared memory (fold_layout) and place the
// augmented block.
template <typename T, typename E>
__device__ __forceinline__ FoldTask<T> fold_task(unsigned char* smem_raw, T* scratch, int k, int m,
                                                 int b, int bb, bool stage) {
  T* smem = reinterpret_cast<T*>(smem_raw);
  const FoldRoute route = E::kInRegisters   ? FoldRoute::kRegisters
                          : scratch != nullptr ? FoldRoute::kGlobal
                                               : FoldRoute::kShared;
  const FoldLayout l = fold_layout(route, m, bb, blockDim.y,
                                   RegShape{E::kRows, E::kCols, E::kGroups}, sizeof(T), stage);
  FoldTask<T> f{};
  f.rowbuf = smem;
  f.fac = smem + l.fac;
  f.red = smem + l.red;
  f.wpad = l.wpad;
  f.mpad = l.mpad;
  if (route == FoldRoute::kRegisters) f.xs = smem + l.rest;
  if (route == FoldRoute::kShared) f.aug = smem + l.rest;
  if (route == FoldRoute::kGlobal)
    f.aug = scratch + (static_cast<size_t>(k) * gridDim.x + blockIdx.x) * m * (m + bb);
  f.stage = smem + l.stage;
  f.stage_cap = l.stage_cap;
  f.k = k;
  f.m = m;
  f.b = b;
  f.bb = bb;
  return f;
}

// Launch a fold kernel over grid (cluster blocks, K): the cluster is the
// fold's row of blocks. The kernel's shared-memory ceiling is raised once.
template <typename... Params, typename... Args>
inline cudaError_t launch_fold_cluster(void (*kernel)(Params...), std::atomic<uint32_t>& opted,
                                       dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                                       Args... args) {
  cudaError_t err = set_smem_once(opted, kernel, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Check the sizes common to both kernels and shape the launch.
inline cudaError_t fold_launch_shape(int k, int m, int b, int bb, bool global_scratch,
                                     RegShape reg_shape, size_t itemsize, bool stage,
                                     FoldShape* shape, dim3* grid) {
  if (k <= 0 || k > 65535 || m <= 0 || b <= 0 || bb <= 0) return cudaErrorInvalidValue;
  *shape = fold_shape(m, bb, global_scratch, reg_shape, itemsize, stage);
  if (shape->smem_elems * itemsize > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int tiles = (b + bb - 1) / bb;
  *grid = dim3(tiles < kMaxClusterBlocks ? tiles : kMaxClusterBlocks, k);
  return cudaSuccess;
}

}  // namespace repro
