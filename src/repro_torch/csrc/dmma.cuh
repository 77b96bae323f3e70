// Hopper's f64 tensor-core path (DMMA) for the f64 routes of gram and
// hat_apply: the f64 mma.sync product, an 8-byte cp.async, and the staging
// of k-major rows that both kernels share. Inline PTX only; no library.
//
// f64 has no wgmma and no ldmatrix: a warp issues mma.sync m16n8k8 .f64
// (sm_90), and each thread reads its own fragments from shared memory. The
// contraction index is permuted inside each k8 step: a fragment's k = q and
// k = q + 4 are read from columns 2q and 2q + 1, for both operands alike,
// so the same products are summed and a thread's two values of a k-major
// row are one 16-byte load. Staged k-major rows hold kDmmaK = 16 columns
// padded to kDmmaLd = 24 doubles (192 bytes): the eight threads of a
// quarter warp then read eight different 16-byte bank groups.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {

constexpr int kDmmaK = 16;    // contraction columns per chunk: two k8 steps
constexpr int kDmmaLd = 24;   // doubles per staged k-major row: 16 + 8 of padding

namespace dmma {

// D (16 x 8) += A (16 x 8) · B (8 x 8), f64 on the tensor cores. With
// g = lane / 4 and q = lane % 4, a thread holds a = {A[g][q], A[g + 8][q],
// A[g][q + 4], A[g + 8][q + 4]}, b = {B[q][g], B[q + 4][g]} and
// d = {D[g][2q], D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1]}.
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Asynchronous 8-byte copy global → shared: src_bytes = 8 reads the value,
// 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Copy columns [kc, kc + kDmmaK) of rows [r0, r0 + kRows) of a row-major
// (rows, ld) f64 matrix into `dst` (kRows staged rows of kDmmaLd), shared by
// kThreadsT threads; zeros past `rows` and at columns >= k_end. `vec`: every
// row starts 16-byte aligned and ld is even (16-byte pieces; a piece is then
// whole or past k_end, as kc and k_end are even), else 8-byte pieces. A
// thread walks its rows with one pointer (not unrolled): addresses held
// across the chunk loop would take the registers the accumulators need.
template <int kRows, int kThreadsT>
__device__ __forceinline__ void stage_rows(double* dst, const double* __restrict__ src,
                                           long long ld, int rows, int r0, int kc, int k_end,
                                           bool vec, int tid) {
  const int per_row = vec ? 8 : 16;            // pieces a row
  const int step = kThreadsT / per_row;        // rows between a thread's pieces
  const int r = tid / per_row, col = (tid % per_row) * (vec ? 2 : 1);
  const bool col_ok = kc + col < k_end;
  const double* from = src + (r0 + r) * ld + kc + col;
  uint32_t to = sm90::smem_u32(dst + r * kDmmaLd + col);
#pragma unroll 1
  for (int rr = r; rr < kRows; rr += step, from += step * ld, to += step * kDmmaLd * 8) {
    const bool ok = col_ok && r0 + rr < rows;
    if (vec)
      sm90::cp_async16(to, ok ? from : src, ok ? 16 : 0);
    else
      cp_async8(to, ok ? from : src, ok ? 8 : 0);
  }
}

// A's fragments of one k8 step (kk) for rows `row` .. row + 15 of a staged
// k-major tile, with the permuted contraction index (columns 2q, 2q + 1).
__device__ __forceinline__ void load_a(double (&a)[4], const double* tile, int row, int kk,
                                       int g, int q) {
  const double2 lo = *reinterpret_cast<const double2*>(tile + (row + g) * kDmmaLd + 8 * kk + 2 * q);
  const double2 hi =
      *reinterpret_cast<const double2*>(tile + (row + g + 8) * kDmmaLd + 8 * kk + 2 * q);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

}  // namespace dmma

}  // namespace repro
