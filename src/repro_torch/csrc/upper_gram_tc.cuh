// Split-contraction partials of the upper 128 x 128 tiles of G = X Xᵀ on the
// tensor cores (wgmma, sm_90a); gram's first pass for f32 and bf16 input.
// hat_apply shares its split store (store16).
//
// Block (u, s) computes upper tile u (its (bi, bj), bj >= bi, in row order)
// over the s-th range of `chunk` contraction columns and writes it to ws[s]
// (N x N); lower tiles are never computed. gram.cu's second pass sums the
// partials in a fixed order and mirrors the lower triangle.
//
// Each block is two warpgroups; warpgroup w owns rows 64w .. 64w + 63 of the
// tile (one m64n128 product). The contraction runs in chunks of one 128-byte
// row (32 f32 or 64 bf16 columns): each thread copies its own 16-byte
// pieces of the chunk's rows of X into a raw ring of kTcRing stages with
// cp.async (no registers held; two chunks in flight ahead of the one being
// converted), then converts its pieces into the swizzled operand tiles,
// double-buffered. A warpgroup's wgmma issue stalls while the tensor cores
// work through the earlier products, so the four k-steps of chunk c are
// interleaved with converting chunk c + 1 and copying chunk c + kTcRing, a
// quarter of each per k-step. Rows are copied as 16-byte pieces where every
// row is aligned (P a multiple of 4 f32 or 8 bf16); otherwise f32 goes 4
// bytes at a time and bf16 through registers. Rows past N and columns past
// the range are zero-filled, so X is never padded or copied. A diagonal
// tile (bi == bj) copies its rows once and uses them as both operands.
//
// f32: each value is split into big = tf32(x) and small = tf32(x − big)
// (sm90::split_tf32) as it is converted, and each k8 step issues
// big·small, small·big, big·big into one f32 accumulator: f32-grade
// products (a single TF32 product misses the 1e-5 pin). bf16: one k16
// product; products of bf16 values are exact in f32.
//
// Sums: the tensor cores' f32 accumulation truncates, so a chain over a
// whole range would drift; each chunk's products go into a fresh accumulator
// (scale_d = 0 on its first product) that is then added, rounded to nearest,
// to a running total in registers. Nothing depends on scheduling: no atomics,
// and every sum has a fixed order.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace repro {

constexpr int kTcTile = 128;       // output tile: two warpgroups of 64 rows
constexpr int kTcThreads = 256;
constexpr int kTcRing = 3;         // raw stages: two chunks in flight

// Per input type: contraction columns per chunk (one 128-byte row) and
// whether values are split into TF32 big + small.
template <typename T>
struct TcIn;
template <>
struct TcIn<float> {
  static constexpr int kChunk = 32;
  static constexpr bool kSplit = true;
};
template <>
struct TcIn<__nv_bfloat16> {
  static constexpr int kChunk = 64;
  static constexpr bool kSplit = false;
};

// Copy the first `count` elements of the 16-byte piece at `src` to `dst`,
// zeros after them (count <= 0: all zeros, `src` is not read). `vec`: the
// piece is 16-byte aligned and count is 0 or whole.
template <typename T>
__device__ __forceinline__ void copy_piece(uint4* dst, const T* src, int count, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const uint32_t d = sm90::smem_u32(dst);
  if (vec) {
    sm90::cp_async16(d, src, count >= E ? 16 : 0);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm90::cp_async4(d + 4 * e, e < count ? src + e : src, e < count ? 4 : 0);
  } else {   // 2-byte elements of an unaligned row: through registers
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(src);
    union {
      uint4 u;
      uint16_t e[E];
    } v;
#pragma unroll
    for (int e = 0; e < E; ++e) v.e[e] = e < count ? bits[e] : uint16_t(0);
    *dst = v.u;
  }
}

// Write a 16-byte piece at byte offset `off` of the big tile (and, split,
// its TF32 small part at the same offset of the small tile).
template <typename T>
__device__ __forceinline__ void store16(unsigned char* big, unsigned char* small, uint32_t off,
                                        uint4 v) {
  if constexpr (TcIn<T>::kSplit) {
    float4 b, s;
    sm90::split_tf32(__uint_as_float(v.x), b.x, s.x);
    sm90::split_tf32(__uint_as_float(v.y), b.y, s.y);
    sm90::split_tf32(__uint_as_float(v.z), b.z, s.z);
    sm90::split_tf32(__uint_as_float(v.w), b.w, s.w);
    *reinterpret_cast<float4*>(big + off) = b;
    *reinterpret_cast<float4*>(small + off) = s;
  } else {
    *reinterpret_cast<uint4*>(big + off) = v;
  }
}

// Shared memory of one gram block: 1,024 bytes of slack for the swizzle
// atom's alignment, two stages of A's and B's 128-row operand tiles (big,
// and small when split), then the raw ring of eight 16-byte pieces a thread.
template <typename T>
constexpr size_t upper_gram_tc_smem() {
  return 1024 + 2 * 2 * (TcIn<T>::kSplit ? 2 : 1) * kTcTile * 128 +
         static_cast<size_t>(kTcRing) * 8 * kTcThreads * 16;
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
upper_gram_tc_kernel(const T* __restrict__ x, float* __restrict__ ws, int n, int p, int chunk) {
  constexpr int KC = TcIn<T>::kChunk;
  constexpr bool kSplit = TcIn<T>::kSplit;
  constexpr int E = 16 / sizeof(T);               // elements per 16-byte piece
  constexpr uint32_t kTileBytes = kTcTile * 128;  // 128 rows of 128 bytes
  constexpr uint32_t kOpBytes = (kSplit ? 2 : 1) * kTileBytes;   // one operand
  constexpr uint32_t kStageBytes = 2 * kOpBytes;                 // A, then B
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint4* raw = reinterpret_cast<uint4*>(tiles_smem + 2 * kStageBytes);   // [ring][slot][thread]

  // upper tile u → (bi, bj), row by row
  const int tiles = (n + kTcTile - 1) / kTcTile;
  int bi = 0, u = blockIdx.x;
  while (u >= tiles - bi) {
    u -= tiles - bi;
    ++bi;
  }
  const int bj = bi + u;
  const bool diag = bi == bj;
  const int s = blockIdx.y;
  const int k_begin = s * chunk;
  const int k_end = min(p, k_begin + chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + KC - 1) / KC : 0;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool vec = p % E == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // this thread's pieces: rows tid/8 + 32i of each operand (slots i and
  // 4 + i), piece tid % 8 of the chunk's 128-byte row
  const int prow = tid / 8, piece = tid % 8;

  // the sources of this thread's pieces at the split's first column (null
  // past N): part q copies row slot q of A and of B, chunk c from c·KC on
  const T* src[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ra = bi * kTcTile + prow + 32 * i, rb = bj * kTcTile + prow + 32 * i;
    src[i] = ra < n ? x + static_cast<size_t>(ra) * p + k_begin + piece * E : nullptr;
    src[4 + i] = !diag && rb < n ? x + static_cast<size_t>(rb) * p + k_begin + piece * E : nullptr;
  }
  auto issue = [&](int c, int r, int q) {
    const int count = min(E, k_end - (k_begin + c * KC + piece * E));
    uint4* slot = raw + r * 8 * kTcThreads + tid;
    const bool oka = src[q] != nullptr && count > 0;
    copy_piece(slot + q * kTcThreads, oka ? src[q] + c * KC : x, oka ? count : 0, vec);
    if (!diag) {
      const bool okb = src[4 + q] != nullptr && count > 0;
      copy_piece(slot + (4 + q) * kTcThreads, okb ? src[4 + q] + c * KC : x, okb ? count : 0,
                 vec);
    }
  };
  auto convert = [&](int r, int t, int q) {
    const uint4* slot = raw + r * 8 * kTcThreads + tid;
    unsigned char* sa = tiles_smem + t * kStageBytes;
    unsigned char* sb = sa + kOpBytes;
    const uint32_t off = sm90::swz128(prow + 32 * q, piece);
    store16<T>(sa, sa + kTileBytes, off, slot[q * kTcThreads]);
    if (!diag) store16<T>(sb, sb + kTileBytes, off, slot[(4 + q) * kTcThreads]);
  };

  float total[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
  auto mma = [&](int t, int kk) {
    const uint32_t stage = sm90::smem_u32(tiles_smem + t * kStageBytes);
    const uint32_t a_addr = stage + wg * 64 * 128 + 32 * kk;
    const uint32_t b_addr = (diag ? stage : stage + kOpBytes) + 32 * kk;
    if (kk == 0) {
      sm90::fence_regs(part);
      sm90::wgmma_fence();
    }
    const uint64_t a_big = sm90::desc_b128(a_addr, 16, 1024);
    const uint64_t b_big = sm90::desc_b128(b_addr, 16, 1024);
    if constexpr (kSplit) {
      const uint64_t a_small = sm90::desc_b128(a_addr + kTileBytes, 16, 1024);
      const uint64_t b_small = sm90::desc_b128(b_addr + kTileBytes, 16, 1024);
      sm90::wgmma_tf32_ss<128>(part, a_big, b_small, kk > 0);
      sm90::wgmma_tf32_ss<128>(part, a_small, b_big, 1);
      sm90::wgmma_tf32_ss<128>(part, a_big, b_big, 1);
    } else {
      sm90::wgmma_bf16_ss<128>(part, a_big, b_big, kk > 0);
    }
  };
  auto add = [&]() {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += part[i];
  };
  // A thread converts only the pieces it copied, so waiting for its own
  // copies is enough before converting; one __syncthreads a chunk publishes
  // the converted tiles and retires the tiles and the raw stage just read.
#pragma unroll
  for (int c = 0; c < kTcRing; ++c) {
    if (c < steps)
#pragma unroll
      for (int q = 0; q < 4; ++q) issue(c, c, q);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<kTcRing - 2>();   // chunks 0 and 1 have landed
  if (steps > 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) convert(0, 0, q);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int c = 0; c < steps; ++c) {
    const bool next = c + 1 < steps, more = c + kTcRing < steps;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma(c & 1, kk);
      if (next) convert((c + 1) % kTcRing, (c + 1) & 1, kk);   // its reader c − 1 is done
      if (more) issue(c + kTcRing, c % kTcRing, kk);           // chunk c's raw stage is converted
    }
    sm90::wgmma_commit();
    sm90::fence_proxy_async();
    sm90::cp_async_commit();
    sm90::cp_async_wait<kTcRing - 2>();   // chunk c + 2 has landed
    add();
    __syncthreads();
  }

  // the accumulator fragment: total[4j + e] at row 16·warp + lane/4 + 8·(e/2)
  // of this warpgroup's 64, column 8j + 2·(lane % 4) + e % 2
  float* out = ws + static_cast<size_t>(s) * n * n;
  const int r0 = bi * kTcTile + 64 * wg + 16 * warp + lane / 4;
  const int c0 = bj * kTcTile + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e / 2), col = c0 + 8 * j + e % 2;
      if (r < n && col < n) out[static_cast<size_t>(r) * n + col] = total[4 * j + e];
    }
}

// Launch the first pass on `stream`; returns the first CUDA error. The
// shared-memory opt-in is made once per device.
template <typename T>
cudaError_t launch_upper_gram_tc(const void* x, void* ws, int n, int p, int splits,
                                 cudaStream_t stream) {
  constexpr int KC = TcIn<T>::kChunk;
  constexpr size_t smem = upper_gram_tc_smem<T>();
  static std::atomic<uint32_t> opted{0};
  const cudaError_t err = set_smem_once(opted, upper_gram_tc_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTcTile - 1) / kTcTile;
  const int chunk = ((p + splits - 1) / splits + KC - 1) / KC * KC;
  dim3 grid(tiles * (tiles + 1) / 2, splits);
  upper_gram_tc_kernel<T><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), n, p, chunk);
  return cudaGetLastError();
}

}  // namespace repro
