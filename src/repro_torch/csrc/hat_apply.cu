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
// of Y and E: a few microseconds of work. On the card it is bound by the
// instructions that stage the operands (copying, converting to TF32,
// transposing Y), not by the products. What the design does about it:
//   * f32 runs on the tensor cores: one block of two warpgroups per 64 x 64
//     tile of E, each warpgroup a wgmma m64n32k8 in TF32 on its 32 columns,
//     with the same big + small split of every value as gram (three
//     products per k8 step, f32-grade; sm90.cuh); both warpgroups share the
//     copying and converting, which is most of a chunk's instructions;
//   * the contraction is split over blockIdx.z so that two blocks per SM
//     run at once even at 13 x 4 tiles (splits: kernels/hat_apply/hat_apply.py);
//     each split writes its partial H·Y tile to a workspace and a second
//     pass writes E = Y − Σ partials, summed in a fixed order (no atomics);
//     with one split the first pass writes Y − H·Y itself. H·Y is never
//     written out on its own. The second pass is a programmatic dependent
//     launch: its blocks start while the first pass ends and wait for it;
//   * chunks of 32 contraction columns, copied three chunks ahead by
//     cp.async into a raw ring as whole aligned 16-byte pieces: N = 787 and
//     B = 250 leave rows unaligned, so each row's window is the aligned
//     pieces around it (9 for H's 32 columns, 17 for Y's 64) and the
//     conversion into the operand tiles reads from the row's offset, fixed
//     per thread for the whole contraction (computed once, as are the
//     copies' sources). Copying element by element cost an instruction per
//     value and bound the kernel;
//   * H's rows are K-major as they lie; Y's chunk is written transposed
//     when converted (TF32 wgmma has no transpose bit);
//   * ragged N and B (down to B = 1) are masked when converting and in the
//     store: nothing is padded or copied.
// Each chunk's products go into a fresh accumulator that is added, rounded
// to nearest, to a running total (the tensor cores' accumulation truncates).
//
// f64 keeps the SIMT tile (tile.cuh), accumulated in f64.
#include "tile.cuh"
#include "upper_gram.cuh"      // split_sum, stride_blocks
#include "upper_gram_tc.cuh"   // store16 and the sm90 primitives

namespace repro {

constexpr int kHatThreads = 256;   // two warpgroups, each owning 32 columns of the tile
constexpr int kHatTile = 64;       // rows and columns of E per block
constexpr int kHatK = 32;          // contraction columns per chunk: one 128-byte row
constexpr int kHatRing = 4;        // raw stages: chunks c + 1 .. c + 3 in flight
// Raw windows: per row of H, the 9 aligned 16-byte pieces around the
// chunk's 32 columns; per row of Y, the 17 around the tile's 64 columns.
constexpr int kHatAPieces = 9, kHatBPieces = 17;
constexpr uint32_t kHatRawBytes = (kHatTile * kHatAPieces + kHatK * kHatBPieces) * 16;
constexpr uint32_t kHatTileBytes = kHatTile * 128;
// 1,024 bytes of slack for the swizzle atom's alignment, one set of operand
// tiles (A big, A small, B big, B small), the raw ring
constexpr size_t kHatSmem = 1024 + 4 * kHatTileBytes + kHatRing * kHatRawBytes;

__global__ void __launch_bounds__(kHatThreads)
hat_apply_tc_kernel(const float* __restrict__ h, const float* __restrict__ y,
                    float* __restrict__ ws, float* __restrict__ e, int n, int b, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* raw = tiles + 4 * kHatTileBytes;   // [ring] A window, then B window
  const int m0 = blockIdx.y * kHatTile, n0 = blockIdx.x * kHatTile, s = blockIdx.z;
  const int k_begin = s * chunk;
  const int k_end = min(n, k_begin + chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + kHatK - 1) / kHatK : 0;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const long long h_size = static_cast<long long>(n) * n, y_size = static_cast<long long>(n) * b;

  // Y's window covers only the block's columns: at B = 1, one piece a row.
  const int b_pieces = min(kHatBPieces, (min(kHatTile, b - n0) + 6) / 4);
  // This thread's copies: pieces tid + 256i of the A window (64 rows x 9)
  // and of the B window (32 rows x b_pieces). Chunks start at multiples of
  // 32, so a piece's source moves by 32 elements of H (32 rows of Y) from
  // one chunk to the next: its offset in chunk 0 is computed once here, as
  // is its place in the raw stage. H and Y start 16-byte aligned (the
  // wrapper checks), so every piece is a whole aligned 16 bytes.
  constexpr int kAP = (kHatTile * kHatAPieces + kHatThreads - 1) / kHatThreads;   // 3
  constexpr int kBP = (kHatK * kHatBPieces + kHatThreads - 1) / kHatThreads;      // 3
  long long a_src[kAP], b_src[kBP];
  int b_dst[kBP], b_row[kBP];
#pragma unroll
  for (int i = 0; i < kAP; ++i) {
    const int p = tid + kHatThreads * i, row = m0 + p / kHatAPieces;
    a_src[i] = p < kHatTile * kHatAPieces && row < n
                   ? ((static_cast<long long>(row) * n + k_begin) & ~3ll) + 4 * (p % kHatAPieces)
                   : -1;
  }
#pragma unroll
  for (int i = 0; i < kBP; ++i) {
    const int p = tid + kHatThreads * i, kk = p / b_pieces, j = p % b_pieces;
    b_row[i] = p < kHatK * b_pieces ? kk : 1 << 30;   // past every split: never copied
    b_dst[i] = 16 * (kk * kHatBPieces + j);
    b_src[i] = ((static_cast<long long>(k_begin + kk) * b + n0) & ~3ll) + 4 * j;
  }
  // Copy chunk `it` into raw stage `r`, zero-filled past the end of the
  // matrix; which of the copied values count is decided when converting.
  auto issue = [&](int it, int r) {
    unsigned char* ra = raw + r * kHatRawBytes;
    unsigned char* rb = ra + kHatTile * kHatAPieces * 16;
    const long long da = static_cast<long long>(it) * kHatK;
    const long long db = da * b;
#pragma unroll
    for (int i = 0; i < kAP; ++i) {
      if (a_src[i] < 0) continue;
      const long long at = a_src[i] + da, left = h_size - at;
      sm90::cp_async16(sm90::smem_u32(ra + 16 * (tid + kHatThreads * i)), left > 0 ? h + at : h,
                       left >= 4 ? 16 : (left > 0 ? static_cast<int>(4 * left) : 0));
    }
#pragma unroll
    for (int i = 0; i < kBP; ++i) {
      if (k_begin + it * kHatK + b_row[i] >= k_end) continue;   // masked when converted
      const long long at = b_src[i] + db, left = y_size - at;
      sm90::cp_async16(sm90::smem_u32(rb + b_dst[i]), left > 0 ? y + at : y,
                       left >= 4 ? 16 : (left > 0 ? static_cast<int>(4 * left) : 0));
    }
  };

  // Raw stage r → the operand tiles: A = H row m0 + tid/8 + 32q, columns
  // 4·(tid % 8) .. + 3 of the chunk; B = Yᵀ, tile column c = tid % 64,
  // contraction quad tid/64 + 4q (Y's chunk lands transposed: TF32 wgmma
  // has no transpose bit). Values past N, B or the split are zeros. A
  // value's place in its window is its element index mod 4 (windows start
  // 16-byte aligned), the same for every chunk: for H row i, (i·N) mod 4;
  // for Y row k, (k·B + n0) mod 4 (32-bit products keep the low bits). So
  // the raw offsets of this thread's values are fixed, computed here.
  const int prow = tid / 8, piece = tid % 8;
  const int c = tid % kHatTile, q0 = tid / kHatTile;
  const bool col_ok = n0 + c < b;
  int a_off[2], b_off[8];
  bool a_ok[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = prow + 32 * q;
    a_ok[q] = m0 + row < n;
    a_off[q] = row * 4 * kHatAPieces +
               static_cast<int>((static_cast<unsigned>(m0 + row) * static_cast<unsigned>(n)) & 3u) +
               4 * piece;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * (q0 + 4 * q) + i;
      b_off[4 * q + i] =
          kk * 4 * kHatBPieces + c +
          static_cast<int>((static_cast<unsigned>(kk) * static_cast<unsigned>(b) +
                            static_cast<unsigned>(n0)) & 3u);
    }
  }
  auto convert = [&](int it, int r) {
    const int k0 = k_begin + it * kHatK;
    const bool full = k0 + kHatK <= k_end;   // every chunk but a split's last
    const float* ra = reinterpret_cast<const float*>(raw + r * kHatRawBytes);
    const float* rb = ra + kHatTile * kHatAPieces * 4;
    float v[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = a_ok[q] && (full || k0 + 4 * piece + i < k_end) ? ra[a_off[q] + i] : 0.f;
      store16<float>(tiles, tiles + kHatTileBytes, sm90::swz128(prow + 32 * q, piece),
                     make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                __float_as_uint(v[2]), __float_as_uint(v[3])));
      const int quad = q0 + 4 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = col_ok && (full || k0 + 4 * quad + i < k_end) ? rb[b_off[4 * q + i]] : 0.f;
      store16<float>(tiles + 2 * kHatTileBytes, tiles + 3 * kHatTileBytes, sm90::swz128(c, quad),
                     make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                __float_as_uint(v[2]), __float_as_uint(v[3])));
    }
    sm90::fence_proxy_async();
  };

  float total[16], part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) total[i] = part[i] = 0.f;
  // this warpgroup's B rows (tile columns) 32·wg ..
  const uint32_t a_addr = sm90::smem_u32(tiles);
  const uint32_t b_addr = a_addr + 2 * kHatTileBytes + wg * 32 * 128;

  // Chunk c is copied kHatRing − 1 chunks ahead; the threads convert it from
  // every thread's copies into the one set of operand tiles, then each
  // warpgroup multiplies its 32 columns.
#pragma unroll
  for (int it = 0; it < kHatRing; ++it) {
    if (it < steps) issue(it, it);
    sm90::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    sm90::cp_async_wait<kHatRing - 1>();   // this thread's copies of chunk it have landed
    __syncthreads();                       // everyone's; the tiles' last reader is done
    convert(it, it % kHatRing);
    __syncthreads();                       // the tiles are written; the raw stage is free
    if (it + kHatRing < steps) issue(it + kHatRing, it % kHatRing);
    sm90::cp_async_commit();
    sm90::fence_regs(part);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a_big = sm90::desc_b128(a_addr + 32 * kk, 16, 1024);
      const uint64_t a_small = sm90::desc_b128(a_addr + kHatTileBytes + 32 * kk, 16, 1024);
      const uint64_t b_big = sm90::desc_b128(b_addr + 32 * kk, 16, 1024);
      const uint64_t b_small = sm90::desc_b128(b_addr + kHatTileBytes + 32 * kk, 16, 1024);
      sm90::wgmma_tf32_ss<32>(part, a_big, b_small, kk > 0);
      sm90::wgmma_tf32_ss<32>(part, a_small, b_big, 1);
      sm90::wgmma_tf32_ss<32>(part, a_big, b_big, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 16; ++i) total[i] += part[i];
  }
  // let the reduce pass launch (programmatic dependent launch); it still
  // waits for this grid's stores before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // total[4j + r] at tile row 16·warp + lane/4 + 8·(r/2), column
  // 32·wg + 8j + 2·(lane % 4) + r % 2: E = Y − H·Y with one split, else this
  // split's partial H·Y; a column pair as one 8-byte store where B is even
  const bool single = gridDim.z == 1;
  float* out = single ? e : ws + static_cast<size_t>(s) * n * b;
  const bool pairs = b % 2 == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * (r / 2);
      const int col = n0 + 32 * wg + 8 * j + 2 * (lane % 4);
      if (row >= n || col >= b) continue;
      const size_t at = static_cast<size_t>(row) * b + col;
      float2 v = make_float2(total[4 * j + r], total[4 * j + r + 1]);
      if (single) {
        v.x = y[at] - v.x;
        if (col + 1 < b) v.y = y[at + 1] - v.y;
      }
      if (pairs) {
        *reinterpret_cast<float2*>(out + at) = v;
      } else {
        out[at] = v.x;
        if (col + 1 < b) out[at + 1] = v.y;
      }
    }
}

// E = Y − Σ_s partial_s, the partials summed in split order. Launched as a
// programmatic dependent of the first pass: its blocks start early and wait
// here until the first pass has finished and its stores are visible.
__global__ void __launch_bounds__(kThreads)
hat_apply_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ y,
                        float* __restrict__ e, int n, int b, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t total = static_cast<size_t>(n) * b;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x)
    e[idx] = y[idx] - split_sum(ws, idx, total, splits);
}

// ws: (splits, n, b) floats, unused with one split.
int hat_apply_tc_launch(const float* h, const float* y, float* ws, float* e, int n, int b,
                        int splits, cudaStream_t st) {
  if (n <= 0 || b <= 0 || splits <= 0 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = set_smem_once(opted, hat_apply_tc_kernel, kHatSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = ((n + splits - 1) / splits + kHatK - 1) / kHatK * kHatK;
  dim3 grid((b + kHatTile - 1) / kHatTile, (n + kHatTile - 1) / kHatTile, splits);
  hat_apply_tc_kernel<<<grid, kHatThreads, kHatSmem, st>>>(h, y, ws, e, n, b, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(n) * b;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(stride_blocks(total));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, hat_apply_reduce_kernel, ws, y, e, n, b,
                                             splits));
}

// f64: the SIMT tile, one block per 64 x 64 tile of E over the whole
// contraction, the subtraction fused into the store.
__global__ void __launch_bounds__(kThreads)
hat_apply_f64_kernel(const double* __restrict__ h, const double* __restrict__ y,
                     double* __restrict__ e, int n, int b) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  double acc[4][4];
  tile_product<double, double, false>(h, n, y, b, n, b, bi * kTile, bj * kTile, 0, n, acc);
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

}  // namespace repro

extern "C" {

// ws: (splits, n, b) f32 workspace of the split partials (null when
// splits == 1); f64 takes splits == 1 and no workspace.
int hat_apply_f32(const void* h, const void* y, void* ws, void* e, int n, int b, int splits,
                  void* stream) {
  return repro::hat_apply_tc_launch(static_cast<const float*>(h), static_cast<const float*>(y),
                                    static_cast<float*>(ws), static_cast<float*>(e), n, b,
                                    splits, static_cast<cudaStream_t>(stream));
}
int hat_apply_f64(const void* h, const void* y, void* ws, void* e, int n, int b, int splits,
                  void* stream) {
  if (n <= 0 || b <= 0 || splits != 1 || ws != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((b + repro::kTile - 1) / repro::kTile, (n + repro::kTile - 1) / repro::kTile);
  repro::hat_apply_f64_kernel<<<grid, repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(h), static_cast<const double*>(y), static_cast<double*>(e), n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
