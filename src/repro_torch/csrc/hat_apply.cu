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
// f64 runs on the FP64 tensor cores (DMMA, mma.sync m16n8k8; f64 has no
// wgmma), on the f64 primitives gram's route uses (dmma.cuh). At the lm_probe
// path's H (384, 384), Y (384, 64) it is 1.9e7 FLOP against 1.6 MB: a few
// device microseconds, so what bounds it is how much of the card a call
// keeps busy (the SIMT tile it replaces ran 6 blocks, each over the whole
// contraction); at N = 787, B = 250 it is the traffic from L2 (H is read
// once per column tile of E, Y once per row tile). What the design does:
//   * blocks of four warps per 64 x 64 tile of E (each warp 32 x 32, two
//     by four products of m16n8); products past N or B are skipped, so
//     B = 1 (the x64 binary_cv label vector) costs one product in eight;
//   * the contraction is split over blockIdx.z (splits:
//     kernels/hat_apply/hat_apply.py::dmma_hat_splits) so that the few
//     tiles of a small N or B still give over a hundred blocks; the same
//     fixed-order second pass as f32, a programmatic dependent launch, and
//     with one split Y − H·Y fused into the store;
//   * chunks of 16 contraction columns by cp.async, a three-stage ring, as
//     16-byte pieces where H's (Y's) rows are 16-byte aligned, else 8-byte
//     pieces, so any H and Y are taken (f64 data is always 8-byte aligned);
//   * Y's chunk is staged as it lies, (K, B) row-major, and read as the
//     .col fragment (B[k][n] with k = 2q, 2q + 1 after the permutation);
//     its rows are padded to 66 doubles so a half warp's 8-byte reads hit
//     16 different bank pairs;
//   * the tile of E goes out through shared memory, a warp to a row;
//   * f64 products and sums need no split and no fresh accumulator.
#include "dmma.cuh"              // the f64 tensor-core primitives
#include "upper_gram_tc.cuh"     // store16 and the sm90 primitives

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
hat_apply_reduce_kernel(const T* __restrict__ ws, const T* __restrict__ y, T* __restrict__ e,
                        int n, int b, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t total = static_cast<size_t>(n) * b;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x)
    e[idx] = y[idx] - ordered_split_sum(ws, idx, total, splits);
}

template <typename T>
cudaError_t launch_hat_reduce(const T* ws, const T* y, T* e, int n, int b, int splits,
                              cudaStream_t st) {
  return launch_dependent(hat_apply_reduce_kernel<T>,
                          dim3(stride_blocks(static_cast<size_t>(n) * b)), dim3(kThreads), st,
                          ws, y, e, n, b, splits);
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
  return static_cast<int>(launch_hat_reduce(ws, y, e, n, b, splits, st));
}

// ---- f64: the FP64 tensor cores ----------------------------------------------

constexpr int kHatDmmaThreads = 128;   // four warps of 32 x 32
constexpr int kHatDmmaRows = 64;       // rows of E per block
constexpr int kHatDmmaCols = 64;       // columns of E per block
constexpr int kHatDmmaNi = kHatDmmaCols / 16;   // n8 products a warp, per m16
constexpr int kHatDmmaLdY = kHatDmmaCols + 2;   // doubles per staged row of Y (padding: 2)
constexpr int kHatDmmaRing = 3;        // stages: chunks c + 1, c + 2 in flight
// one stage: H's 64 k-major rows, then Y's 16 rows of 64 columns
constexpr int kHatDmmaStage = kHatDmmaRows * kDmmaLd + kDmmaK * kHatDmmaLdY;
constexpr size_t kHatDmmaSmem =
    static_cast<size_t>(kHatDmmaRing) * kHatDmmaStage * sizeof(double);   // 62,208 bytes
// the output tile staged for the store: rows of 72 doubles (576 bytes, 64
// mod 128), so a quarter warp's 16-byte writes of two rows hit eight groups
constexpr int kHatDmmaOutLd = kHatDmmaCols + 8;
static_assert(kHatDmmaRows * kHatDmmaOutLd <= kHatDmmaRing * kHatDmmaStage,
              "the tile must fit the stages");

__global__ void __launch_bounds__(kHatDmmaThreads)
hat_apply_dmma_kernel(const double* __restrict__ h, const double* __restrict__ y,
                      double* __restrict__ ws, double* __restrict__ e, int n, int b, int chunk) {
  extern __shared__ __align__(16) double hat_smem[];
  const int m0 = blockIdx.y * kHatDmmaRows, n0 = blockIdx.x * kHatDmmaCols, s = blockIdx.z;
  const int k_begin = s * chunk;
  const int k_end = min(n, k_begin + chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + kDmmaK - 1) / kDmmaK : 0;
  const bool vec_h = n % 2 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const bool vec_y = b % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int wr = 32 * (warp % 2), wc = (kHatDmmaCols / 2) * (warp / 2);   // this warp's 32 x 32
  uint32_t live = 0;   // products (mi, ni) inside N x B
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kHatDmmaNi; ++ni)
      if (m0 + wr + 16 * mi < n && n0 + wc + 8 * ni < b) live |= 1u << (kHatDmmaNi * mi + ni);

  // Chunk c: H's rows m0 .. m0 + 63 at columns kc .. kc + 15 (k-major, as
  // gram stages X), and Y's rows kc .. kc + 15 at columns n0 .. n0 + 63 as
  // they lie; zeros past N, B and the split.
  auto issue = [&](int c, int stage) {
    double* sa = hat_smem + stage * kHatDmmaStage;
    double* sy = sa + kHatDmmaRows * kDmmaLd;
    const int kc = k_begin + c * kDmmaK;
    dmma::stage_rows<kHatDmmaRows, kHatDmmaThreads>(sa, h, n, n, m0, kc, k_end, vec_h, tid);
    // Y: one thread a piece of a row, rows step apart (not unrolled, as in
    // dmma::stage_rows)
    const int per_row = vec_y ? kHatDmmaCols / 2 : kHatDmmaCols;
    const int step = kHatDmmaThreads / per_row;
    const int col = (tid % per_row) * (vec_y ? 2 : 1);
    const bool col_ok = n0 + col < b;
    const double* from = y + static_cast<long long>(kc + tid / per_row) * b + n0 + col;
    uint32_t to = sm90::smem_u32(sy + (tid / per_row) * kHatDmmaLdY + col);
#pragma unroll 1
    for (int kr = tid / per_row; kr < kDmmaK;
         kr += step, from += static_cast<long long>(step) * b, to += step * kHatDmmaLdY * 8) {
      const bool ok = col_ok && kc + kr < k_end;
      if (vec_y)
        sm90::cp_async16(to, ok ? from : y, ok ? 16 : 0);
      else
        dmma::cp_async8(to, ok ? from : y, ok ? 8 : 0);
    }
  };

  double acc[2][kHatDmmaNi][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kHatDmmaNi; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0;

  auto compute = [&](int stage) {
    const double* sa = hat_smem + stage * kHatDmmaStage;
    const double* sy = sa + kHatDmmaRows * kDmmaLd;
#pragma unroll
    for (int kk = 0; kk < kDmmaK / 8; ++kk) {
      double a[2][4], bf[kHatDmmaNi][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) dmma::load_a(a[mi], sa, wr + 16 * mi, kk, g, q);
      // B[k][n] = Y's staged row k: the permuted k = 2q, 2q + 1 of this step
      const double* yk = sy + (8 * kk + 2 * q) * kHatDmmaLdY + wc + g;
#pragma unroll
      for (int ni = 0; ni < kHatDmmaNi; ++ni) {
        bf[ni][0] = yk[8 * ni];
        bf[ni][1] = yk[8 * ni + kHatDmmaLdY];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kHatDmmaNi; ++ni)
          if (live >> (kHatDmmaNi * mi + ni) & 1u) dmma::mma_m16n8k8(acc[mi][ni], a[mi], bf[ni]);
    }
  };

#pragma unroll
  for (int c = 0; c < kHatDmmaRing - 1; ++c) {
    if (c < steps) issue(c, c);
    sm90::cp_async_commit();
  }
  for (int c = 0; c < steps; ++c) {
    sm90::cp_async_wait<kHatDmmaRing - 2>();   // this thread's copies of chunk c have landed
    __syncthreads();                           // everyone's; stage (c − 1) is free
    const int next = c + kHatDmmaRing - 1;
    if (next < steps) issue(next, next % kHatDmmaRing);
    sm90::cp_async_commit();
    compute(c % kHatDmmaRing);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The tile goes out through shared memory (the stages are free now), so
  // that rows of E are written whole: acc[mi][ni][2hh + ee] is entry
  // (wr + 16·mi + g + 8·hh, wc + 8·ni + 2q + ee). E = Y − H·Y with one
  // split, else this split's partial H·Y.
  __syncthreads();
  double* tile = hat_smem;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kHatDmmaNi; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<double2*>(tile + (wr + 16 * mi + g + 8 * hh) * kHatDmmaOutLd + wc +
                                    8 * ni + 2 * q) =
            make_double2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
  __syncthreads();
  const bool single = gridDim.z == 1;
  double* out = single ? e : ws + static_cast<size_t>(s) * n * b;
  for (int i = tid; i < kHatDmmaRows * kHatDmmaCols; i += kHatDmmaThreads) {
    const int row = m0 + i / kHatDmmaCols, col = n0 + i % kHatDmmaCols;
    if (row >= n || col >= b) continue;
    const size_t at = static_cast<size_t>(row) * b + col;
    const double v = tile[(i / kHatDmmaCols) * kHatDmmaOutLd + i % kHatDmmaCols];
    out[at] = single ? y[at] - v : v;
  }
}

// ws: (splits, n, b) doubles, unused with one split.
int hat_apply_dmma_launch(const double* h, const double* y, double* ws, double* e, int n, int b,
                          int splits, cudaStream_t st) {
  if (n <= 0 || b <= 0 || splits <= 0 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint32_t> opted{0};
  cudaError_t err = set_smem_once(opted, hat_apply_dmma_kernel, kHatDmmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = ((n + splits - 1) / splits + kDmmaK - 1) / kDmmaK * kDmmaK;
  dim3 grid((b + kHatDmmaCols - 1) / kHatDmmaCols, (n + kHatDmmaRows - 1) / kHatDmmaRows, splits);
  hat_apply_dmma_kernel<<<grid, kHatDmmaThreads, kHatDmmaSmem, st>>>(h, y, ws, e, n, b, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_hat_reduce(ws, y, e, n, b, splits, st));
}

}  // namespace repro

extern "C" {

// ws: (splits, n, b) workspace of the split partials in the data's type
// (null when splits == 1). splits: kernels/hat_apply/hat_apply.py
// (hat_splits for f32, dmma_hat_splits for f64).
int hat_apply_f32(const void* h, const void* y, void* ws, void* e, int n, int b, int splits,
                  void* stream) {
  return repro::hat_apply_tc_launch(static_cast<const float*>(h), static_cast<const float*>(y),
                                    static_cast<float*>(ws), static_cast<float*>(e), n, b,
                                    splits, static_cast<cudaStream_t>(stream));
}
int hat_apply_f64(const void* h, const void* y, void* ws, void* e, int n, int b, int splits,
                  void* stream) {
  return repro::hat_apply_dmma_launch(static_cast<const double*>(h),
                                      static_cast<const double*>(y), static_cast<double*>(ws),
                                      static_cast<double*>(e), n, b, splits,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
