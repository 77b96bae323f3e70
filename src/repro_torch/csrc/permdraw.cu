// T independent, exactly uniform permutations of 0..N-1 in one launch: the
// (T, N) int64 draws of a permutation test.
//
// Replaces no TPU kernel: the JAX package draws with jax.random.permutation
// (src/repro/core/permutation.py, permutation_indices), which XLA compiles
// to sorts of random keys. It is here so that a permutation test's draws
// cost one launch and no host work a row: row t's random words are a
// function of (key, t) alone, with no generator state, so a larger T draws
// the same leading rows.
//
// Randomness: Philox4x32-10 (Salmon et al., SC'11), keyed by the 64-bit key
// the wrapper derives from the seed, at the counter (w / 4, t lo, t hi, 0);
// word w of row t is lane w % 4 of that block. Each row is a Fisher–Yates
// shuffle, i from N - 1 down to 1 swapping a[i] with a[j], j uniform in
// [0, i] by Lemire's multiply-shift with rejection: j = (x·s) >> 32 for the
// next word x and s = i + 1, a draw whose low 32 bits fall below 2^32 mod s
// rejected and the next word taken. No modulo reduction and no sorted keys,
// so every permutation is exactly equally likely.
// kernels/permdraw/ref.py runs the same steps in plain PyTorch, and gives
// the same bits.
//
// What bounds it here: the output, T·N·8 bytes written once (6.4 MB at
// (1,024, 787), ~2 µs at 3.35 TB/s), but the time is each row's chain of
// N − 1 dependent Philox-and-swap steps on its one thread. One thread owns
// one row; a block of kBlockThreads threads
// owns kRows rows, stages them in shared memory as int16 entries, and
// writes them out together, so the int64 stores are coalesced. That holds
// while kRows rows of N int16 fit in 227 KB, N ≤ 3,632; above it each row
// is shuffled in place in the output (the global route), uncoalesced.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 32;           // rows a block draws: one warp's threads shuffle
constexpr int kBlockThreads = 128;  // threads a block: all of them stage and write
// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // Weyl key increments

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Row t's stream of 32-bit words, one Philox block of four at a time.
struct RowWords {
  uint32_t k0, k1, t_lo, t_hi, block;
  uint4 buf;
  int left;

  __device__ RowWords(uint32_t key0, uint32_t key1, int64_t t)
      : k0(key0), k1(key1), t_lo(static_cast<uint32_t>(t)),
        t_hi(static_cast<uint32_t>(static_cast<uint64_t>(t) >> 32)), block(0),
        buf(make_uint4(0, 0, 0, 0)), left(0) {}

  __device__ __forceinline__ uint32_t next() {
    if (left == 0) {
      buf = philox4x32_10(make_uint4(block++, t_lo, t_hi, 0), k0, k1);
      left = 4;
    }
    const uint32_t x = buf.x;
    buf = make_uint4(buf.y, buf.z, buf.w, 0);
    --left;
    return x;
  }
};

// j uniform in [0, s), s ≥ 1 (Lemire 2019): the rejection threshold
// 2^32 mod s is below s, so it is computed only for a draw whose low half
// falls below s.
__device__ __forceinline__ uint32_t bounded(RowWords& w, uint32_t s) {
  uint64_t m = static_cast<uint64_t>(w.next()) * s;
  uint32_t low = static_cast<uint32_t>(m);
  if (low < s) {
    const uint32_t threshold = (0u - s) % s;
    while (low < threshold) {
      m = static_cast<uint64_t>(w.next()) * s;
      low = static_cast<uint32_t>(m);
    }
  }
  return static_cast<uint32_t>(m >> 32);
}

template <typename E>
__device__ __forceinline__ void shuffle_row(E* a, int n, RowWords& w) {
  for (int i = n - 1; i > 0; --i) {
    const uint32_t j = bounded(w, static_cast<uint32_t>(i) + 1u);
    const E v = a[i];
    a[i] = a[j];
    a[j] = v;
  }
}

// The shared route: the block's rows as int16 in shared memory, then written out.
__global__ void __launch_bounds__(kBlockThreads)
permdraw_shared_kernel(int64_t* __restrict__ out, uint32_t k0, uint32_t k1, int t, int n) {
  extern __shared__ __align__(16) int16_t rows[];
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, t - row0);
  const int tid = static_cast<int>(threadIdx.x);
  for (int r = 0; r < nrows; ++r)
    for (int k = tid; k < n; k += kBlockThreads) rows[static_cast<size_t>(r) * n + k] = k;
  __syncthreads();
  if (tid < nrows) {
    RowWords w(k0, k1, row0 + tid);
    shuffle_row(rows + static_cast<size_t>(tid) * n, n, w);
  }
  __syncthreads();
  int64_t* dst = out + static_cast<size_t>(row0) * n;
  const size_t total = static_cast<size_t>(nrows) * n;
  for (size_t i = tid; i < total; i += kBlockThreads) dst[i] = rows[i];
}

// The global route: each row shuffled in place in the output.
__global__ void __launch_bounds__(kBlockThreads)
permdraw_global_kernel(int64_t* __restrict__ out, uint32_t k0, uint32_t k1, int t, int n) {
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, t - row0);
  const int tid = static_cast<int>(threadIdx.x);
  int64_t* dst = out + static_cast<size_t>(row0) * n;
  for (int r = 0; r < nrows; ++r)
    for (int k = tid; k < n; k += kBlockThreads) dst[static_cast<size_t>(r) * n + k] = k;
  __syncthreads();
  if (tid < nrows) {
    RowWords w(k0, k1, row0 + tid);
    shuffle_row(dst + static_cast<size_t>(tid) * n, n, w);
  }
}

}  // namespace
}  // namespace repro

extern "C" {

// out (t, n) int64, contiguous; t, n >= 1; (k0, k1) the Philox key. The
// route follows n alone.
int permdraw(void* out, uint32_t k0, uint32_t k1, int t, int n, void* stream) {
  using namespace repro;
  if (t <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = t / kRows + (t % kRows != 0);
  const size_t smem = static_cast<size_t>(kRows) * n * sizeof(int16_t);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= kMaxSmemBytes) {
    static std::atomic<uint32_t> opted{0};
    const cudaError_t err = set_smem_once(opted, permdraw_shared_kernel, kMaxSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    permdraw_shared_kernel<<<blocks, kBlockThreads, smem, s>>>(o, k0, k1, t, n);
  } else {
    permdraw_global_kernel<<<blocks, kBlockThreads, 0, s>>>(o, k0, k1, t, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
