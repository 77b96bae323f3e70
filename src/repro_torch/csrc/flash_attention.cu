// Causal / sliding-window / soft-capped GQA self-attention with an online
// softmax: O = softmax(mask(softcap(scale · Q Kᵀ))) · V for q (B, Hq, S, D),
// k and v (B, Hkv, S, D), query head h reading KV head h / (Hq / Hkv). The
// self-attention of the LLM substrate's prefill and forward passes.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, body _flash_kernel):
// grid (B·Hq, S/bq, S/bk) with the key axis innermost, running max,
// denominator and accumulator in VMEM scratch across the key loop, and key
// blocks beyond the causal frontier or outside the local window skipped with
// pl.when. Order of operations, kept by both routes here: scale, then
// softcap·tanh(s/softcap) (the accurate tanhf), then the mask (masked logits
// −1e30), then the online max; p = exp(s − m) with masked p set to 0; the
// denominator l summed from the f32 p and floored at 1e-30; the output
// written once in the input type.
//
// What bounds it here: operations. One call does 4·D·pairs·B·Hq of them, where
// pairs counts the reachable (q, k) pairs (S(S+1)/2 causal, about S·W under
// a window W), against the bytes of Q, K, V and O read or written once. At
// gemma2-2b's prefill (B = 1, Hq 8, Hkv 4, S 8,192, D 256, bf16) that is
// 2.75e11 operations against 1e8 bytes: 0.28 ms at the 989 TFLOP/s of bf16
// tensor cores, 0.03 ms for the bytes. 4·D·pairs stays the bound's
// definition; the bf16 route below issues 6·D·pairs (P·V twice, see "split
// P") plus the masked parts of the tiles on the diagonal and window edges.
//
// Two routes, one per I/O type, chosen by the entry point:
//
// bf16 I/O: flash_tc_kernel, on the tensor cores (wgmma, sm_90a).
//   * One block of 256 threads per (b·Hq, 128-query tile): two warpgroups,
//     each owning 64 query rows (one m64 wgmma tile). Tiles at the causal
//     diagonal's far end, which have the most keys, are launched first.
//   * Q·Kᵀ: wgmma m64n64k16, A = Q and B = the K tile, both bf16 from
//     shared memory, K-major, 128-byte swizzle: D/16 products per key tile
//     of 64 (products of bf16 values are exact in f32 and wgmma sums in
//     f32, so nothing is lost against the f32 reference).
//   * The softmax runs on the accumulator fragments in registers: each
//     thread holds two rows of 16 logits; the row max is reduced over the
//     quad with shuffles, the row sum per thread and over the quad once at
//     the end. The element loop carries no branch: it is instantiated with
//     and without the softcap and the mask (tc_logits, tc_probs), and the
//     mask runs only on tiles that cross the causal diagonal, the window's
//     edge or S. exp is ex2.approx with log2 e folded into one FMA (relative
//     error below 2^-22); tanhf stays the accurate one (tanh.approx's ~2^-11
//     would move a logit capped at 50 by up to 0.02, p by 2 %). O is
//     rescaled only when a row's max moved (α = 1 exactly otherwise).
//   * Split P. P · V on the tensor cores needs P in bf16, and P rounded once
//     to bf16 misses the 2-ulp pin against the f32 reference by far (about
//     30 bf16 ulps at S = 1,024, D = 256, softcap 50: each p carries up to
//     a 2^-9 relative error, and the output sums them). So P is split: p_hi =
//     bf16(p), p_lo = bf16(p − p_hi), both packed from the S accumulator
//     straight into register A operands (the f32 accumulator layout of
//     m64nNk16 is the bf16 A layout of the next product), and p_hi·V and
//     p_lo·V accumulate into one f32 O fragment after O is rescaled by
//     α = exp(m_old − m_new): wgmma m64nDk16, V from shared memory N-major
//     (the transpose bit). Emulated on the CPU (tests/test_torch_flash_split.py)
//     the split stays within 1 bf16 ulp of the reference's bf16 output where
//     a single bf16 P is 27–32 ulps off. It costs 1.5× the counted
//     tensor-core operations.
//   * K and V: a ring of two stages in shared memory, loaded by TMA
//     (cp.async.bulk.tensor, rank-4 tensor maps over (D, S, H, B) with the
//     tensors' own byte strides, 128-byte swizzle matching the wgmma
//     descriptors, rows past S filled with zeros and masked) with one
//     mbarrier per stage: thread 0 issues tile j+1 while tile j is
//     computed; a block barrier at the end of each tile frees its stage. Q
//     is loaded once. No warp specialisation yet.
//   * The tensor maps are built on the host per call with
//     cuTensorMapEncodeTiled, fetched from the driver through the runtime's
//     cudaGetDriverEntryPoint (nothing links libcuda). q, k, v need 16-byte
//     aligned bases and (batch, head, position) strides that are multiples
//     of 8 elements; the wrapper checks it. Key dims are sorted by stride,
//     so (B, S, H, D) memory read as (B, H, S, D) goes in with no copy.
//   * Budget at D = 256: shared memory 2 × 32 KB of Q + 2 stages × (32 KB K
//     + 32 KB V) = 192 KB (+1 KB alignment), so one block per SM; registers
//     (ptxas: 248 of 255 a thread, no spills): the O fragment 128, the
//     logits 32, P's split A operands 32. At D = 64 / 128 the same design
//     takes 48 / 96 KB of shared memory.
//   * Skips: key tiles from max(0, q0 − W + 1) to the causal frontier of the
//     block's 128 rows; a warpgroup sits out the tiles none of its 64 rows
//     reach (the diagonal's last tile, the window's first).
//
// f32 I/O: flash_attention_kernel, the f32 SIMT kernel of the first port (a
// simple kernel that is right first; the tensor cores at f32 need a 3×bf16
// split of Q and K too, later work):
//   * one block of 256 threads per (b·Hq, 64-query tile); the tiles of the
//     causal diagonal's far end, which have the most keys, are launched
//     first;
//   * the key loop runs only over the reachable tiles, from
//     max(0, q_start − W + 1) to the causal frontier (the Pallas kernel's
//     pl.when skip): a local layer does O(S·W) work, not O(S²);
//   * Q, K and V tiles are staged in shared memory as f32, the 64 × 64
//     logits tile too; the running max and denominator stay in registers
//     of the warp that owns the row, and the 64 × D accumulator is split
//     over the block's threads, 4 rows × D/16 columns each (64 registers
//     at D = 256);
//   * q, k, v and o are addressed through their batch, head and sequence
//     strides (the feature stride must be 1); ragged S is masked in the
//     loader (rows past S read as 0), nothing is padded;
//   * at D = 256 the tiles take 214 KB of shared memory: the launch opts in
//     with cudaFuncSetAttribute first, and a refused launch is reported by
//     cudaGetLastError.
#include "common.cuh"
#include "sm90.cuh"

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

#include <cstddef>
#include <cstdint>

namespace repro {

constexpr int kFlashBQ = 64;  // query rows per block
constexpr int kFlashBK = 64;  // keys per tile
constexpr float kFlashNegInf = -1e30f;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, hq, hkv, s;
  // element strides of (batch, head, position); the feature stride is 1
  int q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale, softcap;  // softcap 0: none
  int causal, window;    // window 0: none
};

__device__ __forceinline__ bool flash_valid(const FlashArgs& a, int qi, int kj) {
  return kj < a.s && (!a.causal || qi >= kj) && (a.window <= 0 || qi - kj < a.window);
}

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kFlashBQ) * (D + 1)     // Q
                          + static_cast<size_t>(kFlashBK) * (D + 1)   // K
                          + static_cast<size_t>(kFlashBK) * D         // V
                          + static_cast<size_t>(kFlashBQ) * (kFlashBK + 1)  // logits / P
                          + 2 * kFlashBQ);                            // alpha, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(const FlashArgs a) {
  static_assert(kThreads == 256 && kFlashBQ == 64 && kFlashBK == 64, "thread maps assume these");
  constexpr int QS = D + 1;          // padded row strides: column reads hit distinct banks
  constexpr int SS = kFlashBK + 1;
  constexpr int CJ = D / 16;         // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kFlashBQ * QS;
  float* vs = ks + kFlashBK * QS;
  float* ss = vs + kFlashBK * D;
  float* row_alpha = ss + kFlashBQ * SS;
  float* row_l = row_alpha + kFlashBQ;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFlashBQ;  // far end of the diagonal first
  const int bi = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const T* qg = static_cast<const T*>(a.q) + static_cast<size_t>(bi) * a.q_sb +
                static_cast<size_t>(h) * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + static_cast<size_t>(bi) * a.k_sb +
                static_cast<size_t>(hk) * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + static_cast<size_t>(bi) * a.v_sb +
                static_cast<size_t>(hk) * a.v_sh;
  T* og = static_cast<T*>(a.o) + static_cast<size_t>(bi) * a.o_sb + static_cast<size_t>(h) * a.o_sh;

  for (int e = tid; e < kFlashBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, qi = q0 + r;
    qs[r * QS + c] = qi < a.s ? to_acc(qg[static_cast<size_t>(qi) * a.q_ss + c]) : 0.f;
  }

  // the reachable key tiles of this query tile
  const int q_last = min(q0 + kFlashBQ, a.s) - 1;
  int kt_lo = 0, kt_hi = (a.s - 1) / kFlashBK;
  if (a.causal) kt_hi = min(kt_hi, q_last / kFlashBK);
  if (a.window > 0) kt_lo = max(0, q0 - a.window + 1) / kFlashBK;

  // softmax state: warp w owns rows 8w .. 8w + 7 (every lane holds the values)
  const int warp = tid / 32, lane = tid % 32;
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kFlashNegInf;
    l_r[i] = 0.f;
  }
  // accumulator: rows rg + 16 i, columns cg + 16 j
  const int rg = tid / 16, cg = tid % 16;
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kFlashBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < kFlashBK * D; e += kThreads) {
      const int r = e / D, c = e % D, kj = k0 + r;
      const bool in = kj < a.s;
      ks[r * QS + c] = in ? to_acc(kg[static_cast<size_t>(kj) * a.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_acc(vg[static_cast<size_t>(kj) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    {  // logits: thread (ty, tx) takes rows ty + 16 i and keys tx + 16 j
      const int ty = tid / 16, tx = tid % 16;
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float sv = sacc[i][j] * a.scale;
          if (a.softcap > 0.f) sv = a.softcap * tanhf(sv / a.softcap);
          ss[r * SS + c] = flash_valid(a, q0 + r, k0 + c) ? sv : kFlashNegInf;
        }
    }
    __syncthreads();

    // online softmax, one row at a time per warp; P replaces the logits
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i, qi = q0 + r;
      const float s0 = ss[r * SS + lane], s1 = ss[r * SS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float p0 = flash_valid(a, qi, k0 + lane) ? expf(s0 - m_new) : 0.f;
      const float p1 = flash_valid(a, qi, k0 + lane + 32) ? expf(s1 - m_new) : 0.f;
      ss[r * SS + lane] = p0;
      ss[r * SS + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
      if (lane == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

    // acc = acc · alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 2
    for (int kk = 0; kk < kFlashBK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(rg + 16 * i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = vs[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) row_l[warp * 8 + i] = fmaxf(l_r[i], 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i, qi = q0 + r;
    if (qi >= a.s) continue;
    const float l = row_l[r];
    T* orow = og + static_cast<size_t>(qi) * a.o_ss;
#pragma unroll
    for (int j = 0; j < CJ; ++j) store_out(orow + cg + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t flash_launch_d(const FlashArgs& a, cudaStream_t st) {
  constexpr size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kFlashBQ - 1) / kFlashBQ, a.b * a.hq);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int flash_launch(const FlashArgs& a, int d, void* stream) {
  if (a.b <= 0 || a.hq <= 0 || a.hkv <= 0 || a.s <= 0 || a.hq % a.hkv != 0 || a.window < 0 ||
      static_cast<long long>(a.b) * a.hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(flash_launch_d<T, 64>(a, st));
    case 128: return static_cast<int>(flash_launch_d<T, 128>(a, st));
    case 256: return static_cast<int>(flash_launch_d<T, 256>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- bf16 I/O: the tensor-core route ------------------------------------------

constexpr int kTcBQ = 128;            // query rows per block: two warpgroups of 64
constexpr int kTcBK = 64;             // keys per tile
constexpr int kTcThreads = 256;
constexpr int kTcStages = 2;          // K/V ring depth
constexpr int kTcBox = 64 * 64 * 2;   // one TMA box: 64 rows × 64 features, bf16
constexpr float kLog2e = 1.4426950408889634f;

struct FlashTcArgs {
  // rank 4: dim 0 the features, dims 1..3 the (position, head, batch) axes
  // in the order of their strides; ord_* says which: axis of dim i + 1 is
  // (ord >> 2i) & 3, with 0 position, 1 head, 2 batch
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  int b, hq, hkv, s;
  int o_sb, o_sh, o_ss;
  int ord_q, ord_k, ord_v;
  float scale, softcap;
  int causal, window;
};

template <int D>
constexpr size_t flash_tc_smem_bytes() {
  // 1,024 bytes of slack to align the tiles to the swizzle atom, Q of both
  // warpgroups, the K and V stages, three mbarriers
  return 1024 + static_cast<size_t>(D / 64) * kTcBox * (2 + 2 * kTcStages) + 3 * sizeof(uint64_t);
}

__device__ __forceinline__ int tc_axis(int ord, int dim, int pos, int head, int batch) {
  const int ax = (ord >> (2 * dim)) & 3;
  return ax == 0 ? pos : (ax == 1 ? head : batch);
}

// One box of 64 rows (positions from `pos`) × 64 features (from `feat`).
__device__ __forceinline__ void tc_load_box(void* dst, const CUtensorMap* map, int ord,
                                            uint64_t* bar, int feat, int pos, int head,
                                            int batch) {
  sm90::tma_load_4d(dst, map, bar, feat, tc_axis(ord, 0, pos, head, batch),
                    tc_axis(ord, 1, pos, head, batch), tc_axis(ord, 2, pos, head, batch));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the MUFU (relative error below 2^-22); results below 2^-126 flush
// to 0, which p = exp(s − m) ≤ 1 never needs.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool tc_valid(const FlashTcArgs& a, int qi, int kj) {
  return kj < a.s && (!a.causal || qi >= kj) && (a.window <= 0 || qi - kj < a.window);
}

// Where a logit fragment lies: s[4j + e] of a thread is row row0 + 8·(e / 2)
// and key k0 + 8j + 2·quad_col + e % 2 (the m64nNk16 accumulator layout).
struct TcFrag {
  int row0, k0, quad_col;
  __device__ __forceinline__ int row(int i) const { return row0 + 8 * ((i / 2) % 2); }
  __device__ __forceinline__ int key(int i) const { return k0 + 8 * (i / 4) + 2 * quad_col + i % 2; }
};

// Logits of one tile in place: scale, softcap, mask; mx the row maxima of
// this thread's two rows. The softcap's s / softcap is s · (1 / softcap),
// within one f32 rounding of the quotient. Templated so that the element
// loop carries no branch: kMask only on tiles that cross the causal
// diagonal, the window's edge or S.
template <bool kCap, bool kMask>
__device__ __forceinline__ void tc_logits(float (&s)[32], float (&mx)[2], const FlashTcArgs& a,
                                          float inv_cap, const TcFrag& f) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * a.scale;
    if (kCap) x = a.softcap * tanhf(x * inv_cap);
    if (kMask && !tc_valid(a, f.row(i), f.key(i))) x = kFlashNegInf;
    s[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
}

// p = exp(s − m) in place (m_l2e = m · log2 e), masked p = 0, and this
// thread's share of the row sums.
template <bool kMask>
__device__ __forceinline__ void tc_probs(float (&s)[32], float (&l)[2], const float (&m_l2e)[2],
                                         const FlashTcArgs& a, const TcFrag& f) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = ex2_approx(fmaf(s[i], kLog2e, -m_l2e[(i / 2) % 2]));
    if (kMask && !tc_valid(a, f.row(i), f.key(i))) p = 0.f;
    s[i] = p;
    l[(i / 2) % 2] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_tc_kernel(const __grid_constant__ FlashTcArgs a) {
  constexpr int NR = D / 64;                  // 64-feature column blocks, one TMA box each
  constexpr int kTileBytes = NR * kTcBox;     // 64 rows × D: a warpgroup's Q, one K or V tile
  constexpr int NO = D / 2;                   // O fragment registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = base;                                  // [warpgroup][NR][64 × 64]
  unsigned char* sk = sq + 2 * kTileBytes;                   // [stage][NR][64 × 64]
  unsigned char* sv = sk + kTcStages * kTileBytes;           // [stage][NR][64 × 64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kTcStages * kTileBytes);  // Q, stage 0, 1

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, quad_row = lane / 4, quad_col = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;      // far end of the diagonal first
  const int bi = blockIdx.y / a.hq, h = blockIdx.y % a.hq;
  const int hk = h / (a.hq / a.hkv);

  // the block's key tiles, and this warpgroup's
  const int q_last = min(q0 + kTcBQ, a.s) - 1;
  const int kt_lo = a.window > 0 ? max(0, q0 - a.window + 1) / kTcBK : 0;
  const int kt_hi = (a.causal ? q_last : a.s - 1) / kTcBK;
  const int qw = q0 + 64 * wg;
  const int w_lo = a.window > 0 ? max(0, qw - a.window + 1) / kTcBK : 0;
  const int w_hi = qw >= a.s ? -1 : (a.causal ? min(qw + 64, a.s) - 1 : a.s - 1) / kTcBK;

  auto load_kv = [&](int kt, int stage) {
    uint64_t* bar = bars + 1 + stage;
    sm90::mbar_arrive_expect_tx(bar, 2 * kTileBytes);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      tc_load_box(sk + stage * kTileBytes + r * kTcBox, &a.tk, a.ord_k, bar, 64 * r, kt * kTcBK,
                  hk, bi);
      tc_load_box(sv + stage * kTileBytes + r * kTcBox, &a.tv, a.ord_v, bar, 64 * r, kt * kTcBK,
                  hk, bi);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + i, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bars, 2 * kTileBytes);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        tc_load_box(sq + w * kTileBytes + r * kTcBox, &a.tq, a.ord_q, bars, 64 * r, q0 + 64 * w,
                    h, bi);
    load_kv(kt_lo, 0);
  }

  // softmax state of this thread's two rows (16·warp + quad_row and 8 below);
  // l is this thread's share of the row sum, summed over the quad at the end
  float m_r[2] = {kFlashNegInf, kFlashNegInf}, l_r[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const int row0 = qw + 16 * warp + quad_row;
  const uint32_t q_addr = sm90::smem_u32(sq + wg * kTileBytes);
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  sm90::mbar_wait(bars, 0);

  for (int kt = kt_lo, it = 0; kt <= kt_hi; ++kt, ++it) {
    const int stage = it & 1;
    if (tid == 0 && kt < kt_hi) load_kv(kt + 1, stage ^ 1);   // its stage was freed last tile
    sm90::mbar_wait(bars + 1 + stage, (it >> 1) & 1);
    if (kt >= w_lo && kt <= w_hi) {
      const int k0 = kt * kTcBK;
      const uint32_t k_addr = sm90::smem_u32(sk + stage * kTileBytes);
      const uint32_t v_addr = sm90::smem_u32(sv + stage * kTileBytes);

      // S = Q Kᵀ: D/16 steps of k16; each 64-feature block is one swizzled
      // 8 KB box, a k16 step 32 bytes into its rows
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTcBox + (kk % 4) * 32;
        sm90::wgmma_m64n64k16_ss(s, sm90::desc_b128(q_addr + off, 16, 1024),
                                 sm90::desc_b128(k_addr + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // scale, softcap, mask; the online max over the quad that shares each
      // row; p = exp(s − m)
      const bool edge = k0 + kTcBK > a.s || (a.causal && k0 + kTcBK - 1 > qw) ||
                        (a.window > 0 && qw + 63 - k0 >= a.window);
      const TcFrag frag{row0, k0, quad_col};
      float mx[2] = {kFlashNegInf, kFlashNegInf};
      if (a.softcap > 0.f) {
        if (edge) tc_logits<true, true>(s, mx, a, inv_cap, frag);
        else tc_logits<true, false>(s, mx, a, inv_cap, frag);
      } else {
        if (edge) tc_logits<false, true>(s, mx, a, inv_cap, frag);
        else tc_logits<false, false>(s, mx, a, inv_cap, frag);
      }
      float alpha[2], m_l2e[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = m_new == m_r[r] ? 1.f : ex2_approx((m_r[r] - m_new) * kLog2e);
        m_l2e[r] = m_new * kLog2e;
        m_r[r] = m_new;
        l_r[r] *= alpha[r];
      }
      if (edge) tc_probs<true>(s, l_r, m_l2e, a, frag);
      else tc_probs<false>(s, l_r, m_l2e, a, frag);
      // split P into bf16 hi + lo A fragments: k16 step kk takes n-blocks
      // 2kk and 2kk + 1 of the logits, registers 8kk .. 8kk + 7 in order
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          p_hi[kk][j] = pack_bf16x2(hi);
          p_lo[kk][j] = pack_bf16x2(
              __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi)));
        }
      // O = α·O + p_hi V + p_lo V; V's k16 step kk is its rows 16kk .. 16kk + 15
      // (2 KB into the tile), its 64-feature blocks one box (8 KB) apart
      if (alpha[0] != 1.f || alpha[1] != 1.f) {   // no row's max moved: O stands as it is
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
      }
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sm90::desc_b128(v_addr + kk * 16 * 128, kTcBox, 1024);
        sm90::wgmma_rs_tnsp_b<D>(o, p_hi[kk], dv, 1);
        sm90::wgmma_rs_tnsp_b<D>(o, p_lo[kk], dv, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // the A operands stay put until the products are done
        sm90::fence_regs(p_hi[kk]);
        sm90::fence_regs(p_lo[kk]);
      }
    }
    __syncthreads();   // every read of this stage is done: the next load may overwrite it
  }

  // O / l, written once in bf16 through o's strides
  __nv_bfloat16* og = a.o + static_cast<size_t>(bi) * a.o_sb + static_cast<size_t>(h) * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int qi = row0 + 8 * r;
    if (qi >= a.s) continue;
    __nv_bfloat16* orow = og + static_cast<size_t>(qi) * a.o_ss + 2 * quad_col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l, o[4 * j + 2 * r + 1] / l);
  }
}

// cuTensorMapEncodeTiled, fetched once from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map of 64 × 64 boxes over bf16 (B, H, S, D) with element strides
// (sb, sh, ss) and feature stride 1; the three outer axes go in by rising
// stride (a size-1 axis takes the dense bound), `ord` records their order.
inline cudaError_t make_map(CUtensorMap* map, int* ord, const void* ptr, int d, int s, int h,
                            int b, long long ss, long long sh, long long sb) {
  const unsigned long long dense = static_cast<unsigned long long>(d) * s * h * b;
  const int ext[3] = {s, h, b};
  unsigned long long st[3] = {static_cast<unsigned long long>(ss),
                              static_cast<unsigned long long>(sh),
                              static_cast<unsigned long long>(sb)};
  int axis[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) st[i] = dense;
  for (int i = 1; i < 3; ++i)          // insertion sort of three, stable
    for (int j = i; j > 0 && st[axis[j]] < st[axis[j - 1]]; --j) {
      const int t = axis[j];
      axis[j] = axis[j - 1];
      axis[j - 1] = t;
    }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  *ord = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[axis[i]]);
    strides[i] = st[axis[i]] * sizeof(__nv_bfloat16);
    if (strides[i] % 16 != 0) return cudaErrorInvalidValue;
    *ord |= axis[i] << (2 * i);
  }
  cuuint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i)
    if (axis[i] == 0) box[i + 1] = kTcBK;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

template <int D>
cudaError_t flash_tc_launch_d(const FlashTcArgs& a, cudaStream_t st) {
  constexpr size_t smem = flash_tc_smem_bytes<D>();
  auto kernel = flash_tc_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kTcBQ - 1) / kTcBQ, a.b * a.hq);
  kernel<<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The bf16 entry: tensor maps for q, k and v, then one launch. A stride or
// base the TMA cannot take returns cudaErrorInvalidValue, a map the driver
// refuses cudaErrorInvalidPitchValue, a driver without the encoder
// cudaErrorNotSupported.
inline int flash_tc_launch(const FlashArgs& f, int d, void* stream) {
  if (f.b <= 0 || f.hq <= 0 || f.hkv <= 0 || f.s <= 0 || f.hq % f.hkv != 0 || f.window < 0 ||
      static_cast<long long>(f.b) * f.hq > 65535 || (d != 64 && d != 128 && d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashTcArgs a{};
  cudaError_t err = make_map(&a.tq, &a.ord_q, f.q, d, f.s, f.hq, f.b, f.q_ss, f.q_sh, f.q_sb);
  if (err == cudaSuccess)
    err = make_map(&a.tk, &a.ord_k, f.k, d, f.s, f.hkv, f.b, f.k_ss, f.k_sh, f.k_sb);
  if (err == cudaSuccess)
    err = make_map(&a.tv, &a.ord_v, f.v, d, f.s, f.hkv, f.b, f.v_ss, f.v_sh, f.v_sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.o = static_cast<__nv_bfloat16*>(f.o);
  a.b = f.b, a.hq = f.hq, a.hkv = f.hkv, a.s = f.s;
  a.o_sb = f.o_sb, a.o_sh = f.o_sh, a.o_ss = f.o_ss;
  a.scale = f.scale, a.softcap = f.softcap, a.causal = f.causal, a.window = f.window;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(flash_tc_launch_d<64>(a, st));
    case 128: return static_cast<int>(flash_tc_launch_d<128>(a, st));
    default: return static_cast<int>(flash_tc_launch_d<256>(a, st));
  }
}

}  // namespace repro

extern "C" {

// q, k, v, o: element strides (batch, head, position), feature stride 1;
// softcap 0 and window 0 mean none; causal 0 or 1. f32 runs the SIMT
// kernel, bf16 the tensor-core kernel.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int hkv, int s, int d, int q_sb, int q_sh, int q_ss, int k_sb, int k_sh,
                        int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int o_ss,
                        float scale, float softcap, int causal, int window, void* stream) {
  const repro::FlashArgs a{q, k, v, o, b, hq, hkv, s, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, softcap, causal, window};
  return repro::flash_launch<float>(a, d, stream);
}
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq,
                         int hkv, int s, int d, int q_sb, int q_sh, int q_ss, int k_sb, int k_sh,
                         int k_ss, int v_sb, int v_sh, int v_ss, int o_sb, int o_sh, int o_ss,
                         float scale, float softcap, int causal, int window, void* stream) {
  const repro::FlashArgs a{q, k, v, o, b, hq, hkv, s, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, softcap, causal, window};
  return repro::flash_tc_launch(a, d, stream);
}

}  // extern "C"
