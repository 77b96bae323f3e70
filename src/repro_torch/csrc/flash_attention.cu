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
// pl.when. Order of operations, kept here: scale, then softcap·tanh(s/softcap),
// then the mask (masked logits −1e30), then the online max; the denominator
// is floored at 1e-30; the math is f32 for f32 and bf16 I/O and the output
// is written once in the input type.
//
// What bounds it here: operations. One call does 4·D·pairs·B·Hq of them,
// where pairs counts the reachable (q, k) pairs (S(S+1)/2 causal, about S·W
// under a window W), against the bytes of Q, K, V and O read or written
// once. At gemma2-2b's prefill (B = 1, Hq 8, Hkv 4, S 8,192, D 256, bf16)
// that is 2.8e11 operations against 1e8 bytes: 0.28 ms at the 989 TFLOP/s
// of bf16 tensor cores, 0.03 ms for the bytes. What the design does about it
// (a simple kernel that is right first; it runs on the f32 SIMT cores, not
// the tensor cores, so it is far from the bound):
//   * one block of 256 threads per (b·Hq, 64-query tile); the tiles of the
//     causal diagonal's far end, which have the most keys, are launched
//     first;
//   * the key loop runs only over the reachable tiles, from
//     max(0, q_start − W + 1) to the causal frontier (the Pallas kernel's
//     pl.when skip): a local layer does O(S·W) work, not O(S²);
//   * Q, K and V tiles are staged in shared memory as f32 (bf16 widened on
//     load), the 64 × 64 logits tile too; the running max and denominator
//     stay in registers of the warp that owns the row, and the 64 × D
//     accumulator is split over the block's threads, 4 rows × D/16 columns
//     each (64 registers at D = 256);
//   * q, k, v and o are addressed through their batch, head and sequence
//     strides (the feature stride must be 1), so the (B, S, H, D) layout of
//     the projections is read and written as it is, with no transposed copy;
//     ragged S is masked in the loader (rows past S read as 0), nothing is
//     padded;
//   * at D = 256 the tiles take 214 KB of shared memory, above the 48 KB
//     static limit: the launch opts in with cudaFuncSetAttribute first, and
//     a refused launch is reported by cudaGetLastError.
// Tensor cores (wgmma, with P in bf16), TMA and a split of the key loop are
// later work.
#include "common.cuh"

#include <cstddef>

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

}  // namespace repro

extern "C" {

// q, k, v, o: element strides (batch, head, position), feature stride 1;
// softcap 0 and window 0 mean none; causal 0 or 1.
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
  return repro::flash_launch<__nv_bfloat16>(a, d, stream);
}

}  // extern "C"
