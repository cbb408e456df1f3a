// GQA flash-attention forward for Hopper (sm_90a).
//
//   rm_flash_attention_tc_kernel  (bfloat16)  <- repro/kernels/flash_attention.py  _flash_kernel
//   rm_flash_attention_kernel     (float32)   <- the same
//
// out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the keys j the mask allows: j < S, and causal 0 <= i - j < window, or
// bidirectional |i - j| < window (window = S when the layer has none).  q is
// (B, S, H, D), k and v (B, S, KH, D), out as q; G = H / KH query heads share
// one KV head.  The arithmetic is the reference kernel's: the logits in
// float32 with the scale applied in float32, masked logits set to -1e30 (not
// -inf), an online softmax over key tiles with float32 m, l and accumulator,
// p rounded to v's type before the PV product, and out = acc / max(l, 1e-30).
// Where FlashParams::lse is set (a forward whose gradient follows), both
// kernels also store each row's log-sum-exp, m + log l in natural log, as
// float32 (B, H, S): the backward (rm_flash_bwd.cu) rebuilds P from it.
// Serving passes null and stores nothing.
//
// What bounds it: operations, 4 D per unmasked (query, key) pair.  At the
// serving path's prefill shape (B 8, S 2,048, H 32, KH 8, D 128, bf16,
// causal) that is 4 B H D S (S + 1) / 2 = 2.75e11 operations, 0.278 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 0.100 ms to move Q, K, V and
// O once at 3.35 TB/s.  Only the tensor cores come near that rate, and only
// wgmma reaches their full rate, so the bf16 kernel is built around it.
//
// Both kernels share the plan: one block owns one (batch·head, query tile)
// and walks its key tiles in a loop (the Pallas grid carries its accumulator
// across the sequential k dimension in VMEM; blocks here run in no order, so
// nothing carries between them).  Key tiles that lie wholly outside the
// causal or window range are skipped: with -1e30 masking a fully masked tile
// adds exp(0) terms that a later real tile wipes out through
// alpha = exp(m_prev - m_new) = 0, so skipping changes nothing as long as
// every row meets a real key, which holds inside S (key = query is always
// allowed).  Query tiles are issued longest first.  The public (B, S, H, D)
// layout is read through its strides, with no transposed or padded copy;
// query rows past S are not stored.
//
// bfloat16: the tensor-core kernel.  A block of 384 threads owns 128 query
// rows: warpgroups 0 and 1 are the consumers, 64 rows each, warpgroup 2 the
// producer (setmaxnreg moves its registers to the consumers).
//   * TMA: one producer thread loads the Q tile once, then K and V tiles of
//     128 keys (64 at D 256, where the accumulators need the registers) into
//     a ring of two stages with full / empty mbarriers, so the copy of the
//     next tile overlaps the products of this one.  The tensor maps are
//     built on the host from the tensors' strides (dims D, H, S, B); rows
//     past S arrive as zeros (TMA's out-of-bounds fill) and are masked.
//     Tiles land in the 128-, 64- or 32-byte swizzle that the wgmma
//     descriptors name (D / 64 column chunks of 128-byte rows, or one chunk
//     of 2 D bytes at D 16 and 32).
//   * S = Q K^T by wgmma.mma_async, both operands from shared memory,
//     K-major, float32 accumulators; the scale is applied to the float32
//     logits, folded with log2(e) into an exp2 (q is never rounded scaled).
//   * Softmax in registers: a thread holds two rows of its warp's 16; row
//     maxima and sums are taken over the four threads sharing a row.  The
//     causal, window and tail masks are applied, without branches, only on
//     tiles that straddle a boundary of the warpgroup's rows.
//   * O += P V by a second wgmma: P is converted to bf16 in registers and fed
//     as the A operand (its accumulator layout is the A fragment's), V is
//     read from shared memory as an MN-major B operand (the transpose bit):
//     no copy of V is transposed in device memory.
//
// float32: the first, simple kernel on the CUDA cores (the tensor cores have
// no float32 product that meets the 1e-4 limit short of 3xTF32 splitting).
// One block of 16 warps owns a 64-query tile; Q is staged once as scaled
// float32, each 64-key K and V tile in turn (K rows padded by 4 floats, so a
// quarter-warp's 16-byte row reads hit 32 distinct banks); a warp owns 4
// query rows, a lane the logits of keys lane and lane + 32, then the online
// softmax and the p V product for the D / 32 output columns it owns.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rm_tma.cuh"     // mbarriers, the tensor-map encoder (CUtensorMap via <cuda.h>)
#include "rm_wgmma.cuh"   // TMA tile loads, wgmma descriptors and products, tensor maps

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_FlashParams), which
// checks sizeof at load time.  Strides are in elements.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, H, S) float32 m + log l of each row, natural log; null: not stored
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int32_t batch;
  int32_t seq;
  int32_t heads;
  int32_t kv_heads;
  int32_t head_dim;
  int32_t causal;
  int32_t window;    // >= 1; the wrapper passes S for "no window"
  int32_t dtype;     // 0 float32, 1 bfloat16
  float scale;
  int32_t pad_;
};

namespace {

constexpr float kMaskValue = -1e30f;

// ----------------------------------------------------------- float32 kernel
constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per staged tile
constexpr int kRows = 4;      // query rows per warp (the float4 p stores assume 4)
constexpr int kWarps = kBlockQ / kRows;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return 4 * (kBlockQ * D            // q_s
              + kBlockK * (D + 4)    // k_s
              + kBlockK * D          // v_s
              + kWarps * kBlockK * kRows);  // p_s
}

}  // namespace

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rm_flash_attention_kernel(const __grid_constant__ FlashParams p) {
  constexpr int kKs = D + 4;              // padded K row, in floats
  constexpr int kCols = (D + 31) / 32;    // output columns a lane owns
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlockQ * D;
  float* v_s = k_s + kBlockK * kKs;
  float* p_s = v_s + kBlockK * D;

  const int S = p.seq;
  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x);  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int e = threadIdx.x; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int i = q0 + r;
    q_s[e] = i < S ? q[i * p.q_ss + d] * p.scale : 0.0f;
  }

  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_lo = max(0, q0 - p.window + 1);
  const int k_hi = p.causal ? q_last : min(S - 1, q_last + p.window - 1);
  const int t_lo = k_lo / kBlockK, t_hi = k_hi / kBlockK;

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  float* pw = p_s + warp * kBlockK * kRows;  // this warp's p, [key][row]

  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int j = j0 + r;
      const bool in = j < S;
      k_s[r * kKs + d] = in ? k[j * p.k_ss + d] : 0.0f;
      v_s[e] = in ? v[j * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    // logits of keys lane and lane + 32 for the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* ka = k_s + lane * kKs;
    const float* kb = k_s + (lane + 32) * kKs;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ka + d);
      const float4 c = *reinterpret_cast<const float4*>(kb + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(q_s + (r0 + r) * D + d);
        s[r][0] += x.x * a.x + x.y * a.y + x.z * a.z + x.w * a.w;
        s[r][1] += x.x * c.x + x.y * c.y + x.z * c.z + x.w * c.w;
      }
    }

    float alpha[kRows], pa[kRows], pb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + r0 + r;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + lane + 32 * u;
        const int dist = i - j;
        bool ok = j < S && i < S;
        ok = ok && (p.causal ? (dist >= 0 && dist < p.window)
                             : (dist < p.window && -dist < p.window));
        if (!ok) s[r][u] = kMaskValue;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      pa[r] = expf(s[r][0] - m_new);
      pb[r] = expf(s[r][1] - m_new);
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + (pa[r] + pb[r]);
      m[r] = m_new;
    }
    // one 16-byte store per key: the warp's stores fill whole rows of banks
    *reinterpret_cast<float4*>(pw + lane * kRows) = make_float4(pa[0], pa[1], pa[2], pa[3]);
    *reinterpret_cast<float4*>(pw + (lane + 32) * kRows) = make_float4(pb[0], pb[1], pb[2], pb[3]);
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pw + j * kRows);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vv = v_s[j * D + d];
          acc[0][c] += pj.x * vv;
          acc[1][c] += pj.y * vv;
          acc[2][c] += pj.z * vv;
          acc[3][c] += pj.w * vv;
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + r0 + r;
    const float sum = warp_sum(l[r]);
    const float denom = fmaxf(sum, 1e-30f);
    if (i >= S) continue;
    if (p.lse != nullptr && lane == 0) p.lse[static_cast<long long>(bh) * S + i] = m[r] + logf(sum);
    float* o = static_cast<float*>(p.out) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[r][c] / denom;
    }
  }
}

// ------------------------------------------------ bfloat16 tensor-core kernel
namespace tc {

constexpr int kBlockM = 128;         // query rows per block
constexpr int kConsumers = 2;        // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kStages = 2;           // K / V ring depth
// 384 threads launch with 168 registers each; setmaxnreg hands the
// producer's to the consumers: 40 * 128 + 232 * 256 <= 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = kMaskValue * kLog2e;  // -1e30 in the exp2 domain
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int kBlockN = D <= 128 ? 128 : 64;     // keys per K / V tile
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes of a swizzled row
  static constexpr int kChunk = kSwizzle / 2;              // columns a TMA box carries
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 128 + 1024;  // barriers, then alignment slack
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kPvN = D < 128 ? D : 128;  // width of one PV wgmma
};

using namespace rm_tma;
using namespace rm_wgmma;

// One key tile's online-softmax step for a thread's two rows (r = 0, 1: the
// fragment entries e with (e >> 1) & 1 == r).  `sc` holds the raw logits
// q . k and returns the probabilities; `m` (exp2 domain) and `l` are updated
// and `alpha` gets the factor the accumulator rows are rescaled by.  kMask:
// entry e sits at fragment column c = 8 (e / 4) + (e & 1), allowed for row r
// when lo[r] <= c <= hi[r], else -1e30 as the reference masks.  Unmasked
// tiles take the maximum of the raw logits and fold the scale into one FFMA
// before the exp2; masked ones subtract in the exp2 domain, so a row whose
// logits are all masked gets exp2(0) = 1 exactly, as the reference's exp(0).
template <bool kMask, int kN>
__device__ __forceinline__ void softmax_step(float (&sc)[kN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2,
                                             const int* lo, const int* hi) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const int r = (e >> 1) & 1;
    if (kMask) {
      const int c = 8 * (e / 4) + (e & 1);
      sc[e] = (c >= lo[r] && c <= hi[r]) ? sc[e] * scale_log2 : kMaskLog2;
    }
    mx[r] = fmaxf(mx[r], sc[e]);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (!kMask) mx[r] *= scale_log2;
    mx[r] = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    const int r = (e >> 1) & 1;
    sc[e] = exp2_approx(kMask ? sc[e] - mx[r] : fmaf(sc[e], scale_log2, -mx[r]));
    sum[r] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
rm_flash_attention_tc_kernel(const __grid_constant__ FlashParams p,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v) {
  using namespace tc;
  using T = Tile<D>;
  constexpr int kN = T::kBlockN;
  constexpr int kSw = T::kSwizzle;
  extern __shared__ uint8_t smem_raw[];
  // tiles at a 1,024-byte boundary: the swizzle pattern repeats every 1,024 bytes
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::kQBytes;                     // + stage * kKVBytes
  const uint32_t v_s = k_s + kStages * T::kKVBytes;           // + stage * kKVBytes
  const uint32_t bars = base + T::kBarOffset;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int S = p.seq;
  const int n_q = (S + kBlockM - 1) / kBlockM;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kBlockM;  // longest tiles first
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int kh = h / (p.heads / p.kv_heads);
  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kBlockM, S) - 1;
  const int k_lo = max(0, q0 - p.window + 1);
  const int k_hi = p.causal ? q_last : min(S - 1, q_last + p.window - 1);
  const int t_lo = k_lo / kN, t_hi = k_hi / kN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * kBlockM * kSw, &map_q, q_full, c * T::kChunk, h, q0, b);
      for (int t = t_lo, it = 0; t <= t_hi; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes at once
        const uint32_t ks = k_s + s * T::kKVBytes, vs = v_s + s * T::kKVBytes;
        mbar_expect_tx(k_full(s), T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(ks + c * kN * kSw, &map_k, k_full(s), c * T::kChunk, kh, t * kN, b);
        mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(vs + c * kN * kSw, &map_v, v_full(s), c * T::kChunk, kh, t * kN, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
    const int wgc = threadIdx.x / 128;        // this warpgroup's 64 rows
    const int warp = (threadIdx.x / 32) % 4;  // 16 rows each
    const int lane = threadIdx.x % 32;
    const int r_a = 16 * warp + lane / 4;     // a thread's two rows: r_a and r_a + 8
    const int i_lo = q0 + 64 * wgc;
    const int i_a = i_lo + r_a;
    const float scale_log2 = p.scale * kLog2e;

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    // a thread's two rows, r_a and r_a + 8: running maxima (exp2 domain), this
    // thread's part of the running sums, and each tile's rescale factor
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
    float sc[kN / 2];         // one tile's logits, then its probabilities
    uint32_t pa[kN / 16][4];  // the probabilities as bf16 A fragments

    // Each tile runs QK, softmax, PV in turn.  (Issuing the next tile's QK
    // before this tile's softmax, as FlashAttention-3 does, needs the logits
    // of two tiles live at once: past the consumers' registers here, see
    // PERF.md.)
    auto issue_qk = [&](int s) {
      const uint32_t ks = k_s + s * T::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / T::kChunk, col = kk * 16 % T::kChunk;
        const uint64_t da = desc(q_s + c * kBlockM * kSw + 64 * wgc * kSw + 2 * col,
                                 16, 8 * kSw, T::kLayout);
        const uint64_t db = desc(ks + c * kN * kSw + 2 * col, 16, 8 * kSw, T::kLayout);
        wgmma_ss<kN>(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&](int s) {
      const uint32_t vs = v_s + s * T::kKVBytes;
#pragma unroll
      for (int u = 0; u < kN / 16; ++u) {
#pragma unroll
        for (int n = 0; n < D / T::kPvN; ++n) {
          const uint64_t db = desc(vs + n * (T::kPvN / T::kChunk) * kN * kSw + 16 * u * kSw,
                                   kN * kSw, 8 * kSw, T::kLayout);
          wgmma_rs<T::kPvN>(*reinterpret_cast<float(*)[T::kPvN / 2]>(o + n * T::kPvN / 2), pa[u],
                            db);
        }
      }
      wg_commit();
    };
    // the softmax of tile t on sc (masks only where the tile straddles a
    // boundary of this warpgroup's rows)
    auto softmax = [&](int t) {
      const int j0 = t * kN, j_last = j0 + kN - 1;
      const bool edge = j_last >= S
          || (p.causal ? (j_last > i_lo || i_lo + 63 - j0 >= p.window)
                       : (i_lo + 63 - j0 >= p.window || j_last - i_lo >= p.window));
      if (edge) {
        // the keys a row may see, as columns of this thread's fragment
        const int base = j0 + 2 * (lane % 4);
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i_a + 8 * r;
          lo[r] = i - p.window + 1 - base;
          hi[r] = min(p.causal ? i : i + p.window - 1, S - 1) - base;
        }
        softmax_step<true, kN>(sc, m, l, alpha, scale_log2, lo, hi);
      } else {
        softmax_step<false, kN>(sc, m, l, alpha, scale_log2, nullptr, nullptr);
      }
    };
    // P in bf16 as the A fragments of the PV product (16 keys each)
    auto pack = [&] {
#pragma unroll
      for (int u = 0; u < kN / 16; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[u][r] = pack_bf16(sc[8 * u + 2 * r], sc[8 * u + 2 * r + 1]);
    };
    mbar_wait(q_full, 0);
    for (int t = t_lo, it = 0; t <= t_hi; ++t, ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      mbar_wait(k_full(s), ph);
      wg_fence();
      issue_qk(s);
      wg_wait_all();
      reg_fence(sc);
      softmax(t);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      pack();
      mbar_wait(v_full(s), ph);
      wg_fence();
      issue_pv(s);
      wg_wait_all();
      reg_fence(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
    // the row's log-sum-exp for the backward, in natural log: m is in the
    // exp2 domain of the scaled logits, so lse = (m + log2 l) ln 2
    if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i_a + 8 * r;
        if (i < S) p.lse[static_cast<long long>(bh) * S + i] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int i = i_a + ((e & 2) ? 8 : 0);
      const int col = 128 * (e / 64) + 8 * ((e % 64) / 4) + 2 * (lane % 4);
      if (i < S)
        *reinterpret_cast<__nv_bfloat162*>(out + i * p.o_ss + col) = __floats2bfloat162_rn(
            o[e] / den[(e >> 1) & 1], o[e + 1] / den[(e >> 1) & 1]);
    }
  }
}

namespace {

template <int D>
int launch_f32(const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(rm_flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, p.batch * p.heads);
  rm_flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const FlashParams& p, cudaStream_t stream) {
  using T = tc::Tile<D>;
  CUtensorMap mq, mk, mv;
  using rm_wgmma::tensor_map;
  const int d = p.head_dim, s = p.seq, b = p.batch;
  int err = tensor_map(&mq, p.q, d, p.heads, s, b, p.q_sb, p.q_ss, p.q_sh, tc::kBlockM,
                       T::kChunk, T::kSwizzle);
  if (err == 0)
    err = tensor_map(&mk, p.k, d, p.kv_heads, s, b, p.k_sb, p.k_ss, p.k_sh, T::kBlockN,
                     T::kChunk, T::kSwizzle);
  if (err == 0)
    err = tensor_map(&mv, p.v, d, p.kv_heads, s, b, p.v_sb, p.v_ss, p.v_sh, T::kBlockN,
                     T::kChunk, T::kSwizzle);
  if (err != 0) return err;
  const cudaError_t set = cudaFuncSetAttribute(
      rm_flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(p.batch * p.heads, (p.seq + tc::kBlockM - 1) / tc::kBlockM);
  rm_flash_attention_tc_kernel<D><<<grid, tc::kThreads, T::kSmem, stream>>>(p, mq, mk, mv);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_dim(const FlashParams& p, cudaStream_t s) {
  switch (p.head_dim) {
    case 16: return kBf16 ? launch_bf16<16>(p, s) : launch_f32<16>(p, s);
    case 32: return kBf16 ? launch_bf16<32>(p, s) : launch_f32<32>(p, s);
    case 64: return kBf16 ? launch_bf16<64>(p, s) : launch_f32<64>(p, s);
    case 128: return kBf16 ? launch_bf16<128>(p, s) : launch_f32<128>(p, s);
    case 256: return kBf16 ? launch_bf16<256>(p, s) : launch_f32<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int rm_flash_params_size() { return static_cast<int>(sizeof(FlashParams)); }

// Launch on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  The wrapper has checked shapes,
// types, strides and alignment; a bad head_dim or dtype is refused here too.
int rm_flash_attention(const FlashParams* params, void* stream) {
  const FlashParams& p = *params;
  if (p.seq <= 0 || p.batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0 || p.window < 1 || p.batch * p.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) return launch_dim<false>(p, s);
  if (p.dtype == 1) return launch_dim<true>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
