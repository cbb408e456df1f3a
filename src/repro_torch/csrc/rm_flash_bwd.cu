// GQA flash-attention backward for Hopper (sm_90a).
//
//   rm_flash_bwd_prep_kernel          delta and the padded lse of every row
//   rm_flash_bwd_dkdv_tc_kernel       (bfloat16, D <= 128)  dK and dV
//   rm_flash_bwd_dq_tc_kernel         (bfloat16, D <= 128)  dQ
//   rm_flash_bwd_dkdv_wide_kernel     (bfloat16, D 256)     dK and dV
//   rm_flash_bwd_dq_wide_kernel       (bfloat16, D 256)     dQ
//   rm_flash_bwd_simt_kernel<kKV>     (float32)
//
// No Pallas kernel is replaced: repro/kernels/flash_attention.py has no
// backward, and the reference's gradient is XLA's differentiation of the
// checkpointed blockwise step (repro/models/layers.py:292-298).  These
// kernels compute that gradient from the forward's saved log-sum-exp rather
// than by recomputing the online softmax.  With q (B, S, H, D), k and v
// (B, S, KH, D), G = H / KH, the mask of rm_flash.cu (j < S; causal
// 0 <= i - j < window, or bidirectional |i - j| < window) and
// scale = D^-1/2:
//
//   P_ij  = exp(scale q_i . k_j - lse_i)   where (i, j) is allowed, else 0
//   D_i   = sum_d dO_id O_id                (float32, O the forward's output)
//   dV_j  = sum_i P_ij dO_i                 dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j           dK_j  = scale sum_i dS_ij q_i
//
// summed over the G query heads of a KV head for dK and dV.  In bfloat16, P
// and dS are rounded to bf16 before the products that take them (dV, and
// dQ, dK), as the plain version (flash_attention_backward_torch) rounds them.
//
// What bounds it: operations.  The least work is 5 products of 2 D
// operations a pair (QK, dO V, P^T dO, dS K, dS^T Q), 2.5 times the
// forward's; at a qwen3-8b training layer (B 2, S 2,048, 32 / 8 heads,
// D 128, causal) that is 1.72e11 operations, 0.174 ms at 989 TFLOP/s.
//
// Design: three launches on one stream, deterministic (no atomics on
// values), so two calls on the same inputs give bit-equal gradients.
//   1. prep: one warp a row writes D_i and lse_i (times log2 e in the
//      tensor-core forms) into (B H, seq_pad) scratch, 0 and +inf on rows
//      past S: a row past S then has P = exp2(x - inf) = 0 whatever its
//      logits, besides the explicit mask.  It also zeroes the D 256 form's
//      per-key-tile counters.
//   2. dK / dV: one block owns 128 keys of one (b, kv head): K and V come in
//      once by TMA, then Q, dO, lse and D tiles of 64 queries stream through
//      a two-stage ring for every query tile in range of every head of the
//      group.  S^T = K Q^T and dP^T = V dO^T are wgmma products whose
//      accumulators hold P^T and dS^T in the layout of the A fragment of
//      the next products, dV += P^T dO and dK += dS^T Q (B read MN-major from
//      the same tiles, no transposed copy).  dK and dV sum in registers over
//      the whole group: no atomics, no float32 scratch.
//   3. dQ: one block owns 128 query rows of one (b, head), as the forward:
//      Q, dO once, then 64-key K and V tiles through the ring; S = Q K^T,
//      dP = dO V^T, then dQ += dS K.
// Seven products a pair where a single pass needs five: the price of
// bit-equal gradients without a float32 dQ buffer summed by atomics.
// The dK / dV pass holds two 64 x D float32 accumulators and the 64 x 64
// S^T and dP^T at once: its blocks are two warpgroups, 256 threads of 255
// registers, and thread 0 issues the copies besides its share of the
// products (ptxas gave the 288 threads of a block with a producer warp 168
// registers each, as for 384, and spilled).  The dQ pass fits 168: two
// consumer warpgroups and a producer warp.  Key tiles wholly
// outside the causal or window range are skipped in both passes; the mask
// is applied (to rows and keys) only on tiles that straddle a boundary.
//
// bfloat16 at D 256 (recurrentgemma-9b's local attention): a 64 x 256
// float32 accumulator is 128 registers a thread of a warpgroup, so one
// warpgroup cannot hold dK and dV at once.  The wide form gives each its
// own warpgroup, in blocks of 64 keys:
//   * WG-V computes S^T = K Q^T, turns it into P^T, leaves P^T (float32,
//     16 KB) in shared memory for WG-K and runs dV += P^T dO; WG-K computes
//     dP^T = V dO^T, waits on a named barrier for P^T, forms dS^T and runs
//     dK += dS^T Q.  Two named barriers hand the one P^T buffer back and
//     forth.  Shared memory: K and V 64 KB, a two-stage ring of 64-query Q
//     and dO tiles 128 KB, P^T 16 KB: 210 KB, one block an SM.
//   * MQA / GQA leaves few blocks of 64 keys (recurrentgemma: B 2 x 1 KV
//     head x 32 tiles = 64 at S 2,048, the low causal ones 16 times the
//     high ones' work), so a key tile's (head, query tile) items are cut
//     into chunks of at most FlashBwdParams::kv_chunk (planned by
//     _cuda.flash_bwd_kv_plan for the card's SMs).  A tile cut in more
//     than one chunk writes float32 partials to scratch; the tile's last
//     block (a counter a tile, the only atomic) sums them in chunk order,
//     so the gradients stay bit-equal from call to call.
//   * dQ: a block owns 128 query rows, 64 a warpgroup (dQ 128 registers,
//     S and dP 32), thread 0 issues the copies; Q and dO 128 KB and a
//     two-stage ring of 32-key K and V tiles 64 KB, so that two warpgroups
//     share the tensor cores and each K / V tile serves 128 rows.  A
//     warpgroup skips the products of a key tile none of its rows sees.
//
// float32: the same two passes on the CUDA cores (no tensor-core product
// meets float32's tolerance), templated on the pass.  A block stages 64
// stationary rows (32 at D 256) of Q and dO (dQ pass) or K and V (dK / dV
// pass) as float32, then streams 64-row tiles of the other pair; a warp
// owns 4 stationary rows, a lane the logits of streamed rows lane and
// lane + 32, then the D / 32 output columns it owns, as rm_flash.cu's
// float32 kernel.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rm_tma.cuh"
#include "rm_wgmma.cuh"

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_FlashBwdParams), which
// checks sizeof at load time.  Strides are in elements.
struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;   // the forward's output, q's layout and type
  const void* dout;  // its gradient
  const float* lse;  // (B, H, S) float32, the forward's, natural log
  void* dq;
  void* dk;
  void* dv;          // dk's strides
  float* lse_pad;    // scratch (B H, seq_pad): lse in the form's units, +inf past S
  float* delta;      // scratch (B H, seq_pad): D_i, 0 past S
  float* kv_part;    // D 256 scratch: (B KH, kv_blocks, 2, 64, 256) dV and dK partials
  int32_t* kv_count; // D 256 scratch: (B KH, ceil(S / 64)) blocks done a key tile
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  int32_t batch;
  int32_t seq;
  int32_t heads;
  int32_t kv_heads;
  int32_t head_dim;
  int32_t causal;
  int32_t window;    // >= 1; the wrapper passes S for "no window"
  int32_t dtype;     // 0 float32, 1 bfloat16
  int32_t seq_pad;   // S rounded up to a multiple of kSeqPad
  int32_t kv_chunk;  // D 256: (head, query tile) items a dK / dV block at most
  int32_t kv_blocks; // D 256: dK / dV blocks a (b, kv head), as kv_chunk cuts the key tiles
  float scale;
};

namespace {

constexpr int kSeqPad = 128;  // the scratch rows' padding: a multiple of every tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcMaxD = 256;  // the widest head of the tensor-core forms

// bfloat16 takes the tensor cores (wgmma, log2 units), float32 the CUDA cores
__host__ __device__ __forceinline__ bool tensor_form(const FlashBwdParams& p) {
  return p.dtype == 1 && p.head_dim <= kTcMaxD;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x as the products see it: rounded to T (bf16), unchanged in float32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (i, j) allowed: both inside S and inside the causal or window range
__device__ __forceinline__ bool allowed(const FlashBwdParams& p, int i, int j) {
  const int dist = i - j;
  return i < p.seq && j < p.seq &&
         (p.causal ? (dist >= 0 && dist < p.window) : (dist < p.window && -dist < p.window));
}

}  // namespace

// ----------------------------------------------------------------- prep
template <typename T>
__global__ void __launch_bounds__(256)
rm_flash_bwd_prep_kernel(const __grid_constant__ FlashBwdParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp;
  const int bh = blockIdx.y;
  if (p.kv_count != nullptr) {  // the D 256 form's counters: fewer than the grid's threads
    const long long at = (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 256 +
                         threadIdx.x;
    if (at < static_cast<long long>(p.batch) * p.kv_heads * ((p.seq + 63) / 64))
      p.kv_count[at] = 0;
  }
  if (i >= p.seq_pad) return;
  const int b = bh / p.heads, h = bh % p.heads;
  float sum = 0.0f;
  if (i < p.seq) {
    const T* o = static_cast<const T*>(p.out) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
    const T* g = static_cast<const T*>(p.dout) + b * p.g_sb + i * p.g_ss + h * p.g_sh;
    for (int d = lane; d < p.head_dim; d += 32) sum += to_f(o[d]) * to_f(g[d]);
    sum = warp_sum(sum);
  }
  if (lane == 0) {
    const long long at = static_cast<long long>(bh) * p.seq_pad + i;
    const float lse = i < p.seq ? p.lse[static_cast<long long>(bh) * p.seq + i] : INFINITY;
    p.delta[at] = i < p.seq ? sum : 0.0f;
    p.lse_pad[at] = tensor_form(p) ? lse * kLog2e : lse;
  }
}

// ------------------------------------------------- bfloat16 tensor cores
namespace bwd {

using namespace rm_tma;
using namespace rm_wgmma;

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32;    // dQ: and one producer warp
constexpr int kKvThreads = 128 * kConsumers;       // dK / dV: thread 0 issues the copies
constexpr int kStages = 2;                         // ring depth

template <int D>
struct Tile {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes of a swizzled row
  static constexpr int kChunk = kSwizzle / 2;                 // columns a TMA box carries
  static constexpr int kChunks = D / kChunk;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kPvN = D < 128 ? D : 128;  // width of one register-A wgmma
  // dK / dV pass: 128 keys a block (64 a warpgroup), 64-query tiles streamed
  static constexpr int kKeys = 128;
  static constexpr int kQ = 64;
  static constexpr int kKeyBytes = kKeys * D * 2;  // the block's K (and V)
  static constexpr int kQBytes = kQ * D * 2;       // a stage's Q (and dO)
  static constexpr int kVecBytes = kQ * 4;         // a stage's lse (and D)
  static constexpr int kKvQ = 2 * kKeyBytes;
  static constexpr int kKvG = kKvQ + kStages * kQBytes;
  static constexpr int kKvLse = kKvG + kStages * kQBytes;
  static constexpr int kKvDelta = kKvLse + kStages * kVecBytes;
  static constexpr int kKvBars = kKvDelta + kStages * kVecBytes;
  static constexpr int kKvSmem = kKvBars + 64 + 1024;  // barriers, then alignment slack
  // dQ pass: 128 query rows a block (64 a warpgroup), 64-key tiles streamed
  static constexpr int kRows = 128;
  static constexpr int kN = 64;
  static constexpr int kRowBytes = kRows * D * 2;  // the block's Q (and dO)
  static constexpr int kNBytes = kN * D * 2;       // a stage's K (and V)
  static constexpr int kDqK = 2 * kRowBytes;
  static constexpr int kDqV = kDqK + kStages * kNBytes;
  static constexpr int kDqBars = kDqV + kStages * kNBytes;
  static constexpr int kDqSmem = kDqBars + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// acc (64 x N) (+)= A (64 rows of `a`, a tile of `a_rows` rows) . B^T (the N
// rows of `bt`), both K-major with D columns, over all of D
template <int D, int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t a, int a_rows,
                                           int a_row0, uint32_t bt) {
  using T = Tile<D>;
  constexpr int kSw = T::kSwizzle;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / T::kChunk, col = kk * 16 % T::kChunk;
    const uint64_t da = desc(a + c * a_rows * kSw + a_row0 * kSw + 2 * col, 16, 8 * kSw,
                             T::kLayout);
    const uint64_t db = desc(bt + c * N * kSw + 2 * col, 16, 8 * kSw, T::kLayout);
    wgmma_ss<N>(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A (64 x kRowsB, bf16 fragments) . B (the kRowsB x D tile
// `b`, read MN-major)
template <int D, int kRowsB>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&a)[kRowsB / 16][4],
                                           uint32_t b) {
  using T = Tile<D>;
  constexpr int kSw = T::kSwizzle;
#pragma unroll
  for (int u = 0; u < kRowsB / 16; ++u) {
#pragma unroll
    for (int n = 0; n < D / T::kPvN; ++n) {
      const uint64_t db = desc(b + n * (T::kPvN / T::kChunk) * kRowsB * kSw + 16 * u * kSw,
                               kRowsB * kSw, 8 * kSw, T::kLayout);
      wgmma_rs<T::kPvN>(*reinterpret_cast<float(*)[T::kPvN / 2]>(acc + n * T::kPvN / 2), a[u],
                        db);
    }
  }
}

template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int u = 0; u < N / 16; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[u][r] = pack_bf16(x[8 * u + 2 * r], x[8 * u + 2 * r + 1]);
}

// Store a warpgroup's 64 x D accumulator (times `mul`) as bf16 rows
// row_a and row_a + 8 of a thread, rows >= S dropped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[D / 2], float mul, int row_a,
                                           int seq, int lane) {
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int i = row_a + ((e & 2) ? 8 : 0);
    const int col = 128 * (e / 64) + 8 * ((e % 64) / 4) + 2 * (lane % 4);
    if (i < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * row_stride + col) =
          __floats2bfloat162_rn(acc[e] * mul, acc[e + 1] * mul);
  }
}

}  // namespace bwd

template <int D>
__global__ void __launch_bounds__(bwd::kKvThreads, 1)
rm_flash_bwd_dkdv_tc_kernel(const __grid_constant__ FlashBwdParams p,
                            const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_g,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v) {
  using namespace bwd;
  using T = Tile<D>;
  constexpr int kSw = T::kSwizzle, kQ = T::kQ, kKeys = T::kKeys;
  extern __shared__ uint8_t smem_raw[];
  // tiles at a 1,024-byte boundary: the swizzle pattern repeats every 1,024 bytes
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t k_s = base, v_s = base + T::kKeyBytes;
  auto q_st = [&](int s) { return base + T::kKvQ + s * T::kQBytes; };
  auto g_st = [&](int s) { return base + T::kKvG + s * T::kQBytes; };
  const uint32_t bars = base + T::kKvBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int S = p.seq, W = p.window, G = p.heads / p.kv_heads;
  const int bkh = blockIdx.x;
  const int b = bkh / p.kv_heads, kh = bkh % p.kv_heads;
  const int k0 = blockIdx.y * kKeys;  // causal: the low keys, the longest blocks, first
  // the query tiles any key of this block is seen by, the same for every head
  const int k_last = min(k0 + kKeys, S) - 1;
  const int i_lo = p.causal ? k0 : max(0, k0 - W + 1);
  const int i_hi = min(S - 1, k_last + W - 1);
  const int qt_lo = i_lo / kQ, nq = i_hi / kQ - qt_lo + 1;
  const int items = G * nq;  // (head, query tile), head-major

  // Thread 0 is the producer as well as a consumer: a producer warp would
  // cost the registers the two 64 x D accumulators need (ptxas sizes every
  // thread of a 288-thread block as one of 384).  It fills item `it` into
  // stage it % 2 once the item two before is consumed: two items are in
  // flight before the loop, and each later one is issued as its stage frees.
  auto issue = [&](int it) {
    const int s = it % kStages;
    const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kQ;
    mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes at once
    mbar_expect_tx(full(s), 2 * T::kQBytes + 2 * T::kVecBytes);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(q_st(s) + c * kQ * kSw, &map_q, full(s), c * T::kChunk, h, q0, b);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(g_st(s) + c * kQ * kSw, &map_g, full(s), c * T::kChunk, h, q0, b);
    const long long row = static_cast<long long>(b * p.heads + h) * p.seq_pad + q0;
    bulk_load(base + T::kKvLse + s * T::kVecBytes, p.lse_pad + row, T::kVecBytes, full(s));
    bulk_load(base + T::kKvDelta + s * T::kVecBytes, p.delta + row, T::kVecBytes, full(s));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(kv_full, 2 * T::kKeyBytes);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(k_s + c * kKeys * kSw, &map_k, kv_full, c * T::kChunk, kh, k0, b);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(v_s + c * kKeys * kSw, &map_v, kv_full, c * T::kChunk, kh, k0, b);
    for (int it = 0; it < min(items, kStages); ++it) issue(it);
  }
  __syncthreads();

  const int wgc = threadIdx.x / 128;        // this warpgroup's 64 keys
  const int warp = (threadIdx.x / 32) % 4;  // 16 rows each
  const int lane = threadIdx.x % 32;
  const int r_a = 16 * warp + lane / 4;     // a thread's two rows: r_a and r_a + 8
  const int jw = k0 + 64 * wgc;
  const int j_a = jw + r_a;
  const float scale_log2 = p.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.0f;
  float st[kQ / 2], dpt[kQ / 2];            // S^T then P^T; dP^T then dS^T
  uint32_t pa[kQ / 16][4], da[kQ / 16][4];  // P^T and dS^T as bf16 A fragments

  mbar_wait(kv_full, 0);
  for (int it = 0; it < items; ++it) {
    const int s = it % kStages;
    const int q0 = (qt_lo + it % nq) * kQ;
    mbar_wait(full(s), (it / kStages) & 1);
    wg_fence();
    product_ss<D, kQ>(st, k_s, kKeys, 64 * wgc, q_st(s));
    product_ss<D, kQ>(dpt, v_s, kKeys, 64 * wgc, g_st(s));
    wg_commit();
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);

    // entry e: key row j_a + 8 ((e >> 1) & 1), query column c (below)
    const float* lse = reinterpret_cast<const float*>(gbase + T::kKvLse + s * T::kVecBytes);
    const float* dl = reinterpret_cast<const float*>(gbase + T::kKvDelta + s * T::kVecBytes);
    const int q_last = q0 + kQ - 1, j_last = jw + 63;
    const bool edge = q_last >= S || j_last >= S ||
                      (p.causal ? (q0 < j_last || q_last - jw >= W)
                                : (q_last - jw >= W || j_last - q0 >= W));
#pragma unroll
    for (int e = 0; e < kQ / 2; ++e) {
      const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
      float pr = exp2_approx(fmaf(st[e], scale_log2, -lse[c]));
      if (edge && !allowed(p, q0 + c, j_a + 8 * ((e >> 1) & 1))) pr = 0.0f;
      st[e] = pr;
      dpt[e] = pr * (dpt[e] - dl[c]);
    }
    pack<kQ>(pa, st);
    pack<kQ>(da, dpt);
    wg_fence();
    product_rs<D, kQ>(dv, pa, g_st(s));
    product_rs<D, kQ>(dk, da, q_st(s));
    wg_commit();
    wg_wait_all();
    reg_fence(dv);
    reg_fence(dk);
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && it + kStages < items) issue(it + kStages);
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kh * p.dk_sh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dk_sb + kh * p.dk_sh;
  store_rows<D>(dkp, p.dk_ss, dk, p.scale, j_a, S, lane);
  store_rows<D>(dvp, p.dk_ss, dv, 1.0f, j_a, S, lane);
}

template <int D>
__global__ void __launch_bounds__(bwd::kThreads, 1)
rm_flash_bwd_dq_tc_kernel(const __grid_constant__ FlashBwdParams p,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_g,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  using namespace bwd;
  using T = Tile<D>;
  constexpr int kSw = T::kSwizzle, kN = T::kN, kRows = T::kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, g_s = base + T::kRowBytes;
  auto k_st = [&](int s) { return base + T::kDqK + s * T::kNBytes; };
  auto v_st = [&](int s) { return base + T::kDqV + s * T::kNBytes; };
  const uint32_t bars = base + T::kDqBars;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int S = p.seq, W = p.window;
  const int n_q = (S + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kRows;  // longest tiles first
  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int kh = h / (p.heads / p.kv_heads);
  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_lo = max(0, q0 - W + 1);
  const int k_hi = p.causal ? q_last : min(S - 1, q_last + W - 1);
  const int t_lo = k_lo / kN, t_hi = k_hi / kN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * T::kRowBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * kRows * kSw, &map_q, q_full, c * T::kChunk, h, q0, b);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(g_s + c * kRows * kSw, &map_g, q_full, c * T::kChunk, h, q0, b);
      for (int t = t_lo, it = 0; t <= t_hi; ++t, ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::kNBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(k_st(s) + c * kN * kSw, &map_k, full(s), c * T::kChunk, kh, t * kN, b);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(v_st(s) + c * kN * kSw, &map_v, full(s), c * T::kChunk, kh, t * kN, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int wgc = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r_a = 16 * warp + lane / 4;
    const int i_lo = q0 + 64 * wgc;
    const int i_a = i_lo + r_a;
    const float scale_log2 = p.scale * kLog2e;
    // a thread's two rows' lse (exp2 domain) and D; rows past S read the
    // padding (+inf, 0): their P is 0
    float lse[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = static_cast<long long>(bh) * p.seq_pad + i_a + 8 * r;
      lse[r] = p.lse_pad[at];
      dl[r] = p.delta[at];
    }

    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.0f;
    float sc[kN / 2], dp[kN / 2];  // S then dS; dP
    uint32_t da[kN / 16][4];       // dS as bf16 A fragments

    mbar_wait(q_full, 0);
    for (int t = t_lo, it = 0; t <= t_hi; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      wg_fence();
      product_ss<D, kN>(sc, q_s, kRows, 64 * wgc, k_st(s));
      product_ss<D, kN>(dp, g_s, kRows, 64 * wgc, v_st(s));
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      const int j0 = t * kN, j_last = j0 + kN - 1;
      const bool edge = j_last >= S || i_lo + 63 >= S ||
                        (p.causal ? (j_last > i_lo || i_lo + 63 - j0 >= W)
                                  : (i_lo + 63 - j0 >= W || j_last - i_lo >= W));
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int r = (e >> 1) & 1;
        const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        float pr = exp2_approx(fmaf(sc[e], scale_log2, -lse[r]));
        if (edge && !allowed(p, i_a + 8 * r, j0 + c)) pr = 0.0f;
        sc[e] = pr * (dp[e] - dl[r]);
      }
      pack<kN>(da, sc);
      wg_fence();
      product_rs<D, kN>(dq, da, k_st(s));
      wg_commit();
      wg_wait_all();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(empty(s));
    }

    __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    store_rows<D>(dqp, p.dq_ss, dq, p.scale, i_a, S, lane);
  }
}

// ------------------------------------------- bfloat16 tensor cores, D 256
namespace wide {

using namespace rm_tma;
using namespace rm_wgmma;

constexpr int kD = 256;
constexpr int kRows = 64;                  // the rows of every tile
constexpr int kSw = 128, kChunk = 64;      // 128-byte swizzle: 64 columns a TMA box
constexpr int kChunks = kD / kChunk;
constexpr int kTileBytes = kRows * kD * 2;  // a 64 x 256 bf16 tile: 32 KB
constexpr int kVecBytes = kRows * 4;        // a stage's lse (and D)
constexpr int kAcc = kD / 2;                // a 64 x 256 accumulator's floats a thread
constexpr int kFrag = kRows / 2;            // a 64 x 64 product's floats a thread
constexpr int kKvThreads = 256;             // WG-V, then WG-K
constexpr int kDqThreads = 256;             // two warpgroups of 64 query rows
constexpr int kDqRows = 128;                // a dQ block's query rows
constexpr int kDqKeys = 32;                 // a dQ stage's keys
constexpr int kDqRowBytes = kDqRows * kD * 2;
constexpr int kDqKeyBytes = kDqKeys * kD * 2;
// dK / dV pass: K, V, two stages of Q and of dO, of lse and of D, then P^T
// (float32, entry e of thread t at e * 128 + t)
constexpr int kKvV = kTileBytes;
constexpr int kKvQ = 2 * kTileBytes;
constexpr int kKvG = kKvQ + bwd::kStages * kTileBytes;
constexpr int kKvLse = kKvG + bwd::kStages * kTileBytes;
constexpr int kKvDelta = kKvLse + bwd::kStages * kVecBytes;
constexpr int kKvP = kKvDelta + bwd::kStages * kVecBytes;
constexpr int kKvBars = kKvP + kFrag * 128 * 4;
constexpr int kKvSmem = kKvBars + 64 + 1024;  // barriers, then alignment slack
// dQ pass: Q, dO (128 rows), two stages of K and of V (32 keys)
constexpr int kDqG = kDqRowBytes;
constexpr int kDqK = 2 * kDqRowBytes;
constexpr int kDqV = kDqK + bwd::kStages * kDqKeyBytes;
constexpr int kDqBars = kDqV + bwd::kStages * kDqKeyBytes;
constexpr int kDqSmem = kDqBars + 64 + 1024;
static_assert(kKvSmem <= 232448 && kDqSmem <= 232448, "the D 256 tiles exceed shared memory");

// The 64-query tiles any key of the tile at k0 is seen by: their count, the
// first in qt_lo (mirrored by _cuda.flash_bwd_key_items)
__host__ __device__ __forceinline__ int key_tile_queries(const FlashBwdParams& p, int k0,
                                                         int& qt_lo) {
  const int k_last = (k0 + kRows < p.seq ? k0 + kRows : p.seq) - 1;
  const int i_lo = p.causal ? k0 : (k0 - p.window + 1 > 0 ? k0 - p.window + 1 : 0);
  const int i_hi = k_last + p.window - 1 < p.seq - 1 ? k_last + p.window - 1 : p.seq - 1;
  qt_lo = i_lo / kRows;
  return i_hi / kRows - qt_lo + 1;
}

// dK / dV blocks a (b, kv head): each key tile's G * queries items cut into
// chunks of at most kv_chunk
inline int kv_blocks(const FlashBwdParams& p) {
  const int g = p.heads / p.kv_heads;
  int n = 0, qt_lo = 0;
  for (int k0 = 0; k0 < p.seq; k0 += kRows)
    n += (g * key_tile_queries(p, k0, qt_lo) + p.kv_chunk - 1) / p.kv_chunk;
  return n;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

}  // namespace wide

__global__ void __launch_bounds__(wide::kKvThreads, 1)
rm_flash_bwd_dkdv_wide_kernel(const __grid_constant__ FlashBwdParams p,
                              const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_g,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v) {
  using namespace wide;
  using bwd::kStages, bwd::pack, bwd::product_rs, bwd::product_ss, bwd::smem_addr,
      bwd::store_rows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;  // this block sums the key tile's partials
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t k_s = base, v_s = base + kKvV;
  auto q_st = [&](int s) { return base + kKvQ + s * kTileBytes; };
  auto g_st = [&](int s) { return base + kKvG + s * kTileBytes; };
  float* pt = reinterpret_cast<float*>(gbase + kKvP);
  const uint32_t bars = base + kKvBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int S = p.seq, W = p.window, G = p.heads / p.kv_heads;
  const int bkh = blockIdx.y;
  const int b = bkh / p.kv_heads, kh = bkh % p.kv_heads;
  const int n_kt = (S + kRows - 1) / kRows;
  // this block's key tile (the low ones, the longest when causal, first)
  // and its chunk of the tile's (head, query tile) items, head-major
  int kt = 0, first = 0, splits = 1, qt_lo = 0, nq = 1;
  for (;; ++kt) {
    nq = key_tile_queries(p, kt * kRows, qt_lo);
    splits = (G * nq + p.kv_chunk - 1) / p.kv_chunk;
    if (static_cast<int>(blockIdx.x) < first + splits || kt + 1 == n_kt) break;
    first += splits;
  }
  const int split = static_cast<int>(blockIdx.x) - first;
  const int items = G * nq;
  const int it_lo = static_cast<int>(static_cast<long long>(split) * items / splits);
  const int n_it = static_cast<int>(static_cast<long long>(split + 1) * items / splits) - it_lo;
  const int k0 = kt * kRows;

  // Thread 128 (WG-K's first, the later of the two to free a stage) issues
  // the copies: item l into stage l % 2 once item l - 2 is consumed.
  auto issue = [&](int l) {
    const int it = it_lo + l, s = l % kStages;
    const int h = kh * G + it / nq, q0 = (qt_lo + it % nq) * kRows;
    mbar_wait(empty(s), ((l / kStages) & 1) ^ 1);  // the first round passes at once
    mbar_expect_tx(full(s), 2 * kTileBytes + 2 * kVecBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load(q_st(s) + c * kRows * kSw, &map_q, full(s), c * kChunk, h, q0, b);
    for (int c = 0; c < kChunks; ++c)
      tma_load(g_st(s) + c * kRows * kSw, &map_g, full(s), c * kChunk, h, q0, b);
    const long long row = static_cast<long long>(b * p.heads + h) * p.seq_pad + q0;
    bulk_load(base + kKvLse + s * kVecBytes, p.lse_pad + row, kVecBytes, full(s));
    bulk_load(base + kKvDelta + s * kVecBytes, p.delta + row, kVecBytes, full(s));
  };
  const bool producer = threadIdx.x == 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kKvThreads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(kv_full, 2 * kTileBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load(k_s + c * kRows * kSw, &map_k, kv_full, c * kChunk, kh, k0, b);
    for (int c = 0; c < kChunks; ++c)
      tma_load(v_s + c * kRows * kSw, &map_v, kv_full, c * kChunk, kh, k0, b);
    for (int l = 0; l < min(n_it, kStages); ++l) issue(l);
  }

  const int role = threadIdx.x / 128;  // 0: WG-V (P^T, dV), 1: WG-K (dS^T, dK)
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_a = 16 * warp + lane / 4;  // a thread's two keys: r_a and r_a + 8
  const int j_a = k0 + r_a;
  const float scale_log2 = p.scale * kLog2e;

  float acc[kAcc];  // dV (WG-V) or dK (WG-K)
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  float sp[kFrag];             // S^T then P^T (WG-V); dP^T then dS^T (WG-K)
  uint32_t fr[kRows / 16][4];  // P^T or dS^T as bf16 A fragments

  mbar_wait(kv_full, 0);
  for (int l = 0; l < n_it; ++l) {
    const int it = it_lo + l, s = l % kStages;
    const int q0 = (qt_lo + it % nq) * kRows;
    mbar_wait(full(s), (l / kStages) & 1);
    wg_fence();
    product_ss<kD, kRows>(sp, role == 0 ? k_s : v_s, kRows, 0, role == 0 ? q_st(s) : g_st(s));
    wg_commit();
    wg_wait_all();
    reg_fence(sp);

    // entry e: key row j_a + 8 ((e >> 1) & 1), query column c (below)
    const float* lse = reinterpret_cast<const float*>(gbase + kKvLse + s * kVecBytes);
    const float* dl = reinterpret_cast<const float*>(gbase + kKvDelta + s * kVecBytes);
    const int q_last = q0 + kRows - 1, j_last = k0 + kRows - 1;
    const bool edge = q_last >= S || j_last >= S ||
                      (p.causal ? (q0 < j_last || q_last - k0 >= W)
                                : (q_last - k0 >= W || j_last - q0 >= W));
    if (role == 0) {
      if (l > 0) named_sync(2, kKvThreads);  // WG-K has read the previous P^T
#pragma unroll
      for (int e = 0; e < kFrag; ++e) {
        const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        float pr = exp2_approx(fmaf(sp[e], scale_log2, -lse[c]));
        if (edge && !allowed(p, q0 + c, j_a + 8 * ((e >> 1) & 1))) pr = 0.0f;
        sp[e] = pr;
        pt[e * 128 + t] = pr;
      }
      named_arrive(1, kKvThreads);  // P^T is written
    } else {
      named_sync(1, kKvThreads);
#pragma unroll
      for (int e = 0; e < kFrag; ++e) {
        const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        sp[e] = pt[e * 128 + t] * (sp[e] - dl[c]);
      }
      if (l + 1 < n_it) named_arrive(2, kKvThreads);  // P^T is read
    }
    pack<kRows>(fr, sp);
    wg_fence();
    product_rs<kD, kRows>(acc, fr, role == 0 ? g_st(s) : q_st(s));
    wg_commit();
    wg_wait_all();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty(s));
    if (producer && l + kStages < n_it) issue(l + kStages);
  }

  // dK sums dS^T against unscaled q: the scale is taken here
  const float mul = role == 0 ? 1.0f : p.scale;
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(role == 0 ? p.dv : p.dk) + b * p.dk_sb +
                       kh * p.dk_sh;
  if (splits == 1) {
    store_rows<kD>(dst, p.dk_ss, acc, mul, j_a, S, lane);
    return;
  }
  // A partial of a cut tile: written where the tile's chunks lie side by
  // side, then summed in chunk order by the tile's last block to finish.
  constexpr long long kPart = static_cast<long long>(kRows) * kD;  // floats of one accumulator
  float* part = p.kv_part + (static_cast<long long>(bkh) * p.kv_blocks + first) * 2 * kPart;
  float* mine = part + (2LL * split + role) * kPart;
#pragma unroll
  for (int e = 0; e < kAcc; ++e) mine[e * 128 + t] = acc[e];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.kv_count + static_cast<long long>(bkh) * n_kt + kt, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int c = 0; c < splits; ++c) {
    const float* src = part + (2LL * c + role) * kPart;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] += __ldcg(src + e * 128 + t);
  }
  store_rows<kD>(dst, p.dk_ss, acc, mul, j_a, S, lane);
}

__global__ void __launch_bounds__(wide::kDqThreads, 1)
rm_flash_bwd_dq_wide_kernel(const __grid_constant__ FlashBwdParams p,
                            const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_g,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v) {
  using namespace wide;
  using bwd::kStages, bwd::pack, bwd::product_rs, bwd::product_ss, bwd::smem_addr,
      bwd::store_rows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, g_s = base + kDqG;
  auto k_st = [&](int s) { return base + kDqK + s * kDqKeyBytes; };
  auto v_st = [&](int s) { return base + kDqV + s * kDqKeyBytes; };
  const uint32_t bars = base + kDqBars;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int S = p.seq, W = p.window;
  const int n_q = (S + kDqRows - 1) / kDqRows;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kDqRows;  // longest tiles first
  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int kh = h / (p.heads / p.kv_heads);
  // the key tiles any row of this query tile can see
  const int q_last = min(q0 + kDqRows, S) - 1;
  const int k_lo = max(0, q0 - W + 1);
  const int k_hi = p.causal ? q_last : min(S - 1, q_last + W - 1);
  const int t_lo = k_lo / kDqKeys, n_t = k_hi / kDqKeys - t_lo + 1;

  // thread 0 issues the copies besides its share of the products: tile l
  // into stage l % 2 once both warpgroups have consumed tile l - 2
  auto issue = [&](int l) {
    const int s = l % kStages, j0 = (t_lo + l) * kDqKeys;
    mbar_wait(empty(s), ((l / kStages) & 1) ^ 1);
    mbar_expect_tx(full(s), 2 * kDqKeyBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load(k_st(s) + c * kDqKeys * kSw, &map_k, full(s), c * kChunk, kh, j0, b);
    for (int c = 0; c < kChunks; ++c)
      tma_load(v_st(s) + c * kDqKeys * kSw, &map_v, full(s), c * kChunk, kh, j0, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDqThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_full, 2 * kDqRowBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load(q_s + c * kDqRows * kSw, &map_q, q_full, c * kChunk, h, q0, b);
    for (int c = 0; c < kChunks; ++c)
      tma_load(g_s + c * kDqRows * kSw, &map_g, q_full, c * kChunk, h, q0, b);
    for (int l = 0; l < min(n_t, kStages); ++l) issue(l);
  }
  __syncthreads();

  const int wgc = threadIdx.x / 128;  // this warpgroup's 64 rows
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r_a = 16 * warp + lane / 4;
  const int i_lo = q0 + 64 * wgc;
  const int i_a = i_lo + r_a;
  const float scale_log2 = p.scale * kLog2e;
  // a thread's two rows' lse (exp2 domain) and D; rows past S read the
  // padding (+inf, 0): their P is 0
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = static_cast<long long>(bh) * p.seq_pad + i_a + 8 * r;
    lse[r] = p.lse_pad[at];
    dl[r] = p.delta[at];
  }

  float dq[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) dq[e] = 0.0f;
  float sc[kDqKeys / 2], dp[kDqKeys / 2];  // S then dS; dP
  uint32_t da[kDqKeys / 16][4];            // dS as bf16 A fragments

  mbar_wait(q_full, 0);
  for (int l = 0; l < n_t; ++l) {
    const int s = l % kStages;
    const int j0 = (t_lo + l) * kDqKeys, j_last = j0 + kDqKeys - 1;
    // a tile no row of this warpgroup sees (past the causal diagonal or the
    // window, or rows past S) is only released
    const bool live = i_lo < S && i_lo - j_last < W &&
                      (p.causal ? i_lo + 63 >= j0 : j0 - (i_lo + 63) < W);
    mbar_wait(full(s), (l / kStages) & 1);
    if (live) {
      wg_fence();
      product_ss<kD, kDqKeys>(sc, q_s, kDqRows, 64 * wgc, k_st(s));
      product_ss<kD, kDqKeys>(dp, g_s, kDqRows, 64 * wgc, v_st(s));
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      const bool edge = j_last >= S || i_lo + 63 >= S ||
                        (p.causal ? (j_last > i_lo || i_lo + 63 - j0 >= W)
                                  : (i_lo + 63 - j0 >= W || j_last - i_lo >= W));
#pragma unroll
      for (int e = 0; e < kDqKeys / 2; ++e) {
        const int r = (e >> 1) & 1;
        const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        float pr = exp2_approx(fmaf(sc[e], scale_log2, -lse[r]));
        if (edge && !allowed(p, i_a + 8 * r, j0 + c)) pr = 0.0f;
        sc[e] = pr * (dp[e] - dl[r]);
      }
      pack<kDqKeys>(da, sc);
      wg_fence();
      product_rs<kD, kDqKeys>(dq, da, k_st(s));
      wg_commit();
      wg_wait_all();
      reg_fence(dq);
    }
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && l + kStages < n_t) issue(l + kStages);
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<kD>(dqp, p.dq_ss, dq, p.scale, i_a, S, lane);
}

// ------------------------------------------------------------ CUDA cores
namespace simt {

constexpr int kC = 64;     // streamed rows a tile: two a lane
constexpr int kWRows = 4;  // stationary rows a warp (the float4 P / dS stores assume 4)

template <int D>
struct Tile {
  static constexpr int kR = D <= 128 ? 64 : 32;  // stationary rows a block
  static constexpr int kWarps = kR / kWRows;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kKs = D + 4;              // a padded streamed row, in floats
  static constexpr int kCols = (D + 31) / 32;    // output columns a lane owns
  static constexpr int kSmem = 4 * (2 * kR * D + 2 * kC * kKs + 2 * kWarps * kC * kWRows);
};

}  // namespace simt

// kKV: the dK / dV pass (stationary K and V of one (b, kv head), streamed Q
// scaled and dO of every head of the group); else the dQ pass (stationary Q
// scaled and dO of one (b, head), streamed K and V).  "Rows" are the
// stationary ones, "columns" the streamed ones.
template <typename T, int D, bool kKV>
__global__ void __launch_bounds__(simt::Tile<D>::kThreads, 1)
rm_flash_bwd_simt_kernel(const __grid_constant__ FlashBwdParams p) {
  using Tl = simt::Tile<D>;
  constexpr int kR = Tl::kR, kC = simt::kC, kKs = Tl::kKs, kCols = Tl::kCols;
  constexpr int kThreads = Tl::kThreads;
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [kR][D] Q scaled, or K
  float* b_s = a_s + kR * D;                     // [kR][D] dO, or V
  float* c_s = b_s + kR * D;                     // [kC][kKs] K, or Q scaled
  float* e_s = c_s + kC * kKs;                   // [kC][kKs] V, or dO
  float* pw_all = e_s + kC * kKs;                // [warps][kC][4] P
  float* dw_all = pw_all + Tl::kWarps * kC * simt::kWRows;  // [warps][kC][4] dS

  const int S = p.seq, W = p.window, G = p.heads / p.kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_t = (S + kR - 1) / kR;
  // longest first: the low keys (dK dV, causal), the high queries (dQ)
  const int row0 = (kKV ? static_cast<int>(blockIdx.x) : n_t - 1 - static_cast<int>(blockIdx.x)) * kR;
  const int grp = blockIdx.y;  // b KH + kh (dK dV) or b H + h (dQ)
  const int b = kKV ? grp / p.kv_heads : grp / p.heads;
  const int hs = kKV ? grp % p.kv_heads : grp % p.heads;
  const int kh = kKV ? hs : hs / G;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.g_sb;

  {
    const T* A = kKV ? k : q + hs * p.q_sh;
    const T* B = kKV ? v : g + hs * p.g_sh;
    const long long a_ss = kKV ? p.k_ss : p.q_ss, b_ss = kKV ? p.v_ss : p.g_ss;
    const float a_mul = kKV ? 1.0f : p.scale;
    for (int e = threadIdx.x; e < kR * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int i = row0 + r;
      const bool in = i < S;
      a_s[e] = in ? to_f(A[i * a_ss + d]) * a_mul : 0.0f;
      b_s[e] = in ? to_f(B[i * b_ss + d]) : 0.0f;
    }
  }

  // the streamed tiles in range of any stationary row
  const int r_last = min(row0 + kR, S) - 1;
  const int lo = kKV ? (p.causal ? row0 : max(0, row0 - W + 1)) : max(0, row0 - W + 1);
  const int hi = (kKV || !p.causal) ? min(S - 1, r_last + W - 1) : r_last;
  const int t_lo = lo / kC, t_hi = hi / kC;

  const int r0 = warp * simt::kWRows;
  float acc0[simt::kWRows][kCols];  // dQ, or dK
  float acc1[simt::kWRows][kCols];  // dV (dK dV pass)
  float row_lse[simt::kWRows], row_dl[simt::kWRows];
#pragma unroll
  for (int r = 0; r < simt::kWRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc0[r][c] = acc1[r][c] = 0.0f;
    const long long at = static_cast<long long>(grp) * p.seq_pad + row0 + r0 + r;
    row_lse[r] = kKV ? 0.0f : p.lse_pad[at];
    row_dl[r] = kKV ? 0.0f : p.delta[at];
  }
  float* pw = pw_all + warp * kC * simt::kWRows;
  float* dw = dw_all + warp * kC * simt::kWRows;

  for (int gi = 0; gi < (kKV ? G : 1); ++gi) {
    const int hq = kKV ? kh * G + gi : hs;  // the query head
    const T* C = kKV ? q + hq * p.q_sh : k;
    const T* E = kKV ? g + hq * p.g_sh : v;
    const long long c_ss = kKV ? p.q_ss : p.k_ss, e_ss = kKV ? p.g_ss : p.v_ss;
    const float c_mul = kKV ? p.scale : 1.0f;
    const long long vec = static_cast<long long>(b * p.heads + hq) * p.seq_pad;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int c0 = t * kC;
      __syncthreads();  // the previous tile is consumed (and the rows are staged)
      for (int e = threadIdx.x; e < kC * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        const int j = c0 + r;
        const bool in = j < S;
        c_s[r * kKs + d] = in ? to_f(C[j * c_ss + d]) * c_mul : 0.0f;
        e_s[r * kKs + d] = in ? to_f(E[j * e_ss + d]) : 0.0f;
      }
      __syncthreads();

      float s[simt::kWRows][2], dp[simt::kWRows][2];
#pragma unroll
      for (int r = 0; r < simt::kWRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.0f;
      const float* ca = c_s + lane * kKs;
      const float* cb = c_s + (lane + 32) * kKs;
      const float* ea = e_s + lane * kKs;
      const float* eb = e_s + (lane + 32) * kKs;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(ca + d);
        const float4 x1 = *reinterpret_cast<const float4*>(cb + d);
        const float4 y0 = *reinterpret_cast<const float4*>(ea + d);
        const float4 y1 = *reinterpret_cast<const float4*>(eb + d);
#pragma unroll
        for (int r = 0; r < simt::kWRows; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(a_s + (r0 + r) * D + d);
          const float4 c = *reinterpret_cast<const float4*>(b_s + (r0 + r) * D + d);
          s[r][0] += a.x * x0.x + a.y * x0.y + a.z * x0.z + a.w * x0.w;
          s[r][1] += a.x * x1.x + a.y * x1.y + a.z * x1.z + a.w * x1.w;
          dp[r][0] += c.x * y0.x + c.y * y0.y + c.z * y0.z + c.w * y0.w;
          dp[r][1] += c.x * y1.x + c.y * y1.y + c.z * y1.z + c.w * y1.w;
        }
      }

      float pr[2][simt::kWRows], ds[2][simt::kWRows];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = c0 + lane + 32 * u;
        const float col_lse = kKV ? p.lse_pad[vec + col] : 0.0f;
        const float col_dl = kKV ? p.delta[vec + col] : 0.0f;
#pragma unroll
        for (int r = 0; r < simt::kWRows; ++r) {
          const int row = row0 + r0 + r;
          const bool ok = kKV ? allowed(p, col, row) : allowed(p, row, col);
          const float x = ok ? expf(s[r][u] - (kKV ? col_lse : row_lse[r])) : 0.0f;
          pr[u][r] = round_to<T>(x);
          ds[u][r] = round_to<T>(x * (dp[r][u] - (kKV ? col_dl : row_dl[r])));
        }
      }
      // one 16-byte store per streamed row: the warp's stores fill whole rows of banks
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        if (kKV)
          *reinterpret_cast<float4*>(pw + j * 4) = make_float4(pr[u][0], pr[u][1], pr[u][2], pr[u][3]);
        *reinterpret_cast<float4*>(dw + j * 4) = make_float4(ds[u][0], ds[u][1], ds[u][2], ds[u][3]);
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kC; ++j) {
        const float4 dj = *reinterpret_cast<const float4*>(dw + j * 4);
        const float4 pj = kKV ? *reinterpret_cast<const float4*>(pw + j * 4)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            const float cv = c_s[j * kKs + d];
            acc0[0][c] += dj.x * cv;
            acc0[1][c] += dj.y * cv;
            acc0[2][c] += dj.z * cv;
            acc0[3][c] += dj.w * cv;
            if (kKV) {
              const float ev = e_s[j * kKs + d];
              acc1[0][c] += pj.x * ev;
              acc1[1][c] += pj.y * ev;
              acc1[2][c] += pj.z * ev;
              acc1[3][c] += pj.w * ev;
            }
          }
        }
      }
      __syncwarp();  // pw and dw are rewritten by the next tile
    }
  }

#pragma unroll
  for (int r = 0; r < simt::kWRows; ++r) {
    const int row = row0 + r0 + r;
    if (row >= S) continue;
    // dK sums dS against q already scaled; dQ takes the scale here
    T* o0 = kKV ? static_cast<T*>(p.dk) + b * p.dk_sb + row * p.dk_ss + kh * p.dk_sh
                : static_cast<T*>(p.dq) + b * p.dq_sb + row * p.dq_ss + hs * p.dq_sh;
    T* o1 = static_cast<T*>(p.dv) + b * p.dk_sb + row * p.dk_ss + kh * p.dk_sh;
    const float mul = kKV ? 1.0f : p.scale;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        o0[d] = from_f<T>(acc0[r][c] * mul);
        if (kKV) o1[d] = from_f<T>(acc1[r][c]);
      }
    }
  }
}

namespace {

template <typename T>
int launch_prep(const FlashBwdParams& p, cudaStream_t stream) {
  const dim3 grid(p.seq_pad / 8, p.batch * p.heads);
  rm_flash_bwd_prep_kernel<T><<<grid, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_simt(const FlashBwdParams& p, cudaStream_t stream) {
  using Tl = simt::Tile<D>;
  static_assert(Tl::kSmem <= 232448, "the CUDA-core backward's tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(rm_flash_bwd_simt_kernel<T, D, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rm_flash_bwd_simt_kernel<T, D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.seq + Tl::kR - 1) / Tl::kR;
  rm_flash_bwd_simt_kernel<T, D, true>
      <<<dim3(tiles, p.batch * p.kv_heads), Tl::kThreads, Tl::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rm_flash_bwd_simt_kernel<T, D, false>
      <<<dim3(tiles, p.batch * p.heads), Tl::kThreads, Tl::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const FlashBwdParams& p, cudaStream_t stream) {
  using T = bwd::Tile<D>;
  using rm_wgmma::tensor_map;
  const int d = p.head_dim, s = p.seq, b = p.batch, h = p.heads, kh = p.kv_heads;
  CUtensorMap kv_q, kv_g, kv_k, kv_v, dq_q, dq_g, dq_k, dq_v;
  int err = tensor_map(&kv_q, p.q, d, h, s, b, p.q_sb, p.q_ss, p.q_sh, T::kQ, T::kChunk,
                       T::kSwizzle);
  if (err == 0)
    err = tensor_map(&kv_g, p.dout, d, h, s, b, p.g_sb, p.g_ss, p.g_sh, T::kQ, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&kv_k, p.k, d, kh, s, b, p.k_sb, p.k_ss, p.k_sh, T::kKeys, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&kv_v, p.v, d, kh, s, b, p.v_sb, p.v_ss, p.v_sh, T::kKeys, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&dq_q, p.q, d, h, s, b, p.q_sb, p.q_ss, p.q_sh, T::kRows, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&dq_g, p.dout, d, h, s, b, p.g_sb, p.g_ss, p.g_sh, T::kRows, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&dq_k, p.k, d, kh, s, b, p.k_sb, p.k_ss, p.k_sh, T::kN, T::kChunk,
                     T::kSwizzle);
  if (err == 0)
    err = tensor_map(&dq_v, p.v, d, kh, s, b, p.v_sb, p.v_ss, p.v_sh, T::kN, T::kChunk,
                     T::kSwizzle);
  if (err != 0) return err;
  cudaError_t set = cudaFuncSetAttribute(rm_flash_bwd_dkdv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kKvSmem);
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(rm_flash_bwd_dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kDqSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  rm_flash_bwd_dkdv_tc_kernel<D>
      <<<dim3(b * kh, (s + T::kKeys - 1) / T::kKeys), bwd::kKvThreads, T::kKvSmem, stream>>>(
          p, kv_q, kv_g, kv_k, kv_v);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  rm_flash_bwd_dq_tc_kernel<D>
      <<<dim3(b * h, (s + T::kRows - 1) / T::kRows), bwd::kThreads, T::kDqSmem, stream>>>(
          p, dq_q, dq_g, dq_k, dq_v);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const FlashBwdParams& p, cudaStream_t stream) {
  using namespace wide;
  if (p.kv_chunk < 1 || p.kv_part == nullptr || p.kv_count == nullptr ||
      p.kv_blocks != kv_blocks(p))
    return static_cast<int>(cudaErrorInvalidValue);
  using rm_wgmma::tensor_map;
  const int s = p.seq, b = p.batch, h = p.heads, kh = p.kv_heads;
  // boxes of 64 columns: 64 rows for the dK / dV pass, 128 query rows and
  // 32 keys for the dQ pass
  CUtensorMap mq, mg, mk, mv, dq_q, dq_g, dq_k, dq_v;
  int err = tensor_map(&mq, p.q, kD, h, s, b, p.q_sb, p.q_ss, p.q_sh, kRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&mg, p.dout, kD, h, s, b, p.g_sb, p.g_ss, p.g_sh, kRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&mk, p.k, kD, kh, s, b, p.k_sb, p.k_ss, p.k_sh, kRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&mv, p.v, kD, kh, s, b, p.v_sb, p.v_ss, p.v_sh, kRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&dq_q, p.q, kD, h, s, b, p.q_sb, p.q_ss, p.q_sh, kDqRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&dq_g, p.dout, kD, h, s, b, p.g_sb, p.g_ss, p.g_sh, kDqRows, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&dq_k, p.k, kD, kh, s, b, p.k_sb, p.k_ss, p.k_sh, kDqKeys, kChunk, kSw);
  if (err == 0)
    err = tensor_map(&dq_v, p.v, kD, kh, s, b, p.v_sb, p.v_ss, p.v_sh, kDqKeys, kChunk, kSw);
  if (err != 0) return err;
  cudaError_t set = cudaFuncSetAttribute(rm_flash_bwd_dkdv_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(rm_flash_bwd_dq_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  rm_flash_bwd_dkdv_wide_kernel<<<dim3(p.kv_blocks, b * kh), kKvThreads, kKvSmem, stream>>>(
      p, mq, mg, mk, mv);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  rm_flash_bwd_dq_wide_kernel<<<dim3(b * h, (s + kDqRows - 1) / kDqRows), kDqThreads, kDqSmem,
                                stream>>>(p, dq_q, dq_g, dq_k, dq_v);
  return static_cast<int>(cudaGetLastError());
}

int launch_form(const FlashBwdParams& p, cudaStream_t s) {
  if (tensor_form(p)) {
    switch (p.head_dim) {
      case 16: return launch_tc<16>(p, s);
      case 32: return launch_tc<32>(p, s);
      case 64: return launch_tc<64>(p, s);
      case 128: return launch_tc<128>(p, s);
      case 256: return launch_wide(p, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (p.dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.head_dim) {
    case 16: return launch_simt<float, 16>(p, s);
    case 32: return launch_simt<float, 32>(p, s);
    case 64: return launch_simt<float, 64>(p, s);
    case 128: return launch_simt<float, 128>(p, s);
    case 256: return launch_simt<float, 256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int rm_flash_bwd_params_size() { return static_cast<int>(sizeof(FlashBwdParams)); }

// Launch the backward's three kernels on `stream` of card `device` (made
// current for the launches if it is not) without synchronising; returns
// the first launch's cudaGetLastError() that is not 0 (0 on success).  The
// wrapper has checked shapes, types, strides and alignment; the form
// follows dtype and head_dim (tensor_form), and a head_dim or dtype that no
// form takes is refused here too.
int rm_flash_backward(const FlashBwdParams* params, int device, void* stream) {
  const FlashBwdParams& p = *params;
  if (p.seq <= 0 || p.batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0 || p.window < 1 || p.batch * p.heads > 65535 ||
      p.seq_pad % kSeqPad != 0 || p.seq_pad < p.seq)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = p.dtype == 1 ? launch_prep<__nv_bfloat16>(p, s)
            : p.dtype == 0 ? launch_prep<float>(p, s)
                           : static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) err = launch_form(p, s);
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
