// GQA flash-attention backward for Hopper (sm_90a).
//
//   rm_flash_bwd_prep_kernel          delta and the padded lse of every row
//   rm_flash_bwd_one_kernel           (bfloat16, D 64, 128)  dQ, dK and dV in one pass
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
// Design: a prep launch, then one pass (bf16 D 64, 128) or two on one stream,
// deterministic (no value summed by an atomic in an order that varies), so
// two calls on the same inputs give bit-equal gradients.
//   prep: one warp a row writes D_i and lse_i (times log2 e in the
//      tensor-core forms) into (B H, seq_pad) scratch, 0 and +inf on rows
//      past S: a row past S then has P = exp2(x - inf) = 0 whatever its
//      logits, besides the explicit mask.  It also zeroes the D 256 form's
//      per-key-tile counters and the one-pass form's ticket and counts.
//
// bfloat16 at D 64 and 128 (the LM layers' heads): one pass, the five
// products a pair, warp-specialized (rm_flash_bwd_one_kernel).  bfloat16 at
// D 16 and 32 takes it too: the wrapper (_cuda.run_flash_backward) pads
// the heads with zero columns to D 64, which add nothing to S, dP or D_i,
// and keeps the gradients' first D columns.
//   * Work: a key block of 128 keys of one (b, kv head).  Three warpgroups:
//     a producer (setmaxnreg down to 24 registers) and two consumers of 64
//     keys each (up to 240; they hold dK, dV, S^T, dP^T and both fragments
//     at once).  The producer's thread 0 loads K and V once, then Q, dO,
//     lse and D tiles of 64 queries of every head of the group through a
//     two-stage ring, the query tiles from the top down, the heads within
//     a tile.  Per item a consumer runs S^T = K Q^T and dP^T = V dO^T
//     (committed apart: P^T is formed in registers while dP^T runs), dV +=
//     P^T dO (running while dS^T is formed), dK += dS^T Q, and its half of
//     the 64 x D dQ partial dS K: dS^T goes to shared memory in bf16 as a
//     TMA tile of 128 key rows would lie (two buffers, one named barrier an
//     item), read MN-major as the A operand, K's columns of the
//     warpgroup's half as B.  dK and dV sum in registers over the group.
//   * dQ: a query tile's partials are summed in float32 scratch (B H,
//     seq_pad, D) in increasing key-block order behind a count a tile
//     (tile_contributors gives a tile's key blocks).  At an item's end the
//     consumers stage their halves in shared memory (two buffers, in the
//     scratch's TMA boxes of 64 x 32, 128-byte swizzled) and hand them to
//     the producer's hand-on thread (an mbarrier) after the next item's
//     fence and barrier.  That thread copies the tile out with a TMA tensor
//     store (the tile's first contributor) or, once the count has reached
//     its rank (acquire), a TMA reduce-add (cp.reduce.async.bulk.tensor
//     .add: each element added once, in L2), waits for the copy to
//     complete, releases the count (red.release) and hands the buffer back
//     (an mbarrier).  A tile's last contributor adds its partial the same
//     way, and the hand-on thread then loads the tile's sum back into the
//     buffer (TMA, on the same mbarrier); the consumers convert it to bf16
//     times the scale when they next need the buffer.  (Converted from L2
//     by the consumers, the sums of a bidirectional mask, whose tiles all
//     end at the last key block, held its blocks back.)  A tile with one
//     contributor is written straight.  No memset and no extra launch: the prep kernel
//     zeroes the counts.
//   * Forward progress: a persistent grid (the blocks that fit the SMs)
//     takes key blocks by an atomic ticket, ascending key blocks with the
//     (b, kv head) pairs side by side, so a key block's predecessor — the
//     only work it can wait on — was handed out earlier; the ticket fixes
//     who works, the counts the order of the sums.  Walking the tiles from
//     the top down, every key block of a pair reaches a tile at the same
//     item as the block before it or later, so a successor runs about an
//     item behind its predecessor and the waits stay short under causal,
//     windowed and bidirectional masks (tests/test_torch_flash_backward.py
//     models the items and simulates the grid).
//   * Why a producer warpgroup: the hand-on's fence, turn wait and copy
//     cost about 2,000 cycles an item when a consumer's thread made them
//     (PERF.md §6).  setmaxnreg needs the roles' code apart (a loop each),
//     or ptxas holds every thread to the launch's 168 registers and
//     spills; and the producer must give back all the consumers take, or
//     the increase waits forever.
//   Not done: the consumers meet once an item (the dQ product needs both
//   halves of dS), so one's softmax does not hide behind the other's
//   products as FA3's ping-pong does.

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
// float32: two passes, dK / dV and then dQ, on the CUDA cores (no
// tensor-core product meets float32's tolerance), templated on the pass.  A block stages 64
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
  float* dq_acc;     // one pass: (B H, seq_pad, D) float32 dQ partials summed so far
  int32_t* dq_count; // one pass: [0] the work ticket, then (B H, seq_pad / 64) partials
                     // added a query tile
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
  // the counters of the D 256 form and of the one-pass form: fewer than the grid's threads
  const long long at = (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 256 +
                       threadIdx.x;
  if (p.kv_count != nullptr &&
      at < static_cast<long long>(p.batch) * p.kv_heads * ((p.seq + 63) / 64))
    p.kv_count[at] = 0;
  if (p.dq_count != nullptr && at < 1 + static_cast<long long>(p.batch) * p.heads * (p.seq_pad / 64))
    p.dq_count[at] = 0;
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

// ------------------------- bfloat16 tensor cores: what the forms share
namespace bwd {

using namespace rm_tma;
using namespace rm_wgmma;

constexpr int kStages = 2;  // ring depth

// the swizzled layout of a bf16 tile of D columns, as the products read it
template <int D>
struct Tile {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes of a swizzled row
  static constexpr int kChunk = kSwizzle / 2;                 // columns a TMA box carries
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kPvN = D < 128 ? D : 128;  // width of one register-A wgmma
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

// ---------------------------------- bfloat16 tensor cores, one pass, D 64 / 128
namespace one {

using namespace rm_tma;
using namespace rm_wgmma;

constexpr int kThreads = 384;          // a producer warpgroup, two consumer warpgroups of 64 keys
constexpr int kConsumerWarps = 8;
// setmaxnreg: a block of 384 threads starts at 168 registers a thread; the
// producer's four warps give back 144 each, which the eight consumer warps
// take, 72 each (what inc asks for must be given back, or it waits forever)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(4 * (168 - kProducerRegs) >= 8 * (kConsumerRegs - 168), "setmaxnreg budget");
constexpr int kStages = 2;             // the ring of Q / dO tiles
constexpr int kKeys = 128;             // a block's keys
constexpr int kQ = 64;                 // a streamed query tile's rows
constexpr int kSw = 128, kChunk = 64;  // 128-byte swizzle: 64 columns a TMA box
constexpr int kDsBytes = kKeys * kQ * 2;  // dS^T in bf16: 128 key rows of 128 bytes
constexpr int kDqBoxCols = 32;  // float32 columns of a scratch box: 128 bytes, swizzled

// Byte offset of partial element (row, col) in a half's buffer: box col / 32
// of 64 rows of 128 bytes, 16-byte chunk j of a row at j ^ (row % 8)
__device__ __forceinline__ int dq_at(int row, int col) {
  const int cc = col % kDqBoxCols;
  return (col / kDqBoxCols) * kQ * 128 + row * 128 +
         ((((cc >> 2) ^ (row & 7)) << 4) | ((cc & 3) << 2));
}

template <int D>
struct Tile {
  static_assert(D == 64 || D == 128, "the one-pass form takes D 64 and 128");
  static constexpr int kHalf = D / 2;  // the dQ columns of a warpgroup
  static constexpr int kKeyBytes = kKeys * D * 2;
  static constexpr int kQBytes = kQ * D * 2;
  static constexpr int kVecBytes = kQ * 4;
  // K, V, the ring's Q and dO, two dS^T buffers (1,024-byte aligned: the
  // swizzle repeats every 1,024 bytes), two buffers of the dQ partials
  // waiting for their copy (a half a warpgroup, as the scratch's TMA boxes
  // of 64 rows x 32 columns lie, 128-byte swizzled), the ring's lse and D,
  // the barriers
  static constexpr int kDqHalfBytes = kQ * kHalf * 4;  // a warpgroup's float32 partial
  static constexpr int kDqBoxes = kHalf / kDqBoxCols;   // its TMA boxes
  static constexpr int kV = kKeyBytes;
  static constexpr int kQs = 2 * kKeyBytes;
  static constexpr int kGs = kQs + kStages * kQBytes;
  static constexpr int kDs = kGs + kStages * kQBytes;
  static constexpr int kDq = kDs + 2 * kDsBytes;  // two buffers of the two halves' partials
  static constexpr int kLse = kDq + 2 * 2 * kDqHalfBytes;
  static constexpr int kDelta = kLse + kStages * kVecBytes;
  static constexpr int kBars = kDelta + kStages * kVecBytes;
  static constexpr int kSmem = kBars + 128 + 1024;  // barriers, then alignment slack
};
static_assert(Tile<128>::kSmem <= 232448, "the one-pass tiles exceed shared memory");

// The key blocks whose partials make query tile qt's dQ: [lo, hi], summed
// in that order (modelled in tests/test_torch_flash_backward.py)
__host__ __device__ __forceinline__ void tile_contributors(const FlashBwdParams& p, int qt,
                                                           int& lo, int& hi) {
  const int i0 = qt * kQ;
  const int i_last = (i0 + kQ < p.seq ? i0 + kQ : p.seq) - 1;
  const int j_lo = i0 - p.window + 1 > 0 ? i0 - p.window + 1 : 0;
  const int j_hi = p.causal ? i_last
                            : (i_last + p.window - 1 < p.seq - 1 ? i_last + p.window - 1
                                                                 : p.seq - 1);
  lo = j_lo / kKeys;
  hi = j_hi / kKeys;
}

// Wait until *count is `want` (acquire); a wait past kWaitLimitNs traps
__device__ __forceinline__ void wait_count(const int32_t* count, int want) {
  uint64_t start = 0;
  for (unsigned spins = 1;; ++spins) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(reinterpret_cast<uint64_t>(count)) : "memory");
    if (v == want) return;
    if (spins % 256 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > kWaitLimitNs) __trap();
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the round's barrier: all kThreads threads, from the producer's and the
// consumers' own code
__device__ __forceinline__ void round_sync() {
  asm volatile("bar.sync 2, %0;" :: "n"(kThreads) : "memory");
}

// The tile of the float32 scratch at (column c0, row c1) from shared memory
// `src`: stored (kAdd false) or added element by element in L2 (kAdd), by
// the async proxy, in the issuing thread's open bulk group
template <bool kAdd>
__device__ __forceinline__ void tma_tile_out(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  if (kAdd) {
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
  } else {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
                 : "memory");
  }
}

// The tile of the float32 scratch at (column c0, row c1) into shared memory
// `dst`, completing on mbarrier `bar`
__device__ __forceinline__ void tma_tile_in(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// hand a tile's count on: the copies before are complete and fenced
__device__ __forceinline__ void release_count(int32_t* count) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;"
               :: "l"(reinterpret_cast<uint64_t>(count)) : "memory");
}

// the issuing thread's bulk groups are complete: their writes are performed
// (and ordered before the generic proxy's later accesses)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// the tile's count has reached `want`: the sums it stands for, written by
// other blocks' copies, are visible to this thread's copies too
__device__ __forceinline__ void wait_turn(const int32_t* count, int want) {
  wait_count(count, want);
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// acc (64 queries x D / 2) = dS (64 x 128 keys: dS^T in `ds`, MN-major) .
// K (128 keys x D / 2: the key block's K from column `col0`, MN-major)
template <int D>
__device__ __forceinline__ void product_dq(float (&acc)[D / 4], uint32_t ds, uint32_t k_s,
                                           int col0) {
  const uint32_t kb = k_s + (col0 / kChunk) * kKeys * kSw + (col0 % kChunk) * 2;
#pragma unroll
  for (int u = 0; u < kKeys / 16; ++u) {
    const uint64_t da = desc(ds + 16 * u * kSw, kKeys * kSw, 8 * kSw, 1);
    const uint64_t db = desc(kb + 16 * u * kSw, kKeys * kSw, 8 * kSw, 1);
    wgmma_tt<D / 2>(acc, da, db, u > 0);
  }
}

}  // namespace one

template <int D>
__global__ void __launch_bounds__(one::kThreads, 1)
rm_flash_bwd_one_kernel(const __grid_constant__ FlashBwdParams p,
                        const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_acc) {
  using namespace one;
  using T = Tile<D>;
  using bwd::pack, bwd::product_rs, bwd::product_ss, bwd::smem_addr, bwd::store_rows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int ticket;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t k_s = base, v_s = base + T::kV;
  auto q_st = [&](int s) { return base + T::kQs + s * T::kQBytes; };
  auto g_st = [&](int s) { return base + T::kGs + s * T::kQBytes; };
  const uint32_t bars = base + T::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  // a dQ buffer's partials are staged (the consumers' 8 warps), then copied
  // out and complete (the hand-on thread)
  auto staged = [&](int buf) { return bars + 8 * (1 + 2 * kStages + buf); };
  auto done_bar = [&](int buf) { return bars + 8 * (3 + 2 * kStages + buf); };
  auto dq_buf = [&](int buf, int half) { return T::kDq + (2 * buf + half) * T::kDqHalfBytes; };

  const int S = p.seq, W = p.window, G = p.heads / p.kv_heads;
  const int groups = p.batch * p.kv_heads;
  const int tickets = (S + kKeys - 1) / kKeys * groups;
  const int n_qt = p.seq_pad / kQ;
  int32_t* counts = p.dq_count + 1;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);  // one arrival per consumer warp
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(staged(buf), kConsumerWarps);
      mbar_init(done_bar(buf), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int role = threadIdx.x / 128;  // 0: the producer, 1 and 2: consumer warpgroups
  const int wgc = role - 1;  // a consumer warpgroup's 64 keys and half of dQ's columns
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int r_a = 16 * warp + lane / 4;  // a thread's two rows of a fragment: r_a and r_a + 8
  const int col0 = wgc * T::kHalf;
  const float scale_log2 = p.scale * kLog2e;

  // The next key block by ticket, for every thread (the round's two
  // barriers take all 384): key blocks in ascending order (the longest,
  // when causal, first), the (b, kv head) pairs side by side, so a key
  // block's predecessor holds a lower ticket and was handed out earlier.
  // Item it of a key block: query tile qt_hi - it / G (from the top: every
  // key block of a (b, kv head) reaches a tile at the same item or later
  // than the block before it), head kh G + it % G.
  int kb = 0, b = 0, kh = 0, k0 = 0, qt_hi = 0, items = 0;
  auto next_block = [&]() {
    round_sync();  // the last key block's K, V, ring and hand-on are through
    if (threadIdx.x == 0) ticket = atomicAdd(p.dq_count, 1);
    round_sync();
    const int tk = ticket;
    if (tk >= tickets) return false;
    kb = tk / groups;
    const int bkh = tk % groups;
    b = bkh / p.kv_heads;
    kh = bkh % p.kv_heads;
    k0 = kb * kKeys;
    const int k_last = min(k0 + kKeys, S) - 1;
    const int qt_lo = (p.causal ? k0 : max(0, k0 - W + 1)) / kQ;
    qt_hi = min(S - 1, k_last + W - 1) / kQ;
    items = G * (qt_hi - qt_lo + 1);
    return true;
  };

  int done = 0;              // items of this block's earlier key blocks: the ring's position
  int uses0 = 0, uses1 = 0;  // the dQ buffers' uses so far: their barriers' phases
  if (role == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    while (next_block()) {
      if (t == 0) {
        // the ring: K and V once, then item it into stage (done + it) % 2
        // once the item two before is consumed
        mbar_expect_tx(kv_full, 2 * T::kKeyBytes);
        for (int c = 0; c < D / kChunk; ++c)
          tma_load(k_s + c * kKeys * kSw, &map_k, kv_full, c * kChunk, kh, k0, b);
        for (int c = 0; c < D / kChunk; ++c)
          tma_load(v_s + c * kKeys * kSw, &map_v, kv_full, c * kChunk, kh, k0, b);
        for (int it = 0; it < items; ++it) {
          const int l = done + it, s = l % kStages;
          const int h = kh * G + it % G, q0 = (qt_hi - it / G) * kQ;
          mbar_wait(empty(s), ((l / kStages) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(full(s), 2 * T::kQBytes + 2 * T::kVecBytes);
          for (int c = 0; c < D / kChunk; ++c)
            tma_load(q_st(s) + c * kQ * kSw, &map_q, full(s), c * kChunk, h, q0, b);
          for (int c = 0; c < D / kChunk; ++c)
            tma_load(g_st(s) + c * kQ * kSw, &map_g, full(s), c * kChunk, h, q0, b);
          const long long row = static_cast<long long>(b * p.heads + h) * p.seq_pad + q0;
          bulk_load(base + T::kLse + s * T::kVecBytes, p.lse_pad + row, T::kVecBytes, full(s));
          bulk_load(base + T::kDelta + s * T::kVecBytes, p.delta + row, T::kVecBytes, full(s));
        }
      } else if (t == 32) {
        // the hand-on: each staged item's partials go out in item order, the
        // tile's first contributor's stored, a later one's added once the
        // tile's count has reached its rank; once the copy is complete its
        // count is released (but for a tile's last) and its buffer handed back
        for (int it = 0; it < items; ++it) {
          const int l = done + it, buf = l & 1;
          const int qt = qt_hi - it / G, h = kh * G + it % G;
          int lo, hi;
          tile_contributors(p, qt, lo, hi);
          if (lo == hi) continue;  // written straight by the consumers
          const int use = buf ? uses1++ : uses0++;
          const long long bh = static_cast<long long>(b) * p.heads + h;
          int32_t* count = counts + bh * n_qt + qt;
          mbar_wait(staged(buf), use & 1);
          if (kb > lo) wait_turn(count, kb - lo);
          const int row = static_cast<int>(bh * p.seq_pad + qt * kQ);
          for (int half = 0; half < 2; ++half)
            for (int bx = 0; bx < T::kDqBoxes; ++bx) {
              const uint32_t src = base + dq_buf(buf, half) + bx * kQ * 128;
              const int c = half * T::kHalf + bx * kDqBoxCols;
              if (kb == lo) tma_tile_out<false>(&map_acc, src, c, row);
              else tma_tile_out<true>(&map_acc, src, c, row);
            }
          bulk_commit();
          bulk_wait_all();
          if (kb != hi) {
            release_count(count);
            mbar_arrive(done_bar(buf));
          } else {
            // the tile's sum is complete: back into the buffer for the
            // consumers to convert
            mbar_expect_tx(done_bar(buf), 2 * T::kDqHalfBytes);
            for (int half = 0; half < 2; ++half)
              for (int bx = 0; bx < T::kDqBoxes; ++bx)
                tma_tile_in(base + dq_buf(buf, half) + bx * kQ * 128, &map_acc,
                            half * T::kHalf + bx * kDqBoxCols, row, done_bar(buf));
          }
        }
      }
      done += items;
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
  for (int round = 0; next_block(); ++round) {
    const int jw = k0 + 64 * wgc;
    const int j_a = jw + r_a;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.0f;
    float st[kQ / 2], dpt[kQ / 2];            // S^T then P^T; dP^T then dS^T
    float dq[D / 4];                          // this warpgroup's half of dS K
    uint32_t pa[kQ / 16][4], da[kQ / 16][4];  // P^T and dS^T as bf16 A fragments
    // a buffer whose last partial finished a tile: its (query tile, head) + 1,
    // converted once its copy is complete, when the buffer is next needed
    int conv0 = 0, conv1 = 0;
    int staged_buf = -1;  // the buffer staged last item, not yet handed on

    // tile `tile`'s sum, loaded back into buffer `buf`, in bf16 times the scale
    auto convert = [&](int buf, int tile) {
      const int qt = (tile - 1) / G, h = kh * G + (tile - 1) % G, r0 = qt * kQ;
      __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + col0;
      const uint8_t* sum = gbase + dq_buf(buf, wgc);
#pragma unroll
      for (int e = 0; e < D / 4; e += 2) {
        const int row = r_a + ((e & 2) ? 8 : 0);
        const int col = 8 * (e / 4) + 2 * (lane % 4);
        const float2 v = *reinterpret_cast<const float2*>(sum + dq_at(row, col));
        if (r0 + row < S)
          *reinterpret_cast<__nv_bfloat162*>(dqp + (r0 + row) * p.dq_ss + col) =
              __floats2bfloat162_rn(v.x * p.scale, v.y * p.scale);
      }
    };
    // buffer `buf`'s copy is complete (its previous use, if any): it may be
    // staged again, and a tile it finished is converted
    auto reclaim = [&](int buf) {
      const int use = buf ? uses1 : uses0;
      if (use == 0) return;
      mbar_wait(done_bar(buf), (use - 1) & 1);
      const int conv = buf ? conv1 : conv0;
      if (conv != 0) convert(buf, conv);
      if (buf) conv1 = 0; else conv0 = 0;
    };

    mbar_wait(kv_full, round & 1);
    for (int it = 0; it < items; ++it) {
      const int l = done + it, s = l % kStages;
      const int qt = qt_hi - it / G, h = kh * G + it % G, q0 = qt * kQ;
      mbar_wait(full(s), (l / kStages) & 1);
      // S^T and dP^T, committed apart: P^T is formed while dP^T runs
      wg_fence();
      product_ss<D, kQ>(st, k_s, kKeys, 64 * wgc, q_st(s));
      wg_commit();
      product_ss<D, kQ>(dpt, v_s, kKeys, 64 * wgc, g_st(s));
      wg_commit();
      wg_wait<1>();
      reg_fence(st);

      // entry e: key row j_a + 8 ((e >> 1) & 1), query column c (below)
      const float* lse = reinterpret_cast<const float*>(gbase + T::kLse + s * T::kVecBytes);
      const float* dl = reinterpret_cast<const float*>(gbase + T::kDelta + s * T::kVecBytes);
      const int q_last = q0 + kQ - 1, j_last = jw + 63;
      const bool edge = q_last >= S || j_last >= S ||
                        (p.causal ? (q0 < j_last || q_last - jw >= W)
                                  : (q_last - jw >= W || j_last - q0 >= W));
#pragma unroll
      for (int e = 0; e < kQ / 2; e += 2) {
        const int c = 8 * (e / 4) + 2 * (lane % 4);  // entries e, e + 1: queries c, c + 1
        const float2 lv = *reinterpret_cast<const float2*>(lse + c);
        float p0 = exp2_approx(fmaf(st[e], scale_log2, -lv.x));
        float p1 = exp2_approx(fmaf(st[e + 1], scale_log2, -lv.y));
        if (edge) {
          const int j = j_a + 8 * ((e >> 1) & 1);
          if (!allowed(p, q0 + c, j)) p0 = 0.0f;
          if (!allowed(p, q0 + c + 1, j)) p1 = 0.0f;
        }
        st[e] = p0;
        st[e + 1] = p1;
      }
      pack<kQ>(pa, st);
      // dV += P^T dO runs while dS^T is formed
      wg_fence();
      product_rs<D, kQ>(dv, pa, g_st(s));
      wg_commit();
      wg_wait<1>();
      reg_fence(dpt);
#pragma unroll
      for (int e = 0; e < kQ / 2; e += 2) {
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * (e / 4) + 2 * (lane % 4));
        dpt[e] = st[e] * (dpt[e] - dv2.x);
        dpt[e + 1] = st[e + 1] * (dpt[e + 1] - dv2.y);
      }
      pack<kQ>(da, dpt);
      // dS^T (bf16) into buffer l % 2 as a TMA tile of 128 key rows of 64
      // queries would lie: 128 bytes a row, 16-byte chunk c at c ^ (row % 8)
      uint8_t* ds = gbase + T::kDs + (l & 1) * kDsBytes;
#pragma unroll
      for (int u = 0; u < kQ / 16; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kr = 64 * wgc + r_a + 8 * (r & 1);
          const int c = 16 * u + 8 * (r >> 1) + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(ds + kr * kSw + ((((c >> 3) ^ (kr & 7)) << 4) |
                                                        ((c & 7) << 1))) = da[u][r];
        }
      }
      wg_fence();
      product_rs<D, kQ>(dk, da, q_st(s));
      wg_commit();
      fence_proxy_async();
      named_sync(1, 256);  // both consumer warpgroups' dS^T (and last item's partials) are in place
      if (staged_buf >= 0) {
        if (lane == 0) mbar_arrive(staged(staged_buf));
        staged_buf = -1;
      }
      wg_fence();
      product_dq<D>(dq, base + T::kDs + (l & 1) * kDsBytes, k_s, col0);
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(dq);
      if (lane == 0) mbar_arrive(empty(s));

      // this item's partial: written out now if no other key block adds to
      // its tile, else staged in buffer l % 2 for the hand-on
      int lo, hi;
      tile_contributors(p, qt, lo, hi);
      if (lo == hi) {
        __nv_bfloat16* dqp =
            static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh + col0;
#pragma unroll
        for (int e = 0; e < D / 4; e += 2) {
          const int row = r_a + ((e & 2) ? 8 : 0);
          const int col = 8 * (e / 4) + 2 * (lane % 4);
          if (q0 + row < S)
            *reinterpret_cast<__nv_bfloat162*>(dqp + (q0 + row) * p.dq_ss + col) =
                __floats2bfloat162_rn(dq[e] * p.scale, dq[e + 1] * p.scale);
        }
        continue;
      }
      const int buf = l & 1;
      reclaim(buf);
      uint8_t* stage_at = gbase + dq_buf(buf, wgc);
#pragma unroll
      for (int e = 0; e < D / 4; e += 2) {
        const int row = r_a + ((e & 2) ? 8 : 0);
        const int col = 8 * (e / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(stage_at + dq_at(row, col)) = make_float2(dq[e], dq[e + 1]);
      }
      staged_buf = buf;  // handed on after the next item's fence and barrier
      if (buf) ++uses1; else ++uses0;
      if (kb == hi) {
        if (buf) conv1 = qt * G + it % G + 1; else conv0 = qt * G + it % G + 1;
      }
    }

    // the last item's partials, then the tiles this key block finished once
    // their copies are complete
    if (staged_buf >= 0) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(staged(staged_buf));
    }
    if (conv0 != 0) reclaim(0);
    if (conv1 != 0) reclaim(1);

    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kh * p.dk_sh;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dk_sb + kh * p.dk_sh;
    store_rows<D>(dkp, p.dk_ss, dk, p.scale, j_a, S, lane);
    store_rows<D>(dvp, p.dk_ss, dv, 1.0f, j_a, S, lane);
    done += items;
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
int launch_one(const FlashBwdParams& p, cudaStream_t stream) {
  using T = one::Tile<D>;
  using rm_wgmma::tensor_map;
  if (p.dq_acc == nullptr || p.dq_count == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int s = p.seq, b = p.batch, h = p.heads, kh = p.kv_heads;
  CUtensorMap mq, mg, mk, mv;
  int err = tensor_map(&mq, p.q, D, h, s, b, p.q_sb, p.q_ss, p.q_sh, one::kQ, one::kChunk,
                       one::kSw);
  if (err == 0)
    err = tensor_map(&mg, p.dout, D, h, s, b, p.g_sb, p.g_ss, p.g_sh, one::kQ, one::kChunk,
                     one::kSw);
  if (err == 0)
    err = tensor_map(&mk, p.k, D, kh, s, b, p.k_sb, p.k_ss, p.k_sh, one::kKeys, one::kChunk,
                     one::kSw);
  if (err == 0)
    err = tensor_map(&mv, p.v, D, kh, s, b, p.v_sb, p.v_ss, p.v_sh, one::kKeys, one::kChunk,
                     one::kSw);
  if (err != 0) return err;
  // the float32 scratch (B H seq_pad rows of D) in boxes of 64 rows of 32
  // columns, 128-byte swizzled in shared memory (a warpgroup's half: D / 64)
  if (static_cast<long long>(b) * h * p.seq_pad > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap macc;
  {
    const rm_tma::EncodeTiled encode = rm_tma::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(b) * h * p.seq_pad};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(one::kDqBoxCols), one::kQ};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&macc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.dq_acc, dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(rm_flash_bwd_one_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rm_flash_bwd_one_kernel<D>,
                                                      one::kThreads, T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a persistent grid: every block takes key blocks by ticket until none is left
  const long long tickets = static_cast<long long>((s + one::kKeys - 1) / one::kKeys) * b * kh;
  const long long grid = tickets < static_cast<long long>(sms) * per_sm
                             ? tickets : static_cast<long long>(sms) * per_sm;
  rm_flash_bwd_one_kernel<D><<<static_cast<unsigned>(grid), one::kThreads, T::kSmem, stream>>>(
      p, mq, mg, mk, mv, macc);
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
      case 64: return launch_one<64>(p, s);
      case 128: return launch_one<128>(p, s);
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
