// The int8-weight decode matmul: y_r (M, N_r) = x (M, K) @ dequant(q_r, s_r)
// for a group of up to four records r that share x, with q_r an int8 (K, N_r)
// weight and s_r its bf16 per-column scale (1, N_r).
//
// Replaces: no Pallas kernel.  The reference's `cast` of an int8 record,
// `q.astype(dt) * s.astype(dt)` (src/repro/models/layers.py:51), is fused by
// XLA into the matmul that consumes it, so on the TPU the device reads the
// int8 buffer once.  Eager PyTorch would write and re-read a dequantized copy
// of every weight; this kernel reads the int8 buffer itself.
//
// Bound: bytes.  A decode step has M = B (8 on the serving path) rows, so a
// weight byte feeds 2·M operations: the K·N weight bytes, read once, set the
// time (qwen3-8b: 192,937,984 B a layer, 57.6 µs at the 3.35 TB/s of the
// H100 SXM data sheet).  Two forms:
//
// bf16 with every N_r a multiple of 16 (rm_w8_matmul_tc_kernel, the tensor
// cores).  One launch takes a group of products that share x (a layer's wq,
// wk, wv; its w_gate, w_up), so a decode layer runs 4 launches, not 7 plus a
// reduction for each.  A block owns a strip of 128 output columns of one
// record, 8 rows of x and one rank's chunk of K; the chunks of a strip are
// the blocks of one thread-block cluster along K (at most 8), so the grid
// fills the card for N as small as 1,024:
//   * a ring of 4 stages of 64 K rows × 128 columns (8 KB) in shared
//     memory, fed by TMA from a tensor map of q (box 128 × 64, the 128-byte
//     swizzle) by one producer thread, with full / empty mbarriers: 32 KB in
//     flight a block whatever its chunk, up to 4 blocks an SM (the ~25 KB an
//     SM that 3.35 TB/s × ~1 µs of latency asks for over 132 SMs); rows past
//     K and columns past N arrive as zeros;
//   * four consumer warps take one 16-row k step of every stage each and
//     run mma.sync m16n8k16, y^T = W^T x^T: the dequantized q^T as A, 16
//     columns a tile, x^T as B (its 8 rows the tile's n: no padding).  Lane
//     (g, t) reads rows 2t, 2t+1, 2t+8, 2t+9 of its step (the fragment's k)
//     at columns 16g..16g+15: the swizzle puts a quarter-warp's 16-byte reads
//     on distinct banks.  In mma j its A rows g and g+8 are columns 16g+2j
//     and 16g+2j+1.  The rank's rows of x are staged once in shared memory;
//   * a weight byte is dequantized in registers exactly as `cast` does:
//     float(q), exact (the byte's sign flipped into the mantissa of 2^23,
//     instead of the quarter-rate I2F), its upper half the exact bf16, times
//     s with __hmul2 (the product rounded once to bf16); float32 sums;
//   * the sums are added in a fixed order: the four warps' in warp order in
//     shared memory (the spent ring), then the cluster's ranks' in rank
//     order, each rank reading its share of the outputs from every rank's
//     shared memory (distributed shared memory) between two cluster
//     barriers: no second kernel, no float32 partials in device memory, no
//     atomics, so a result is the same every run, in a graph replay, and in
//     a group or alone (the ranks depend on K alone).
// Otherwise (float32, or N % 16 != 0: rm_w8_matmul_kernel, the CUDA cores;
// one record a launch) a block of four warps owns a 256-column strip and a
// chunk of K, a lane 8 columns read with one 8-byte load a row, 8 rows in
// flight, doing the 8 × 8 FMAs itself; the warps' sums meet in shared memory
// in warp order, and with several K chunks each block writes a float32
// partial that rm_w8_reduce_kernel adds in chunk order.
//
// The launcher only enqueues on the caller's stream (no synchronisation, no
// allocation; the tensor maps are encoded on the host into the kernel's
// parameters), so a CUDA graph can capture it.  The dynamic shared memory
// above 48 KB is allowed once, by rm_w8_init, when the library is loaded.
// The layout of W8Params is mirrored by ctypes in
// repro_torch/kernels/_cuda.py (_W8Params), checked at load time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rm_tma.cuh"  // mbarriers, the tensor-map encoder (CUtensorMap via <cuda.h>)

constexpr int kW8MaxRecords = 4;  // products one launch takes

// At namespace scope, not in the unnamed namespace: the extern "C" entry
// point takes it, and a type of internal linkage would hide that symbol.
struct W8Params {
  const void* x;                            // (M, K) float32 or bf16, contiguous
  const int8_t* q[kW8MaxRecords];           // (K, N_r) int8, contiguous
  const __nv_bfloat16* s[kW8MaxRecords];    // (1, N_r) bf16
  void* y[kW8MaxRecords];                   // (M, N_r) in x's type
  float* partials;                          // CUDA cores, splits > 1: (splits, M, N) float32
  int32_t n[kW8MaxRecords];                 // N_r
  int32_t records;                          // 1..kW8MaxRecords (1 on the CUDA cores)
  int32_t M, K;
  int32_t chunk;   // K rows a block (CUDA cores) or a cluster rank (tensor cores)
  int32_t splits;  // ceil(K / chunk): blocks along K, the cluster's size on the tensor cores
  int32_t dtype;   // 0 float32, 1 bf16
  int32_t form;    // kFormCudaCores or kFormTensor
  int32_t pad_;
};

namespace {

using namespace rm_tma;

constexpr int kW8Threads = 128;                // four warps a block (CUDA cores)
constexpr int kW8Warps = kW8Threads / 32;
constexpr int kW8Cols = 8;                     // columns a lane: one 8-byte load
constexpr int kW8Strip = 32 * kW8Cols;         // 256 columns a block
constexpr int kW8Rows = 8;                     // rows of x a block (an m tile)
constexpr int kW8Unroll = 8;                   // rows of q a warp has in flight
constexpr int kW8MaxChunk = 1024;              // K rows a block stages (CUDA cores)
constexpr int kW8RedBytes = kW8Warps * kW8Rows * kW8Strip * 4;  // 32 KB
constexpr int kW8ReduceThreads = 256;
// the tensor-core kernel
constexpr int kTcStrip = 128;                  // columns a block: a 128-byte TMA box row
constexpr int kTcConsumers = 4;                // warps that run the products
constexpr int kTcThreads = 32 * (kTcConsumers + 1);  // and one producer warp
constexpr int kTcStep = 16;                    // K rows an mma
constexpr int kTcStageRows = kTcStep * kTcConsumers;  // 64: a step per consumer warp
constexpr int kTcStageBytes = kTcStageRows * kTcStrip;  // 8 KB
constexpr int kTcStages = 4;                   // stages of the ring
constexpr int kTcBlocks = 4;                   // blocks an SM (__launch_bounds__): the register cap
constexpr int kTcXPad = 8;                     // bf16 pad of a staged x row
constexpr int kTcRedRow = 140;                 // floats a row of the warps' sums
constexpr int kTcRedBytes = kTcConsumers * kW8Rows * kTcRedRow * 4;
constexpr int kTcOut = kW8Rows * kTcStrip;     // a strip's sums: 8 rows x 128 columns
constexpr int kTcMaxCluster = 8;               // the portable cluster size
constexpr int kTcMaxChunk = 8192;              // K rows a rank stages of x
// shared memory from the 1,024-byte aligned base: the ring (once spent, the
// warps' sums, then the rank's sums that the cluster reads), x, barriers
constexpr int kTcRing = ((kTcStages * kTcStageBytes > kTcRedBytes + kTcOut * 4
                              ? kTcStages * kTcStageBytes
                              : kTcRedBytes + kTcOut * 4) + 1023) / 1024 * 1024;
static_assert(kTcStages >= 2, "the ring needs two stages");

// W8Params::form: the CUDA cores (N % 8 == 0, q 8-byte aligned) or the
// tensor cores (bf16, N % 16 == 0, q and s 16-byte aligned)
enum Form : int32_t { kFormCudaCores = 0, kFormTensor = 1 };

// The tensor-core kernel's parameters: the records' tensor maps and strips.
struct W8TcArgs {
  CUtensorMap map[kW8MaxRecords];   // q_r as (N_r, K): box 128 × 64, 128-byte swizzle
  const __nv_bfloat16* x;
  const __nv_bfloat16* s[kW8MaxRecords];
  __nv_bfloat16* y[kW8MaxRecords];
  int32_t n[kW8MaxRecords];
  int32_t strip_end[kW8MaxRecords];  // strips of records 0..r
  int32_t records, M, K, chunk;
  int32_t x_vec;                     // x 16-byte aligned, K % 8 == 0: staged 16 bytes a load
};

int tc_smem_bytes(int chunk) {
  return 1024 + kTcRing + kW8Rows * (chunk + kTcXPad) * 2 + 2 * kTcStages * 8;
}

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The exact float of signed byte `i` of `word`, where `flipped` is the word
// with every byte's sign bit flipped (b + 128 as an unsigned byte): that byte
// becomes the low mantissa byte of 2^23, the float 2^23 + 128 + b.
__device__ __forceinline__ float s8_to_float(uint32_t flipped, int i) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | i)) - 8388736.0f;
}

// Where a CUDA-core block's sums go: y directly (one K chunk) or its row of
// the split-K partials.
template <typename T>
__device__ __forceinline__ void store_sum(const W8Params& p, int row, int col, float v) {
  const long long at = static_cast<long long>(row) * p.n[0] + col;
  if (p.splits == 1)
    static_cast<T*>(p.y[0])[at] = from_float<T>(v);
  else
    p.partials[static_cast<long long>(blockIdx.y) * p.M * p.n[0] + at] = v;
}

// Eight int8 weights of row k from column col (col < N, N % 8 == 0).
__device__ __forceinline__ uint2 load_q(const W8Params& p, int k, int col) {
  return __ldg(reinterpret_cast<const uint2*>(p.q[0] + static_cast<long long>(k) * p.n[0] + col));
}

template <typename T>
__global__ void __launch_bounds__(kW8Threads, 4)
rm_w8_matmul_kernel(const __grid_constant__ W8Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = p.n[0];
  const int strip0 = blockIdx.x * kW8Strip;
  const int col0 = strip0 + lane * kW8Cols;
  const int k0 = blockIdx.y * p.chunk;
  const int kc = min(p.K - k0, p.chunk);
  const int m0 = blockIdx.z * kW8Rows;
  const T* x = static_cast<const T*>(p.x);

  // x[m0 : m0 + 8, k0 : k0 + kc] as float32, k-major (xs[k][m])
  for (int i = threadIdx.x; i < kc * kW8Rows; i += kW8Threads) {
    const int m = i / kc, kk = i - m * kc;
    smem[kk * kW8Rows + m] =
        m0 + m < p.M ? to_float(x[static_cast<long long>(m0 + m) * p.K + k0 + kk]) : 0.0f;
  }
  float sc[kW8Cols];
#pragma unroll
  for (int c = 0; c < kW8Cols; ++c)
    sc[c] = col0 + c < N ? __bfloat162float(p.s[0][col0 + c]) : 0.0f;
  __syncthreads();

  float acc[kW8Rows][kW8Cols];
#pragma unroll
  for (int m = 0; m < kW8Rows; ++m)
#pragma unroll
    for (int c = 0; c < kW8Cols; ++c) acc[m][c] = 0.0f;

  if (col0 < N) {
    for (int kb = warp; kb < kc; kb += kW8Warps * kW8Unroll) {
      uint2 raw[kW8Unroll];
#pragma unroll
      for (int u = 0; u < kW8Unroll; ++u) {
        const int kk = kb + u * kW8Warps;
        raw[u] = kk < kc ? load_q(p, k0 + kk, col0) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kW8Unroll; ++u) {
        const int kk = kb + u * kW8Warps;
        if (kk >= kc) break;  // the same for the whole warp
        const float4 xa = smem4[kk * 2], xb = smem4[kk * 2 + 1];
        const float xv[kW8Rows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const uint32_t words[2] = {raw[u].x ^ 0x80808080u, raw[u].y ^ 0x80808080u};
#pragma unroll
        for (int c = 0; c < kW8Cols; ++c) {
          float w = s8_to_float(words[c / 4], c % 4) * sc[c];  // exact
          if constexpr (sizeof(T) == 2) w = __bfloat162float(__float2bfloat16_rn(w));
#pragma unroll
          for (int m = 0; m < kW8Rows; ++m) acc[m][c] = fmaf(xv[m], w, acc[m][c]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with xs: the space holds the sums
#pragma unroll
  for (int m = 0; m < kW8Rows; ++m) {
    float4* dst = reinterpret_cast<float4*>(
        smem + (warp * kW8Rows + m) * kW8Strip + lane * kW8Cols);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kW8Rows * kW8Strip; o += kW8Threads) {
    const int m = o / kW8Strip, c = o % kW8Strip;
    const int row = m0 + m, col = strip0 + c;
    if (row >= p.M || col >= N) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kW8Warps; ++w) v += smem[(w * kW8Rows + m) * kW8Strip + c];
    store_sum<T>(p, row, col, v);
  }
}

__device__ __forceinline__ uint32_t hmul2_bits(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// Every thread of the cluster: shared-memory writes before it are seen by
// the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
// The shared address `addr` of this block, in the cluster's rank `rank`.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
__device__ __forceinline__ float ld_cluster(uint32_t remote) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory offset of row `row` (0..63), 16-byte column chunk `chunk`
// of a stage, as the 128-byte swizzle lays it out (the chunk XOR row % 8).
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * kTcStrip + ((chunk ^ (row & 7)) << 4);
}

// The record of the launch's strip `strip` and that strip's first column.
__device__ __forceinline__ int record_of(const W8TcArgs& a, int strip) {
  int rec = 0;
  while (rec + 1 < a.records && strip >= a.strip_end[rec]) ++rec;
  return rec;
}
__device__ __forceinline__ int first_col(const W8TcArgs& a, int rec, int strip) {
  return (strip - (rec ? a.strip_end[rec - 1] : 0)) * kTcStrip;
}

// Block (strip blockIdx.x, rank r of its cluster, m tile blockIdx.z): K
// rows [r·chunk, (r+1)·chunk) of the strip's 128 columns, 8 rows of x.
__global__ void __launch_bounds__(kTcThreads, kTcBlocks)
rm_w8_matmul_tc_kernel(const __grid_constant__ W8TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at a 1,024-byte boundary: the swizzle pattern repeats every 1,024 bytes
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* red = reinterpret_cast<float*>(smem);                  // the warps' sums
  float* part = reinterpret_cast<float*>(smem + kTcRedBytes);   // the rank's sums
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kTcRing);
  const int stride = a.chunk + kTcXPad;  // a staged row of x, in bf16
  const uint32_t bars = base + kTcRing + kW8Rows * stride * 2;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTcStages + s); };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rec = record_of(a, blockIdx.x);
  const int col0 = first_col(a, rec, blockIdx.x);
  const int n = a.n[rec];
  const uint32_t rank = cluster_rank(), ranks = cluster_size();
  const int k0 = static_cast<int>(rank) * a.chunk;
  const int kc = min(a.K - k0, a.chunk);  // >= 1: the wrapper's plan
  const int stages = (kc + kTcStageRows - 1) / kTcStageRows;
  const int m0 = blockIdx.z * kW8Rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kTcConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  if (warp == kTcConsumers) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      const CUtensorMap* map = &a.map[rec];
      asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
      for (int i = 0; i < stages; ++i) {
        const int s = i % kTcStages;
        mbar_wait(empty(s), ((i / kTcStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), kTcStageBytes);
        tma_load_2d(base + s * kTcStageBytes, map, full(s), col0, k0 + i * kTcStageRows);
      }
    }
    __syncwarp();
  } else {
    // ---------------------------------------------------------- consumers
    // x[m0 : m0 + 8, k0 : k0 + stages * 64] in bf16, row-major, zeros past M and kc
    const int xk = stages * kTcStageRows;
    if (a.x_vec) {
      const int per_row = xk / 8;
      for (int i = threadIdx.x; i < kW8Rows * per_row; i += 32 * kTcConsumers) {
        const int m = i / per_row, kk = (i - m * per_row) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + m < a.M && kk < kc)  // kc is a multiple of 8
          v = __ldg(reinterpret_cast<const uint4*>(a.x + static_cast<long long>(m0 + m) * a.K +
                                                   k0 + kk));
        *reinterpret_cast<uint4*>(xs + m * stride + kk) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kW8Rows * xk; i += 32 * kTcConsumers) {
        const int m = i / xk, kk = i - m * xk;
        xs[m * stride + kk] = (m0 + m < a.M && kk < kc)
                                  ? a.x[static_cast<long long>(m0 + m) * a.K + k0 + kk]
                                  : __float2bfloat16_rn(0.0f);
      }
    }
    // s of the lane's 16 columns, two bf16 a word (N % 16 == 0)
    const int col = col0 + 16 * g;
    uint4 sw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (col < n) {
      sw[0] = __ldg(reinterpret_cast<const uint4*>(a.s[rec] + col));
      sw[1] = __ldg(reinterpret_cast<const uint4*>(a.s[rec] + col + 8));
    }
    const uint32_t sv[8] = {sw[0].x, sw[0].y, sw[0].z, sw[0].w, sw[1].x, sw[1].y, sw[1].z, sw[1].w};
    asm volatile("bar.sync 1, %0;" :: "n"(32 * kTcConsumers) : "memory");  // xs staged

    const __nv_bfloat16* xrow = xs + g * stride + warp * kTcStep + 2 * t;
    for (int i = 0; i < stages; ++i) {
      const int s = i % kTcStages;
      const uint32_t stage = base + s * kTcStageBytes;
      mbar_wait(full(s), (i / kTcStages) & 1);
      // rows 2t, 2t+1 | 2t+8, 2t+9 of this warp's step, columns 16g..16g+15
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = warp * kTcStep + 2 * t + (j & 1) + 8 * (j >> 1);
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(r[j].x), "=r"(r[j].y), "=r"(r[j].z), "=r"(r[j].w)
                     : "r"(stage + swizzled(row, g)) : "memory");
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // the stage's bytes are in registers
      // B: x row g at the fragment's k 2t, 2t+1 | 2t+8, 2t+9
      const uint32_t xb0 = *reinterpret_cast<const uint32_t*>(xrow + i * kTcStageRows);
      const uint32_t xb1 = *reinterpret_cast<const uint32_t*>(xrow + i * kTcStageRows + 8);
      const uint32_t fl[4][4] = {
          {r[0].x ^ 0x80808080u, r[0].y ^ 0x80808080u, r[0].z ^ 0x80808080u, r[0].w ^ 0x80808080u},
          {r[1].x ^ 0x80808080u, r[1].y ^ 0x80808080u, r[1].z ^ 0x80808080u, r[1].w ^ 0x80808080u},
          {r[2].x ^ 0x80808080u, r[2].y ^ 0x80808080u, r[2].z ^ 0x80808080u, r[2].w ^ 0x80808080u},
          {r[3].x ^ 0x80808080u, r[3].y ^ 0x80808080u, r[3].z ^ 0x80808080u, r[3].w ^ 0x80808080u}};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t af[4];  // rows 2t, 2t+1 | 2t+8, 2t+9 of columns 2j (a0, a2), 2j + 1 (a1, a3)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * j + h, wi = c >> 2, b = c & 3;
          const float q0 = s8_to_float(fl[0][wi], b), q1 = s8_to_float(fl[1][wi], b);
          const float q2 = s8_to_float(fl[2][wi], b), q3 = s8_to_float(fl[3][wi], b);
          // the exact bf16 of q (7 significant bits) is a float's upper half
          const uint32_t s2 = __byte_perm(sv[j], 0u, h ? 0x3232u : 0x1010u);
          af[h] = hmul2_bits(__byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632u), s2);
          af[h + 2] = hmul2_bits(__byte_perm(__float_as_uint(q2), __float_as_uint(q3), 0x7632u), s2);
        }
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(xb0), "r"(xb1));
      }
    }
  }

  // lane (g, t) holds rows 2t, 2t + 1 of x (c0, c1 | c2, c3) times columns
  // 16g + 2j (c0, c1) and 16g + 2j + 1 (c2, c3).  A row of sums keeps
  // column c at c + c / 16, so the 32 lanes' stores fall in 32 banks.
  __syncthreads();  // the ring is spent: its space holds the sums
  if (warp < kTcConsumers) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 2 * t + (e & 1), c = 16 * g + 2 * j + (e >> 1);
        red[(warp * kW8Rows + m) * kTcRedRow + c + g] = acc[j][e];
      }
  }
  __syncthreads();
  // the warps' sums in warp order: y (one rank) or the rank's sums
  const int rows = min(kW8Rows, a.M - m0);
  __nv_bfloat16* y = a.y[rec];
  for (int o = threadIdx.x; o < kTcOut; o += kTcThreads) {
    const int m = o / kTcStrip, c = o % kTcStrip;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kTcConsumers; ++w) v += red[(w * kW8Rows + m) * kTcRedRow + c + (c >> 4)];
    if (ranks > 1)
      part[o] = v;
    else if (m < rows && col0 + c < n)
      y[static_cast<long long>(m0 + m) * n + col0 + c] = __float2bfloat16_rn(v);
  }
  if (ranks == 1) return;
  // the ranks' sums in rank order: rank r writes every ranks-th output
  cluster_sync();
  const uint32_t part_addr = static_cast<uint32_t>(__cvta_generic_to_shared(part));
  for (int o = rank * kTcThreads + threadIdx.x; o < kTcOut; o += ranks * kTcThreads) {
    const int m = o / kTcStrip, c = o % kTcStrip;
    if (m >= rows || col0 + c >= n) continue;
    float pv[kTcMaxCluster];
#pragma unroll
    for (int q = 0; q < kTcMaxCluster; ++q)  // every load in flight, then the sum in order
      pv[q] = q < static_cast<int>(ranks) ? ld_cluster(at_rank(part_addr + 4 * o, q)) : 0.0f;
    float v = pv[0];
#pragma unroll
    for (int q = 1; q < kTcMaxCluster; ++q)
      if (q < static_cast<int>(ranks)) v += pv[q];
    y[static_cast<long long>(m0 + m) * n + col0 + c] = __float2bfloat16_rn(v);
  }
  cluster_sync();  // no rank leaves while another still reads its sums
}

// A (N, K) view of the int8 (K, N) weight q: a box of 128 columns × 64 rows
// in the 128-byte swizzle; rows past K and columns past N read as zeros.
int q_map(CUtensorMap* map, const int8_t* q, int k, int n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t box[2] = {kTcStrip, kTcStageRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                            const_cast<int8_t*>(q), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_tc(const W8Params& p, cudaStream_t stream) {
  W8TcArgs a = {};
  int strips = 0;
  for (int r = 0; r < p.records; ++r) {
    const int err = q_map(&a.map[r], p.q[r], p.K, p.n[r]);
    if (err != 0) return err;
    a.s[r] = p.s[r];
    a.y[r] = static_cast<__nv_bfloat16*>(p.y[r]);
    a.n[r] = p.n[r];
    strips += (p.n[r] + kTcStrip - 1) / kTcStrip;
    a.strip_end[r] = strips;
  }
  a.x = static_cast<const __nv_bfloat16*>(p.x);
  a.records = p.records;
  a.M = p.M;
  a.K = p.K;
  a.chunk = p.chunk;
  a.x_vec = p.K % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips, p.splits, (p.M + kW8Rows - 1) / kW8Rows);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = tc_smem_bytes(p.chunk);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rm_w8_matmul_tc_kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// y = the sum of the split-K partials, in chunk order.
template <typename T>
__global__ void __launch_bounds__(kW8ReduceThreads)
rm_w8_reduce_kernel(const float* partials, int splits, long long mn, T* y) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partials[s * mn + i];
    y[i] = from_float<T>(v);
  }
}

template <typename T>
int launch_cuda_cores(const W8Params& p, cudaStream_t stream) {
  const dim3 grid((p.n[0] + kW8Strip - 1) / kW8Strip, p.splits, (p.M + kW8Rows - 1) / kW8Rows);
  const int smem = p.chunk * kW8Rows * 4 > kW8RedBytes ? p.chunk * kW8Rows * 4 : kW8RedBytes;
  rm_w8_matmul_kernel<T><<<grid, kW8Threads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const long long mn = static_cast<long long>(p.M) * p.n[0];
  long long blocks = (mn + kW8ReduceThreads - 1) / kW8ReduceThreads;
  if (blocks > 4096) blocks = 4096;
  rm_w8_reduce_kernel<T><<<static_cast<int>(blocks), kW8ReduceThreads, 0, stream>>>(
      p.partials, p.splits, mn, static_cast<T*>(p.y[0]));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// A plan either kernel can run: the wrapper's checks, repeated.
bool valid(const W8Params& p) {
  if (p.M <= 0 || p.M > kW8Rows * kW8Rows || p.K <= 0 || p.chunk <= 0 ||
      p.splits != (p.K + p.chunk - 1) / p.chunk || p.x == nullptr ||
      p.records < 1 || p.records > kW8MaxRecords || (p.dtype != 0 && p.dtype != 1))
    return false;
  for (int r = 0; r < p.records; ++r)
    if (p.q[r] == nullptr || p.s[r] == nullptr || p.y[r] == nullptr || p.n[r] <= 0 ||
        p.n[r] % 8 != 0 || !aligned(p.q[r], 8))
      return false;
  if (p.form == kFormCudaCores)
    return p.records == 1 && p.chunk <= kW8MaxChunk && p.splits <= 65535 &&
           (p.splits == 1 || p.partials != nullptr);
  if (p.form != kFormTensor || p.dtype != 1 || p.chunk % kTcStageRows != 0 ||
      p.chunk > kTcMaxChunk || p.splits > kTcMaxCluster)
    return false;
  for (int r = 0; r < p.records; ++r)
    if (p.n[r] % 16 != 0 || !aligned(p.q[r], 16) || !aligned(p.s[r], 16)) return false;
  return true;
}

}  // namespace

extern "C" {

int rm_w8_params_size() { return static_cast<int>(sizeof(W8Params)); }

// Allow the tensor-core kernel its largest shared memory (a rank's x at
// kTcMaxChunk rows) on the current device: once, before any launch, so no
// launch a CUDA graph captures sets an attribute.
int rm_w8_init() {
  return static_cast<int>(cudaFuncSetAttribute(rm_w8_matmul_tc_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               tc_smem_bytes(kTcMaxChunk)));
}

// Launch on `stream` without synchronising; returns the launches'
// cudaGetLastError() (0 on success).  The wrapper has checked types,
// shapes, devices and contiguity and planned chunk and splits; a plan the
// kernels cannot run is refused here too.
int rm_w8_matmul(const W8Params* params, void* stream) {
  const W8Params& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.form == kFormTensor) return launch_tc(p, s);
  return p.dtype == 1 ? launch_cuda_cores<__nv_bfloat16>(p, s) : launch_cuda_cores<float>(p, s);
}

}  // extern "C"
