// The int8-weight decode matmul: y (M, N) = x (M, K) @ dequant(q, s), with
// q an int8 (K, N) weight and s its bf16 per-column scale (1, N).
//
// Replaces: no Pallas kernel.  The reference's `cast` of an int8 record,
// `q.astype(dt) * s.astype(dt)` (src/repro/models/layers.py:51), is fused by
// XLA into the matmul that consumes it, so on the TPU the device reads the
// int8 buffer once.  Eager PyTorch would write and re-read a dequantized copy
// of every weight; this kernel reads the int8 buffer itself.
//
// Bound: bytes.  A decode step has M = B (8 on the serving path) rows, so a
// weight byte feeds 2·M operations: the K·N weight bytes, read once, set
// the time (qwen3-8b: 192,937,984 B a layer).  The work around the bytes
// must stay below them: on the CUDA cores, eight float32 FMAs a weight and
// its dequant cost more issue slots than the bytes take to arrive, so the
// bf16 form runs its products on the tensor cores.  Two forms, one design:
//   * a block of four warps owns a strip of output columns and a chunk of K
//     (split-K, so that the grid fills the card for N as small as 1,024);
//     the warps take interleaved rows of the chunk; the block's rows of x
//     (an m tile of 8; zeros past M) are staged in shared memory;
//   * a weight byte is dequantized in registers exactly as `cast` does:
//     float(q), exact (the byte's sign flipped into the mantissa of 2^23,
//     instead of the quarter-rate I2F), times s, rounded to bf16 when x is
//     bf16 (the exact product rounded once); products accumulate in float32;
//   * bf16, N a multiple of 16 (rm_w8_matmul_tc_kernel): a warp owns 128
//     columns and walks K 16 rows a step with mma.sync m16n8k16, y^T =
//     W^T x^T: the dequantized q^T as A, 16 columns a tile, and x^T as B,
//     its 8 rows the tile's n, so no part of a tile is padding.  Lane
//     (g, t) loads rows 4t..4t+3 of the step and columns 16g..16g+15 (four
//     16-byte loads, the next step's in flight while this one is served);
//     in mma j its A rows g and g+8 are columns 16g+2j and 16g+2j+1.  Since
//     k is summed over, the four physical rows stand for the fragment's
//     k = 2t, 2t+1, 2t+8, 2t+9, and x is read in the same order;
//   * otherwise (float32, or N a multiple of 8 but not of 16:
//     rm_w8_matmul_kernel, CUDA cores) a lane owns 8 columns of a
//     256-column strip, reads them with one 8-byte load a row, 8 rows in
//     flight, and does the 8 × 8 FMAs itself;
//   * the four warps' sums meet in shared memory and are added in warp
//     order; with several K chunks each block writes a float32 partial and
//     rm_w8_reduce_kernel adds them in chunk order.  No atomics: a result
//     is the same every run (and inside a CUDA graph).
// The launcher only enqueues on the caller's stream (no synchronisation, no
// allocation, no attribute calls: under 48 KB of shared memory), so a CUDA
// graph can capture it.  wgmma, TMA and larger M are later work.
//
// The layout of W8Params is mirrored by ctypes in
// repro_torch/kernels/_cuda.py (_W8Params), checked at load time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// At namespace scope, not in the unnamed namespace: the extern "C" entry
// point takes it, and a type of internal linkage would hide that symbol.
struct W8Params {
  const void* x;             // (M, K) float32 or bf16, contiguous
  const int8_t* q;           // (K, N) int8, contiguous
  const __nv_bfloat16* s;    // (1, N) bf16
  void* y;                   // (M, N) in x's type
  float* partials;           // (splits, M, N) float32 when splits > 1
  int32_t M, K, N;
  int32_t chunk;             // K rows a block, <= kW8MaxChunk
  int32_t splits;            // ceil(K / chunk)
  int32_t dtype;             // 0 float32, 1 bf16
  int32_t form;              // kFormCudaCores or kFormTensor
  int32_t pad_;
};

namespace {

constexpr int kW8Threads = 128;                // four warps a block
constexpr int kW8Warps = kW8Threads / 32;
constexpr int kW8Cols = 8;                     // columns a lane: one 8-byte load
constexpr int kW8Strip = 32 * kW8Cols;         // 256 columns a block
constexpr int kW8Rows = 8;                     // rows of x a block (an m tile)
constexpr int kW8Unroll = 8;                   // rows of q a warp has in flight
constexpr int kW8MaxChunk = 1024;              // K rows a block stages
constexpr int kW8RedBytes = kW8Warps * kW8Rows * kW8Strip * 4;  // 32 KB
constexpr int kW8ReduceThreads = 256;
constexpr int kW8TcStrip = 128;                // columns a tensor-core block
constexpr int kW8TcXPad = 8;                   // bf16 pad of a staged x row
constexpr int kW8TcRedRow = 140;               // floats a row of the warps' sums
// W8Params::form: the CUDA cores (N % 8 == 0, q 8-byte aligned) or the
// tensor cores (bf16, N % 16 == 0, q and s 16-byte aligned)
enum Form : int32_t { kFormCudaCores = 0, kFormTensor = 1 };

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

// Where a block's partial sums go: y directly (one K chunk) or its row of
// the split-K partials.
template <typename T>
__device__ __forceinline__ void store_sum(const W8Params& p, int row, int col, float v) {
  const long long at = static_cast<long long>(row) * p.N + col;
  if (p.splits == 1)
    static_cast<T*>(p.y)[at] = from_float<T>(v);
  else
    p.partials[static_cast<long long>(blockIdx.y) * p.M * p.N + at] = v;
}

// Eight int8 weights of row k from column col (col < N, N % 8 == 0).
__device__ __forceinline__ uint2 load_q(const W8Params& p, int k, int col) {
  return __ldg(reinterpret_cast<const uint2*>(p.q + static_cast<long long>(k) * p.N + col));
}

template <typename T>
__global__ void __launch_bounds__(kW8Threads, 4)
rm_w8_matmul_kernel(const __grid_constant__ W8Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    sc[c] = col0 + c < p.N ? __bfloat162float(p.s[col0 + c]) : 0.0f;
  __syncthreads();

  float acc[kW8Rows][kW8Cols];
#pragma unroll
  for (int m = 0; m < kW8Rows; ++m)
#pragma unroll
    for (int c = 0; c < kW8Cols; ++c) acc[m][c] = 0.0f;

  if (col0 < p.N) {
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
    if (row >= p.M || col >= p.N) continue;
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

// Rows 4t..4t+3 of k step `step`, columns col..col+15 (zeros past the chunk
// or past N).
__device__ __forceinline__ void load_tc(const W8Params& p, int k0, int kc, int step, int t,
                                        int col, uint4 (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = step * 16 + 4 * t + i;
    r[i] = (kk < kc && col < p.N)
               ? __ldg(reinterpret_cast<const uint4*>(p.q + static_cast<long long>(k0 + kk) * p.N + col))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kW8Threads, 4)
rm_w8_matmul_tc_kernel(const __grid_constant__ W8Params p) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* red = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip0 = blockIdx.x * kW8TcStrip;
  const int col = strip0 + 16 * g;  // this lane's 16 columns of q
  const int k0 = blockIdx.y * p.chunk;
  const int kc = min(p.K - k0, p.chunk);
  const int steps = (kc + 15) / 16;
  const int stride = steps * 16 + kW8TcXPad;  // a staged row of x, in bf16
  const int m0 = blockIdx.z * kW8Rows;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);

  // the first step's weights are in flight while x is staged
  uint4 cur[4] = {}, nxt[4] = {};
  if (warp < steps) load_tc(p, k0, kc, warp, t, col, cur);
  // x[m0 : m0 + 8, k0 : k0 + kc] in bf16, row-major, zeros past M and kc
  for (int i = threadIdx.x; i < kW8Rows * steps * 16; i += kW8Threads) {
    const int m = i / (steps * 16), kk = i - m * (steps * 16);
    xs[m * stride + kk] = (m0 + m < p.M && kk < kc)
                              ? x[static_cast<long long>(m0 + m) * p.K + k0 + kk]
                              : __float2bfloat16_rn(0.0f);
  }
  // s of the lane's 16 columns, two bf16 a word
  uint4 sw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (col < p.N) {
    sw[0] = __ldg(reinterpret_cast<const uint4*>(p.s + col));
    sw[1] = __ldg(reinterpret_cast<const uint4*>(p.s + col + 8));
  }
  __syncthreads();

  // mma j: A rows g and g + 8 are this lane's columns col + 2j and
  // col + 2j + 1, so C (16 columns x 8 rows of x) has no padding
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int step = warp; step < steps; step += kW8Warps) {
    if (step + kW8Warps < steps) load_tc(p, k0, kc, step + kW8Warps, t, col, nxt);
    // B: x row g at the fragment's k 2t, 2t+1 | 2t+8, 2t+9, physical
    // rows 4t, 4t+1 | 4t+2, 4t+3 of the step
    const uint2 xb = *reinterpret_cast<const uint2*>(xs + g * stride + step * 16 + 4 * t);
    const uint32_t fl[4][4] = {
        {cur[0].x ^ 0x80808080u, cur[0].y ^ 0x80808080u, cur[0].z ^ 0x80808080u, cur[0].w ^ 0x80808080u},
        {cur[1].x ^ 0x80808080u, cur[1].y ^ 0x80808080u, cur[1].z ^ 0x80808080u, cur[1].w ^ 0x80808080u},
        {cur[2].x ^ 0x80808080u, cur[2].y ^ 0x80808080u, cur[2].z ^ 0x80808080u, cur[2].w ^ 0x80808080u},
        {cur[3].x ^ 0x80808080u, cur[3].y ^ 0x80808080u, cur[3].z ^ 0x80808080u, cur[3].w ^ 0x80808080u}};
    const uint32_t sv[8] = {sw[0].x, sw[0].y, sw[0].z, sw[0].w, sw[1].x, sw[1].y, sw[1].z, sw[1].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t a[4];  // rows 4t, 4t+1 | 4t+2, 4t+3 of columns 2j (a0, a2), 2j + 1 (a1, a3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * j + h, wi = c >> 2, b = c & 3;
        const float q0 = s8_to_float(fl[0][wi], b), q1 = s8_to_float(fl[1][wi], b);
        const float q2 = s8_to_float(fl[2][wi], b), q3 = s8_to_float(fl[3][wi], b);
        // the exact bf16 of q (7 significant bits) is a float's upper half
        const uint32_t s2 = __byte_perm(sv[j], 0u, h ? 0x3232u : 0x1010u);
        a[h] = hmul2_bits(__byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632u), s2);
        a[h + 2] = hmul2_bits(__byte_perm(__float_as_uint(q2), __float_as_uint(q3), 0x7632u), s2);
      }
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(xb.x), "r"(xb.y));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }

  // lane (g, t) holds rows 2t, 2t + 1 of x (c0, c1 | c2, c3) times columns
  // col + 2j (c0, c1) and col + 2j + 1 (c2, c3).  A row of sums keeps
  // column c at c + c / 16, so the 32 lanes' stores fall in 32 banks.
  __syncthreads();  // every warp is done with xs: the space holds the sums
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1), c = 16 * g + 2 * j + (e >> 1);
      red[(warp * kW8Rows + m) * kW8TcRedRow + c + g] = acc[j][e];
    }
  __syncthreads();
  for (int o = threadIdx.x; o < kW8Rows * kW8TcStrip; o += kW8Threads) {
    const int m = o / kW8TcStrip, c = o % kW8TcStrip;
    const int row = m0 + m, out = strip0 + c;
    if (row >= p.M || out >= p.N) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kW8Warps; ++w) v += red[(w * kW8Rows + m) * kW8TcRedRow + c + (c >> 4)];
    store_sum<__nv_bfloat16>(p, row, out, v);
  }
}

void launch_tc(const W8Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + kW8TcStrip - 1) / kW8TcStrip, p.splits, (p.M + kW8Rows - 1) / kW8Rows);
  const int steps = (p.chunk + 15) / 16;
  const int xs = kW8Rows * (steps * 16 + kW8TcXPad) * 2;
  const int redb = kW8Warps * kW8Rows * kW8TcRedRow * 4;
  rm_w8_matmul_tc_kernel<<<grid, kW8Threads, xs > redb ? xs : redb, stream>>>(p);
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
cudaError_t launch(const W8Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + kW8Strip - 1) / kW8Strip, p.splits, (p.M + kW8Rows - 1) / kW8Rows);
  const int smem = p.chunk * kW8Rows * 4 > kW8RedBytes ? p.chunk * kW8Rows * 4 : kW8RedBytes;
  if (p.form == kFormTensor)
    launch_tc(p, stream);
  else
    rm_w8_matmul_kernel<T><<<grid, kW8Threads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long mn = static_cast<long long>(p.M) * p.N;
  long long blocks = (mn + kW8ReduceThreads - 1) / kW8ReduceThreads;
  if (blocks > 4096) blocks = 4096;
  rm_w8_reduce_kernel<T><<<static_cast<int>(blocks), kW8ReduceThreads, 0, stream>>>(
      p.partials, p.splits, mn, static_cast<T*>(p.y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rm_w8_params_size() { return static_cast<int>(sizeof(W8Params)); }

// Launch on `stream` without synchronising; returns the launches'
// cudaGetLastError() (0 on success).  The wrapper has checked types,
// shapes, devices and contiguity and planned chunk and splits; a plan the
// kernels cannot run is refused here too.
int rm_w8_matmul(const W8Params* params, void* stream) {
  const W8Params& p = *params;
  if (p.M <= 0 || p.K <= 0 || p.N <= 0 || p.chunk <= 0 || p.chunk > kW8MaxChunk ||
      p.splits != (p.K + p.chunk - 1) / p.chunk || p.splits > 65535 ||
      (p.M + kW8Rows - 1) / kW8Rows > 65535 || (p.splits > 1 && p.partials == nullptr) ||
      (p.dtype != 0 && p.dtype != 1) || p.N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(p.q) % 8 != 0 ||
      (p.form == kFormTensor &&
       (p.dtype != 1 || p.N % 16 != 0 || reinterpret_cast<uintptr_t>(p.q) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(p.s) % 16 != 0)) ||
      (p.form != kFormCudaCores && p.form != kFormTensor))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

}  // extern "C"
