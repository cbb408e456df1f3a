// The decode-sized expert FFN of the MoE block, in two launches over the
// dispatched buffer x (E, cap, d) and the kept rows of each expert, count (E,):
//   gate/up: h[e, c] = silu(x[e, c] @ Wg[e]) * (x[e, c] @ Wu[e])   (E, cap, f)
//   down:    y[e, c] = h[e, c] @ Wd[e]                              (E, cap, d)
// for c < count[e]; rows c >= count[e] are written as zeros, which is what
// the dense form gives on the dispatch's zero rows (silu(0) * 0 = 0).
//
// Replaces: no Pallas kernel.  The reference's expert FFN is three einsums
// over the dense (E, cap, d) buffer (src/repro/models/layers.py:583-585),
// which XLA runs over every one of the E experts.  A decode step routes its
// few tokens to a fraction of them (qwen3-moe-235b: 8 tokens, top-8 of 128
// experts, about 52 touched), so the dense form reads every expert's weights
// (4.83 GB a layer in bf16) where the answer needs the touched ones (about
// 1.96 GB).  Skipping the others in PyTorch needs shapes that depend on the
// data (nonzero, boolean indexing), which read back to the host and break
// the decode step's CUDA graph; this kernel reads each expert's count on the
// device, and the blocks of an expert with no rows write their zeros and
// leave.
//
// Bound: bytes.  Each touched expert's three weights are read once
// (touched · 3 · d · f · elem bytes) plus x and y, over the 3.35 TB/s of the
// H100 SXM data sheet: 0.59 ms a layer at qwen3-moe-235b's decode step.  A
// weight element feeds at most 16 FMAs (one a kept row), so the CUDA cores'
// float32 rate is not the limit at the decode step's 4 rows.
//
// Design (a simple kernel; no tensor cores, no TMA):
//   * a block of 8 warps owns one expert (blockIdx.y) and a strip of 32 · VEC
//     output columns (blockIdx.x), VEC = 16 bytes of the dtype (8 bf16, 4
//     float32): a lane reads its VEC columns of a weight row with one 16-byte
//     load, eight rows in flight, and keeps float32 sums for the ROWS (4, 8
//     or 16, the least >= cap) rows of x in registers;
//   * the warps split K into interleaved blocks of 8 rows (gate/up: warps 0-3
//     the gate weight, 4-7 the up weight); x is staged in shared memory
//     k-major as float32, 512 rows of K at a time, so a lane reads the rows'
//     values at one k with one broadcast 16-byte load;
//   * the warps' sums meet in shared memory and are added in warp order: no
//     atomics and no second pass, so a result is the same every run and in
//     a CUDA graph's replay.  The rounding points are the dense form's: each
//     product rounded to the dtype, then silu, rounded, then the product of
//     the two, rounded;
//   * a block reads count[e] (clamped to [0, cap]) on the device: count 0
//     writes the strip's cap zero rows and returns before any weight load.
//
// The launcher only enqueues on the caller's stream (no synchronisation, no
// allocation), so a CUDA graph can capture it, and returns
// cudaGetLastError().  The layout of MoeParams is mirrored by ctypes in
// repro_torch/kernels/_cuda.py (_MoeParams), checked at load time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// At namespace scope: the extern "C" entry point takes it.
struct MoeParams {
  const void* x;            // (E, cap, K) float32 or bf16, contiguous
  const long long* count;   // (E,) int64: kept rows of each expert
  const void* w0;           // (E, K, N): the gate weight (gated) or the down weight
  const void* w1;           // (E, K, N): the up weight (gated), else null
  void* y;                  // (E, cap, N) in x's type
  int32_t experts, cap, K, N;
  int32_t rows;             // 4, 8 or 16: the kernel's rows, >= cap
  int32_t dtype;            // 0 float32, 1 bf16
  int32_t gated;            // 1: y = silu(x @ w0) * (x @ w1); 0: y = x @ w0
  int32_t pad_;
};

namespace {

constexpr int kMoeThreads = 256;   // eight warps a block
constexpr int kMoeWarps = kMoeThreads / 32;
constexpr int kMoeKBlock = 8;      // K rows a warp loads at a time (in flight)
constexpr int kMoeChunk = 512;     // K rows of x staged at a time
constexpr int kMoeRedRows = 4;     // rows of sums one reduction round stages

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
// v rounded to T and back: the dense form's rounding of an intermediate
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return to_float<T>(from_float<T>(v));
}

// The 16 bytes of a weight row at a lane's columns, as floats.
__device__ __forceinline__ void unpack(uint4 raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(uint4 raw, float* out, __nv_bfloat16) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its float
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <typename T, int ROWS, bool GATED>
struct MoeShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // columns a lane
  static constexpr int kStrip = 32 * kVec;                        // columns a block
  static constexpr int kGroupWarps = GATED ? kMoeWarps / 2 : kMoeWarps;  // warps a weight
  static constexpr int kXFloats = kMoeChunk * ROWS;               // the staged x
  static constexpr int kRedFloats = kMoeWarps * kMoeRedRows * kStrip;
  static constexpr int kSmemFloats = kXFloats > kRedFloats ? kXFloats : kRedFloats;
};

// Block (strip blockIdx.x, expert blockIdx.y).
template <typename T, int ROWS, bool GATED>
__global__ void __launch_bounds__(kMoeThreads, ROWS == 4 ? 2 : 1)
rm_moe_ffn_kernel(const __grid_constant__ MoeParams p) {
  using S = MoeShape<T, ROWS, GATED>;
  constexpr int kVec = S::kVec, kStrip = S::kStrip, kGroupWarps = S::kGroupWarps;
  static_assert(ROWS % 4 == 0 && ROWS % kMoeRedRows == 0, "rows come in fours");
  __shared__ __align__(16) float smem[S::kSmemFloats];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.y;
  const int strip0 = blockIdx.x * kStrip;
  const int col0 = strip0 + lane * kVec;
  const long long stored = p.count[e];
  const int cnt = stored < 0 ? 0 : (stored > p.cap ? p.cap : static_cast<int>(stored));
  T* y = static_cast<T*>(p.y) + static_cast<long long>(e) * p.cap * p.N;

  if (cnt == 0) {  // an expert no row reached: its zero rows, no weight read
    for (int i = threadIdx.x; i < p.cap * kStrip; i += kMoeThreads) {
      const int col = strip0 + i % kStrip;
      if (col < p.N) y[static_cast<long long>(i / kStrip) * p.N + col] = from_float<T>(0.0f);
    }
    return;
  }

  const int group = warp / kGroupWarps, gw = warp % kGroupWarps;
  const T* w = static_cast<const T*>(group ? p.w1 : p.w0) +
               static_cast<long long>(e) * p.K * p.N;
  const T* x = static_cast<const T*>(p.x) + static_cast<long long>(e) * p.cap * p.K;
  const bool active = col0 < p.N;

  float acc[ROWS][kVec];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < p.K; k0 += kMoeChunk) {
    const int kc = min(kMoeChunk, p.K - k0);
    __syncthreads();  // the previous chunk's readers are done
    // xs[kk][r] = x[r][k0 + kk] as float32 (rows at or past cnt as zeros)
    for (int i = threadIdx.x; i < kc * ROWS; i += kMoeThreads) {
      const int r = i / kc, kk = i - r * kc;
      smem[kk * ROWS + r] =
          r < cnt ? to_float<T>(x[static_cast<long long>(r) * p.K + k0 + kk]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int kb = gw * kMoeKBlock; kb < kc; kb += kGroupWarps * kMoeKBlock) {
      uint4 raw[kMoeKBlock];  // K % 8 == 0, so a block of 8 rows is whole
#pragma unroll
      for (int u = 0; u < kMoeKBlock; ++u)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<long long>(k0 + kb + u) * p.N + col0));
#pragma unroll
      for (int u = 0; u < kMoeKBlock; ++u) {
        float wf[kVec];
        unpack(raw[u], wf, T());
        const float4* xk = reinterpret_cast<const float4*>(smem + (kb + u) * ROWS);
#pragma unroll
        for (int r4 = 0; r4 < ROWS / 4; ++r4) {
          if (4 * r4 < cnt) {  // the same for the whole block
            const float4 xq = xk[r4];
            const float xr[4] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < kVec; ++c)
                acc[4 * r4 + j][c] = fmaf(xr[j], wf[c], acc[4 * r4 + j][c]);
          }
        }
      }
    }
  }

  // the warps' sums, kMoeRedRows rows a round, added in warp order
  float* red = smem;  // [warp][row of the round][column of the strip]
#pragma unroll
  for (int r0 = 0; r0 < ROWS; r0 += kMoeRedRows) {
    __syncthreads();  // the staged x (or the last round) is no longer read
#pragma unroll
    for (int j = 0; j < kMoeRedRows; ++j) {
      float4* dst = reinterpret_cast<float4*>(red + (warp * kMoeRedRows + j) * kStrip + lane * kVec);
#pragma unroll
      for (int c = 0; c < kVec; c += 4)
        dst[c / 4] = make_float4(acc[r0 + j][c], acc[r0 + j][c + 1], acc[r0 + j][c + 2],
                                 acc[r0 + j][c + 3]);
    }
    __syncthreads();
    for (int o = threadIdx.x; o < kMoeRedRows * kStrip; o += kMoeThreads) {
      const int j = o / kStrip, c = o - j * kStrip;
      const int row = r0 + j, col = strip0 + c;
      if (row >= p.cap || col >= p.N) continue;
      float v = 0.0f;
      if (row < cnt) {
        if constexpr (GATED) {
          float g = 0.0f, u = 0.0f;
#pragma unroll
          for (int ww = 0; ww < kGroupWarps; ++ww) g += red[(ww * kMoeRedRows + j) * kStrip + c];
#pragma unroll
          for (int ww = kGroupWarps; ww < kMoeWarps; ++ww)
            u += red[(ww * kMoeRedRows + j) * kStrip + c];
          g = rounded<T>(g);
          u = rounded<T>(u);
          const float s = rounded<T>(g / (1.0f + expf(-g)));
          v = s * u;
        } else {
#pragma unroll
          for (int ww = 0; ww < kMoeWarps; ++ww) v += red[(ww * kMoeRedRows + j) * kStrip + c];
        }
      }
      y[static_cast<long long>(row) * p.N + col] = from_float<T>(v);
    }
  }
}

template <typename T, int ROWS>
int launch(const MoeParams& p, cudaStream_t stream) {
  constexpr int kStrip = MoeShape<T, ROWS, true>::kStrip;
  const dim3 grid((p.N + kStrip - 1) / kStrip, p.experts);
  if (p.gated)
    rm_moe_ffn_kernel<T, ROWS, true><<<grid, kMoeThreads, 0, stream>>>(p);
  else
    rm_moe_ffn_kernel<T, ROWS, false><<<grid, kMoeThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const MoeParams& p, cudaStream_t stream) {
  switch (p.rows) {
    case 4: return launch<T, 4>(p, stream);
    case 8: return launch<T, 8>(p, stream);
    default: return launch<T, 16>(p, stream);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The wrapper's checks, repeated: a plan the kernel cannot run is refused.
bool valid(const MoeParams& p) {
  if (p.x == nullptr || p.count == nullptr || p.w0 == nullptr || p.y == nullptr ||
      (p.gated && p.w1 == nullptr) || (p.gated != 0 && p.gated != 1) ||
      (p.dtype != 0 && p.dtype != 1))
    return false;
  if (p.rows != 4 && p.rows != 8 && p.rows != 16) return false;
  if (p.experts < 1 || p.experts > 65535 || p.cap < 1 || p.cap > p.rows) return false;
  if (p.K < 8 || p.K % 8 != 0 || p.N < 8 || p.N % 8 != 0) return false;
  return aligned16(p.x) && aligned16(p.w0) && (!p.gated || aligned16(p.w1));
}

}  // namespace

extern "C" {

int rm_moe_params_size() { return static_cast<int>(sizeof(MoeParams)); }

// Launch one stage (gate/up when p.gated, else down) on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
int rm_moe_ffn(const MoeParams* params, void* stream) {
  const MoeParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.dtype == 1 ? launch_rows<__nv_bfloat16>(p, s) : launch_rows<float>(p, s);
}

}  // extern "C"
