// GQA flash-attention forward for Hopper (sm_90a).
//
//   rm_flash_attention_kernel   <- repro/kernels/flash_attention.py  _flash_kernel
//
// out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the keys j the mask allows: j < S, and causal 0 <= i - j < window, or
// bidirectional |i - j| < window (window = S when the layer has none).  q is
// (B, S, H, D), k and v (B, S, KH, D), out as q; G = H / KH query heads share
// one KV head.  The arithmetic is the reference kernel's: q and k in float32,
// q scaled before the dot, masked logits set to -1e30 (not -inf), an online
// softmax over key tiles with float32 m, l and accumulator, p rounded to v's
// type before the PV product, and out = acc / max(l, 1e-30).
//
// What bounds it: operations.  At the serving path's prefill shape (B 8,
// S 2,048, H 32, KH 8, D 128, bf16, causal) the unmasked pairs need
// 4 B H D S (S + 1) / 2 = 2.75e11 operations, 0.278 ms at the 989 TFLOP/s of
// the bf16 tensor cores, against 0.100 ms to move Q, K, V and O once at
// 3.35 TB/s.
//
// Design (a first, simple kernel on the CUDA cores; tensor cores, mma.sync
// or wgmma with TMA, are the redesign's work).  The Pallas grid (BH, n_q,
// n_k) carries its accumulator across the sequential k dimension in VMEM;
// here one block owns one (batch, head, 64-query tile) and walks its key
// tiles in a loop, so nothing carries between blocks:
//
//   * the block's Q tile is staged once in shared memory as scaled float32;
//     each 64-key K and V tile is staged in turn as float32 (K rows padded by
//     4 floats, so a quarter-warp's 16-byte row reads hit 32 distinct banks);
//   * 16 warps each own 4 query rows.  A lane computes the logits of keys
//     lane and lane + 32 for the warp's 4 rows (float4 reads of K, broadcast
//     float4 reads of Q: 12 shared loads per 32 FMAs), then the online
//     softmax update (a warp max per row; l kept as per-lane partials, summed
//     once at the end), writes its p values to the warp's slice of shared
//     memory, and accumulates p V for the D / 32 output columns it owns;
//   * key tiles that lie wholly outside the causal or window range are
//     skipped.  With -1e30 masking a fully masked tile adds exp(0) terms that
//     a later real tile wipes out through alpha = exp(m_prev - m_new) = 0, so
//     skipping changes nothing as long as every row meets a real key — which
//     holds inside S, since key = query is always allowed;
//   * the public (B, S, H, D) layout is read through strides (no transpose or
//     padded copy): rows past S stage as zeros and are masked, and query rows
//     past S are not stored;
//   * query tiles are issued last-first, so a causal launch starts its
//     longest blocks first.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per staged tile
constexpr int kRows = 4;      // query rows per warp (the float4 p stores assume 4)
constexpr int kWarps = kBlockQ / kRows;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -1e30f;
constexpr unsigned kNegInfBits = 0xff800000u;  // -inf as float32 bits

}  // namespace

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_FlashParams), which
// checks sizeof at load time.  Strides are in elements.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p in v's type, back in float32 for the product (exact for bf16 x bf16)
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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

template <typename T, int D>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int e = threadIdx.x; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int i = q0 + r;
    q_s[e] = i < S ? to_float(q[i * p.q_ss + d]) * p.scale : 0.0f;
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
    m[r] = __uint_as_float(kNegInfBits);
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
      k_s[r * kKs + d] = in ? to_float(k[j * p.k_ss + d]) : 0.0f;
      v_s[e] = in ? to_float(v[j * p.v_ss + d]) : 0.0f;
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
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + (p0 + p1);
      m[r] = m_new;
      pa[r] = round_like(p0, static_cast<const T*>(nullptr));
      pb[r] = round_like(p1, static_cast<const T*>(nullptr));
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
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    if (i >= S) continue;
    T* o = static_cast<T*>(p.out) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) from_float(o + d, acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(rm_flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, p.batch * p.heads);
  rm_flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const FlashParams& p, cudaStream_t stream) {
  switch (p.head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" {

int rm_flash_params_size() { return static_cast<int>(sizeof(FlashParams)); }

// Launch on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).  The wrapper has checked shapes,
// types and strides; a bad head_dim or dtype is refused here too.
int rm_flash_attention(const FlashParams* params, void* stream) {
  const FlashParams& p = *params;
  if (p.seq <= 0 || p.batch <= 0 || p.heads <= 0 || p.kv_heads <= 0 ||
      p.heads % p.kv_heads != 0 || p.window < 1 || p.batch * p.heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) return launch_dim<float>(p, s);
  if (p.dtype == 1) return launch_dim<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
