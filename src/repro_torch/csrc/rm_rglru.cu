// The RG-LRU linear recurrence of the Griffin block's prefill:
//   h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],   h[b, -1, w] = 0
// over a, x (B, S, W) float32, contiguous, into h (B, S, W) float32.
//
// Replaces: no Pallas kernel.  The reference runs the recurrence as
// lax.associative_scan over S (src/repro/models/layers.py:1031), a log-depth
// tree of elementwise combines that XLA lowers to about 2 · log2(S) passes
// over the (B, S, W) pairs.  PyTorch has no associative scan, and a loop over
// S is two launches a step and a layer.  The recurrence is one pass over its
// operands: each (b, w) lane is an independent chain.
//
// Bound: bytes.  a and x are read once and h written once: 3 · B · S · W · 4
// bytes over the 3.35 TB/s of the H100 SXM data sheet (0.2404 ms at
// recurrentgemma-9b's prefill of B 8, S 2,048, W 4,096).  The chain costs two
// float32 operations an element.
//
// Design (a simple kernel):
//   * one thread a lane, lanes consecutive in w, so a warp's loads and stores
//     of one step are 128 contiguous bytes; a grid-stride loop over lanes, so
//     any B · W fits any grid;
//   * the chain's operands are loaded kRglruAhead steps ahead of the
//     multiply-add that needs them, in two register groups: the loads of the
//     next group are issued before the current group's chain runs, so each
//     thread has 2 · kRglruAhead steps of a and x in flight (streaming loads
//     and stores: nothing is read twice);
//   * each step is __fmul_rn then __fadd_rn, never a contracted FMA, so h is
//     bit-equal to the plain version's sequential float32 loop
//     (h = a[:, t] * h + x[:, t], two roundings a step);
//   * steps past S load a = 1 and x = 0, which leave h unchanged, and store
//     nothing.
//
// The launcher only enqueues on the caller's stream (no synchronisation, no
// allocation), so a CUDA graph can capture it, and returns
// cudaGetLastError().  The layout of RglruParams is mirrored by ctypes in
// repro_torch/kernels/_cuda.py (_RglruParams), checked at load time.

#include <cstdint>
#include <cuda_runtime.h>

// At namespace scope: the extern "C" entry point takes it.
struct RglruParams {
  const float* a;    // (B, S, W) decay
  const float* x;    // (B, S, W) input term
  float* h;          // (B, S, W) output
  int32_t batch, seq, width;
  int32_t blocks;    // grid size (the lanes' grid-stride loop covers the rest)
};

namespace {

constexpr int kRglruThreads = 128;  // must match RGLRU_THREADS in _cuda.py
constexpr int kRglruAhead = 8;      // steps a register group holds

__device__ __forceinline__ void load_group(const float* a, const float* x, long long w,
                                           int t0, int seq, float (&av)[kRglruAhead],
                                           float (&xv)[kRglruAhead]) {
#pragma unroll
  for (int u = 0; u < kRglruAhead; ++u) {
    const int t = t0 + u;
    const bool in = t < seq;
    av[u] = in ? __ldcs(a + static_cast<long long>(t) * w) : 1.0f;
    xv[u] = in ? __ldcs(x + static_cast<long long>(t) * w) : 0.0f;
  }
}

__global__ void __launch_bounds__(kRglruThreads) rm_rglru_scan_kernel(RglruParams p) {
  const long long width = p.width;
  const long long lanes = static_cast<long long>(p.batch) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride) {
    const long long b = lane / width;
    const long long base = b * p.seq * width + (lane - b * width);
    const float* a = p.a + base;
    const float* x = p.x + base;
    float* h = p.h + base;
    float av[kRglruAhead], xv[kRglruAhead];
    load_group(a, x, width, 0, p.seq, av, xv);
    float state = 0.0f;
    for (int t0 = 0; t0 < p.seq; t0 += kRglruAhead) {
      float an[kRglruAhead], xn[kRglruAhead];
      load_group(a, x, width, t0 + kRglruAhead, p.seq, an, xn);
#pragma unroll
      for (int u = 0; u < kRglruAhead; ++u) {
        state = __fadd_rn(__fmul_rn(av[u], state), xv[u]);
        if (t0 + u < p.seq) __stcs(h + static_cast<long long>(t0 + u) * width, state);
      }
#pragma unroll
      for (int u = 0; u < kRglruAhead; ++u) {
        av[u] = an[u];
        xv[u] = xn[u];
      }
    }
  }
}

bool valid(const RglruParams& p) {
  return p.a && p.x && p.h && p.batch > 0 && p.seq > 0 && p.width > 0 && p.blocks > 0;
}

}  // namespace

extern "C" {

int rm_rglru_params_size() { return static_cast<int>(sizeof(RglruParams)); }

// Launch the scan on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
int rm_rglru_scan(const RglruParams* params, void* stream) {
  const RglruParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  rm_rglru_scan_kernel<<<p.blocks, kRglruThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
