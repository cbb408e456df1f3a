// The RG-LRU linear recurrence of the Griffin block's prefill and its
// gradient, over (B, S, W) float32 contiguous tensors:
//
//   forward  h[b, t, w] = a[b, t, w] * h[b, t - 1, w] + x[b, t, w],   h[b, -1, w] = 0
//   backward g[t] = a[t + 1] * g[t + 1] + dh[t] from t = S - 1 down (a[S] = 0,
//            g zero before the first step); dx[t] = g[t], da[t] = g[t] * h[t - 1]
//            (h[-1] = 0)
//
// Replaces: no Pallas kernel.  The reference runs the recurrence as
// lax.associative_scan over S (src/repro/models/layers.py:1031), a log-depth
// tree of elementwise combines that XLA lowers to about 2 · log2(S) passes
// over the (B, S, W) pairs, and takes its gradient by differentiating that
// tree (as many passes again).  PyTorch has no associative scan, and a loop
// over S is two launches a step and a layer.  Each direction is one pass over
// its operands: each (b, w) lane is an independent chain.
//
// ---- rm_rglru_scan_kernel (the forward)
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
// ---- rm_rglru_scan_backward_kernel (the gradient)
//
// Bound: bytes.  a, h and dh are read once and da and dx written once:
// 5 · B · S · W · 4 bytes over 3.35 TB/s (0.4007 ms at B 8, S 2,048, W 4,096;
// 0.1002 ms at a training microbatch's B 2).  Three float32 operations an
// element.  At B 2 there are only 8,192 lanes, one sequential chain each, so
// the bytes in flight, not the arithmetic, decide how near the bound it runs:
// about 2 MB must be in flight to keep 3.35 TB/s busy.
//
// Design:
//   * a block is one warp of kBwdLanes lanes (b, w0 .. w0 + 31), so B 2 ×
//     W 4,096 is 256 blocks on 132 SMs, and 48 KB of shared memory a block
//     lets four of them be resident an SM;
//   * a, h and dh come through a ring of kBwdStages stages in shared memory,
//     each stage one TMA box of kBwdSteps steps × kBwdLanes lanes of each
//     operand, taken from the last step down.  The tensor maps are 3-D over
//     (W, S, B), so a box never reads into the neighbouring batch, and the
//     boxes lie at multiples of kBwdSteps: the top one reaches past S, where
//     TMA's zero fill gives a[S] = 0 exactly (the padded steps leave g at +0),
//     and a box past the ragged W edge reads zeros there.  Lane 0 issues the
//     loads (an mbarrier a stage) and refills a stage as soon as the warp has
//     read it, so kBwdStages - 1 stages (36 KB) a block are in flight while
//     one is consumed;
//   * one thread a lane reads its column of a stage (32 consecutive floats a
//     warp: no bank conflict).  Each operand is read once: a[t + 1] is the
//     value the lane read one step earlier, kept in a register, and h[t - 1]
//     is the one it reads one step later, so da[t] is stored a step late (at
//     step t - 1) and da[0] = g[0] * 0 after the walk, multiplying by the
//     zero as the plain version does;
//   * dx and da are written by streaming stores, a warp's 128 contiguous
//     bytes a step each; steps past S and lanes past W store nothing;
//   * each step is __fmul_rn then __fadd_rn, and da one __fmul_rn, never a
//     contracted FMA, and the chain stays sequential in each lane, so da and
//     dx are bit-equal to the plain reverse loop.
//   TMA needs 16-byte row strides and a 16-byte aligned base: W a multiple
//   of 4 (the wrapper checks, and the launcher again).
//
// Each launcher only enqueues on the caller's stream (no synchronisation, no
// allocation), so a CUDA graph can capture it, and returns
// cudaGetLastError().  The layouts of RglruParams and RglruBwdParams are
// mirrored by ctypes in repro_torch/kernels/_cuda.py (_RglruParams,
// _RglruBwdParams), checked at load time, and so are the backward's plan
// constants (rm_rglru_backward_plan against RGLRU_BWD_*).

#include <cstdint>
#include <cuda_runtime.h>

#include "rm_tma.cuh"  // mbarriers, the tensor-map encoder (CUtensorMap via <cuda.h>)

// At namespace scope: the extern "C" entry point takes it.
struct RglruParams {
  const float* a;    // (B, S, W) decay
  const float* x;    // (B, S, W) input term
  float* h;          // (B, S, W) output
  int32_t batch, seq, width;
  int32_t blocks;    // grid size (the lanes' grid-stride loop covers the rest)
};

struct RglruBwdParams {
  const float* a;    // (B, S, W) decay, as the forward read it
  const float* h;    // (B, S, W) the forward's output
  const float* dh;   // (B, S, W) the gradient of h
  float* da;         // (B, S, W) outputs
  float* dx;
  int32_t batch, seq, width;
  int32_t blocks;    // grid size: batch · ceil(width / kBwdLanes)
  int32_t smem;      // dynamic shared bytes: kBwdStages stages
  int32_t pad_;
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

// ------------------------------------------------------------ the backward
constexpr int kBwdLanes = 32;   // lanes a block: one warp (RGLRU_BWD_LANES in _cuda.py)
constexpr int kBwdSteps = 32;   // steps a stage: a TMA box's rows (RGLRU_BWD_STEPS)
constexpr int kBwdStages = 4;   // stages in the ring (RGLRU_BWD_STAGES)
constexpr int kBwdBox = kBwdSteps * kBwdLanes;            // floats of one operand's box
constexpr int kBwdStageBytes = 3 * kBwdBox * 4;           // a, h, dh
constexpr int kBwdRingBytes = kBwdStages * kBwdStageBytes;  // 48 KB
// the ring, its mbarriers, and up to 128 bytes to align the ring for TMA
constexpr int kBwdSmem = kBwdRingBytes + kBwdStages * 8 + 128;

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(kBwdLanes)
rm_rglru_scan_backward_kernel(const __grid_constant__ RglruBwdParams p,
                              const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_dh) {
  using namespace rm_tma;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring_s = (raw + 127) & ~127u;  // [stage][a, h, dh][step][lane]
  const uint32_t full_s = ring_s + kBwdRingBytes;  // an mbarrier a stage
  const float* const ring = reinterpret_cast<const float*>(smem_raw + (ring_s - raw));
  const int lane = threadIdx.x;
  const int groups = (p.width + kBwdLanes - 1) / kBwdLanes;
  const int b = blockIdx.x / groups;
  const int w0 = (blockIdx.x - b * groups) * kBwdLanes;
  const int boxes = (p.seq + kBwdSteps - 1) / kBwdSteps;
  // stage k holds steps [(boxes - 1 - k) · kBwdSteps, + kBwdSteps) in slot k % kBwdStages
  auto issue = [&](int k) {
    const int slot = k % kBwdStages;
    const uint32_t dst = ring_s + slot * kBwdStageBytes, bar = full_s + slot * 8;
    const int t0 = (boxes - 1 - k) * kBwdSteps;
    mbar_expect_tx(bar, kBwdStageBytes);
    tma_load_3d(dst, &map_a, bar, w0, t0, b);
    tma_load_3d(dst + kBwdBox * 4, &map_h, bar, w0, t0, b);
    tma_load_3d(dst + 2 * kBwdBox * 4, &map_dh, bar, w0, t0, b);
  };
  if (lane == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(full_s + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kBwdStages && k < boxes; ++k) issue(k);
  }
  __syncwarp();

  const long long row = p.width;
  const long long base = static_cast<long long>(b) * p.seq * row + w0 + lane;
  float* const dx = p.dx + base;
  float* const da = p.da + base;
  const bool live = w0 + lane < p.width;
  float g = 0.0f;       // g[t + 1]: zero before the first step
  float a_next = 0.0f;  // a[t + 1]: the top box's zero fill past S
  for (int k = 0; k < boxes; ++k) {
    const int slot = k % kBwdStages;
    mbar_wait(full_s + slot * 8, (k / kBwdStages) & 1);
    const float* const sa = ring + slot * 3 * kBwdBox + lane;
    const float* const sh = sa + kBwdBox;
    const float* const sdh = sa + 2 * kBwdBox;
    const int t0 = (boxes - 1 - k) * kBwdSteps;
#pragma unroll
    for (int u = kBwdSteps - 1; u >= 0; --u) {
      const int t = t0 + u;
      const float at = sa[u * kBwdLanes];
      const float ht = sh[u * kBwdLanes];
      const float gt = __fadd_rn(__fmul_rn(a_next, g), sdh[u * kBwdLanes]);
      // da[t + 1] = g[t + 1] · h[t], a step late; dx[t] = g[t]
      if (live && t + 1 < p.seq) __stcs(da + (t + 1) * row, __fmul_rn(g, ht));
      if (live && t < p.seq) __stcs(dx + t * row, gt);
      g = gt;
      a_next = at;
    }
    // every lane has read the slot: refill it with the stage kBwdStages on
    __syncwarp();
    if (lane == 0 && k + kBwdStages < boxes) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + kBwdStages);
    }
  }
  if (live) __stcs(da, __fmul_rn(g, 0.0f));  // da[0] = g[0] · h[-1]
}

// A (W, S, B) view of a contiguous (B, S, W) float32 tensor, boxes of
// kBwdSteps steps × kBwdLanes lanes of one batch row, zero fill outside.
int bwd_map(CUtensorMap* map, const float* base, const RglruBwdParams& p) {
  const rm_tma::EncodeTiled encode = rm_tma::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.width), static_cast<cuuint64_t>(p.seq),
                              static_cast<cuuint64_t>(p.batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.width) * 4,
                                 static_cast<cuuint64_t>(p.seq) * p.width * 4};
  const cuuint32_t box[3] = {kBwdLanes, kBwdSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool valid(const RglruBwdParams& p) {
  const long long groups = (static_cast<long long>(p.width) + kBwdLanes - 1) / kBwdLanes;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.h) |
                        reinterpret_cast<uintptr_t>(p.dh)) % 16 == 0;
  return p.a && p.h && p.dh && p.da && p.dx && aligned && p.batch > 0 && p.seq > 0 &&
         p.width > 0 && p.width % 4 == 0 && p.blocks == p.batch * groups &&
         p.smem == kBwdSmem;
}

}  // namespace

extern "C" {

int rm_rglru_params_size() { return static_cast<int>(sizeof(RglruParams)); }
int rm_rglru_bwd_params_size() { return static_cast<int>(sizeof(RglruBwdParams)); }

// The backward's plan constants: lanes a block, steps a stage, stages.
void rm_rglru_backward_plan(int* lanes, int* steps, int* stages) {
  *lanes = kBwdLanes;
  *steps = kBwdSteps;
  *stages = kBwdStages;
}

// Launch the scan on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
int rm_rglru_scan(const RglruParams* params, void* stream) {
  const RglruParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  rm_rglru_scan_kernel<<<p.blocks, kRglruThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch the scan's gradient on `stream` without synchronising (the plan's
// grid and shared bytes, checked against the kernel's); returns
// cudaGetLastError() (0 on success).
int rm_rglru_scan_backward(const RglruBwdParams* params, void* stream) {
  const RglruBwdParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mh, mdh;
  int err = bwd_map(&ma, p.a, p);
  if (err == 0) err = bwd_map(&mh, p.h, p);
  if (err == 0) err = bwd_map(&mdh, p.dh, p);
  if (err != 0) return err;
  const cudaError_t set = cudaFuncSetAttribute(
      rm_rglru_scan_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  rm_rglru_scan_backward_kernel<<<p.blocks, kBwdLanes, p.smem,
                                  static_cast<cudaStream_t>(stream)>>>(p, ma, mh, mdh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
