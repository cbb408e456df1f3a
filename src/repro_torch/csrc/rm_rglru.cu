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
// recurrentgemma-9b's prefill of B 8, S 2,048, W 4,096; 0.0601 ms at a
// training microbatch's B 2).  The chain costs two float32 operations an
// element.  As in the gradient, B 2 has only 8,192 lanes, each one
// sequential chain, so the bytes in flight decide how near the bound it
// runs (about 2 MB keep 3.35 TB/s busy).
//
// Design (the gradient's, walked the other way):
//   * a block is one warp of kFwdLanes lanes (b, w0 .. w0 + 31): B 2 × W 4,096
//     is 256 blocks on 132 SMs, B 8 is 1,024;
//   * a and x come through a ring of kFwdStages stages in shared memory
//     (24 KB a block, so 8 blocks an SM hold B 8's 1,024 blocks in one wave;
//     a deeper ring moved B 2 by under 1% and split B 8 into two waves),
//     each stage kFwdSteps steps × kFwdLanes lanes of both operands, taken
//     from step 0 up.  The ring fits 48 KB, so the launch sets no attribute.
//     Two fill forms, the plan's choice by width, alignment and grid size:
//       - kFillTma: one TMA box an operand a stage, issued by lane 0 against
//         the stage's mbarrier.  The tensor maps are 3-D over (W, S, B), so a
//         box never reads into the next batch row; past S and past the
//         ragged W edge it reads TMA's zero fill.  TMA needs W a multiple of
//         4 and a, x 16-byte aligned.  The plan takes it for a grid of at
//         most four blocks an SM, where it reads faster (train_rg's B 2: 16%
//         by device time on an H100 80GB HBM3 at 700 W);
//       - kFillAsync: any other width or base, and fuller grids (B 8's 1,024
//         blocks: 3% faster on that card).  Each lane copies its own column
//         of the stage with 4-byte cp.async copies (zeros past S and W) and
//         arrives on the stage's mbarrier when they land (.noinc: the
//         barrier counts the warp's 32 arrivals);
//     a slot is refilled with the stage kFwdStages on once the warp has read
//     it, so kFwdStages - 1 stages (16 KB a block, 4 MB over B 2's 256 blocks)
//     are in flight while one is consumed;
//   * one thread a lane reads its column of a stage (32 consecutive floats a
//     warp: no bank conflict) and runs the chain, each step __fmul_rn then
//     __fadd_rn, never a contracted FMA, so h is bit-equal to the plain
//     version's sequential float32 loop (h = a[:, t] * h + x[:, t], two
//     roundings a step).  The zero fill past S (a = 0, x = 0) only touches
//     steps that are never stored;
//   * h is written by streaming stores, a warp's 128 contiguous bytes a
//     step; steps past S and lanes past W store nothing.
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
// _RglruBwdParams), checked at load time, and so are the plans' constants
// (rm_rglru_forward_plan against RGLRU_FWD_*, rm_rglru_backward_plan against
// RGLRU_BWD_*).

#include <cstdint>
#include <cuda_runtime.h>

#include "rm_tma.cuh"  // mbarriers, the tensor-map encoder (CUtensorMap via <cuda.h>)

// At namespace scope: the extern "C" entry point takes it.
struct RglruParams {
  const float* a;    // (B, S, W) decay
  const float* x;    // (B, S, W) input term
  float* h;          // (B, S, W) output
  int32_t batch, seq, width;
  int32_t blocks;    // grid size: batch · ceil(width / kFwdLanes)
  int32_t smem;      // dynamic shared bytes: kFwdSmem
  int32_t form;      // how the ring is filled: kFillTma or kFillAsync
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A (W, S, B) view of a contiguous (B, S, W) float32 tensor, boxes of `steps`
// steps × `lanes` lanes of one batch row, zero fill outside.
int scan_map(CUtensorMap* map, const float* base, int batch, int seq, int width, int lanes,
             int steps) {
  const rm_tma::EncodeTiled encode = rm_tma::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 4,
                                 static_cast<cuuint64_t>(seq) * width * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lanes), static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------- the forward
constexpr int kFwdLanes = 32;      // lanes a block: one warp (RGLRU_FWD_LANES in _cuda.py)
constexpr int kFwdSteps = 32;      // steps a stage: a TMA box's rows (RGLRU_FWD_STEPS)
constexpr int kFwdStages = 3;      // stages in the ring (RGLRU_FWD_STAGES)
constexpr int kFwdBox = kFwdSteps * kFwdLanes;   // floats of one operand's box
constexpr int kFwdStageBytes = 2 * kFwdBox * 4;  // a, x: 8 KB
constexpr int kFillTma = 0, kFillAsync = 1;      // RglruParams::form (RGLRU_FWD_FORMS)

// the ring, its mbarriers, and up to 128 bytes to align the ring for TMA
constexpr int kFwdSmem = kFwdStages * (kFwdStageBytes + 8) + 128;
static_assert(kFwdSmem <= 48 * 1024, "the ring must need no attribute");

__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}
// arrive on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(bar) : "memory");
}

template <int kForm>
__global__ void __launch_bounds__(kFwdLanes)
rm_rglru_scan_kernel(const __grid_constant__ RglruParams p,
                     const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_x) {
  using namespace rm_tma;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t ring_s = (raw + 127) & ~127u;  // [stage][a, x][step][lane]
  const uint32_t full_s = ring_s + kFwdStages * kFwdStageBytes;  // an mbarrier a stage
  const float* const ring = reinterpret_cast<const float*>(smem_raw + (ring_s - raw));
  const int lane = threadIdx.x;
  const int groups = (p.width + kFwdLanes - 1) / kFwdLanes;
  const int b = blockIdx.x / groups;
  const int w0 = (blockIdx.x - b * groups) * kFwdLanes;
  const int boxes = (p.seq + kFwdSteps - 1) / kFwdSteps;
  const long long row = p.width;
  const long long base = static_cast<long long>(b) * p.seq * row + w0 + lane;
  const bool live = w0 + lane < p.width;
  // stage k holds steps [k · kFwdSteps, + kFwdSteps) in slot k % kFwdStages; in
  // the TMA form lane 0 alone calls this, in the cp.async form every lane
  auto issue = [&](int k) {
    const int slot = k % kFwdStages;
    const uint32_t dst = ring_s + slot * kFwdStageBytes, bar = full_s + slot * 8;
    const int t0 = k * kFwdSteps;
    if constexpr (kForm == kFillTma) {
      mbar_expect_tx(bar, kFwdStageBytes);
      tma_load_3d(dst, &map_a, bar, w0, t0, b);
      tma_load_3d(dst + kFwdBox * 4, &map_x, bar, w0, t0, b);
    } else {
#pragma unroll 8
      for (int u = 0; u < kFwdSteps; ++u) {
        const bool in = live && t0 + u < p.seq;
        const long long off = in ? base + (t0 + u) * row : 0;
        const uint32_t at = dst + (u * kFwdLanes + lane) * 4;
        cp_async_4(at, p.a + off, in);
        cp_async_4(at + kFwdBox * 4, p.x + off, in);
      }
      cp_async_arrive(bar);
    }
  };
  if (lane == 0) {
    for (int s = 0; s < kFwdStages; ++s) mbar_init(full_s + s * 8, kForm == kFillTma ? 1 : kFwdLanes);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if (kForm == kFillAsync || lane == 0)
    for (int k = 0; k < kFwdStages && k < boxes; ++k) issue(k);

  float* const h = p.h + base;
  float state = 0.0f;  // h[-1]
  for (int k = 0; k < boxes; ++k) {
    const int slot = k % kFwdStages;
    mbar_wait(full_s + slot * 8, (k / kFwdStages) & 1);
    const float* const sa = ring + slot * 2 * kFwdBox + lane;
    const float* const sx = sa + kFwdBox;
    const int t0 = k * kFwdSteps;
#pragma unroll
    for (int u = 0; u < kFwdSteps; ++u) {
      const int t = t0 + u;
      state = __fadd_rn(__fmul_rn(sa[u * kFwdLanes], state), sx[u * kFwdLanes]);
      if (live && t < p.seq) __stcs(h + t * row, state);
    }
    // every lane has read the slot: refill it with the stage kFwdStages on
    __syncwarp();
    if (k + kFwdStages < boxes) {
      if constexpr (kForm == kFillTma) {
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue(k + kFwdStages);
        }
      } else {
        issue(k + kFwdStages);
      }
    }
  }
}

bool valid(const RglruParams& p) {
  const long long groups = (static_cast<long long>(p.width) + kFwdLanes - 1) / kFwdLanes;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.x)) %
                       16 == 0;
  const bool form = p.form == kFillAsync || (p.form == kFillTma && aligned && p.width % 4 == 0);
  return p.a && p.x && p.h && form && p.batch > 0 && p.seq > 0 && p.width > 0 &&
         p.blocks == p.batch * groups && p.smem == kFwdSmem;
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

// The forward's plan constants: lanes a block, steps a stage, stages.
void rm_rglru_forward_plan(int* lanes, int* steps, int* stages) {
  *lanes = kFwdLanes;
  *steps = kFwdSteps;
  *stages = kFwdStages;
}

// Launch the scan on `stream` without synchronising (the plan's grid, shared
// bytes and fill form, checked against the kernel's and the inputs); returns cudaGetLastError() (0 on
// success).  The ring fits 48 KB, so nothing but the launch is enqueued.
int rm_rglru_scan(const RglruParams* params, void* stream) {
  const RglruParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma{}, mx{};  // unread by the cp.async form
  if (p.form == kFillTma) {
    int err = scan_map(&ma, p.a, p.batch, p.seq, p.width, kFwdLanes, kFwdSteps);
    if (err == 0) err = scan_map(&mx, p.x, p.batch, p.seq, p.width, kFwdLanes, kFwdSteps);
    if (err != 0) return err;
    rm_rglru_scan_kernel<kFillTma><<<p.blocks, kFwdLanes, p.smem, s>>>(p, ma, mx);
  } else {
    rm_rglru_scan_kernel<kFillAsync><<<p.blocks, kFwdLanes, p.smem, s>>>(p, ma, mx);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the scan's gradient on `stream` without synchronising (the plan's
// grid and shared bytes, checked against the kernel's); returns
// cudaGetLastError() (0 on success).
int rm_rglru_scan_backward(const RglruBwdParams* params, void* stream) {
  const RglruBwdParams& p = *params;
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mh, mdh;
  int err = scan_map(&ma, p.a, p.batch, p.seq, p.width, kBwdLanes, kBwdSteps);
  if (err == 0) err = scan_map(&mh, p.h, p.batch, p.seq, p.width, kBwdLanes, kBwdSteps);
  if (err == 0) err = scan_map(&mdh, p.dh, p.batch, p.seq, p.width, kBwdLanes, kBwdSteps);
  if (err != 0) return err;
  const cudaError_t set = cudaFuncSetAttribute(
      rm_rglru_scan_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  rm_rglru_scan_backward_kernel<<<p.blocks, kBwdLanes, p.smem,
                                  static_cast<cudaStream_t>(stream)>>>(p, ma, mh, mdh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
