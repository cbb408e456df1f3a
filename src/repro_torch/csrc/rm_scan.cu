// Relational-memory scan kernels for Hopper (sm_90a): the five Pallas TPU
// kernels of the engine's batch path, written again for the card.
//
//   rm_project_kernel      <- repro/kernels/rme_project.py   _mlp_kernel
//   rm_filter_kernel       <- repro/kernels/rme_filter.py    _filter_kernel
//   rm_aggregate_kernel    <- repro/kernels/rme_aggregate.py _agg_kernel
//   rm_groupby_kernel      <- repro/kernels/rme_aggregate.py _groupby_kernel
//   rm_scan_multi_kernel   <- repro/kernels/rme_scan_multi.py _scan_multi_kernel
//
// What bounds them: bytes.  Each reads the row store once and does a few
// integer compares and float adds per row, far below the card's operation
// rate, so the least time is the 32-byte sectors holding the enabled words
// (for the 72-byte rows of the benchmark table that is nearly every sector)
// plus the output, over the memory rate.
//
// Design: a persistent grid (as many blocks as fit on the card, capped by
// the tile count) walks the row store in tiles of whole rows.  Each tile is
// staged once in shared memory with coalesced 16-byte loads (rm_common.cuh)
// and every request of the launch is served from the staged copy, so a fused
// scan_multi reads the row store once for all its requests.  On the TPU the
// grid ran in order and a reduction carried across grid steps in one output
// block; here blocks run in any order, so a reduced request leaves one
// partial row per block and rm_reduce_partials sums them in block order.
// The predicate constant, the snapshot time and the geometry are runtime
// data (Params), so nothing is compiled per query.  The grid-stride tile
// loop and the row bound `rows` replace the reference's padding to whole
// tiles and its `ridx < n` mask.
#include "rm_common.cuh"

using namespace rm;

__global__ void __launch_bounds__(kThreads)
rm_project_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  int32_t* tile = smem;
  int32_t* sm_map = smem + p.map_smem;
  stage_map(p, sm_map);
  const Req& q = p.req[0];
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();  // the previous tile is consumed (and the map staged)
    stage_tile(tile, p.words, row0, rows, p.row_words);
    __syncthreads();
    pack_tile<false>(tile, rows, p.row_words, sm_map + q.map_off, q, row0);
  }
}

__global__ void __launch_bounds__(kThreads)
rm_filter_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  int32_t* tile = smem;
  int32_t* sm_map = smem + p.map_smem;
  stage_map(p, sm_map);
  const Req& q = p.req[0];
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    stage_tile(tile, p.words, row0, rows, p.row_words);
    __syncthreads();
    pack_tile<true>(tile, rows, p.row_words, sm_map + q.map_off, q, row0);
  }
}

__global__ void __launch_bounds__(kThreads)
rm_aggregate_kernel(const __grid_constant__ Params p) {
  int32_t* tile = smem_words();
  const Req& q = p.req[0];
  float s = 0.0f;
  unsigned c = 0;
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    stage_tile(tile, p.words, row0, rows, p.row_words);
    __syncthreads();
    agg_tile(tile, rows, p.row_words, q, s, c);
  }
  block_sum2(s, c);
  if (threadIdx.x == 0) {
    float* dst = p.partials + blockIdx.x * static_cast<long long>(p.part_w) + q.red_off;
    dst[0] = s;
    dst[1] = static_cast<float>(c);  // a block's count stays far below 2^24
  }
}

__global__ void __launch_bounds__(kThreads)
rm_groupby_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  int32_t* tile = smem;
  const Req& q = p.req[0];
  float* hist = group_hist(p, q, smem);
  zero_floats(hist, 2 * q.num_groups);
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();  // also orders the histogram's zeroing before any add
    stage_tile(tile, p.words, row0, rows, p.row_words);
    __syncthreads();
    group_tile(tile, rows, p.row_words, q, hist);
  }
  __syncthreads();
  flush_hist(p, q, hist);
}

__global__ void __launch_bounds__(kThreads)
rm_scan_multi_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  int32_t* tile = smem;
  int32_t* sm_map = smem + p.map_smem;
  float* slot_s = reinterpret_cast<float*>(smem + p.slot_smem);
  unsigned* slot_c = reinterpret_cast<unsigned*>(smem + p.slot_smem) + p.n_slots * kThreads;
  stage_map(p, sm_map);
  for (int s = 0; s < p.n_slots; ++s) {
    slot_s[s * kThreads + threadIdx.x] = 0.0f;
    slot_c[s * kThreads + threadIdx.x] = 0;
  }
  for (int r = 0; r < p.n_req; ++r) {
    const Req& q = p.req[r];
    if (q.kind == kGroupBy) zero_floats(group_hist(p, q, smem), 2 * q.num_groups);
  }
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    stage_tile(tile, p.words, row0, rows, p.row_words);
    __syncthreads();
    for (int r = 0; r < p.n_req; ++r) {
      const Req& q = p.req[r];
      if (q.kind == kProject) {
        pack_tile<false>(tile, rows, p.row_words, sm_map + q.map_off, q, row0);
      } else if (q.kind == kFilter) {
        pack_tile<true>(tile, rows, p.row_words, sm_map + q.map_off, q, row0);
      } else if (q.kind == kAggregate) {
        const int at = q.slot * kThreads + threadIdx.x;
        float s = slot_s[at];
        unsigned c = slot_c[at];
        agg_tile(tile, rows, p.row_words, q, s, c);
        slot_s[at] = s;
        slot_c[at] = c;
      } else {
        group_tile(tile, rows, p.row_words, q, group_hist(p, q, smem));
      }
    }
  }
  __syncthreads();
  for (int r = 0; r < p.n_req; ++r) {
    const Req& q = p.req[r];
    if (q.kind == kAggregate) {
      float s = slot_s[q.slot * kThreads + threadIdx.x];
      unsigned c = slot_c[q.slot * kThreads + threadIdx.x];
      block_sum2(s, c);
      if (threadIdx.x == 0) {
        float* dst = p.partials + blockIdx.x * static_cast<long long>(p.part_w) + q.red_off;
        dst[0] = s;
        dst[1] = static_cast<float>(c);
      }
    } else if (q.kind == kGroupBy) {
      flush_hist(p, q, group_hist(p, q, smem));
    }
  }
}

// Sum the per-block partial rows in block order.  Even columns are float32
// sums, kept float32 as on the TPU; odd columns are counts, exact integers
// in each row, summed in double so the total is exact before its one
// rounding to float32.
__global__ void __launch_bounds__(kThreads)
rm_reduce_partials_kernel(const float* partials, int n_parts, int width, float* out) {
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    if (j & 1) {
      double c = 0.0;
      for (int b = 0; b < n_parts; ++b) c += partials[static_cast<long long>(b) * width + j];
      out[j] = static_cast<float>(c);
    } else {
      float s = 0.0f;
      for (int b = 0; b < n_parts; ++b) s += partials[static_cast<long long>(b) * width + j];
      out[j] = s;
    }
  }
}

namespace {

// Kernel order shared with _cuda.KERNELS (the index rm_max_blocks takes).
const void* const kKernels[] = {
    reinterpret_cast<const void*>(rm_project_kernel),
    reinterpret_cast<const void*>(rm_filter_kernel),
    reinterpret_cast<const void*>(rm_aggregate_kernel),
    reinterpret_cast<const void*>(rm_groupby_kernel),
    reinterpret_cast<const void*>(rm_scan_multi_kernel),
};
constexpr int kNumKernels = sizeof(kKernels) / sizeof(kKernels[0]);

cudaError_t allow_smem(const void* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// One plain C launcher per kernel: launch on `stream`, do not synchronise,
// return the launch's cudaGetLastError() (0 on success).
#define RM_LAUNCHER(name, kernel)                                              \
  int name(const Params* params, int n_blocks, long long smem, void* stream) { \
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);        \
    cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);  \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    kernel<<<n_blocks, kThreads, static_cast<size_t>(smem),                   \
             static_cast<cudaStream_t>(stream)>>>(*params);                    \
    return static_cast<int>(cudaGetLastError());                               \
  }

extern "C" {

int rm_params_size() { return static_cast<int>(sizeof(Params)); }

const char* rm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of kernel `kernel` that fit on the whole current device at once
// with `smem` bytes of dynamic shared memory each (0 if none fits).
int rm_max_blocks(int kernel, long long smem, int* blocks) {
  *blocks = 0;
  if (kernel < 0 || kernel >= kNumKernels) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(kKernels[kernel], smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernels[kernel], kThreads,
                                                    static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = per_sm * sms;
  return 0;
}

RM_LAUNCHER(rm_project, rm_project_kernel)
RM_LAUNCHER(rm_filter_project, rm_filter_kernel)
RM_LAUNCHER(rm_aggregate, rm_aggregate_kernel)
RM_LAUNCHER(rm_groupby_sum, rm_groupby_kernel)
RM_LAUNCHER(rm_scan_multi, rm_scan_multi_kernel)

int rm_reduce_partials(const float* partials, int n_parts, int width,
                       float* out, void* stream) {
  rm_reduce_partials_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_parts, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
