// Relational-memory scan kernels for Hopper (sm_90a): the five Pallas TPU
// kernels of the engine's batch path, written again for the card.
//
//   rm_project_kernel      <- repro/kernels/rme_project.py   _mlp_kernel
//   rm_filter_kernel       <- repro/kernels/rme_filter.py    _filter_kernel
//   rm_aggregate_kernel    <- repro/kernels/rme_aggregate.py _agg_kernel
//   rm_groupby_kernel      <- repro/kernels/rme_aggregate.py _groupby_kernel
//   rm_scan_multi_kernel   <- repro/kernels/rme_scan_multi.py _scan_multi_kernel
//   rm_project_multi_kernel <- repro/kernels/rme_project_multi.py _mlp_multi_kernel
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
// partial row per block and rm_reduce_partials sums them in a fixed order.
// The predicate constant, the snapshot time and the geometry are runtime
// data (Params), so nothing is compiled per query.  The grid-stride tile
// loop and the row bound `rows` replace the reference's padding to whole
// tiles and its `ridx < n` mask.
//
// The fused scan (rm_scan_multi_kernel) serves the most requests from one
// tile, so it hides its copies and walks each row once: tiles arrive by
// cp.async into a ring of two, the next in flight while one is served, and
// thread r serves row r of the tile for every request —
// vector stores of the packed words, a filter's predicate once a row, no
// division per output word.  The single-request kernels stage synchronously
// and pack one output word a thread (pack_tile).
//
// Rows wider than 2,048 words (Params::direct) are served where they lie:
// no tile is staged, and every kernel reads the words it uses straight from
// the row store — for a filter or a multi-view projection, one output word
// a thread, so a warp's loads of a contiguous map are contiguous.  The word
// map comes from device memory (staged into shared memory where it fits),
// so no launch has a limit on its packed words.  A single projection of
// such rows is not launched here: rm_project_spans_kernel (rm_spans.cu)
// copies its column ranges with 16-byte transfers, and rm_project_kernel is
// staged only.
#include "rm_common.cuh"

using namespace rm;

// Staged rows only: wider rows take rm_project_spans_kernel (rm_spans.cu).
__global__ void __launch_bounds__(kThreads)
rm_project_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  const int32_t* map = stage_map(p, smem);
  const Req& q = p.req[0];
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();  // the previous tile is consumed (and the map staged)
    const int32_t* tile = load_tile<false>(p, smem, row0, rows);
    __syncthreads();
    pack_tile<false, false>(tile, rows, p.row_words, map + q.map_off, q, row0);
  }
}

// Several packed views from one staged row tile: every request of the
// launch is a projection (the Python side splits larger view sets).
template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
rm_project_multi_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  const int32_t* map = stage_map(p, smem);
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    const int32_t* tile = load_tile<kDirect>(p, smem, row0, rows);
    __syncthreads();
    for (int r = 0; r < p.n_req; ++r) {
      const Req& q = p.req[r];
      pack_tile<false, kDirect>(tile, rows, p.row_words, map + q.map_off, q, row0);
    }
  }
}

template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
rm_filter_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  const int32_t* map = stage_map(p, smem);
  const Req& q = p.req[0];
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    const int32_t* tile = load_tile<kDirect>(p, smem, row0, rows);
    __syncthreads();
    pack_tile<true, kDirect>(tile, rows, p.row_words, map + q.map_off, q, row0);
  }
}

template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
rm_aggregate_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  const Req& q = p.req[0];
  float s = 0.0f;
  unsigned c = 0;
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();
    const int32_t* tile = load_tile<kDirect>(p, smem, row0, rows);
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

template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
rm_groupby_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  const Req& q = p.req[0];
  float* hist = group_hist(p, q, smem);
  zero_floats(hist, 2 * q.num_groups);
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    __syncthreads();  // also orders the histogram's zeroing before any add
    const int32_t* tile = load_tile<kDirect>(p, smem, row0, rows);
    __syncthreads();
    group_tile(tile, rows, p.row_words, q, hist);
  }
  __syncthreads();
  flush_hist(p, q, hist);
}

// Store one row's packed words: 16- or 8-byte stores where the width and
// the output allow, so a warp's stores stay contiguous.
__device__ __forceinline__ void put_row(const int32_t* row, const int32_t* map,
                                        int out_w, int32_t* dst, bool keep) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if ((out_w & 3) == 0 && (a & 15) == 0) {
    for (int w = 0; w < out_w; w += 4) {
      const int4 v = keep ? make_int4(row[map[w]], row[map[w + 1]], row[map[w + 2]],
                                      row[map[w + 3]])
                          : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(dst + w) = v;
    }
  } else if ((out_w & 1) == 0 && (a & 7) == 0) {
    for (int w = 0; w < out_w; w += 2) {
      const int2 v = keep ? make_int2(row[map[w]], row[map[w + 1]]) : make_int2(0, 0);
      *reinterpret_cast<int2*>(dst + w) = v;
    }
  } else {
    for (int w = 0; w < out_w; ++w) dst[w] = keep ? row[map[w]] : 0;
  }
}

// Every request of the launch from one staged row, row `grow` of the chunk:
// the row is walked once, a filter's predicate evaluated once.
__device__ __forceinline__ void serve_row(const Params& p, const int32_t* row,
                                          long long grow, const int32_t* map,
                                          float* slot_s, unsigned* slot_c,
                                          int32_t* smem) {
  for (int r = 0; r < p.n_req; ++r) {
    const Req& q = p.req[r];
    if (q.kind == kProject) {
      put_row(row, map + q.map_off, q.out_w, q.out + grow * q.out_w, true);
    } else if (q.kind == kFilter) {
      const bool keep = row_pass(row, q);
      put_row(row, map + q.map_off, q.out_w, q.out + grow * q.out_w, keep);
      q.mask[grow] = keep ? 1 : 0;
    } else if (row_pass(row, q)) {
      if (q.kind == kAggregate) {
        const int at = q.slot * kThreads + threadIdx.x;
        slot_s[at] += agg_value(row, q);
        slot_c[at] += 1;
      } else {
        float* hist = group_hist(p, q, smem);
        const int g = group_of(row[q.group_word], q.num_groups);
        atomicAdd(hist + 2 * g, agg_value(row, q));
        atomicAdd(hist + 2 * g + 1, 1.0f);
      }
    }
  }
}

// Tiles in the fused scan's ring: a block serves one slot while the other
// fills (slot ^ 1).  _cuda.SCAN_RING lays the ring out and checks it against
// rm_scan_ring() at load time.
constexpr int kScanRing = 2;

// The staged form of the fused scan: tiles arrive by cp.async into the
// ring, the next in flight while one is served.
__device__ __forceinline__ void serve_ring(const Params& p, int32_t* smem, const int32_t* map,
                                           float* slot_s, unsigned* slot_c,
                                           long long n_tiles) {
  auto issue = [&](long long t, int stage) {
    if (t < n_tiles) {
      const long long row0 = t * p.tile_rows;
      const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
      issue_tile(smem + stage * p.tile_stride, p.words, row0, rows, p.row_words);
    }
    cp_async_commit();
  };
  issue(blockIdx.x, 0);
  int stage = 0;  // the ring slot holding tile t
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    cp_async_wait_all();  // tile t, the only group in flight
    // tile t is in for every thread, and every thread is done with the
    // other slot (also orders the zeroing above before any use)
    __syncthreads();
    issue(t + gridDim.x, stage ^ 1);
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    if (static_cast<int>(threadIdx.x) < rows) {
      serve_row(p, smem + stage * p.tile_stride + threadIdx.x * p.row_words,
                row0 + threadIdx.x, map, slot_s, slot_c, smem);
    }
    stage ^= 1;
  }
  cp_async_wait_all();
}

// The fused one-pass scan.  Tiles arrive by cp.async into a ring of two,
// so while a block serves tile t from shared memory its next tile is in
// flight; thread r serves row r of the tile for every request (a tile holds
// at most kThreads rows).  Direct rows are served in place, a thread a row.
template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
rm_scan_multi_kernel(const __grid_constant__ Params p) {
  int32_t* smem = smem_words();
  float* slot_s = reinterpret_cast<float*>(smem + p.slot_smem);
  unsigned* slot_c = reinterpret_cast<unsigned*>(smem + p.slot_smem) + p.n_slots * kThreads;
  const int32_t* map = stage_map(p, smem);
  for (int s = 0; s < p.n_slots; ++s) {
    slot_s[s * kThreads + threadIdx.x] = 0.0f;
    slot_c[s * kThreads + threadIdx.x] = 0;
  }
  for (int r = 0; r < p.n_req; ++r) {
    const Req& q = p.req[r];
    if (q.kind == kGroupBy) zero_floats(group_hist(p, q, smem), 2 * q.num_groups);
  }
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  if (kDirect) {
    __syncthreads();  // the map staged and the slots and histograms zeroed
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long grow = t * p.tile_rows + threadIdx.x;
      if (static_cast<int>(threadIdx.x) < p.tile_rows && grow < p.n) {
        serve_row(p, p.words + grow * p.row_words, grow, map, slot_s, slot_c, smem);
      }
    }
  } else {
    serve_ring(p, smem, map, slot_s, slot_c, n_tiles);
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

// Sum the per-block partial rows.  A block takes 32 columns; its 8 warps
// each add every 8th row in order (lanes on neighbouring columns, so loads
// coalesce), then warp 0 adds the 8 results in warp order — a fixed order,
// so results do not vary run to run.  Even columns are float32 sums, kept
// float32 as on the TPU; odd columns are counts, exact integers in each row,
// summed in double so the total is exact before its one rounding to float32.
constexpr int kReduceCols = 32;

__global__ void __launch_bounds__(kThreads)
rm_reduce_partials_kernel(const float* partials, int n_parts, int width, float* out) {
  constexpr int kPhases = kThreads / kReduceCols;
  __shared__ double part[kPhases][kReduceCols];
  const int tx = threadIdx.x % kReduceCols, ty = threadIdx.x / kReduceCols;
  const int j = blockIdx.x * kReduceCols + tx;
  const bool count = j & 1;
  float s = 0.0f;
  double c = 0.0;
  if (j < width) {
    for (int b = ty; b < n_parts; b += kPhases) {
      const float x = partials[static_cast<long long>(b) * width + j];
      if (count) {
        c += x;
      } else {
        s += x;
      }
    }
  }
  part[ty][tx] = count ? c : static_cast<double>(s);
  __syncthreads();
  if (ty == 0 && j < width) {
    if (count) {
      double total = 0.0;
      for (int k = 0; k < kPhases; ++k) total += part[k][tx];
      out[j] = static_cast<float>(total);
    } else {
      float total = 0.0f;
      for (int k = 0; k < kPhases; ++k) total += static_cast<float>(part[k][tx]);
      out[j] = total;
    }
  }
}

namespace {

#define RM_BOTH(kernel) \
  {reinterpret_cast<const void*>(kernel<false>), reinterpret_cast<const void*>(kernel<true>)}

// Kernel order shared with _cuda.KERNELS (the index rm_max_blocks takes);
// each kernel's staged, then direct instantiation (none for the projection).
const void* const kKernels[][2] = {
    {reinterpret_cast<const void*>(rm_project_kernel), nullptr},
    RM_BOTH(rm_filter_kernel),
    RM_BOTH(rm_aggregate_kernel),
    RM_BOTH(rm_groupby_kernel),
    RM_BOTH(rm_scan_multi_kernel),
    RM_BOTH(rm_project_multi_kernel),
};
constexpr int kNumKernels = sizeof(kKernels) / sizeof(kKernels[0]);

cudaError_t allow_smem(const void* fn, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// One plain C launcher per kernel: launch the instantiation params->direct
// names on `stream`, do not synchronise, return the launch's
// cudaGetLastError() (0 on success).
#define RM_LAUNCHER(name, kernel)                                              \
  int name(const Params* params, int n_blocks, long long smem, void* stream) { \
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);        \
    const bool direct = params->direct != 0;                                   \
    cudaError_t e = allow_smem(direct ? reinterpret_cast<const void*>(kernel<true>)   \
                                      : reinterpret_cast<const void*>(kernel<false>), \
                               smem);                                          \
    if (e != cudaSuccess) return static_cast<int>(e);                          \
    const auto s = static_cast<cudaStream_t>(stream);                          \
    if (direct) {                                                              \
      kernel<true><<<n_blocks, kThreads, static_cast<size_t>(smem), s>>>(*params);  \
    } else {                                                                   \
      kernel<false><<<n_blocks, kThreads, static_cast<size_t>(smem), s>>>(*params); \
    }                                                                          \
    return static_cast<int>(cudaGetLastError());                               \
  }

extern "C" {

int rm_params_size() { return static_cast<int>(sizeof(Params)); }

int rm_scan_ring() { return kScanRing; }

const char* rm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of kernel `kernel` (its direct instantiation if `direct`; the
// projection has none) that fit on the whole current device at once with
// `smem` bytes of dynamic shared memory each (0 if none fits).
int rm_max_blocks(int kernel, int direct, long long smem, int* blocks) {
  *blocks = 0;
  if (kernel < 0 || kernel >= kNumKernels) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kKernels[kernel][direct ? 1 : 0];
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = per_sm * sms;
  return 0;
}

// The projection's launcher takes staged rows only.
int rm_project(const Params* params, int n_blocks, long long smem, void* stream) {
  if (n_blocks <= 0 || params->direct) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(rm_project_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rm_project_kernel<<<n_blocks, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(*params);
  return static_cast<int>(cudaGetLastError());
}
RM_LAUNCHER(rm_filter_project, rm_filter_kernel)
RM_LAUNCHER(rm_aggregate, rm_aggregate_kernel)
RM_LAUNCHER(rm_groupby_sum, rm_groupby_kernel)
RM_LAUNCHER(rm_scan_multi, rm_scan_multi_kernel)
RM_LAUNCHER(rm_project_multi, rm_project_multi_kernel)

int rm_reduce_partials(const float* partials, int n_parts, int width,
                       float* out, void* stream) {
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (width + kReduceCols - 1) / kReduceCols;
  rm_reduce_partials_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_parts, width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
