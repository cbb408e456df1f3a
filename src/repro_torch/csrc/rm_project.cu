// The paper's §5.2 projection revisions and the compacting selection for
// Hopper (sm_90a).
//
//   rm_project_bsl_kernel     <- repro/kernels/rme_project.py _bsl_kernel
//   rm_project_pck_kernel     <- repro/kernels/rme_project.py _pck_kernel
//   rm_select_compact_kernel  <- repro/kernels/rme_select.py  _select_kernel
//
// (The MLP revision is rm_project_kernel and the multi-view projection
// rm_project_multi_kernel, both in rm_scan.cu: they stage whole row tiles.)
//
// What bounds them: bytes.  Each moves the enabled words of every row once
// and writes the packed output once, with no arithmetic to speak of, so the
// least time is the 32-byte sectors holding the enabled (and, for the
// selection, the predicate and timestamp) words plus the output, over the
// memory rate.
//
// Design.  The three revisions must stay structurally distinct, because the
// distinction is what the paper's revision study measures:
//
//   * BSL (baseline, no packer): grid (row tiles, Q), the Q column blocks of
//     a tile adjacent in launch order as the Pallas grid iterates them.  Each
//     block copies one column's word range of its row tile from global
//     memory straight into that column's slice of the output rows.  Nothing
//     is staged: the loads and the stores are strided and partial, Q blocks
//     touch every output row, and the row tile is read Q times — from L2
//     after the first, because the tile's blocks run together.  (Launched
//     column-major instead, each column becomes a pass over the whole table
//     from device memory; PERF.md has both orders' times.)
//     Rows wider than kDirectRowWords (a training record's tokens and
//     labels: Q 2 columns of 2,048+ words) leave that grid a few dozen
//     blocks, each moving megabytes 4 bytes at a time.  Their wide form
//     keeps the grid's order and the column-by-column copy (no packer, no
//     staging, no merged columns) and changes three things: each column's
//     range is cut into chunks (ColParams::chunk_w words, cut at 16-byte
//     boundaries of the packed row, planned by _cuda.bsl_plan), so tiles x
//     chunks fill the card; a warp copies a (row, chunk), kBslUnroll rows'
//     loads in flight before their stores; and the copy is rm_copy.cuh's,
//     16-byte stores driven by the destination, the source realigned in
//     registers.
//   * PCK (packer register): one block per row tile walks the Q columns,
//     gathers each column's words into a packed tile in shared memory (the
//     packer), then writes the whole packed tile with one coalesced store.
//     The Q strided gathers of a tile re-read its sectors, so they load
//     through the cache (not the streaming hint the one-pass kernels use).
//     A packed row wider than the packer (ColParams::range_w < out_w: more
//     than 14,528 words at 4 rows a tile) is packed in word ranges by the
//     kernel's ranged instantiation, each range gathered from the columns
//     that cross it and then stored; every enabled word is still read once.
//   * MLP (rm_scan.cu): the whole row tile is staged with coalesced 16-byte
//     loads and every column is packed out of shared memory.
//
// The selection keeps a row when the predicate holds, the row exists
// (ridx < n: the reference pads the table with zero rows, here the tail is
// masked and nothing is copied) and it is visible at the snapshot.  One
// block per contract block of block_rows rows walks it in sub-tiles of
// kThreads rows: a warp ballot and popc give each kept row its rank in the
// warp, a prefix over the block's warps and a running base give its slot,
// so kept rows keep their original order (the reference's stable argsort).
// Slots from the count to block_rows are zero-filled and the count written.
// A map of at most kSelectInlineMap words rides in the parameter block
// (SelectParams::map_inline); a longer one lives in device memory and its
// instantiation stages it into shared memory when it takes at most
// kSelectSmemMap words.
#include "rm_common.cuh"
#include "rm_copy.cuh"

using namespace rm;

namespace {

constexpr int kMaxCols = 256;  // column slices one BSL / PCK launch carries
constexpr int kBslRows = 256;  // rows per BSL block
constexpr int kBslWarps = kThreads / 32;
constexpr int kBslUnroll = 4;  // rows a warp of the wide form loads before it stores
constexpr int kDirectRowWords = 2048;  // wider rows take BSL's wide form (_cuda.DIRECT_ROW_WORDS)
constexpr int kSelectInlineMap = 512;  // map words the selection's parameter block holds
constexpr int kSelectSmemMap = 12 * 1024;  // longer maps the selection stages (48 KB)

}  // namespace

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_ColParams,
// _SelectParams), which checks both sizes at load time.
struct ColParams {
  const int32_t* words;  // (n, row_words) row store
  int32_t* out;          // (n, out_w) packed output
  long long n;
  int32_t row_words;
  int32_t out_w;
  int32_t n_cols;        // Q
  int32_t tile_rows;     // PCK: rows per packed tile (a multiple of 4)
  int32_t range_w;       // PCK: packed words a pass of the packer (out_w: one pass)
  int32_t chunk_w;       // BSL, rows over kDirectRowWords: words a chunk (else 0)
  int32_t chunks;        // BSL wide: chunks a row tile, the columns' summed
  int32_t pad_;
  int32_t src[kMaxCols]; // first row word of each column
  int32_t dst[kMaxCols]; // first packed word of each column
  int32_t width[kMaxCols];
};

struct SelectParams {
  const int32_t* words;  // (n, row_words) row store
  int32_t* out;          // (n_blocks, block_rows, out_w)
  int32_t* counts;       // (n_blocks,)
  const int32_t* map;    // (out_w,) source word of every packed word, out_w > kSelectInlineMap
  long long n;
  int32_t row_words;
  int32_t out_w;
  int32_t block_rows;
  int32_t pad_;
  Req q;                 // predicate and MVCC test (pred_* and ts_* fields)
  int32_t map_inline[kSelectInlineMap];  // the map, out_w <= kSelectInlineMap
};

__global__ void __launch_bounds__(kThreads)
rm_project_bsl_kernel(const __grid_constant__ ColParams p) {
  const long long tile = blockIdx.x / p.n_cols;
  const int j = static_cast<int>(blockIdx.x - tile * p.n_cols);
  const long long row0 = tile * kBslRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kBslRows), p.n - row0));
  const int src = p.src[j], dst = p.dst[j], w = p.width[j];
  const int32_t* in = p.words + row0 * p.row_words + src;
  int32_t* out = p.out + row0 * p.out_w + dst;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w, k = i - r * w;
    out[static_cast<long long>(r) * p.out_w + k] =
        __ldg(in + static_cast<long long>(r) * p.row_words + k);
  }
}

// BSL's wide form: its first chunk of column j starts at the 16-byte
// boundary of the packed row at or before dst (where out_w is a multiple of
// 4; else at dst), later ones chunk_w words apart (mirrored by
// _cuda.bsl_chunk).
__host__ __device__ __forceinline__ int bsl_lead(int dst, int out_w) {
  return (out_w & 3) == 0 ? (dst & 3) : 0;
}

__global__ void __launch_bounds__(kThreads)
rm_project_bsl_wide_kernel(const __grid_constant__ ColParams p) {
  const long long tile = blockIdx.x / p.chunks;
  const int c = static_cast<int>(blockIdx.x - tile * p.chunks);
  // the column of chunk c and its first chunk: the columns' chunks side by side
  int j = 0, first = 0;
  for (;; ++j) {
    const int n = (bsl_lead(p.dst[j], p.out_w) + p.width[j] + p.chunk_w - 1) / p.chunk_w;
    if (c < first + n || j + 1 == p.n_cols) break;
    first += n;
  }
  const int lead = bsl_lead(p.dst[j], p.out_w);
  const int k = c - first;
  const int lo = max(0, k * p.chunk_w - lead);
  const int hi = min(p.width[j], (k + 1) * p.chunk_w - lead);
  const long long row0 = tile * kBslRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kBslRows), p.n - row0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the row store's word address: blocks are aligned on the address
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(p.words) >> 2);
  for (int r0 = warp; r0 < rows; r0 += kBslWarps * kBslUnroll) {
    rm_copy::Span sp[kBslUnroll];
    rm_copy::Item it[kBslUnroll];
#pragma unroll
    for (int u = 0; u < kBslUnroll; ++u) {
      const long long row = row0 + r0 + u * kBslWarps;
      sp[u].d0 = row * p.out_w + p.dst[j] + lo;
      sp[u].d1 = row * p.out_w + p.dst[j] + hi;
      sp[u].s0 = base + row * p.row_words + p.src[j] + lo;
      sp[u].s1 = sp[u].s0 + (hi - lo);
      if (r0 + u * kBslWarps < rows) it[u] = rm_copy::load_item(sp[u], 0, lane);
    }
#pragma unroll
    for (int u = 0; u < kBslUnroll; ++u) {
      if (r0 + u * kBslWarps >= rows) continue;  // the same for the whole warp
      rm_copy::store_item(p.out, sp[u], it[u], lane);
      // a chunk the plan keeps within one item; any rest, an item at a time
      for (int i = 1; i < rm_copy::items(sp[u]); ++i)
        rm_copy::store_item(p.out, sp[u], rm_copy::load_item(sp[u], i, lane), lane);
    }
  }
}

// One tile's packed rows, written with one contiguous store: 16 bytes a
// thread where the destination is aligned (a tile of a multiple of 4 rows is).
__device__ __forceinline__ void store_packed(const int32_t* packed, int32_t* out, int n_words) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int n_vec = n_words >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(packed);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) o4[i] = s4[i];
    head = n_vec << 2;
  }
  for (int i = head + threadIdx.x; i < n_words; i += blockDim.x) out[i] = packed[i];
}

template <bool kRanged>
__global__ void __launch_bounds__(kThreads)
rm_project_pck_kernel(const __grid_constant__ ColParams p) {
  int32_t* packed = smem_words();
  const long long n_tiles = (p.n + p.tile_rows - 1) / p.tile_rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * p.tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.tile_rows), p.n - row0));
    const int32_t* in = p.words + row0 * p.row_words;
    int32_t* out = p.out + row0 * p.out_w;
    if (!kRanged) {
      __syncthreads();  // the previous tile's packer is flushed
      // one column chunk per step into the packer register
      for (int j = 0; j < p.n_cols; ++j) {
        const int src = p.src[j], dst = p.dst[j], w = p.width[j];
        for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
          const int r = i / w, k = i - r * w;
          packed[r * p.out_w + dst + k] = __ldg(in + static_cast<long long>(r) * p.row_words + src + k);
        }
      }
      __syncthreads();
      store_packed(packed, out, rows * p.out_w);
      continue;
    }
    // packed words [w0, w0 + rw) of the tile's rows a pass
    for (int w0 = 0; w0 < p.out_w; w0 += p.range_w) {
      const int rw = min(p.range_w, p.out_w - w0);
      __syncthreads();  // the previous pass's packer is flushed
      for (int j = 0; j < p.n_cols; ++j) {
        const int lo = max(p.dst[j], w0), hi = min(p.dst[j] + p.width[j], w0 + rw);
        if (lo >= hi) continue;
        const int src = p.src[j] + lo - p.dst[j], dst = lo - w0, w = hi - lo;
        for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
          const int r = i / w, k = i - r * w;
          packed[r * rw + dst + k] = __ldg(in + static_cast<long long>(r) * p.row_words + src + k);
        }
      }
      __syncthreads();
      // a range of each packed row: contiguous within the row
      for (int i = threadIdx.x; i < rows * rw; i += blockDim.x) {
        const int r = i / rw, k = i - r * rw;
        out[static_cast<long long>(r) * p.out_w + w0 + k] = packed[i];
      }
    }
  }
}

template <bool kDeviceMap>
__global__ void __launch_bounds__(kThreads)
rm_select_compact_kernel(const __grid_constant__ SelectParams p) {
  __shared__ int warp_n[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* map = p.map;
  if (kDeviceMap && p.out_w <= kSelectSmemMap) {  // the launcher gave the staged map room
    int32_t* sm_map = smem_words();
    for (int i = threadIdx.x; i < p.out_w; i += blockDim.x) sm_map[i] = __ldg(p.map + i);
    __syncthreads();
    map = sm_map;
  }
  const long long blk0 = static_cast<long long>(blockIdx.x) * p.block_rows;
  int32_t* out = p.out + blk0 * p.out_w;
  int base = 0;  // slots filled by earlier sub-tiles (same in every thread)
  for (int s = 0; s < p.block_rows; s += blockDim.x) {
    const int slot_row = s + threadIdx.x;
    const long long ridx = blk0 + slot_row;
    const int32_t* row = p.words + ridx * p.row_words;
    const bool keep = slot_row < p.block_rows && ridx < p.n && row_pass(row, p.q);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
      before += i < warp ? warp_n[i] : 0;
      total += warp_n[i];
    }
    if (keep) {
      const int slot = base + before + __popc(ballot & ((1u << lane) - 1u));
      int32_t* dst = out + static_cast<long long>(slot) * p.out_w;
      if (kDeviceMap) {
        for (int k = 0; k < p.out_w; ++k) dst[k] = row[map[k]];
      } else {
        for (int k = 0; k < p.out_w; ++k) dst[k] = row[p.map_inline[k]];
      }
    }
    base += total;
    __syncthreads();  // warp_n is rewritten by the next sub-tile
  }
  // zero-fill the slots past the count
  const long long fill0 = static_cast<long long>(base) * p.out_w;
  const long long fill1 = static_cast<long long>(p.block_rows) * p.out_w;
  for (long long i = fill0 + threadIdx.x; i < fill1; i += blockDim.x) out[i] = 0;
  if (threadIdx.x == 0) p.counts[blockIdx.x] = base;
}

namespace {

int launch_bsl(const ColParams& p, cudaStream_t s) {
  if (p.n_cols <= 0 || p.n_cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = p.row_words > kDirectRowWords;
  long long per_tile = p.n_cols;
  if (wide) {
    if (p.chunk_w <= 0 || p.chunk_w % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    per_tile = 0;
    for (int j = 0; j < p.n_cols; ++j)
      per_tile += (bsl_lead(p.dst[j], p.out_w) + p.width[j] + p.chunk_w - 1) / p.chunk_w;
    if (per_tile != p.chunks) return static_cast<int>(cudaErrorInvalidValue);
  } else if (p.chunk_w != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (p.n + kBslRows - 1) / kBslRows * per_tile;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    rm_project_bsl_wide_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    rm_project_bsl_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_pck(const ColParams& p, int n_blocks, long long smem, cudaStream_t s) {
  if (n_blocks <= 0 || p.n_cols <= 0 || p.n_cols > kMaxCols || p.range_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ranged = p.range_w < p.out_w;
  if (smem > 48 * 1024) {
    const void* fn = ranged ? reinterpret_cast<const void*>(rm_project_pck_kernel<true>)
                            : reinterpret_cast<const void*>(rm_project_pck_kernel<false>);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (ranged) {
    rm_project_pck_kernel<true><<<n_blocks, kThreads, static_cast<size_t>(smem), s>>>(p);
  } else {
    rm_project_pck_kernel<false><<<n_blocks, kThreads, static_cast<size_t>(smem), s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Run `launch` with card `device` current (made so for the launch if it
// is not), returning its error or the device switch's.
template <typename F>
int on_device(int device, F launch) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int err = launch();
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // namespace

extern "C" {

int rm_col_params_size() { return static_cast<int>(sizeof(ColParams)); }
int rm_select_params_size() { return static_cast<int>(sizeof(SelectParams)); }

// BSL: ceil(n / kBslRows) * Q blocks, block b on tile b / Q, column b % Q;
// rows over kDirectRowWords: ceil(n / kBslRows) * chunks blocks, block b on
// tile b / chunks, chunk b % chunks (the plan checked here: chunk_w a
// positive multiple of 4, chunks the columns' chunks summed).  Launch on
// `stream` of card `device`, do not synchronise, return the launch's
// cudaGetLastError() (0 on success).
int rm_project_bsl(const ColParams* params, int device, void* stream) {
  return on_device(device, [&] { return launch_bsl(*params, static_cast<cudaStream_t>(stream)); });
}

// PCK: `n_blocks` blocks walk the packed tiles, `smem` bytes of packer each
// (tile_rows * range_w words; the ranged instantiation when range_w < out_w),
// on `stream` of card `device`.
int rm_project_pck(const ColParams* params, int n_blocks, long long smem, int device,
                   void* stream) {
  return on_device(device, [&] {
    return launch_pck(*params, n_blocks, smem, static_cast<cudaStream_t>(stream));
  });
}

// Selection: one block per contract block.
int rm_select_compact(const SelectParams* params, long long n_blocks, void* stream) {
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || params->block_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (params->out_w <= kSelectInlineMap) {
    rm_select_compact_kernel<false><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(*params);
  } else {
    const size_t smem = params->out_w <= kSelectSmemMap ? 4 * params->out_w : 0;
    rm_select_compact_kernel<true><<<static_cast<unsigned>(n_blocks), kThreads, smem, s>>>(*params);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
