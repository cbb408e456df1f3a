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
//     Rows wider than kDirectRowWords take PCK's wide form, which keeps the
//     packer, the column-by-column gather and one contiguous store a packed
//     range, and is built so that several blocks share an SM, loads are 16
//     bytes wide and a block's stores overlap its next gather:
//       - the work is (row tile x packed range) items, planned per layout by
//         _cuda.pck_plan: ranges of ColParams::range_w words (a multiple of
//         4) of tile_rows rows, a 16 KB packer, ColParams::chunks ranges a
//         tile; a grid of the blocks that fit the card walks the items;
//       - the gather is rm_copy.cuh's: 16-byte loads of the source blocks
//         under each 16-byte vector of the packer, realigned in registers
//         and stored into the packer, a warp an item of a (column, row),
//         kPckUnroll items' loads in flight;
//       - each block has two packers: once one is gathered, one thread
//         stores each of its packed rows with a bulk copy
//         (cp.async.bulk.global.shared::cta, one a row range), and the
//         block gathers the next item into the other packer while the copies
//         read; a packer is gathered again only after its copies have read
//         it (cp.async.bulk.wait_group.read).  Where out_w is not a
//         multiple of 4 (a packed row is then not 16-byte aligned) the
//         block stores the range word by word instead.
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
#include <atomic>

#include "rm_common.cuh"
#include "rm_copy.cuh"

using namespace rm;

namespace {

constexpr int kMaxCols = 256;  // column slices one BSL / PCK launch carries
constexpr int kBslRows = 256;  // rows per BSL block
constexpr int kBslWarps = kThreads / 32;
constexpr int kBslUnroll = 4;  // rows a warp of the wide form loads before it stores
constexpr int kPckUnroll = 2;  // items a warp of PCK's wide form loads before it stores
constexpr int kPckPackers = 2;  // packers a block of PCK's wide form (_cuda.PCK_PACKERS)
constexpr int kDirectRowWords = 2048;  // wider rows take BSL's wide form (_cuda.DIRECT_ROW_WORDS)
constexpr int kSelectInlineMap = 512;  // map words the selection's parameter block holds
constexpr int kSelectSmemMap = 12 * 1024;  // longer maps the selection stages (48 KB)
constexpr int kMaxDevices = 64;  // cards whose PCK occupancy the launcher keeps

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
  int32_t tile_rows;     // PCK: rows per packed tile (a multiple of 4; wide form: any)
  int32_t range_w;       // PCK: packed words a pass of the packer (out_w: one pass)
  int32_t chunk_w;       // BSL, rows over kDirectRowWords: words a chunk (else 0)
  int32_t chunks;        // BSL wide: chunks a row tile, the columns' summed; PCK wide: ranges
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

namespace {

// cp.async.bulk: a row range of a packer to device memory, by the async
// proxy; the generic proxy's writes to the packer are made visible to it
// first (fence_proxy_async by every writer, then a barrier)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void bulk_store(int32_t* dst, const int32_t* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(reinterpret_cast<uint64_t>(dst)),
                  "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))),
                  "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// all but the newest `kLeft` groups of copies have read their packers
template <int kLeft>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kLeft) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// PCK's wide form (rows over kDirectRowWords): items (row tile, packed
// range), item i of the tile t at (t * chunks + i); block b walks items b,
// b + gridDim.x, ..., its l-th into packer l % 2 (see the header).
__global__ void __launch_bounds__(kThreads)
rm_project_pck_wide_kernel(const __grid_constant__ ColParams p) {
  constexpr int kWarps = kThreads / 32;
  int32_t* packers = smem_words();
  const int R = p.tile_rows, rw = p.range_w;
  const long long n_items = (p.n + R - 1) / R * p.chunks;
  // a packed row range is one bulk copy where it starts and ends 16-byte aligned
  const bool bulk = (p.out_w & 3) == 0 && (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(p.words) >> 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int l = 0;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x, ++l) {
    const long long tile = item / p.chunks;
    const int w0 = static_cast<int>(item - tile * p.chunks) * rw;
    const int width = min(rw, p.out_w - w0);
    const long long row0 = tile * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), p.n - row0));
    int32_t* packer = packers + (l % kPckPackers) * R * rw;
    // the copies of item l - 2 have read this packer (those of l - 1 may not)
    if (bulk && l >= kPckPackers && threadIdx.x == 0) bulk_wait_read<kPckPackers - 1>();
    __syncthreads();
    // the gather, column by column: a column's piece of the range in packer
    // row r is words [lo - w0, hi - w0) + r * rw, its items the same in every
    // row (rw is a multiple of 4); units (item c, row r) are dealt to the
    // warps in turn across the columns
    int dealt = 0;
    for (int j = 0; j < p.n_cols; ++j) {
      const int lo = max(p.dst[j], w0), hi = min(p.dst[j] + p.width[j], w0 + width);
      if (lo >= hi) continue;
      const long long s0 = base + row0 * p.row_words + p.src[j] + (lo - p.dst[j]);
      const rm_copy::Span sp0{lo - w0, hi - w0, s0, s0 + (hi - lo)};
      const int units = rm_copy::items(sp0) * rows;
      const int first = (warp - dealt % kWarps + kWarps) % kWarps;
      for (int u0 = first; u0 < units; u0 += kWarps * kPckUnroll) {
        rm_copy::Span sp[kPckUnroll];
        rm_copy::Item it[kPckUnroll];
#pragma unroll
        for (int v = 0; v < kPckUnroll; ++v) {
          const int u = u0 + v * kWarps;
          if (u >= units) continue;  // the same for the whole warp
          const int r = u % rows;
          sp[v] = sp0;
          sp[v].d0 += static_cast<long long>(r) * rw;
          sp[v].d1 += static_cast<long long>(r) * rw;
          sp[v].s0 += static_cast<long long>(r) * p.row_words;
          sp[v].s1 += static_cast<long long>(r) * p.row_words;
          it[v] = rm_copy::load_item(sp[v], u / rows, lane);
        }
#pragma unroll
        for (int v = 0; v < kPckUnroll; ++v)
          if (u0 + v * kWarps < units) rm_copy::store_item<true>(packer, sp[v], it[v], lane);
      }
      dealt += units;
    }
    if (bulk) {
      fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int r = 0; r < rows; ++r)
          bulk_store(p.out + (row0 + r) * p.out_w + w0, packer + r * rw, 4u * width);
        bulk_commit();
      }
    } else {
      __syncthreads();
      for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
        const int r = i / width, k = i - r * width;
        p.out[(row0 + r) * p.out_w + w0 + k] = packer[r * rw + k];
      }
    }
  }
  if (bulk && threadIdx.x == 0) bulk_wait_all();
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

// PCK's wide form: the plan checked (ranges of a multiple of 4 words
// covering out_w, two packers of tile_rows x range_w words in `smem`)
bool pck_wide_plan_ok(const ColParams& p, long long smem) {
  return p.tile_rows > 0 && p.range_w > 0 && p.range_w % 4 == 0 && p.chunks > 0 &&
         p.chunks == (p.out_w + p.range_w - 1) / p.range_w &&
         smem == 4LL * kPckPackers * p.tile_rows * p.range_w;
}

// Blocks of PCK's wide form with `smem` bytes of packers that card
// `device` holds at once (its SMs times the blocks an SM holds), asked of
// the runtime once a card and size: kept as smem * 2^20 + blocks
int pck_wide_resident(int device, long long smem, int* blocks) {
  static std::atomic<long long> asked[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const long long got = asked[device].load(std::memory_order_relaxed);
  if (got >> 20 == smem) {
    *blocks = static_cast<int>(got & 0xfffff);
    return 0;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rm_project_pck_wide_kernel,
                                                      kThreads, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = sms * per_sm;
  asked[device].store(smem << 20 | *blocks, std::memory_order_relaxed);
  return 0;
}

int launch_pck(const ColParams& p, int n_blocks, long long smem, int device, cudaStream_t s) {
  if (n_blocks <= 0 || p.n_cols <= 0 || p.n_cols > kMaxCols || p.range_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.row_words > kDirectRowWords) {
    if (!pck_wide_plan_ok(p, smem)) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rm_project_pck_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // a grid of the blocks that fit the card walks the items
    int resident = 0;
    const int err = pck_wide_resident(device, smem, &resident);
    if (err != 0) return err;
    if (n_blocks > resident) n_blocks = resident;
    rm_project_pck_wide_kernel<<<n_blocks, kThreads, static_cast<size_t>(smem), s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.chunks != 0) return static_cast<int>(cudaErrorInvalidValue);
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
// on `stream` of card `device`.  Rows over kDirectRowWords: the wide form,
// at most `n_blocks` blocks (no more than the card holds at once) walking
// the (tile, range) items, `smem` its two packers (the plan checked:
// range_w a positive multiple of 4, chunks the ranges covering out_w; else
// an error, never another form).
int rm_project_pck(const ColParams* params, int n_blocks, long long smem, int device,
                   void* stream) {
  return on_device(device, [&] {
    return launch_pck(*params, n_blocks, smem, device, static_cast<cudaStream_t>(stream));
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
