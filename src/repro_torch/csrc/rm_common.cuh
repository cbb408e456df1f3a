// Shared device code of the relational-memory scan kernels (rm_scan.cu).
//
// Every kernel of the family does the same first step: a block stages a
// contiguous tile of whole rows of the (N, row_words) int32 row store in
// shared memory with 16-byte loads (rows are contiguous, so a tile is one
// contiguous span) — the fused scan_multi asynchronously, into a ring of
// two tiles (issue_tile) — then per-request code reads the staged tile.
// A row wider than a quarter of a tile (Params::direct: more than 2,048
// words, a training record's tokens and labels) is not staged: each kernel's
// direct instantiation (template argument kDirect) reads the tile's rows
// straight from the row store (load_tile), so only the 32-byte sectors
// holding the words it uses leave device memory, each once; the staged
// instantiation is the code of the staged rows alone.  (The single
// projection has no direct instantiation: rm_spans.cu copies such rows.)
// The per-request code:
//
//   * project / filter: a src_word[out_w] map scatters each row's enabled
//     words into the packed output row; a filter writes zeros for failing
//     rows and one bool byte per row;
//   * aggregate: per-thread [sum, count] over the block's rows, reduced in
//     the block by warp shuffles in a fixed order;
//   * group-by: a (G, 2) float histogram in shared memory (or, when it does
//     not fit, in the block's own row of the partials buffer) fed with
//     atomics.
//
// Reduced requests leave one partial row per block; rm_reduce_partials sums
// those rows in a fixed order, so aggregates are deterministic run to run.
//
// The word map (the source word of every packed output word, all requests
// back to back) lives in device memory, so a launch takes a map of any
// length; a block copies it into shared memory when it fits there
// (Params::map_smem >= 0) and reads it through the cache otherwise.
//
// The layout of Params / Req is mirrored by ctypes in
// repro_torch/kernels/_cuda.py, which checks sizeof(Params) at load time.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rm {

constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kMaxReq = 16;    // requests one launch carries

enum Kind : int32_t { kProject = 0, kFilter = 1, kAggregate = 2, kGroupBy = 3 };
enum PredOp : int32_t { kNone = 0, kGt = 1, kLt = 2 };

// One request of a launch.  Offsets into shared memory are in 4-byte words.
struct Req {
  int32_t kind;
  int32_t out_w;       // packed words per row (project / filter)
  int32_t map_off;     // first entry of this request's word map in the map
  int32_t pred_word;
  int32_t pred_float;  // the predicate column is float32 (else int32)
  int32_t pred_op;     // PredOp
  int32_t k_bits;      // predicate constant, as the column dtype's bits
  int32_t ts_word;     // < 0: no MVCC test; else begin at ts_word, end at +1
  int32_t ts;          // snapshot time
  int32_t agg_word;
  int32_t agg_float;   // the aggregated column is float32 (else int32)
  int32_t group_word;
  int32_t num_groups;
  int32_t red_off;     // reduced requests: offset in a block's partial row
  int32_t hist_off;    // group-by: histogram in shared memory; < 0: global
  int32_t slot;        // scan_multi aggregates: per-thread accumulator slot
  int32_t* out;        // packed output (project / filter)
  uint8_t* mask;       // filter validity, one byte per row
};

// Everything a launch needs, passed by value as a __grid_constant__.
struct Params {
  const int32_t* words;  // (n, row_words) row store, row-major
  float* partials;       // (gridDim.x, part_w) per-block reduced partials
  const int32_t* map;    // (map_len,) source word of every packed word
  long long n;           // rows
  int32_t row_words;
  int32_t tile_rows;     // rows a tile (staged: a multiple of 4)
  int32_t n_req;
  int32_t map_len;
  int32_t part_w;
  int32_t n_slots;       // aggregate accumulator slots (scan_multi)
  int32_t map_smem;      // shared-memory word offset of the staged map; < 0: read in place
  int32_t slot_smem;     // shared-memory word offset of the slots
  int32_t tile_stride;   // words between the ring's two tiles (scan_multi)
  int32_t direct;        // rows read from the row store, not staged
  Req req[kMaxReq];
};

__device__ __forceinline__ int32_t* smem_words() {
  extern __shared__ int4 smem4[];
  return reinterpret_cast<int32_t*>(smem4);
}

// Stage rows [row0, row0 + rows) into `tile`.  Byte offsets are 64-bit: at
// 33.5M rows of 18 words the row store passes 2^31 bytes.
__device__ __forceinline__ void stage_tile(int32_t* tile, const int32_t* words,
                                           long long row0, int rows,
                                           int row_words) {
  const int32_t* src = words + row0 * static_cast<long long>(row_words);
  const int n_words = rows * row_words;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // a tile of a multiple of 4 rows starts 16-byte aligned when its chunk
    // does; a chunk sliced at an odd row falls back to word loads
    const int n_vec = n_words >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* t4 = reinterpret_cast<int4*>(tile);
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) t4[i] = __ldcs(s4 + i);
    head = n_vec << 2;
  }
  for (int i = head + threadIdx.x; i < n_words; i += blockDim.x) tile[i] = __ldcs(src + i);
}

// Asynchronous copies into shared memory (cp.async): 16 bytes through L2
// only, or 4 bytes where the source is not 16-byte aligned.
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's copy groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [row0, row0 + rows) into `tile`, as stage_tile does but
// without waiting; the caller commits the group.
__device__ __forceinline__ void issue_tile(int32_t* tile, const int32_t* words,
                                           long long row0, int rows,
                                           int row_words) {
  const int32_t* src = words + row0 * static_cast<long long>(row_words);
  const int n_words = rows * row_words;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n_vec = n_words >> 2;
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) cp_async16(tile + 4 * i, src + 4 * i);
    head = n_vec << 2;
  }
  for (int i = head + threadIdx.x; i < n_words; i += blockDim.x) cp_async4(tile + i, src + i);
}

// Predicate AND MVCC visibility of one staged row.
__device__ __forceinline__ bool row_pass(const int32_t* row, const Req& q) {
  bool m = true;
  if (q.pred_op != kNone) {
    const int32_t v = row[q.pred_word];
    if (q.pred_float) {
      const float fv = __int_as_float(v), fk = __int_as_float(q.k_bits);
      m = q.pred_op == kGt ? fv > fk : fv < fk;
    } else {
      m = q.pred_op == kGt ? v > q.k_bits : v < q.k_bits;
    }
  }
  if (q.ts_word >= 0) m = m && row[q.ts_word] <= q.ts && q.ts < row[q.ts_word + 1];
  return m;
}

__device__ __forceinline__ float agg_value(const int32_t* row, const Req& q) {
  const int32_t v = row[q.agg_word];
  return q.agg_float ? __int_as_float(v) : static_cast<float>(v);
}

// Floored modulo: CUDA's % truncates toward zero, the reference's
// jnp.remainder takes the divisor's sign.  For g >= 1 the 32-bit remainder
// cannot overflow and |r| < g, so r + g fits too; a power of two is a mask
// of the two's-complement key.
__device__ __forceinline__ int group_of(int32_t key, int g) {
  if ((g & (g - 1)) == 0) return key & (g - 1);
  const int r = key % g;
  return r < 0 ? r + g : r;
}

// Pack the enabled words of a tile: one thread per output word, so the
// stores of a warp are contiguous.  Read in place (kDirect), packed rows at
// least a block wide are walked a row at a time (no division per word, and
// a thread's loads of a row are independent of each other, so several are
// in flight).
template <bool kWithFilter, bool kDirect>
__device__ __forceinline__ void pack_tile(const int32_t* tile, int rows,
                                          int row_words, const int32_t* map,
                                          const Req& q, long long row0) {
  const int out_w = q.out_w;
  int32_t* dst = q.out + row0 * out_w;
  if (kDirect && out_w >= static_cast<int>(blockDim.x)) {
    for (int r = 0; r < rows; ++r) {
      const int32_t* row = tile + static_cast<long long>(r) * row_words;
      const bool keep = !kWithFilter || row_pass(row, q);
      int32_t* d = dst + static_cast<long long>(r) * out_w;
#pragma unroll 4
      for (int w = threadIdx.x; w < out_w; w += blockDim.x) d[w] = keep ? row[map[w]] : 0;
    }
  } else {
    const int n_out = rows * out_w;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      const int r = i / out_w;
      const int32_t* row = tile + r * row_words;
      int32_t v = row[map[i - r * out_w]];
      if (kWithFilter && !row_pass(row, q)) v = 0;
      dst[i] = v;
    }
  }
  if (kWithFilter) {
    uint8_t* m = q.mask + row0;
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      m[r] = row_pass(tile + r * row_words, q) ? 1 : 0;
  }
}

// This thread's share of one tile's masked [sum, count].
__device__ __forceinline__ void agg_tile(const int32_t* tile, int rows,
                                         int row_words, const Req& q, float& s,
                                         unsigned& c) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int32_t* row = tile + r * row_words;
    if (row_pass(row, q)) {
      s += agg_value(row, q);
      c += 1;
    }
  }
}

// One tile's rows into a (G, 2) [sum, count] histogram.
__device__ __forceinline__ void group_tile(const int32_t* tile, int rows,
                                           int row_words, const Req& q,
                                           float* hist) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int32_t* row = tile + r * row_words;
    if (row_pass(row, q)) {
      const int g = group_of(row[q.group_word], q.num_groups);
      atomicAdd(hist + 2 * g, agg_value(row, q));
      atomicAdd(hist + 2 * g + 1, 1.0f);
    }
  }
}

// Block-wide [sum, count] in a fixed order: shuffles within each warp, then
// thread 0 adds the warp totals in warp order.  The result is in thread 0.
__device__ __forceinline__ void block_sum2(float& s, unsigned& c) {
  __shared__ float warp_s[kThreads / 32];
  __shared__ unsigned warp_c[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_s[w] = s;
    warp_c[w] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.0f;
    c = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
      s += warp_s[i];
      c += warp_c[i];
    }
  }
  __syncthreads();
}

// The word maps of every request: staged into shared memory once per block
// where the plan found room (the caller synchronises before any use), read
// from device memory otherwise.
__device__ __forceinline__ const int32_t* stage_map(const Params& p, int32_t* smem) {
  if (p.map_smem < 0) return p.map;
  int32_t* sm_map = smem + p.map_smem;
  for (int i = threadIdx.x; i < p.map_len; i += blockDim.x) sm_map[i] = __ldg(p.map + i);
  return sm_map;
}

// The rows [row0, row0 + rows) a block serves, laid out as in the row store:
// staged into `tile` (the caller synchronises before and after), or, read in
// place (kDirect), the row store itself.
template <bool kDirect>
__device__ __forceinline__ const int32_t* load_tile(const Params& p, int32_t* tile,
                                                    long long row0, int rows) {
  if (kDirect) return p.words + row0 * static_cast<long long>(p.row_words);
  stage_tile(tile, p.words, row0, rows, p.row_words);
  return tile;
}

// Where a group-by request accumulates: its shared histogram, or this
// block's own row of the partials buffer when G is too large for shared
// memory.
__device__ __forceinline__ float* group_hist(const Params& p, const Req& q,
                                             int32_t* smem) {
  return q.hist_off >= 0 ? reinterpret_cast<float*>(smem + q.hist_off)
                         : p.partials + blockIdx.x * static_cast<long long>(p.part_w) + q.red_off;
}

__device__ __forceinline__ void zero_floats(float* x, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = 0.0f;
}

// A shared histogram goes to this block's partial row; a global one is
// already there.
__device__ __forceinline__ void flush_hist(const Params& p, const Req& q,
                                           const float* hist) {
  if (q.hist_off < 0) return;
  float* dst = p.partials + blockIdx.x * static_cast<long long>(p.part_w) + q.red_off;
  for (int i = threadIdx.x; i < 2 * q.num_groups; i += blockDim.x) dst[i] = hist[i];
}

}  // namespace rm
