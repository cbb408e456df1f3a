// The wide-row form of the packed projection for Hopper (sm_90a).
//
//   rm_project_spans_kernel <- repro/kernels/rme_project.py _mlp_kernel, for
//                              rows wider than 2,048 words (_cuda.DIRECT_ROW_WORDS)
//
// Narrower rows take rm_project_kernel (rm_scan.cu), which stages whole row
// tiles; a row this wide (a training record's tokens and labels) leaves too
// few rows in a tile to stage, so this kernel copies the enabled words
// straight from the row store to the packed output.
//
// What bounds it: bytes.  It moves every enabled word once and writes the
// packed rows once, with no arithmetic, so the least time is the 32-byte
// sectors holding the enabled words plus the output, over the memory rate.
//
// Design.  The launch carries the enabled columns as (src, dst, width) word
// ranges, the reference's own column slices, with the ranges that continue
// each other merged (SpanParams, kMaxSpans of them; planned once per
// layout by _cuda.span_plan), never a word map.  Each row's ranges are then
// a batch of span copies whose source and destination are misaligned
// differently: a row of 4,101 words starts one word further off 16-byte
// alignment than the row before it.  So the copy is driven by the
// destination:
//
//   * a warp copies one item: 32 * kVecs consecutive 16-byte vectors of one
//     span of one row, kVecs a lane, 32 lanes side by side, so every load
//     and store instruction of the warp covers 512 contiguous bytes (kVecs
//     1, 2, 4 and 8 timed within 2% of each other on the H100, PERF.md §6;
//     2 is kept);
//   * a lane loads the 16-byte-aligned source block under its vector with
//     ld.global.nc.L1::no_allocate (the data is read once), and takes the
//     next block from its neighbour by one warp shuffle — lane 31 from lane
//     0's next vector, and once an item a load of its own — so a warp's
//     kVecs loads a lane are all issued before the first is used;
//   * the two blocks are realigned in registers by the span's word shift
//     (source minus destination, mod 4: the same for the whole warp) and
//     stored as one 16-byte vector; only a span's first and last vector,
//     where the span starts or ends inside it, are stored word by word.
//
// A block is loaded only if it holds a word of the span, so nothing past
// the row store's last 16-byte block is read (the last row's cover is
// clamped), nor before its first.  Items are numbered row by row, span by
// span (SpanParams::first: a span's first item in a row), and the grid
// walks them a warp an item.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSpanThreads = 256;  // threads a block
constexpr int kSpanWarps = kSpanThreads / 32;
// ranges one launch carries (_cuda.MAX_SPANS): a configuration port's 11
// columns fit one launch, and a small parameter block launches faster
constexpr int kMaxSpans = 16;
constexpr int kVecs = 2;  // 16-byte vectors a lane copies an item (_cuda.SPAN_VECS)

}  // namespace

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_SpanParams), which
// checks its size at load time.
struct SpanParams {
  const int32_t* words;  // (n, row_words) row store
  int32_t* out;          // (n, out_w) packed output, 16-byte aligned
  long long n;
  int32_t row_words;
  int32_t out_w;
  int32_t n_spans;
  int32_t chunks;        // items a row: the spans' items, summed
  int32_t src[kMaxSpans];    // first row word of each span
  int32_t dst[kMaxSpans];    // first packed word of each span
  int32_t width[kMaxSpans];  // words of each span
  int32_t first[kMaxSpans];  // its first item in a row (ascending, first[0] 0)
};

namespace {

// One 16-byte block of the row store at word address `a` (a multiple of 4),
// or zeros if the block holds no word of [s0, s1).
__device__ __forceinline__ int4 load_block(long long a, long long s0, long long s1) {
  int4 v = make_int4(0, 0, 0, 0);
  if (a + 4 > s0 && a < s1) {
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(static_cast<unsigned long long>(a) << 2));
  }
  return v;
}

// Words shift .. shift + 3 of the 8 words lo, hi.
__device__ __forceinline__ int4 realign(int4 lo, int4 hi, int shift) {
  switch (shift) {
    case 1: return make_int4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_int4(lo.z, lo.w, hi.x, hi.y);
    case 3: return make_int4(lo.w, hi.x, hi.y, hi.z);
    default: return lo;
  }
}

// `v` from the lane above (lane 31: from lane 0).
__device__ __forceinline__ int4 from_next_lane(int4 v, int lane) {
  const int src = (lane + 1) & 31;
  return make_int4(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src),
                   __shfl_sync(0xffffffffu, v.z, src), __shfl_sync(0xffffffffu, v.w, src));
}

// Output words [vd, vd + 4) of `out` that lie in [d0, d1): one 16-byte store
// when all four do, else word by word.
__device__ __forceinline__ void store_vec(int32_t* out, long long vd, int4 v, long long d0,
                                          long long d1) {
  if (vd >= d0 && vd + 4 <= d1) {
    __stcs(reinterpret_cast<int4*>(out + vd), v);
    return;
  }
  const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (vd + q >= d0 && vd + q < d1) out[vd + q] = w[q];
}

}  // namespace

__global__ void __launch_bounds__(kSpanThreads)
rm_project_spans_kernel(const __grid_constant__ SpanParams p) {
  const int lane = threadIdx.x & 31;
  const long long items = p.n * p.chunks;
  const long long warps = static_cast<long long>(gridDim.x) * kSpanWarps;
  // the row store's word address: blocks are aligned on the address, not on
  // the tensor's start, so a row store sliced at any word is read right
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(p.words) >> 2);
  for (long long item = static_cast<long long>(blockIdx.x) * kSpanWarps + (threadIdx.x >> 5);
       item < items; item += warps) {
    const long long row = item / p.chunks;
    const int c = static_cast<int>(item - row * p.chunks);
    int k = 0;  // the span of item c: the last whose first item is at most c
    for (int step = kMaxSpans / 2; step > 0; step >>= 1)
      if (k + step < p.n_spans && p.first[k + step] <= c) k += step;
    const long long d0 = row * p.out_w + p.dst[k], d1 = d0 + p.width[k];
    const long long s0 = base + row * p.row_words + p.src[k], s1 = s0 + p.width[k];
    const long long delta = s0 - d0;  // source word address of output word 0
    const int shift = static_cast<int>(delta & 3);
    // the output word of this lane's first vector; vector j lies 32 vectors on
    const long long vd0 =
        ((d0 >> 2) + static_cast<long long>(c - p.first[k]) * (32 * kVecs) + lane) << 2;
    const long long a0 = vd0 + delta - shift;  // its source block
    int4 lo[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) lo[j] = load_block(a0 + 128 * j, s0, s1);
    // the block after lane 31's last one (lane 0 of the next item's)
    int4 tail = make_int4(0, 0, 0, 0);
    if (lane == 31 && shift) tail = load_block(a0 + 128 * (kVecs - 1) + 4, s0, s1);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      int4 v = lo[j];
      if (shift) {  // the same for the whole warp
        // lane 0 hands lane 31 the block after its own: lane 0's next vector
        const int4 give = (lane == 0 && j + 1 < kVecs) ? lo[j + 1 < kVecs ? j + 1 : j] : lo[j];
        int4 hi = from_next_lane(give, lane);
        if (lane == 31 && j + 1 == kVecs) hi = tail;
        v = realign(lo[j], hi, shift);
      }
      store_vec(p.out, vd0 + 128 * j, v, d0, d1);
    }
  }
}

extern "C" {

int rm_span_params_size() { return static_cast<int>(sizeof(SpanParams)); }

// Launch `n_blocks` blocks on `stream` of card `device` (made current for
// the launch if it is not), do not synchronise, return the launch's
// cudaGetLastError() (0 on success).
int rm_project_spans(const SpanParams* params, int n_blocks, int device, void* stream) {
  if (n_blocks <= 0 || params->n_spans <= 0 || params->n_spans > kMaxSpans ||
      params->chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  rm_project_spans_kernel<<<n_blocks, kSpanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *params);
  e = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

}  // extern "C"
