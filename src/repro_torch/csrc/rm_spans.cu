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
// a batch of span copies, each copied a warp an item by the destination-
// driven copy of rm_copy.cuh (16-byte loads and stores, the source
// realigned in registers).  Items are numbered row by row, span by span
// (SpanParams::first: a span's first item in a row), and the grid walks
// them a warp an item.
#include <cstdint>
#include <cuda_runtime.h>

#include "rm_copy.cuh"

namespace {

constexpr int kSpanThreads = 256;  // threads a block
constexpr int kSpanWarps = kSpanThreads / 32;
// ranges one launch carries (_cuda.MAX_SPANS): a configuration port's 11
// columns fit one launch, and a small parameter block launches faster
constexpr int kMaxSpans = 16;

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
    rm_copy::Span sp;
    sp.d0 = row * p.out_w + p.dst[k];
    sp.d1 = sp.d0 + p.width[k];
    sp.s0 = base + row * p.row_words + p.src[k];
    sp.s1 = sp.s0 + p.width[k];
    rm_copy::store_item(p.out, sp, rm_copy::load_item(sp, c - p.first[k], lane), lane);
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
