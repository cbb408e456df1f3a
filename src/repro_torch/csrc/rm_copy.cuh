// The destination-driven word-range copy of the wide-row projections: the
// span kernel (rm_spans.cu, MLP's wide form), BSL's wide form and PCK's
// wide form (rm_project.cu), the last into its packer in shared memory.
//
// A span is output words [d0, d1) of a packed row, copied from row-store
// word addresses [s0, s1) (s1 - s0 = d1 - d0); its source and destination
// are misaligned differently (a row of 4,101 words starts one word further
// off 16-byte alignment than the row before it), so the copy is driven by
// the destination:
//
//   * a warp copies one item: 32 * kVecs consecutive 16-byte output vectors
//     of one span, kVecs a lane, 32 lanes side by side, so every load and
//     store instruction of the warp covers 512 contiguous bytes;
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
// the row store's last 16-byte block is read, nor before its first.  The
// loads of an item (load_item) and its stores (store_item) are apart, so a
// warp can have several items' loads in flight.  The output must start
// 16-byte aligned.  Its stores go to device memory (streaming) or, with
// kShared, to a packer in shared memory (PCK's wide form).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rm_copy {

// 16-byte vectors a lane copies an item (_cuda.SPAN_VECS; 1, 2, 4 and 8
// timed within 2% of each other in the span kernel on the H100, PERF.md §6)
constexpr int kVecs = 2;
constexpr int kItemVecs = 32 * kVecs;  // output vectors an item

struct Span {
  long long d0, d1;  // output words
  long long s0, s1;  // row-store word addresses
};

// One item's source blocks in registers: a lane's kVecs blocks and, for
// lane 31, the block after its last one.
struct Item {
  int4 lo[kVecs];
  int4 tail;
  long long vd0;  // the output word of the lane's first vector
};

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
template <bool kShared = false>
__device__ __forceinline__ void store_vec(int32_t* out, long long vd, int4 v, long long d0,
                                          long long d1) {
  if (vd >= d0 && vd + 4 <= d1) {
    if constexpr (kShared) {
      *reinterpret_cast<int4*>(out + vd) = v;
    } else {
      __stcs(reinterpret_cast<int4*>(out + vd), v);
    }
    return;
  }
  const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (vd + q >= d0 && vd + q < d1) out[vd + q] = w[q];
}

// The items of a span: kItemVecs of the output vectors it touches each.
__device__ __forceinline__ int items(const Span& sp) {
  return static_cast<int>((((sp.d1 - 1) >> 2) - (sp.d0 >> 2)) / kItemVecs) + 1;
}

// Load item `c` of `sp` (the whole warp, the same item).
__device__ __forceinline__ Item load_item(const Span& sp, long long c, int lane) {
  const long long delta = sp.s0 - sp.d0;  // source word address of output word 0
  const int shift = static_cast<int>(delta & 3);
  Item it;
  // vector j of a lane lies 32 vectors after its vector j - 1
  it.vd0 = ((sp.d0 >> 2) + c * kItemVecs + lane) << 2;
  const long long a0 = it.vd0 + delta - shift;  // its source block
#pragma unroll
  for (int j = 0; j < kVecs; ++j) it.lo[j] = load_block(a0 + 128 * j, sp.s0, sp.s1);
  // the block after lane 31's last one (lane 0 of the next item's)
  it.tail = make_int4(0, 0, 0, 0);
  if (lane == 31 && shift) it.tail = load_block(a0 + 128 * (kVecs - 1) + 4, sp.s0, sp.s1);
  return it;
}

// Realign and store an item that load_item(sp, ..) brought in (kShared:
// `out` is shared memory).
template <bool kShared = false>
__device__ __forceinline__ void store_item(int32_t* out, const Span& sp, const Item& it,
                                           int lane) {
  const int shift = static_cast<int>((sp.s0 - sp.d0) & 3);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int4 v = it.lo[j];
    if (shift) {  // the same for the whole warp
      // lane 0 hands lane 31 the block after its own: lane 0's next vector
      const int4 give = (lane == 0 && j + 1 < kVecs) ? it.lo[j + 1 < kVecs ? j + 1 : j] : it.lo[j];
      int4 hi = from_next_lane(give, lane);
      if (lane == 31 && j + 1 == kVecs) hi = it.tail;
      v = realign(it.lo[j], hi, shift);
    }
    store_vec<kShared>(out, it.vd0 + 128 * j, v, sp.d0, sp.d1);
  }
}

}  // namespace rm_copy
