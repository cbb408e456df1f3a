// Hash-join probe for Hopper (sm_90a).
//
//   rm_hash_join_kernel   <- repro/kernels/rme_join.py  _probe_kernel
//
// For every probe row (a row of the row store, or of a packed block the
// shared scan produced): hash the row's key word to its bucket with the
// Fibonacci hash on the key's unsigned 32-bit pattern, compare the key with
// each of the bucket's C slots (and, under build_ts, test the slot's MVCC
// timestamps against the snapshot), and write
//
//   s_out[i] = valid ? row[val_word] : 0
//   r_out[i] = matched ? sum of the matching slots' payloads : 0   (wraps)
//   m_out[i] = matched = any slot matches && valid
//
// where valid is the row's own MVCC test when ts_word >= 0.  The payload sum
// is taken in uint32_t, so a duplicate-key build wraps exactly as the
// reference's int32 sum does, without signed overflow.
//
// What bounds it: bytes.  Each row reads two or three 4-byte words (key,
// payload, and the two timestamp words) and writes 9 bytes; the bucket
// arrays are read at random but are small (18 MiB for a 1M-row build side)
// and stay in the 50 MB L2 after the first touch.  The least time is the
// 32-byte sectors holding the probe words, the bucket arrays once, and the
// outputs, over the memory rate.
//
// Design: one thread per probe row in a grid-stride loop, slots scanned in
// global memory through the read-only path.  On the TPU the kernel selected
// a bucket by a one-hot matrix product over 16-bit halves (no dynamic
// indexing there); on the card a gather is native, so the slot loop reads
// the bucket directly.  Only 4-byte loads: a row slice of a chunk may start
// at any 8-byte boundary, so nothing assumes 16-byte alignment.  Staging
// buckets in shared memory and warp-cooperative slot compares are later
// work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJoinThreads = 256;
constexpr uint32_t kMix = 2654435761u;  // floor(2^32 / golden ratio)

}  // namespace

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_JoinParams), which
// checks sizeof at load time.
struct JoinParams {
  const int32_t* words;  // (n, row_words) probe rows
  const int32_t* keys;   // (P, C) bucket arrays, row-major
  const int32_t* vals;
  const int32_t* begin;
  const int32_t* end;
  int32_t* s_out;        // (n,)
  int32_t* r_out;        // (n,)
  uint8_t* m_out;        // (n,) bool
  long long n;
  int32_t row_words;
  int32_t key_word;
  int32_t val_word;
  int32_t ts_word;       // < 0: no probe-side MVCC test
  int32_t ts;            // snapshot time
  int32_t build_ts;      // test the build rows' timestamps too
  int32_t shift;         // 32 - log2(P), in [1, 31]
  int32_t cap;           // C, slots per bucket
};

__global__ void __launch_bounds__(kJoinThreads)
rm_hash_join_kernel(const __grid_constant__ JoinParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    // 64-bit row offset: 33.5M rows of 18 words pass 2^31 words' bytes
    const int32_t* row = p.words + i * static_cast<long long>(p.row_words);
    const int32_t key = __ldcs(row + p.key_word);
    bool valid = true;
    if (p.ts_word >= 0) {
      valid = __ldcs(row + p.ts_word) <= p.ts && p.ts < __ldcs(row + p.ts_word + 1);
    }
    const uint32_t g = (static_cast<uint32_t>(key) * kMix) >> p.shift;
    const long long base = static_cast<long long>(g) * p.cap;
    const int32_t* bk = p.keys + base;
    const int32_t* bv = p.vals + base;
    bool any = false;
    uint32_t r = 0;
    for (int c = 0; c < p.cap; ++c) {
      if (__ldg(bk + c) != key) continue;
      if (p.build_ts) {
        const int32_t b = __ldg(p.begin + base + c);
        const int32_t e = __ldg(p.end + base + c);
        if (!(b <= p.ts && p.ts < e)) continue;
      }
      any = true;
      r += static_cast<uint32_t>(__ldg(bv + c));
    }
    const bool matched = any && valid;
    p.s_out[i] = valid ? __ldcs(row + p.val_word) : 0;
    p.r_out[i] = matched ? static_cast<int32_t>(r) : 0;
    p.m_out[i] = matched ? 1 : 0;
  }
}

extern "C" {

int rm_join_params_size() { return static_cast<int>(sizeof(JoinParams)); }

// Launch the probe on `stream` without synchronising; returns the launch's
// cudaGetLastError() (0 on success).
int rm_hash_join(const JoinParams* params, int n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rm_hash_join_kernel<<<n_blocks, kJoinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *params);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
