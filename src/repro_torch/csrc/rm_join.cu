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
// reference's int32 sum does, without signed overflow; integer addition
// does not depend on order, so the sum is bit-equal however it is split.
//
// What bounds it.  The least time is bytes: the 32-byte sectors holding the
// probe words, the bucket arrays once (18 MiB for a 1M-row build side: they
// stay in the 50 MB L2) and 9 output bytes a row.  What bounds it on the
// card is latency: a row's bucket and its matches are random reads from L2,
// and on the row store its key, payload and timestamp words are scattered
// reads from DRAM, so the time follows how many of those reads are in
// flight.  The first version (one thread a row, C dependent 4-byte slot
// loads) was held back before that by load requests: the 32 lanes of a warp
// hash to 32 buckets, so every slot load touched about 32 lines.
//
// Design.  rm_join_prepare_kernel first repacks the buckets into scratch
// memory, so a row reads one sector for its bucket and one per candidate:
//   * fps: an 8-bit fingerprint of every slot key — the top 8 bits of
//     key * MIX below the bucket bits — 32 bytes a bucket per 32 slots;
//   * recs: a 16-byte (key, payload, begin, end) record a slot.
// Then a warp probes 32 rows (a task):
//   1. Lane j holds row j's key, payload and timestamp words and publishes
//      the row's bucket, fingerprint and key in shared memory.
//   2. Eight lanes read one row's fingerprints, four slots a lane in one
//      4-byte load, so one load instruction covers four rows and the eight
//      that cover all 32 rows are in flight before any is compared (a pass
//      per 32 slots while C > 32).  Each lane then holds a bit for each of
//      its 32 (row, slot) pairs whose fingerprint is the row's.
//   3. The candidate pairs go on the warp's list, placed by a prefix sum of
//      the lanes' counts; then each lane takes one pair, reads the slot's
//      record in one load and, if the key is the row's and the slot is
//      visible, adds the payload into the row's uint32 sum in shared memory
//      and sets the row's flag.  More pairs than the list holds take more
//      rounds.  A fingerprint only selects: the record's key decides, so
//      a fingerprint collision costs a record read and nothing else.
//   4. Lane j writes row j's three outputs: coalesced stores.
// Two forms, chosen by the row width (JoinParams::stream):
//   * rows wider than a 32-byte sector (the row store): each row's words
//     are scattered DRAM reads, so a persistent grid fetches every lane's
//     row words two tasks ahead (kDepth 2) and the probe of a task hides
//     the fetch of the next ones;
//   * narrower rows (a packed block): the rows stream in few lines, and a
//     grid of one task a warp with more warps an SM (no prefetch registers)
//     hides the L2 reads better.
// Bounds: a bucket index is h >> shift < 2^(32 - shift) = P; a fingerprint
// load reads bytes [g * fp_stride + c0 + 4q, + 4) with c0 + 4q + 3 < c0 + 32
// <= fp_stride; a record is read only for a slot c < C; rows and outputs
// only for i < n; the list is written below kList and read below `listed`
// <= kList.
// On the TPU the kernel selected a bucket by a one-hot matrix product over
// 16-bit halves (no dynamic indexing there); on the card a gather is native.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJoinThreads = 256;
constexpr int kWarps = kJoinThreads / 32;
constexpr int kList = 64;  // candidates a warp lists before it settles them
// blocks an SM: the dense form at 40 registers a thread, the streaming form
// (two tasks' row words in registers) at 48
constexpr int kDenseBlocksPerSm = 6;
constexpr int kStreamBlocksPerSm = 5;
constexpr uint32_t kMix = 2654435761u;  // floor(2^32 / golden ratio)
constexpr unsigned kFull = 0xffffffffu;

// One warp's shared state for a task of 32 probe rows.
struct __align__(16) WarpStage {
  int2 probe[32];       // (bucket, fingerprint) of row j
  int2 list[kList];     // (row, slot) of candidate slots
  int32_t key[32];      // key of row j
  uint32_t sum[32];     // visible matching payloads of row j, wrapping
  int32_t hit[32];      // row j has a visible matching slot
};

__device__ __forceinline__ uint32_t mixed(int32_t key) {
  return static_cast<uint32_t>(key) * kMix;
}

// The 8 bits of the mixed key just below its bucket bits.
__device__ __forceinline__ uint32_t fingerprint(uint32_t h, int shift) {
  return (h << (32 - shift)) >> 24;
}

// A probe row's words, as one lane holds them.
struct RowWords {
  int32_t key, val, tb, te;
};

}  // namespace

// Mirrored by ctypes in repro_torch/kernels/_cuda.py (_JoinParams), which
// checks sizeof at load time.
struct JoinParams {
  const int32_t* words;  // (n, row_words) probe rows
  const int32_t* keys;   // (P, C) bucket arrays, row-major
  const int32_t* vals;
  const int32_t* begin;
  const int32_t* end;
  uint8_t* fps;          // (P, fp_stride) fingerprints (scratch)
  int4* recs;            // (P, C) (key, payload, begin, end) records (scratch)
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
  int32_t fp_stride;     // fingerprint bytes a bucket: 32 per 32 slots
  int32_t stream;        // rows wider than a sector: the prefetching form
};

// A warp per (bucket, 32-slot pass): lane c repacks slot c (fingerprint 0
// past C, where the probe's slot mask drops it).
__global__ void __launch_bounds__(kJoinThreads)
rm_join_prepare_kernel(const __grid_constant__ JoinParams p, long long n_buckets) {
  const int lane = threadIdx.x & 31;
  const int passes = p.fp_stride >> 5;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       w < n_buckets * passes; w += n_warps) {
    const long long g = w / passes;
    const int c = static_cast<int>(w - g * passes) * 32 + lane;
    uint32_t fp = 0;
    if (c < p.cap) {
      const long long at = g * p.cap + c;
      const int32_t k = __ldg(p.keys + at);
      p.recs[at] = make_int4(k, __ldg(p.vals + at), __ldg(p.begin + at), __ldg(p.end + at));
      fp = fingerprint(mixed(k), p.shift);
    }
    p.fps[g * p.fp_stride + c] = static_cast<uint8_t>(fp);
  }
}

// Candidate slot c of row j: add its payload to the row if its key is the
// row's and it is visible.
__device__ __forceinline__ void settle(WarpStage& ws, const JoinParams& p, int j, int c) {
  const int4 r = __ldg(p.recs + static_cast<long long>(ws.probe[j].x) * p.cap + c);
  const bool seen = !p.build_ts || (r.z <= p.ts && p.ts < r.w);
  if (r.x == ws.key[j] && seen) {
    atomicAdd(&ws.sum[j], static_cast<uint32_t>(r.y));
    ws.hit[j] = 1;
  }
}

// Task tt's row words for this lane (left as they were past the end: such
// rows are never published as live).  64-bit offsets: 33.5M rows of 18
// words pass 2^31 bytes.
__device__ __forceinline__ void fetch(RowWords& r, const JoinParams& p, long long tt,
                                      long long n_tasks, int lane) {
  const long long i = (tt << 5) + lane;
  if (tt < n_tasks && i < p.n) {
    const int32_t* row = p.words + i * static_cast<long long>(p.row_words);
    r.key = __ldcs(row + p.key_word);
    r.val = __ldcs(row + p.val_word);
    if (p.ts_word >= 0) {
      r.tb = __ldcs(row + p.ts_word);
      r.te = __ldcs(row + p.ts_word + 1);
    }
  }
}

// Steps 1-4 of the design note for task t, whose row words this lane holds.
__device__ __forceinline__ void probe_task(WarpStage& ws, const JoinParams& p, long long t,
                                           const RowWords& rw, int lane) {
  const int sub = lane >> 3, q = lane & 7;  // rows sub, sub + 4, ...; slots 4q..4q+3
  const long long i = (t << 5) + lane;
  const int rows = static_cast<int>(min(32LL, p.n - (t << 5)));
  const bool valid = p.ts_word < 0 || (rw.tb <= p.ts && p.ts < rw.te);

  // 1. publish this lane's row
  const uint32_t h = mixed(rw.key);
  ws.probe[lane] = make_int2(static_cast<int32_t>(h >> p.shift),
                             static_cast<int32_t>(fingerprint(h, p.shift)));
  ws.key[lane] = rw.key;
  ws.sum[lane] = 0u;
  ws.hit[lane] = 0;
  __syncwarp();

  for (int c0 = 0; c0 < p.cap; c0 += 32) {
    // 2. the fingerprints of rows 4u + sub at slots cq..cq+3, all 8 loads
    // in flight; then bit 4u + k for a match at slot cq + k
    const int cq = c0 + 4 * q;
    const uint32_t slots = (1u << min(max(p.cap - cq, 0), 4)) - 1u;
    uint32_t fp4[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long g = ws.probe[4 * u + sub].x;
      fp4[u] = __ldg(reinterpret_cast<const uint32_t*>(p.fps + g * p.fp_stride + cq));
    }
    uint32_t bits = 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = 4 * u + sub;
      const uint32_t e = __vcmpeq4(fp4[u], static_cast<uint32_t>(ws.probe[j].y) * 0x01010101u);
      const uint32_t m = (e & 1u) | ((e >> 7) & 2u) | ((e >> 14) & 4u) | ((e >> 21) & 8u);
      bits |= (j < rows ? m & slots : 0u) << (4 * u);
    }
    if (!__any_sync(kFull, bits != 0u)) continue;

    // 3. list the candidates: each lane's count, prefix-summed across the
    // warp, places its (row, slot) pairs; then a lane a listed pair.  A
    // pass that finds more than kList pairs takes several rounds.
    do {
      const int cnt = __popc(bits);
      int off = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, off, o);
        if (lane >= o) off += x;
      }
      const int listed = min(__shfl_sync(kFull, off, 31), kList);
      for (off -= cnt; bits != 0u && off < kList; bits &= bits - 1u, ++off) {
        const int b = __ffs(bits) - 1;
        ws.list[off] = make_int2(4 * (b >> 2) + sub, cq + (b & 3));
      }
      __syncwarp();
      for (int e = lane; e < listed; e += 32) settle(ws, p, ws.list[e].x, ws.list[e].y);
      __syncwarp();
    } while (__any_sync(kFull, bits != 0u));
  }

  // 4. row lane's outputs
  if (lane < rows) {
    const bool matched = ws.hit[lane] && valid;
    p.s_out[i] = valid ? rw.val : 0;
    p.r_out[i] = matched ? static_cast<int32_t>(ws.sum[lane]) : 0;
    p.m_out[i] = matched ? 1 : 0;
  }
  __syncwarp();  // the stage is read before the next task overwrites it
}

// kDepth 0: a task a warp, its row words read when it starts (the dense
// form).  kDepth 2: a persistent grid; each lane holds the row words of the
// next two tasks while it probes one (the streaming form).
template <int kDepth, int kMinBlocks>
__global__ void __launch_bounds__(kJoinThreads, kMinBlocks)
rm_hash_join_kernel(const __grid_constant__ JoinParams p) {
  __shared__ WarpStage stages[kWarps];
  const int lane = threadIdx.x & 31;
  WarpStage& ws = stages[threadIdx.x >> 5];
  const long long n_tasks = (p.n + 31) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  RowWords a{0, 0, 0, 1}, b{0, 0, 0, 1};
  if (kDepth == 0) {
    for (; t < n_tasks; t += step) {
      fetch(a, p, t, n_tasks, lane);
      probe_task(ws, p, t, a, lane);
    }
  } else {
    // a holds task t's words and b task t + step's; each is refilled two
    // tasks ahead as soon as it is read, so no register is copied while its
    // load is in flight
    fetch(a, p, t, n_tasks, lane);
    fetch(b, p, t + step, n_tasks, lane);
    for (; t < n_tasks; t += 2 * step) {
      RowWords cur = a;
      fetch(a, p, t + 2 * step, n_tasks, lane);
      probe_task(ws, p, t, cur, lane);
      if (t + step >= n_tasks) break;
      cur = b;
      fetch(b, p, t + 3 * step, n_tasks, lane);
      probe_task(ws, p, t + step, cur, lane);
    }
  }
}

using JoinKernel = void (*)(JoinParams);
const JoinKernel kDenseKernel = rm_hash_join_kernel<0, kDenseBlocksPerSm>;
const JoinKernel kStreamKernel = rm_hash_join_kernel<2, kStreamBlocksPerSm>;

extern "C" {

int rm_join_params_size() { return static_cast<int>(sizeof(JoinParams)); }

// Blocks of the streaming form that fit on the current device at once: its
// persistent grid.
int rm_join_stream_blocks(int* blocks) {
  *blocks = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kStreamKernel, kJoinThreads, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(e);
}

// Repack the buckets, then launch the probe in the form params->stream
// names on `n_blocks` blocks, both on `stream` without synchronising;
// returns the first failing launch's cudaGetLastError() (0 on success).
int rm_hash_join(const JoinParams* params, long long n_buckets, int n_blocks, void* stream) {
  if (n_blocks <= 0 || n_buckets <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long prep_warps = n_buckets * (params->fp_stride >> 5);
  const int prep_blocks = static_cast<int>(min((prep_warps + kWarps - 1) / kWarps, 1LL << 20));
  rm_join_prepare_kernel<<<prep_blocks, kJoinThreads, 0, st>>>(*params, n_buckets);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const JoinKernel kernel = params->stream ? kStreamKernel : kDenseKernel;
  kernel<<<n_blocks, kJoinThreads, 0, st>>>(*params);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
