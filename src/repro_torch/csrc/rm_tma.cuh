// Shared pieces of the TMA-fed kernels (rm_flash.cu, rm_w8.cu, rm_rglru.cu):
// mbarrier helpers, the tensor-map encoder and the context it needs.
//
// A TMA copy lands in shared memory and completes a transaction count on an
// mbarrier; a consumer waits on the barrier's phase.  mbar_wait traps (a
// launch error) after kWaitLimitNs rather than hang the card on a lost
// barrier.  The encoder, cuTensorMapEncodeTiled, is fetched from the driver
// at run time, so the library needs no -lcuda at link time.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

namespace rm_tma {

constexpr uint64_t kWaitLimitNs = 10000000000ull;  // 10 s: a lost barrier traps

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.  A wait
// that outlasts kWaitLimitNs traps (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (unsigned spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > kWaitLimitNs) __trap();
    }
  }
}

// Make this host thread's device context current before a driver call (the
// tensor-map encoder) needs one.  A thread whose CUDA work so far went through
// another runtime without touching the device (PyTorch's autograd worker,
// handed tensors from its caching allocator) may have none, and the encoder
// then fails.  cudaSetDevice only binds the primary context: no stream work,
// so a graph capture may call it.  encode_tiled() calls it, so every launcher
// that encodes a map binds the context first.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// cuTensorMapEncodeTiled, fetched from the driver at run time; null where the
// driver lacks it or this thread's context cannot be bound
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  if (bind_context() != cudaSuccess) return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

}  // namespace rm_tma
