// Bulk copies from device memory into shared memory that complete on an
// mbarrier: Hopper's TMA in its plain (non-tensor) form. K2 and K3 stage
// each camera step's table slice and each frame's inputs with them, one
// copy ahead of the step that reads it.
//
// Rules of the hardware that the callers keep: both addresses 16-byte
// aligned, the byte count a multiple of 16 (and below 2^20 per phase); one
// thread issues the copy and arms the barrier with the byte count; every
// thread that reads the buffer first waits for the barrier's phase. A
// buffer is refilled only after a block barrier that follows its last
// read.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ses3d {

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initializes the barrier for one arrival (the issuing
// thread's); a block barrier must follow before any thread waits on it.
__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` from device memory at `src` to shared memory at `dst`; the
// barrier's current phase completes when the bytes have landed. Called by
// one thread. The proxy fence orders the block's earlier reads of `dst`
// (made visible by the block barrier before this call) before the copy's
// writes.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Polls of a barrier before the kernel gives up: a copy that never lands
// (a fault of the caller's layout) ends the launch with an error, seconds
// in, instead of spinning forever.
constexpr uint32_t kMaxPolls = 1u << 26;

// Wait until the barrier's phase of parity `parity` (0 for its first use,
// then alternating) has completed.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

}  // namespace ses3d
