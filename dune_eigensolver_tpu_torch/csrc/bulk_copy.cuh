// Hopper's bulk copies (TMA without a tensor map) and the mbarriers that
// report them, as inline PTX for sm_90a. Shared by copy_probe.cu and
// gather_probe.cu.
//
// A bulk load (global -> shared) is issued by one thread and completes its
// bytes on an mbarrier: the issuing side arms the barrier with
// mbar_arrive_expect_tx(bytes) for the whole stage, then issues one or more
// loads whose sizes add up to those bytes; a waiter on the barrier's phase
// parity sees the data once every byte has landed. A bulk store (shared ->
// global) joins the issuing thread's bulk group; bulk_commit closes the
// group and bulk_wait_read<N> waits until at most N groups still read
// shared memory, after which their stages may be refilled.
//
// Rules the callers keep: addresses on 16 bytes and sizes multiples of 16;
// under 2^20 bytes of transaction per barrier phase; a thread that wrote a
// stage with ordinary stores runs fence_proxy_async before a bulk store
// reads it. No tensor map is used, so the build links no libcuda.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one barrier of `count` arrivals a phase; then make it visible to the
// async proxy, which completes the bulk loads' bytes on it
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one arrival that also adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// global -> shared, `bytes` counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst_smem)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the issuing thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src_smem)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N of this thread's committed groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// at most N of this thread's committed groups are still in flight at all
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ordinary stores to shared memory made visible to later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
