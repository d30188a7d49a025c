// sm90.cuh — the Hopper pieces the kernels share: mbarriers and 1-D TMA
// bulk copies (cp.async.bulk, no tensor map), with a watchdog on waits.
#pragma once

#include <cstdint>

namespace sm90 {

// no wait in these kernels takes this long unless a pipeline is stuck
constexpr unsigned long long kHangNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

// makes mbarrier.init visible to the other threads and the async proxy
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return ok != 0u;
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// A wait that outlasts kHangNs is a deadlock: trap, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void hang_check(unsigned long long t0) {
    if (now_ns() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    if (mbar_try_wait(bar, parity)) return;
    const unsigned long long t0 = now_ns();
    while (!mbar_try_wait(bar, parity)) hang_check(t0);
}

// 1-D TMA: bytes (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on bar's transaction count.
__device__ __forceinline__ void tma_load_1d(void* dst, const void* src,
                                            unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

}  // namespace sm90
