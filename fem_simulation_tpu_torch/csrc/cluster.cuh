// Hopper helpers shared by ell_kernels.cu (ell_gs) and lattice_kernels.cu
// (the multigrid level kernels): asynchronous copies from device to shared
// memory (cp.async), and for thread-block clusters addresses in another
// block's shared memory, 16-byte st.async stores that complete bytes on
// that block's mbarrier, and the mbarrier's init, arrive and wait (sm_90).
#pragma once

#include <cuda_runtime.h>

namespace {

// 4 bytes from device memory into shared memory, asynchronously (cached in
// L1: for data no block writes during the launch).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

// 16 bytes (16-byte aligned) the same way, through L2 only: for data other
// blocks wrote before a grid barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shared::cta address of a shared memory pointer, and its
// shared::cluster address in the block of cluster rank `rank`.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(out)
                 : "r"(addr), "r"(rank));
    return out;
}

// 16 bytes stored into another block's shared memory (raddr, 16-byte
// aligned), completing 16 bytes of the transaction count of that block's
// mbarrier rbar.
__device__ __forceinline__ void st_async4(unsigned raddr, float a, float b,
                                          float c, unsigned rbar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(raddr),
        "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
        "r"(__float_as_uint(c)), "r"(0u), "r"(rbar)
        : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

// This block's arrival on its mbarrier, expecting `bytes` more of
// transactions (st_async4 from the other blocks) before the phase ends.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile(
        "{\n.reg .b64 state;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
            "r"(bar),
        "r"(bytes)
        : "memory");
}

// Wait for the phase of the given parity of a local mbarrier to complete.
// A wait that outlasts 2^26 tries (seconds) traps: the launch then fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    for (unsigned tries = 0;; ++tries) {
        unsigned done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (tries == (1u << 26)) __trap();
    }
}

}  // namespace
