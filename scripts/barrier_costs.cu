// The cost of the barriers ell_gs can put between its passes, on one GPU.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o barrier_costs scripts/barrier_costs.cu
//     ./barrier_costs
//
// Blocks of 512 threads (ell_gs's staged forms) loop over a barrier 200 and
// 2,000 times in one launch; the difference of the two launches' CUDA-event
// times over 1,800 is the cost of one barrier:
// - cluster.sync() (cooperative_groups: barrier.cluster.arrive, a release
//   at cluster scope, then wait) and the same barrier with a relaxed
//   arrive, in one cluster of 1-16 blocks with 180 KB of shared memory each;
// - a pass of one warp's dependent chain (shared memory loads, a width-8
//   butterfly, optionally an IEEE division and stores into every block's
//   shared memory) followed by cluster.sync();
// - cg::grid_group::sync() in a cooperative launch of 16-132 blocks of 512
//   and of 256 threads.
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(512, 1) cluster_sync(int passes) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int p = 0; p < passes; ++p) cluster.sync();
}

__global__ void __launch_bounds__(512, 1) cluster_sync_relaxed(int passes) {
    for (int p = 0; p < passes; ++p) {
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
}

__global__ void __launch_bounds__(512, 1)
cluster_chain(int passes, float* out, int remote, int divide) {
    extern __shared__ float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int nb = static_cast<int>(cluster.num_blocks());
    for (int i = threadIdx.x; i < 4096; i += blockDim.x)
        smem[i] = 1.0f + i * 1e-6f;
    cluster.sync();
    float v = smem[threadIdx.x];
    for (int p = 0; p < passes; ++p) {
        if (threadIdx.x < 32) {
            const float a = smem[static_cast<int>(v) & 1023];
            const float b = smem[static_cast<int>(a) & 2047];
            float s = b * a + v;
            s += __shfl_down_sync(0xffffffffu, s, 4, 8);
            s += __shfl_down_sync(0xffffffffu, s, 2, 8);
            s += __shfl_down_sync(0xffffffffu, s, 1, 8);
            if (divide) s = s / (s * s + 1e-12f);
            if (remote) {
                for (int q = threadIdx.x & 7; q < nb; q += 8)
                    *(cluster.map_shared_rank(smem, q) + 2048
                      + (threadIdx.x >> 3) + 8 * blockIdx.x) = s;
            } else {
                smem[2048 + threadIdx.x] = s;
            }
            v = s;
        }
        cluster.sync();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = v;
}

__global__ void __launch_bounds__(512, 1) grid_sync512(int passes) {
    cg::grid_group grid = cg::this_grid();
    for (int p = 0; p < passes; ++p) grid.sync();
}

__global__ void __launch_bounds__(256) grid_sync256(int passes) {
    cg::grid_group grid = cg::this_grid();
    for (int p = 0; p < passes; ++p) grid.sync();
}

// Mean ms of 5 launches after one to warm up (cluster of `blocks` blocks,
// or a cooperative launch of `blocks` blocks of `threads`).
float launch_ms(const void* fn, int blocks, int threads, bool cluster,
                void** args) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 180000;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    float ms = 0.f;
    for (int r = 0; r < 6; ++r) {
        if (r == 1) cudaEventRecord(e0);
        if (cluster)
            cudaLaunchKernelExC(&cfg, fn, args);
        else
            cudaLaunchCooperativeKernel(fn, blocks, threads, args, 0, 0);
    }
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) printf("error: %s\n", cudaGetErrorString(e));
    return ms / 5;
}

// us of one barrier (or pass) of fn: two launches of 200 and 2,000.
float per_pass_us(const void* fn, int blocks, int threads, bool cluster,
                  int remote = 0, int divide = 0, float* out = nullptr) {
    int few = 200, many = 2000;
    void* a[] = {&few, &out, &remote, &divide};
    void* b[] = {&many, &out, &remote, &divide};
    const float t0 = launch_ms(fn, blocks, threads, cluster, a);
    const float t1 = launch_ms(fn, blocks, threads, cluster, b);
    return (t1 - t0) * 1e3f / (many - few);
}

int main() {
    float* out;
    cudaMalloc(&out, 4096);
    const void* clustered[] = {reinterpret_cast<const void*>(cluster_sync),
                               reinterpret_cast<const void*>(
                                   cluster_sync_relaxed),
                               reinterpret_cast<const void*>(cluster_chain)};
    for (const void* f : clustered) {
        cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             180000);
        cudaFuncSetAttribute(
            f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    for (int nb : {1, 2, 4, 8, 12, 16}) {
        printf("cluster of %2d: cluster.sync %.3f us, relaxed arrive %.3f us;"
               " a chain pass (local / remote stores, without / with the "
               "division): %.3f %.3f %.3f %.3f us\n",
               nb, per_pass_us(clustered[0], nb, 512, true),
               per_pass_us(clustered[1], nb, 512, true),
               per_pass_us(clustered[2], nb, 512, true, 0, 0, out),
               per_pass_us(clustered[2], nb, 512, true, 0, 1, out),
               per_pass_us(clustered[2], nb, 512, true, 1, 0, out),
               per_pass_us(clustered[2], nb, 512, true, 1, 1, out));
    }
    for (int blocks : {16, 41, 66, 132})
        printf("grid of %3d blocks: grid.sync %.3f us (512 threads), %.3f us "
               "(256)\n", blocks,
               per_pass_us(reinterpret_cast<const void*>(grid_sync512),
                           blocks, 512, false),
               per_pass_us(reinterpret_cast<const void*>(grid_sync256),
                           blocks, 256, false));
    return 0;
}
