// Trace-only kernel over the 8-wide tree for Hopper (sm_90a): the
// short-stack walk of walk.cuh — closest hit or any hit — for each
// active ray, writing t, the triangle id, the interpolated object-space
// normal and the bad flag; optionally its node pops, leaf visits and
// triangle tests.
//
// Replaces the TPU kernel wide_kernel
// (shader_ray_tpu/ops/pallas/kernel_wide.py, pallas_call in
// packet_wide.packet_trace_wide).  Contract (packet.PacketHit):
// inactive rays return t = INFINITELY_FAR, which = -1; rays that exceed
// the stack or the step budget t = -1, which = -1, bad; an any-hit walk
// that finds a hit t = 0.
//
// What bounds it here: the walk's dependent loads in diverging warps
// (walk.cuh), not arithmetic or bytes; per ray it moves 25 bytes in and
// 21 out.  The design: one thread a ray with its stack in local memory;
// given an image's width, a block walks an 8x16 tile of its pixels (a
// warp 8x4) instead of 128 pixels of a row, so a warp's rays and an SM's
// blocks share nodes and leaf records in L1.  On the bench frame (H100
// 80GB HBM3 at 700 W, PERF.md): 0.22 ms closest and 0.19 ms any-hit on
// the 786,432 primaries, 0.83 ms for a frame's six launches, against
// 0.30 / 0.24 / 1.14 ms for the parent's per-row design; 10x above the
// operation bound.  Compacting a block's active rays, the whole stack in
// shared memory (it takes L1's room), loading a node in storage order and
// prefetching the next node were each slower or no faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Entry points: srt_trace_wide,
//        srt_trace_wide_info (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using namespace srt;

constexpr int BLOCK = TRACE_BLOCK;

__device__ __forceinline__ void store(long long r, const Walk& w, float* __restrict__ t_out,
                                      int* __restrict__ which_out, float* __restrict__ n_out,
                                      uint8_t* __restrict__ bad_out, int* __restrict__ stats_out) {
    t_out[r] = w.bad ? -1.0f : w.t;
    which_out[r] = w.bad ? -1 : w.which;
    n_out[3 * r] = w.nx;
    n_out[3 * r + 1] = w.ny;
    n_out[3 * r + 2] = w.nz;
    bad_out[r] = w.bad ? 1 : 0;
    if (stats_out != nullptr) {
        stats_out[3 * r] = (int)w.steps;
        stats_out[3 * r + 1] = (int)w.leafs;
        stats_out[3 * r + 2] = (int)w.tris;
    }
}

__global__ void __launch_bounds__(BLOCK)
trace_wide(Scene s, const float* __restrict__ P, const float* __restrict__ D,
           const uint8_t* __restrict__ active, long long n, int width, bool any_hit,
           float* __restrict__ t_out, int* __restrict__ which_out,
           float* __restrict__ n_out, uint8_t* __restrict__ bad_out,
           int* __restrict__ stats_out) {
    const long long r = ray_of(n, width, threadIdx.x);
    if (r < 0) return;
    if (!active[r]) {
        store(r, no_walk(), t_out, which_out, n_out, bad_out, stats_out);
        return;
    }
    LocalStack stack;
    const float Px = __ldg(P + 3 * r), Py = __ldg(P + 3 * r + 1), Pz = __ldg(P + 3 * r + 2);
    const float Dx = __ldg(D + 3 * r), Dy = __ldg(D + 3 * r + 1), Dz = __ldg(D + 3 * r + 2);
    const Walk w = any_hit ? walk<true, true>(s, Px, Py, Pz, Dx, Dy, Dz, stack)
                           : walk<true, false>(s, Px, Py, Pz, Dx, Dy, Dz, stack);
    store(r, w, t_out, which_out, n_out, bad_out, stats_out);
}

}  // namespace

extern "C" int srt_trace_wide(
    const float* nodes, const float* leaves, const float* normals,
    const float* P, const float* D, const uint8_t* active, long long n, int width,
    int any_hit, float mt_eps, int max_steps, int stack_depth,
    float* t_out, int* which_out, float* n_out, uint8_t* bad_out,
    int* stats_out, void* stream) {
    if (n < 1 || stack_depth < 1 || stack_depth > MAX_STACK || max_steps < 1 || width < 0 ||
        (width > 0 && n % width))
        return (int)cudaErrorInvalidValue;
    Scene s{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(leaves),
            reinterpret_cast<const float4*>(normals), stack_depth, max_steps, mt_eps};
    trace_wide<<<ray_blocks(n, width), BLOCK, 0, (cudaStream_t)stream>>>(
        s, P, D, active, n, width, any_hit != 0, t_out, which_out, n_out, bad_out, stats_out);
    return (int)cudaGetLastError();
}

// The launch's resources, into info[0..6): registers a thread, static
// shared bytes, local bytes a thread (the stack), dynamic shared bytes
// (none), resident blocks an SM, threads a block.
extern "C" int srt_trace_wide_info(int stack_depth, int* info) {
    if (stack_depth < 1 || stack_depth > MAX_STACK) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, trace_wide);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_wide, BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = 0;
    info[4] = per_sm;
    info[5] = BLOCK;
    return 0;
}
