// Trace-only kernel over the 8-wide tree for Hopper (sm_90a): one thread
// per ray runs the short-stack walk of walk.cuh — closest hit or any
// hit — and writes t, the triangle id, the interpolated object-space
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
// What bounds it here: operations and latency of dependent loads, as
// for the frame kernel; per ray it moves 25 bytes in and 21 out, which
// at the bench frame is ~36 MB a launch, small beside the walk.  The
// design is the frame kernel's: one thread, one ray, a short stack in
// local memory, nodes and records through the read-only cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Entry point: srt_trace_wide (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using namespace srt;

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
trace_wide(Scene s, const float* __restrict__ P, const float* __restrict__ D,
           const uint8_t* __restrict__ active, long long n, bool any_hit,
           float* __restrict__ t_out, int* __restrict__ which_out,
           float* __restrict__ n_out, uint8_t* __restrict__ bad_out,
           int* __restrict__ stats_out) {
    const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (r >= n) return;
    int stack[MAX_STACK];
    Walk w;
    w.t = INFINITELY_FAR;
    w.nx = w.ny = w.nz = 0.0f;
    w.which = -1;
    w.bad = false;
    w.steps = w.leafs = w.tris = 0;
    if (active[r]) {
        w = walk<true>(s, __ldg(P + 3 * r), __ldg(P + 3 * r + 1), __ldg(P + 3 * r + 2),
                       __ldg(D + 3 * r), __ldg(D + 3 * r + 1), __ldg(D + 3 * r + 2),
                       any_hit, stack);
    }
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

}  // namespace

extern "C" int srt_trace_wide(
    const float* boxes, const int* meta, const float* leaves,
    const float* P, const float* D, const uint8_t* active, long long n,
    int any_hit, float mt_eps, int max_steps, int stack_depth,
    float* t_out, int* which_out, float* n_out, uint8_t* bad_out,
    int* stats_out, void* stream) {
    if (n < 1 || stack_depth < 1 || stack_depth > MAX_STACK || max_steps < 1)
        return (int)cudaErrorInvalidValue;
    Scene s{boxes, meta, leaves, stack_depth, max_steps, mt_eps};
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    trace_wide<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        s, P, D, active, n, any_hit != 0, t_out, which_out, n_out, bad_out,
        stats_out);
    return (int)cudaGetLastError();
}
