// Trace-only kernel over the BINARY tree for Hopper (sm_90a): each
// active ray walks the stackless hit/miss links of its own direction
// octant — slab-test node g, Moller-Trumbore-test a hit leaf's triangles
// clipped to the leaf's slab range [t0, t1], go on to the next node —
// for the closest hit or any hit.
//
// Replaces the TPU kernel packet_kernel
// (shader_ray_tpu/ops/pallas/kernel_body.py, pallas_call in
// packet.packet_trace), same PacketHit contract as trace_kernel.cu.  The
// TPU kernel follows the bank of the packet's majority octant because a
// packet has one node pointer; a thread has its own, so each ray follows
// its own octant's bank, as the per-lane walk of ops/traversal.py does.
// Boxes are plain f32 (the TPU's 16-bit fixed point fitted its scalar
// memory).
//
// What bounds it here: latency.  A ray takes ~5x as many steps as the
// 8-wide walk takes pops (33.5 a primary at the bench), and each step's
// next node depends on its box test.  The design (ops/pack.py):
//   * one bank of node records per octant, numbered in the order that
//     octant's walk visits them, so an inner node's hit link is the next
//     record and only the miss link is stored: a step is one 32-byte
//     record (box, miss link, leaf range) in two 16-byte loads from one
//     sector, one round trip, where the parent design read a box, a leaf
//     range and then a link from three tables;
//   * triangles as v0, v1 - v0, v0 - v2 in three float4s, loaded
//     together; normals in their own table, read once after the walk;
//   * one flattened loop: an iteration is one node step or one triangle
//     test, so a lane at a leaf does not hold its warp's stepping lanes
//     through all its tests;
//   * given an image's width, a block walks an 8x16 tile of its pixels
//     (walk.cuh's ray map).
// On the bench frame (H100 80GB HBM3 at 700 W, PERF.md): 0.18 ms
// closest and 0.15 ms any-hit on the 786,432 primaries, 0.68 ms for a
// frame's six launches, against 0.31 / 0.26 / 1.20 ms for the parent
// design; 10x above the operation bound.  Compacting a block's active
// rays, loading both possible next records at once and register caps for
// more blocks an SM were slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Entry points: srt_trace_binary,
//        srt_trace_binary_info (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using srt::COUNT_SHIFT;
using srt::FIRST_MASK;
using srt::INFINITELY_FAR;
using srt::safe_inv;
using srt::slab;

constexpr int BLOCK = srt::TRACE_BLOCK;

__device__ __forceinline__ void store(long long r, float t, int which, float nx, float ny,
                                      float nz, bool bad, int steps, int leafs, int tests,
                                      float* __restrict__ t_out, int* __restrict__ which_out,
                                      float* __restrict__ n_out, uint8_t* __restrict__ bad_out,
                                      int* __restrict__ stats_out) {
    t_out[r] = bad ? -1.0f : t;
    which_out[r] = bad ? -1 : which;
    n_out[3 * r] = nx;
    n_out[3 * r + 1] = ny;
    n_out[3 * r + 2] = nz;
    bad_out[r] = bad ? 1 : 0;
    if (stats_out != nullptr) {
        stats_out[3 * r] = steps;
        stats_out[3 * r + 1] = leafs;
        stats_out[3 * r + 2] = tests;
    }
}

__global__ void __launch_bounds__(BLOCK)
trace_binary(const float4* __restrict__ nodes, const float4* __restrict__ tris,
             const float4* __restrict__ normals, int N, int max_steps, float mt_eps,
             const float* __restrict__ P, const float* __restrict__ D,
             const uint8_t* __restrict__ active, long long n, int width, bool any_hit,
             float* __restrict__ t_out, int* __restrict__ which_out,
             float* __restrict__ n_out, uint8_t* __restrict__ bad_out,
             int* __restrict__ stats_out) {
    const long long r = srt::ray_of(n, width, threadIdx.x);
    if (r < 0) return;
    if (!active[r]) {
        store(r, INFINITELY_FAR, -1, 0.0f, 0.0f, 0.0f, false, 0, 0, 0,
              t_out, which_out, n_out, bad_out, stats_out);
        return;
    }
    float t = INFINITELY_FAR;
    int best = -1, steps = 0, leafs = 0, tests = 0;
    float bu = 0.0f, bv = 0.0f;
    bool bad = false;
    const float Px = __ldg(P + 3 * r), Py = __ldg(P + 3 * r + 1), Pz = __ldg(P + 3 * r + 2);
    const float Dx = __ldg(D + 3 * r), Dy = __ldg(D + 3 * r + 1), Dz = __ldg(D + 3 * r + 2);
    const float ix = safe_inv(Dx), iy = safe_inv(Dy), iz = safe_inv(Dz);
    const int oct = (Dx > 0.0f) + 2 * (Dy > 0.0f) + 4 * (Dz > 0.0f);
    const float4* bank = nodes + (size_t)oct * N * 2;   // (N, 2) float4 records
    int g = 0;                                          // the root is record 0
    float4 a = __ldg(bank), b = __ldg(bank + 1);   // (lo, miss), (hi, leaf)
    // one step or one triangle test an iteration: lanes at a leaf and
    // lanes stepping share iterations; each ray's sequence is unchanged
    const float4* tr = tris;
    int tri = 0, tleft = 0, after = -1;
    float lt0 = 0.0f, lt1 = 0.0f;
    while (true) {
        int next;
        if (tleft > 0) {
            ++tests;
            // Moller-Trumbore (walk.cuh's mt_hit), clipped to the leaf's
            // slab range
            const float4 v0 = __ldg(tr), e0 = __ldg(tr + 1), e1 = __ldg(tr + 2);
            float d, u, v;
            if (srt::mt_hit<true>(v0, e0, e1, Px, Py, Pz, Dx, Dy, Dz, mt_eps, t, lt0, lt1,
                                  d, u, v)) {
                if (any_hit) {
                    t = 0.0f;
                    break;
                }
                t = d;
                best = tri;
                bu = u;
                bv = v;
            }
            tr += 3;
            ++tri;
            if (--tleft > 0) continue;
            next = after;
        } else {
            ++steps;
            const int miss = __float_as_int(a.w);
            const int leaf = __float_as_int(b.w);       // -1: inner node
            float t0, t1;
            slab(a.x, a.y, a.z, b.x, b.y, b.z, Px, Py, Pz, ix, iy, iz, t0, t1);
            const bool boxhit = t0 < t1 && t0 < t;
            const int cnt = leaf >> COUNT_SHIFT;
            if (boxhit && cnt > 0) {
                ++leafs;
                tri = leaf & FIRST_MASK;
                tr = tris + (size_t)tri * 3;
                tleft = cnt;
                lt0 = t0;
                lt1 = t1;
                after = miss;
                continue;
            }
            next = (boxhit && leaf < 0) ? g + 1 : miss;
        }
        if (next < 0) break;
        if (steps >= max_steps) {
            bad = true;
            break;
        }
        a = __ldg(bank + 2 * next);
        b = __ldg(bank + 2 * next + 1);
        g = next;
    }
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (best >= 0) {
        // n0 + u (n1 - n0) + v (n2 - n0)
        const float4* nr = normals + (size_t)best * 3;
        const float4 n0 = __ldg(nr), d1 = __ldg(nr + 1), d2 = __ldg(nr + 2);
        nx = n0.x + bu * d1.x + bv * d2.x;
        ny = n0.y + bu * d1.y + bv * d2.y;
        nz = n0.z + bu * d1.z + bv * d2.z;
    }
    store(r, t, best, nx, ny, nz, bad, steps, leafs, tests,
          t_out, which_out, n_out, bad_out, stats_out);
}

}  // namespace

extern "C" int srt_trace_binary(
    const float* nodes, const float* tris, const float* normals,
    int node_count, int max_steps, float mt_eps,
    const float* P, const float* D, const uint8_t* active, long long n, int width,
    int any_hit, float* t_out, int* which_out, float* n_out, uint8_t* bad_out,
    int* stats_out, void* stream) {
    if (n < 1 || node_count < 1 || max_steps < 1 || width < 0 || (width > 0 && n % width))
        return (int)cudaErrorInvalidValue;
    trace_binary<<<srt::ray_blocks(n, width), BLOCK, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
        reinterpret_cast<const float4*>(normals), node_count, max_steps, mt_eps,
        P, D, active, n, width, any_hit != 0, t_out, which_out, n_out, bad_out, stats_out);
    return (int)cudaGetLastError();
}

// The launch's resources, into info[0..6): registers a thread, static
// shared bytes, local bytes a thread, dynamic shared bytes (none: the
// walk has no stack, so stack_depth is not read), resident blocks an
// SM, threads a block.
extern "C" int srt_trace_binary_info(int stack_depth, int* info) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, trace_binary);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_binary, BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = 0;
    info[4] = per_sm;
    info[5] = BLOCK;
    return 0;
}
