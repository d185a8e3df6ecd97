// Trace-only kernel over the BINARY tree for Hopper (sm_90a): one thread
// per ray walks the stackless hit/miss links of its own direction octant
// — slab-test node g, Moller-Trumbore-test a hit leaf's triangles
// clipped to the leaf's slab range [t0, t1], follow the hit or the miss
// link — for the closest hit or any hit.
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
// What bounds it here: latency.  Every step is one dependent chain —
// box (24 B), leaf range (8 B) and link pair (8 B) of node g, then g
// itself — and a deep binary tree costs a ray several times the steps
// that the 8-wide walk takes pops.  The design is the simple
// one: no stack, no shared memory, tables through the read-only cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Entry point: srt_trace_binary (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using srt::INFINITELY_FAR;
using srt::safe_inv;
using srt::slab;

constexpr int BLOCK = 128;
constexpr int TRI = 18;                   // v0 v1 v2 n0 n1 n2

__global__ void __launch_bounds__(BLOCK)
trace_binary(const int* __restrict__ links, const float* __restrict__ boxes,
             const int* __restrict__ leaf, const float* __restrict__ tris,
             int root, int max_steps, float mt_eps,
             const float* __restrict__ P, const float* __restrict__ D,
             const uint8_t* __restrict__ active, long long n, bool any_hit,
             float* __restrict__ t_out, int* __restrict__ which_out,
             float* __restrict__ n_out, uint8_t* __restrict__ bad_out,
             int* __restrict__ stats_out) {
    const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (r >= n) return;
    float t = INFINITELY_FAR, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    int which = -1, steps = 0, leafs = 0, tests = 0;
    bool bad = false;
    if (active[r]) {
        const float Px = __ldg(P + 3 * r), Py = __ldg(P + 3 * r + 1), Pz = __ldg(P + 3 * r + 2);
        const float Dx = __ldg(D + 3 * r), Dy = __ldg(D + 3 * r + 1), Dz = __ldg(D + 3 * r + 2);
        const float ix = safe_inv(Dx), iy = safe_inv(Dy), iz = safe_inv(Dz);
        const int oct = (Dx > 0.0f) + 2 * (Dy > 0.0f) + 4 * (Dz > 0.0f);
        int g = root;
        while (g >= 0) {
            ++steps;
            float t0, t1;
            slab(boxes + (size_t)g * 6, Px, Py, Pz, ix, iy, iz, t0, t1);
            const bool boxhit = t0 < t1 && t0 < t;
            const int cnt = __ldg(leaf + 2 * (size_t)g + 1);
            if (boxhit && cnt > 0) {
                ++leafs;
                const int first = __ldg(leaf + 2 * (size_t)g);
                const float* tr = tris + (size_t)first * TRI;
                for (int k = 0; k < cnt; ++k, tr += TRI) {
                    ++tests;
                    // Moller-Trumbore (kernel_body.slot_hit, "mt" branch)
                    const float v0x = __ldg(tr + 0), v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
                    const float e0x = __ldg(tr + 3) - v0x, e0y = __ldg(tr + 4) - v0y,
                                e0z = __ldg(tr + 5) - v0z;                 // v1 - v0
                    const float e1x = v0x - __ldg(tr + 6), e1y = v0y - __ldg(tr + 7),
                                e1z = v0z - __ldg(tr + 8);                 // v0 - v2
                    const float Mx = e1y * Dz - e1z * Dy;
                    const float My = e1z * Dx - e1x * Dz;
                    const float Mz = e1x * Dy - e1y * Dx;
                    const float det = e0x * Mx + e0y * My + e0z * Mz;
                    if (!(fabsf(det) >= mt_eps)) continue;
                    const float minv_det = -1.0f / det;
                    const float inv_det = -minv_det;
                    const float Tx = Px - v0x, Ty = Py - v0y, Tz = Pz - v0z;
                    const float Qx = Ty * e0z - Tz * e0y;
                    const float Qy = Tz * e0x - Tx * e0z;
                    const float Qz = Tx * e0y - Ty * e0x;
                    const float d = (e1x * Qx + e1y * Qy + e1z * Qz) * minv_det;
                    if (!(d <= t && d >= t0 && d <= t1)) continue;
                    const float u = (Tx * Mx + Ty * My + Tz * Mz) * inv_det;
                    if (!(u >= 0.0f)) continue;
                    const float v = (Dx * Qx + Dy * Qy + Dz * Qz) * inv_det;
                    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
                    if (any_hit) {
                        t = 0.0f;
                        break;
                    }
                    t = d;
                    which = first + k;
                    const float n0x = __ldg(tr + 9), n0y = __ldg(tr + 10), n0z = __ldg(tr + 11);
                    nx = n0x + u * (__ldg(tr + 12) - n0x) + v * (__ldg(tr + 15) - n0x);
                    ny = n0y + u * (__ldg(tr + 13) - n0y) + v * (__ldg(tr + 16) - n0y);
                    nz = n0z + u * (__ldg(tr + 14) - n0z) + v * (__ldg(tr + 17) - n0z);
                }
                if (any_hit && t == 0.0f) break;
            }
            g = __ldg(links + ((size_t)g * 8 + oct) * 2 + (boxhit ? 0 : 1));
            if (steps >= max_steps && g >= 0) {
                bad = true;
                break;
            }
        }
    }
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

}  // namespace

extern "C" int srt_trace_binary(
    const int* links, const float* boxes, const int* leaf, const float* tris,
    int root, int node_count, int max_steps, float mt_eps,
    const float* P, const float* D, const uint8_t* active, long long n,
    int any_hit, float* t_out, int* which_out, float* n_out, uint8_t* bad_out,
    int* stats_out, void* stream) {
    if (n < 1 || node_count < 1 || root < 0 || root >= node_count || max_steps < 1)
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    trace_binary<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        links, boxes, leaf, tris, root, max_steps, mt_eps, P, D, active, n,
        any_hit != 0, t_out, which_out, n_out, bad_out, stats_out);
    return (int)cudaGetLastError();
}
