// The per-thread 8-wide short-stack BVH walk shared by the fused frame
// kernel (frame_kernel.cu) and the trace-only kernel (trace_kernel.cu),
// so both paths visit the same nodes in the same order and accept the
// same hits.  Node table and Woop leaf records as ops/pack_wide.py
// lays them out; both are read with 16-byte loads.  The stack is the
// caller's: local memory for the trace kernel, shared memory for the
// frame kernel.  The binary-tree kernel (trace_binary_kernel.cu) takes
// the constants, safe_inv and the slab test from here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr int WIDE = 8;
constexpr int MAX_STACK = 128;
constexpr int NODE_F4 = 2 * WIDE;   // float4s a wide node: two a child
constexpr int RECORD_F4 = 6;        // float4s a Woop record (21 floats, padded to 24)
constexpr int COUNT_SHIFT = 26;
constexpr int FIRST_MASK = (1 << COUNT_SHIFT) - 1;
constexpr float INFINITELY_FAR = 1.0e7f;  // fs:115
constexpr float RANGE_T1 = 1.0e8f;        // fs:463,491

struct Scene {
    // (Nw, 8, 2) float4: child k as (lo.xyz, meta bits) and (hi.xyz,
    // bits of the child order of octant k)
    const float4* nodes;
    const float4* leaves;  // (T, 6) float4 Woop records
    int stack_depth;
    int max_steps;
    float mt_eps;
};

struct Walk {
    float t;              // INFINITELY_FAR = miss; 0 = any-hit found
    float nx, ny, nz;     // interpolated object-space normal
    int which;            // BVH-order triangle id (TRACK_ID walks), -1 = none
    bool bad;             // stack or step budget exceeded
    unsigned steps, leafs, tris;
};

// A thread's whole stack in local memory.
struct LocalStack {
    int s[MAX_STACK];
    __device__ __forceinline__ int get(int i) const { return s[i]; }
    __device__ __forceinline__ void set(int i, int v) { s[i] = v; }
};

// finite 1/d: IEEE inf NaN-kills slab terms (kernel_body.py:48-59)
__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// slab test of the box (lo, hi): the ray's entry and exit distances,
// clipped to [0, RANGE_T1]; the box is hit where t0 < t1
__device__ __forceinline__ void slab(float lx, float ly, float lz,
                                     float hx, float hy, float hz,
                                     float Px, float Py, float Pz,
                                     float ix, float iy, float iz,
                                     float& t0, float& t1) {
    const float tax = (lx - Px) * ix;
    const float tay = (ly - Py) * iy;
    const float taz = (lz - Pz) * iz;
    const float tbx = (hx - Px) * ix;
    const float tby = (hy - Py) * iy;
    const float tbz = (hz - Pz) * iz;
    t0 = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fmaxf(fminf(taz, tbz), 0.0f));
    t1 = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fminf(fmaxf(taz, tbz), RANGE_T1));
}

// the same for a box stored as 6 floats lo.xyz, hi.xyz
__device__ __forceinline__ void slab(const float* __restrict__ b,
                                     float Px, float Py, float Pz,
                                     float ix, float iy, float iz,
                                     float& t0, float& t1) {
    slab(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4), __ldg(b + 5),
         Px, Py, Pz, ix, iy, iz, t0, t1);
}

// One ray's short-stack walk: pop a node, slab-test its 8 children in
// the octant's near-to-far order, Woop-test hit leaves near-to-far
// (accept d <= t: the last of equal distances wins), push hit internal
// children far-to-near.  ANY_HIT returns at the first accepted hit.
// TRACK_ID also records the accepted triangle's id.  Stack: get(i) and
// set(i, v) of entry i < s.stack_depth.
template <bool TRACK_ID, bool ANY_HIT, class Stack>
__device__ __forceinline__ Walk walk(const Scene& s, float Px, float Py, float Pz,
                                     float Dx, float Dy, float Dz, Stack& stack) {
    Walk o;
    o.t = INFINITELY_FAR;
    o.nx = o.ny = o.nz = 0.0f;
    o.which = -1;
    o.bad = false;
    o.steps = o.leafs = o.tris = 0;
    const float ix = safe_inv(Dx), iy = safe_inv(Dy), iz = safe_inv(Dz);
    const int oct = (Dx > 0.0f) + 2 * (Dy > 0.0f) + 4 * (Dz > 0.0f);
    int best = -1;          // record of the accepted hit, its u and v
    float bu = 0.0f, bv = 0.0f;
    int sp = 1;
    stack.set(0, 0);
    while (sp > 0) {
        const int node = stack.get(--sp);
        ++o.steps;
        const float4* nd = s.nodes + (size_t)node * NODE_F4;
        const int order = __float_as_int(__ldg(&nd[2 * oct + 1].w));
        int cms[WIDE];
        unsigned hits = 0;
#pragma unroll
        for (int p = 0; p < WIDE; ++p) {
            const int ck = (order >> (3 * p)) & 7;
            const float4 lo = __ldg(nd + 2 * ck);
            const int cm = __float_as_int(lo.w);
            cms[p] = cm;
            if (cm == -1) continue;
            const float4 hi = __ldg(nd + 2 * ck + 1);
            float t0, t1;
            slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, Px, Py, Pz, ix, iy, iz, t0, t1);
            if (t0 < t1 && t0 < o.t) hits |= 1u << p;
        }
#pragma unroll
        for (int p = 0; p < WIDE; ++p) {
            const int cm = cms[p];
            if (!((hits >> p) & 1u) || cm < (1 << COUNT_SHIFT)) continue;
            ++o.leafs;
            const int cnt = cm >> COUNT_SHIFT;
            const int first = cm & FIRST_MASK;
            const float4* rec = s.leaves + (size_t)first * RECORD_F4;
            for (int k = 0; k < cnt; ++k, rec += RECORD_F4) {
                ++o.tris;
                const float4 r0 = __ldg(rec);
                const float dz = r0.x * Dx + r0.y * Dy + r0.z * Dz;   // == -det_MT
                const float oz = r0.x * Px + r0.y * Py + r0.z * Pz + r0.w;
                if (!(fabsf(dz) >= s.mt_eps)) continue;
                const float d = oz * (-1.0f / dz);
                if (!(d <= o.t && d >= 0.0f)) continue;
                const float4 r1 = __ldg(rec + 1);
                const float u = (r1.x * Px + r1.y * Py + r1.z * Pz + r1.w)
                              + d * (r1.x * Dx + r1.y * Dy + r1.z * Dz);
                if (!(u >= 0.0f)) continue;
                const float4 r2 = __ldg(rec + 2);
                const float v = (r2.x * Px + r2.y * Py + r2.z * Pz + r2.w)
                              + d * (r2.x * Dx + r2.y * Dy + r2.z * Dz);
                if (!(v >= 0.0f && u + v <= 1.0f)) continue;
                if (ANY_HIT) {
                    o.t = 0.0f;
                    return o;
                }
                o.t = d;
                best = first + k;
                bu = u;
                bv = v;
            }
        }
#pragma unroll
        for (int p = WIDE - 1; p >= 0; --p) {
            const int cm = cms[p];
            if (!((hits >> p) & 1u) || cm >= (1 << COUNT_SHIFT)) continue;
            if (sp < s.stack_depth) stack.set(sp++, cm);
            else o.bad = true;
        }
        if (o.steps >= (unsigned)s.max_steps && sp > 0) {
            o.bad = true;
            break;
        }
    }
    if (!ANY_HIT && best >= 0) {
        // n0 + u (n1 - n0) + v (n2 - n0): record floats 12-14, 15-17, 18-20
        const float4* rec = s.leaves + (size_t)best * RECORD_F4;
        const float4 r3 = __ldg(rec + 3), r4 = __ldg(rec + 4), r5 = __ldg(rec + 5);
        o.nx = r3.x + bu * r3.w + bv * r4.z;
        o.ny = r3.y + bu * r4.x + bv * r4.w;
        o.nz = r3.z + bu * r4.y + bv * r5.x;
        if (TRACK_ID) o.which = best;
    }
    return o;
}

}  // namespace srt
