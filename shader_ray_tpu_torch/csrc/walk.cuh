// The per-thread 8-wide short-stack BVH walk shared by the fused frame
// kernel (frame_kernel.cu) and the trace-only kernel (trace_kernel.cu),
// so both paths visit the same nodes in the same order and accept the
// same hits.  Node table and Woop leaf records as ops/pack_wide.py
// lays them out.  The binary-tree kernel (trace_binary_kernel.cu) takes
// the constants, safe_inv and the slab test from here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr int WIDE = 8;
constexpr int MAX_STACK = 128;
constexpr int RECORD = 21;
constexpr int COUNT_SHIFT = 26;
constexpr int FIRST_MASK = (1 << COUNT_SHIFT) - 1;
constexpr float INFINITELY_FAR = 1.0e7f;  // fs:115
constexpr float RANGE_T1 = 1.0e8f;        // fs:463,491

struct Scene {
    const float* boxes;   // (Nw, 8, 6) child lo.xyz, hi.xyz
    const int* meta;      // (Nw, 16) child meta [0:8], octant orders [8:16]
    const float* leaves;  // (T, 21) Woop records
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

// finite 1/d: IEEE inf NaN-kills slab terms (kernel_body.py:48-59)
__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// slab test of the box b (lo.xyz, hi.xyz): the ray's entry and exit
// distances, clipped to [0, RANGE_T1]; the box is hit where t0 < t1
__device__ __forceinline__ void slab(const float* __restrict__ b,
                                     float Px, float Py, float Pz,
                                     float ix, float iy, float iz,
                                     float& t0, float& t1) {
    const float tax = (__ldg(b + 0) - Px) * ix;
    const float tay = (__ldg(b + 1) - Py) * iy;
    const float taz = (__ldg(b + 2) - Pz) * iz;
    const float tbx = (__ldg(b + 3) - Px) * ix;
    const float tby = (__ldg(b + 4) - Py) * iy;
    const float tbz = (__ldg(b + 5) - Pz) * iz;
    t0 = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fmaxf(fminf(taz, tbz), 0.0f));
    t1 = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fminf(fmaxf(taz, tbz), RANGE_T1));
}

// One ray's short-stack walk: pop a node, slab-test its 8 children in
// the octant's near-to-far order, Woop-test hit leaves near-to-far
// (accept d <= t: the last of equal distances wins), push hit internal
// children far-to-near.  any_hit returns at the first accepted hit.
// TRACK_ID also records the accepted triangle's id.
template <bool TRACK_ID>
__device__ Walk walk(const Scene& s, float Px, float Py, float Pz,
                     float Dx, float Dy, float Dz, bool any_hit,
                     int* stack) {
    Walk o;
    o.t = INFINITELY_FAR;
    o.nx = o.ny = o.nz = 0.0f;
    o.which = -1;
    o.bad = false;
    o.steps = o.leafs = o.tris = 0;
    const float ix = safe_inv(Dx), iy = safe_inv(Dy), iz = safe_inv(Dz);
    const int oct = (Dx > 0.0f) + 2 * (Dy > 0.0f) + 4 * (Dz > 0.0f);
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
        const int node = stack[--sp];
        ++o.steps;
        const int* nm = s.meta + (size_t)node * (2 * WIDE);
        const float* nb = s.boxes + (size_t)node * (WIDE * 6);
        const int order = __ldg(nm + WIDE + oct);
        int cms[WIDE];
        unsigned hits = 0;
#pragma unroll
        for (int p = 0; p < WIDE; ++p) {
            const int ck = (order >> (3 * p)) & 7;
            const int cm = __ldg(nm + ck);
            cms[p] = cm;
            if (cm == -1) continue;
            float t0, t1;
            slab(nb + ck * 6, Px, Py, Pz, ix, iy, iz, t0, t1);
            if (t0 < t1 && t0 < o.t) hits |= 1u << p;
        }
#pragma unroll
        for (int p = 0; p < WIDE; ++p) {
            const int cm = cms[p];
            if (!((hits >> p) & 1u) || cm < (1 << COUNT_SHIFT)) continue;
            ++o.leafs;
            const int cnt = cm >> COUNT_SHIFT;
            const int first = cm & FIRST_MASK;
            const float* rec = s.leaves + (size_t)first * RECORD;
            for (int k = 0; k < cnt; ++k, rec += RECORD) {
                ++o.tris;
                const float n0 = __ldg(rec + 0), n1 = __ldg(rec + 1), n2 = __ldg(rec + 2);
                const float dz = n0 * Dx + n1 * Dy + n2 * Dz;   // == -det_MT
                const float oz = n0 * Px + n1 * Py + n2 * Pz + __ldg(rec + 3);
                if (!(fabsf(dz) >= s.mt_eps)) continue;
                const float d = oz * (-1.0f / dz);
                if (!(d <= o.t && d >= 0.0f)) continue;
                const float a0 = __ldg(rec + 4), a1 = __ldg(rec + 5), a2 = __ldg(rec + 6);
                const float u = (a0 * Px + a1 * Py + a2 * Pz + __ldg(rec + 7))
                              + d * (a0 * Dx + a1 * Dy + a2 * Dz);
                if (!(u >= 0.0f)) continue;
                const float b0 = __ldg(rec + 8), b1 = __ldg(rec + 9), b2 = __ldg(rec + 10);
                const float v = (b0 * Px + b1 * Py + b2 * Pz + __ldg(rec + 11))
                              + d * (b0 * Dx + b1 * Dy + b2 * Dz);
                if (!(v >= 0.0f && u + v <= 1.0f)) continue;
                if (any_hit) {
                    o.t = 0.0f;
                    return o;
                }
                o.t = d;
                if (TRACK_ID) o.which = first + k;
                o.nx = __ldg(rec + 12) + u * __ldg(rec + 15) + v * __ldg(rec + 18);
                o.ny = __ldg(rec + 13) + u * __ldg(rec + 16) + v * __ldg(rec + 19);
                o.nz = __ldg(rec + 14) + u * __ldg(rec + 17) + v * __ldg(rec + 20);
            }
        }
#pragma unroll
        for (int p = WIDE - 1; p >= 0; --p) {
            const int cm = cms[p];
            if (!((hits >> p) & 1u) || cm >= (1 << COUNT_SHIFT)) continue;
            if (sp < s.stack_depth) stack[sp++] = cm;
            else o.bad = true;
        }
        if (o.steps >= (unsigned)s.max_steps && sp > 0) {
            o.bad = true;
            break;
        }
    }
    return o;
}

}  // namespace srt
