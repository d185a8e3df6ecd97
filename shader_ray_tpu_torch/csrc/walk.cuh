// The per-thread 8-wide short-stack BVH walk shared by the fused frame
// kernel (frame_kernel.cu) and the trace-only kernel (trace_kernel.cu),
// so both paths visit the same nodes in the same order and accept the
// same hits; and the ray-to-thread map of both trace kernels.  Node table
// and leaf test rows as ops/pack_wide.py lays them out, in either form of
// Config.leaf_isect (template argument ISECT): Woop rows, or
// Moller-Trumbore's v0, e0, e1 (kernel_body.slot_hit's two branches).  The
// stack is the caller's: local memory for the trace kernel, shared memory
// for the frame kernel.  The binary-tree kernel (trace_binary_kernel.cu)
// takes the constants, the ray map, safe_inv, the slab test and the
// Moller-Trumbore test (mt_hit) from here.
//
// What bounds the walk: the latency and the cache traffic of its
// dependent loads (pop, order word, children, leaf records), in warps
// whose lanes diverge; not arithmetic (it runs 10x above its operation
// bound) and not device memory (the tables stay in L2).  A pop reads the
// octant's order word, then each child's two float4s in visit order; a
// Woop test issues its three 16-byte rows at once and never touches the
// normals, which a walk reads once, for its accepted hit, from a table of
// their own (48-byte test rows instead of 96-byte records: -7% on the
// trace's primaries, -1.5% on the frame kernel; H100 80GB HBM3 at 700 W,
// PERF.md section 6).  Loading a node in storage order without waiting
// for the order word and permuting the hits afterwards, prefetching the
// next node into L1 while the leaves are tested, a 16-bit stack (within
// 1%) and L1 eviction hints measured no faster; a flattened pop-or-test
// loop slower.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr int WIDE = 8;
constexpr int MAX_STACK = 128;
constexpr int NODE_F4 = 2 * WIDE;   // float4s a wide node: two a child
constexpr int RECORD_F4 = 3;        // float4s a triangle's test rows, and its normal terms
// the leaf test forms (ops/pack_wide.ISECTS; kernel_body.slot_hit)
constexpr int ISECT_WOOP = 0;       // rows: N | -N.v0, r0 | -r0.v0, r1 | -r1.v0
constexpr int ISECT_MT = 1;         // rows: v0, e0 = v1 - v0, e1 = v0 - v2
constexpr int COUNT_SHIFT = 26;
constexpr int FIRST_MASK = (1 << COUNT_SHIFT) - 1;
constexpr float INFINITELY_FAR = 1.0e7f;  // fs:115
constexpr float RANGE_T1 = 1.0e8f;        // fs:463,491
constexpr int TRACE_BLOCK = 128;          // threads a block of the trace kernels
constexpr int RAY_TILE_W = 8, RAY_TILE_H = TRACE_BLOCK / RAY_TILE_W;  // a block's tile of an image

struct Scene {
    // (Nw, 8, 2) float4: child k as (lo.xyz, meta bits) and (hi.xyz,
    // bits of the child order of octant k)
    const float4* nodes;
    const float4* leaves;   // (T, 3) float4 test rows of the walk's ISECT form
    const float4* normals;  // (T, 3) float4 n0, n1 - n0, n2 - n0 (floats 12-20)
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

// The result of no walk: a miss, no id, no work.
__device__ __forceinline__ Walk no_walk() {
    Walk o;
    o.t = INFINITELY_FAR;
    o.nx = o.ny = o.nz = 0.0f;
    o.which = -1;
    o.bad = false;
    o.steps = o.leafs = o.tris = 0;
    return o;
}

// A thread's whole stack in local memory.
struct LocalStack {
    int s[MAX_STACK];
    __device__ __forceinline__ int get(int i) const { return s[i]; }
    __device__ __forceinline__ void set(int i, int v) { s[i] = v; }
};

// The ray a thread of a trace kernel walks, or -1: with width 0 the n
// rays are a list and thread i walks ray i; with width > 0 they are the
// pixels of a width-wide image, row-major, and a block walks a RAY_TILE_W x
// RAY_TILE_H tile of them, so neighbouring rays share warps and SMs.
__device__ __forceinline__ long long ray_of(long long n, int width, int tid) {
    if (width <= 0) {
        const long long i = (long long)blockIdx.x * TRACE_BLOCK + tid;
        return i < n ? i : -1;
    }
    const long long height = n / width, tiles_x = (width + RAY_TILE_W - 1) / RAY_TILE_W;
    const long long px = (blockIdx.x % tiles_x) * RAY_TILE_W + tid % RAY_TILE_W;
    const long long py = (blockIdx.x / tiles_x) * RAY_TILE_H + tid / RAY_TILE_W;
    return px < width && py < height ? py * width + px : -1;
}

// the blocks of a trace launch over n rays (ray_of)
inline unsigned ray_blocks(long long n, int width) {
    if (width <= 0) return (unsigned)((n + TRACE_BLOCK - 1) / TRACE_BLOCK);
    const long long height = n / width;
    return (unsigned)(((width + RAY_TILE_W - 1) / RAY_TILE_W) * ((height + RAY_TILE_H - 1) / RAY_TILE_H));
}

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

// Moller-Trumbore test of the triangle (v0, e0 = v1 - v0, e1 = v0 - v2)
// against the ray (kernel_body.slot_hit, "mt" branch), in its order and
// with its accept set: |det| >= eps, then d = (e1 . Q) * -1/det with
// lo <= d <= t (and d <= hi where CLIP), then u >= 0, then v >= 0 and
// u + v <= 1.  True where accepted, with d, u and v (left as they were
// otherwise).  The nested form, outputs written only on accept, is the
// one that compiles the binary kernel's loop to the instructions it had
// before the test was shared (registers, and SASS instruction for
// instruction); an early-return form compiled it to more registers.
template <bool CLIP>
__device__ __forceinline__ bool mt_hit(const float4& v0, const float4& e0, const float4& e1,
                                       float Px, float Py, float Pz,
                                       float Dx, float Dy, float Dz, float eps,
                                       float t, float lo, float hi,
                                       float& d, float& u, float& v) {
    // M = cross(e1, D)  (fs:305)
    const float Mx = e1.y * Dz - e1.z * Dy;
    const float My = e1.z * Dx - e1.x * Dz;
    const float Mz = e1.x * Dy - e1.y * Dx;
    const float det = e0.x * Mx + e0.y * My + e0.z * Mz;
    if (fabsf(det) >= eps) {
        const float minv_det = -1.0f / det;
        const float inv_det = -minv_det;
        const float Tx = Px - v0.x, Ty = Py - v0.y, Tz = Pz - v0.z;
        const float Qx = Ty * e0.z - Tz * e0.y;
        const float Qy = Tz * e0.x - Tx * e0.z;
        const float Qz = Tx * e0.y - Ty * e0.x;
        const float dd = (e1.x * Qx + e1.y * Qy + e1.z * Qz) * minv_det;
        if (dd <= t && dd >= lo && (!CLIP || dd <= hi)) {
            const float uu = (Tx * Mx + Ty * My + Tz * Mz) * inv_det;
            if (uu >= 0.0f) {
                const float vv = (Dx * Qx + Dy * Qy + Dz * Qz) * inv_det;
                if (vv >= 0.0f && uu + vv <= 1.0f) {
                    d = dd;
                    u = uu;
                    v = vv;
                    return true;
                }
            }
        }
    }
    return false;
}

// One ray's short-stack walk: pop a node, slab-test its 8 children in
// the octant's near-to-far order, test hit leaves' triangles near-to-far
// with the ISECT form's test (accept d <= t: the last of equal distances
// wins), push hit internal children far-to-near.  ANY_HIT returns at the
// first accepted hit.  TRACK_ID also records the accepted triangle's id.
// Stack: get(i) and set(i, v) of entry i < s.stack_depth.
template <bool TRACK_ID, bool ANY_HIT, int ISECT, class Stack>
__device__ __forceinline__ Walk walk(const Scene& s, float Px, float Py, float Pz,
                                     float Dx, float Dy, float Dz, Stack& stack) {
    Walk o = no_walk();
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
                const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
                // zero-initialised: undefined off mt_hit's accept path, they
                // cost the Moller-Trumbore instantiations registers
                float d = 0.0f, u = 0.0f, v = 0.0f;
                if constexpr (ISECT == ISECT_MT) {
                    if (!mt_hit<false>(r0, r1, r2, Px, Py, Pz, Dx, Dy, Dz, s.mt_eps, o.t, 0.0f,
                                       0.0f, d, u, v))
                        continue;
                } else {
                    const float dz = r0.x * Dx + r0.y * Dy + r0.z * Dz;   // == -det_MT
                    const float oz = r0.x * Px + r0.y * Py + r0.z * Pz + r0.w;
                    if (!(fabsf(dz) >= s.mt_eps)) continue;
                    d = oz * (-1.0f / dz);
                    if (!(d <= o.t && d >= 0.0f)) continue;
                    u = (r1.x * Px + r1.y * Py + r1.z * Pz + r1.w)
                      + d * (r1.x * Dx + r1.y * Dy + r1.z * Dz);
                    if (!(u >= 0.0f)) continue;
                    v = (r2.x * Px + r2.y * Py + r2.z * Pz + r2.w)
                      + d * (r2.x * Dx + r2.y * Dy + r2.z * Dz);
                    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
                }
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
        // n0 + u (n1 - n0) + v (n2 - n0)
        const float4* rec = s.normals + (size_t)best * RECORD_F4;
        const float4 r3 = __ldg(rec), r4 = __ldg(rec + 1), r5 = __ldg(rec + 2);
        o.nx = r3.x + bu * r3.w + bv * r4.z;
        o.ny = r3.y + bu * r4.x + bv * r4.w;
        o.nz = r3.z + bu * r4.y + bv * r5.x;
        if (TRACK_ID) o.which = best;
    }
    return o;
}

}  // namespace srt
