// Fused frame kernel for Hopper (sm_90a): one thread per pixel renders
// K jittered samples — pinhole raygen, `bounces` x (closest-hit 8-wide
// BVH walk, Schlick/Lambert shading, lcos-gated any-hit shadow walk),
// the lat-long env term, bad-ray paint — and writes their linear mean.
//
// Replaces the TPU kernel mega_kernel
// (shader_ray_tpu/ops/pallas/kernel_mega.py, pallas_call in
// packet_mega.packet_shade) with its walker make_wide_walker
// (kernel_wide.py), leaf math slot_hit/slot_normal/safe_inv
// (kernel_body.py) and fused env sampler env_window_body /
// env_coords_kernel (envwin.py, trig.py), for which = 0.
//
// What bounds it here: operations and latency, not bytes.  The scene
// (node table + Woop records, ~7 MB at 69k triangles) and the 25 MB env
// level stay in the 50 MB L2, so the frame reads little from device
// memory; the work is ~200 f32 ops per node pop and ~50 per triangle
// test, in dependent chains with data-dependent branches.  This first
// design is the simple one: one thread walks one ray with a short
// stack in local memory, warps diverge freely, and nodes and leaves are
// read through the read-only cache.  Coherent traversal, shared-memory
// node caching and persistent threads are later work.
//
// Sums are deterministic: a thread adds its samples in order and
// writes their mean (no atomics on colour).  Counters (rays cast; per
// walk phase node pops, leaf visits, triangle tests) are summed per
// block and added with one 64-bit atomic per counter.
//
// The walk itself lives in walk.cuh, shared with trace_kernel.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (accurate atan2f/acosf/sqrtf/div:
//        no fast math).  Entry point: srt_frame_kernel (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using namespace srt;  // Scene, Walk, walk(), the table constants (walk.cuh)

constexpr int MAX_PHASES = 16;
constexpr int N_COUNTERS = 1 + 3 * MAX_PHASES;
constexpr int BLOCK = 128;
// the reference's pi, kept verbatim (fs:116), rounded to f32 once
constexpr float PI_REF = (float)3.14159265259;
constexpr float TAU_REF = (float)(2.0 * 3.14159265259);

// uniform table layout (kernel_mega.py:43-54)
constexpr int UNI_OBJECT_MATRIX = 0;
constexpr int UNI_NORMAL_MATRIX = 12;
constexpr int UNI_NORMAL_INVERSE = 21;
constexpr int UNI_LIGHT_DIR = 30;
constexpr int UNI_SPECULAR = 33;
constexpr int UNI_DIFFUSE = 36;
constexpr int UNI_CAM_ORIGIN = 39;
constexpr int UNI_CAM_NORMAL = 42;
constexpr int UNI_IPW = 51;
constexpr int UNI_SIZE = 52;

__global__ void __launch_bounds__(BLOCK)
frame(Scene s, const float* __restrict__ env, int eh, int ew,
      const float* __restrict__ uni_g, const float* __restrict__ jit, int K,
      int W, int H, float inv_w, float inv_h, float aspect, int bounces,
      bool shadows, bool diffuse, float fudge, int n_counters,
      float* __restrict__ out, unsigned long long* __restrict__ counters) {
    __shared__ float u[UNI_SIZE];
    __shared__ unsigned long long red[BLOCK / 32][N_COUNTERS];
    for (int i = threadIdx.x; i < UNI_SIZE; i += BLOCK) u[i] = uni_g[i];
    __syncthreads();

    unsigned cnt[N_COUNTERS];
    for (int c = 0; c < N_COUNTERS; ++c) cnt[c] = 0;
    int stack[MAX_STACK];

    const float* m = u + UNI_OBJECT_MATRIX;
    const float* nm = u + UNI_NORMAL_MATRIX;
    const float* ni = u + UNI_NORMAL_INVERSE;
    const float* cmx = u + UNI_CAM_NORMAL;
    const float Lx = u[UNI_LIGHT_DIR], Ly = u[UNI_LIGHT_DIR + 1], Lz = u[UNI_LIGHT_DIR + 2];
    const float ipw = u[UNI_IPW];
    // object-space light: every shadow ray shares it
    const float oLx = nm[0] * Lx + nm[1] * Ly + nm[2] * Lz;
    const float oLy = nm[3] * Lx + nm[4] * Ly + nm[5] * Lz;
    const float oLz = nm[6] * Lx + nm[7] * Ly + nm[8] * Lz;
    const int phase_stride = shadows ? 2 : 1;

    const long long pix = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (pix < (long long)W * H) {
        const float iif = (float)(pix % W);
        const float jf = (float)(pix / W);
        float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f;
        for (int k = 0; k < K; ++k) {
            // pinhole raygen (kernel_mega.py:203-220), two normalisations
            const float uu = (iif + 0.5f + __ldg(jit + 2 * k)) * inv_w;
            const float vv = 1.0f - (jf + 0.5f + __ldg(jit + 2 * k + 1)) * inv_h;
            const float ex = ipw * (uu - 0.5f);
            const float ey = (ipw * aspect) * (vv - 0.5f);
            const float inv_e = 1.0f / sqrtf(ex * ex + ey * ey + 1.0f);
            const float dex = ex * inv_e, dey = ey * inv_e, dez = -inv_e;
            float Dx = cmx[0] * dex + cmx[1] * dey + cmx[2] * dez;
            float Dy = cmx[3] * dex + cmx[4] * dey + cmx[5] * dez;
            float Dz = cmx[6] * dex + cmx[7] * dey + cmx[8] * dez;
            const float inv_d = 1.0f / sqrtf(Dx * Dx + Dy * Dy + Dz * Dz);
            Dx *= inv_d;
            Dy *= inv_d;
            Dz *= inv_d;
            float Px = u[UNI_CAM_ORIGIN], Py = u[UNI_CAM_ORIGIN + 1], Pz = u[UNI_CAM_ORIGIN + 2];

            float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
            float mod0 = 1.0f, mod1 = 1.0f, mod2 = 1.0f;
            bool bad = false;
            for (int b = 0; b < bounces; ++b) {
                cnt[0] += 1;
                const float oPx = m[0] * Px + m[1] * Py + m[2] * Pz + m[3];
                const float oPy = m[4] * Px + m[5] * Py + m[6] * Pz + m[7];
                const float oPz = m[8] * Px + m[9] * Py + m[10] * Pz + m[11];
                const float oDx = nm[0] * Dx + nm[1] * Dy + nm[2] * Dz;
                const float oDy = nm[3] * Dx + nm[4] * Dy + nm[5] * Dz;
                const float oDz = nm[6] * Dx + nm[7] * Dy + nm[8] * Dz;
                const Walk w = walk<false>(s, oPx, oPy, oPz, oDx, oDy, oDz, false, stack);
                const int ph = 1 + 3 * (phase_stride * b);
                cnt[ph] += w.steps;
                cnt[ph + 1] += w.leafs;
                cnt[ph + 2] += w.tris;
                bad |= w.bad;
                if (w.bad || !(w.t < INFINITELY_FAR)) break;
                const float t = w.t;

                // object -> world normal, flipped against the incoming ray
                float wnx = ni[0] * w.nx + ni[1] * w.ny + ni[2] * w.nz;
                float wny = ni[3] * w.nx + ni[4] * w.ny + ni[5] * w.nz;
                float wnz = ni[6] * w.nx + ni[7] * w.ny + ni[8] * w.nz;
                const float flip = (wnx * Dx + wny * Dy + wnz * Dz > 0.0f) ? -1.0f : 1.0f;
                wnx *= flip;
                wny *= flip;
                wnz *= flip;

                // transfer + fudged reflect (fs:65-96)
                const float rPx = Px + t * Dx + wnx * fudge;
                const float rPy = Py + t * Dy + wny * fudge;
                const float rPz = Pz + t * Dz + wnz * fudge;
                const float ddn = Dx * wnx + Dy * wny + Dz * wnz;
                const float rDx = Dx - 2.0f * ddn * wnx;
                const float rDy = Dy - 2.0f * ddn * wny;
                const float rDz = Dz - 2.0f * ddn * wnz;

                // Schlick in (view . reflected) half-angle form (fs:479-482)
                const float h = (Dx * rDx + Dy * rDy + Dz * rDz) * 0.5f + 0.5f;
                const float h2 = h * h;
                const float fres = h2 * h2 * h;

                if (diffuse) {
                    const float lcos = fmaxf(wnx * Lx + wny * Ly + wnz * Lz, 0.0f);
                    float irr = lcos;
                    if (shadows && lcos > 0.0f) {
                        cnt[0] += 1;
                        const float sPx = m[0] * rPx + m[1] * rPy + m[2] * rPz + m[3];
                        const float sPy = m[4] * rPx + m[5] * rPy + m[6] * rPz + m[7];
                        const float sPz = m[8] * rPx + m[9] * rPy + m[10] * rPz + m[11];
                        const Walk sw = walk<false>(s, sPx, sPy, sPz, oLx, oLy, oLz, true, stack);
                        cnt[ph + 3] += sw.steps;
                        cnt[ph + 4] += sw.leafs;
                        cnt[ph + 5] += sw.tris;
                        bad |= sw.bad;
                        irr = lcos * (sw.t >= INFINITELY_FAR ? 1.0f : 0.0f);
                    }
                    acc0 = acc0 + mod0 * u[UNI_DIFFUSE] * irr;
                    acc1 = acc1 + mod1 * u[UNI_DIFFUSE + 1] * irr;
                    acc2 = acc2 + mod2 * u[UNI_DIFFUSE + 2] * irr;
                }
                const float c0 = u[UNI_SPECULAR], c1 = u[UNI_SPECULAR + 1], c2 = u[UNI_SPECULAR + 2];
                mod0 = mod0 * (c0 + (1.0f - c0) * fres);
                mod1 = mod1 * (c1 + (1.0f - c1) * fres);
                mod2 = mod2 * (c2 + (1.0f - c2) * fres);
                Px = rPx; Py = rPy; Pz = rPz;
                Dx = rDx; Dy = rDy; Dz = rDz;
            }

            float col0 = 1.0f, col1 = 0.0f, col2 = 0.0f;  // bad-ray paint
            if (!bad) {
                // env term: u = 1 + atan2(-z, x)/tau, v = 1 - acos(y)/pi
                // (envmap.py:36-41), level-0 bilinear, REPEAT wrap
                const float eu = 1.0f + atan2f(-Dz, Dx) / TAU_REF;
                const float ev = 1.0f - acosf(fminf(fmaxf(Dy, -1.0f), 1.0f)) / PI_REF;
                const float x = eu * (float)ew - 0.5f;
                const float y = (1.0f - ev) * (float)eh - 0.5f;
                const float x0 = floorf(x), y0 = floorf(y);
                const float fx = x - x0, fy = y - y0;
                int xi0 = (int)x0 % ew; if (xi0 < 0) xi0 += ew;
                int yi0 = (int)y0 % eh; if (yi0 < 0) yi0 += eh;
                const int xi1 = xi0 + 1 == ew ? 0 : xi0 + 1;
                const int yi1 = yi0 + 1 == eh ? 0 : yi0 + 1;
                const float* r0 = env + (size_t)yi0 * ew * 3;
                const float* r1 = env + (size_t)yi1 * ew * 3;
                float e[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float top = __ldg(r0 + xi0 * 3 + c) * (1.0f - fx) + __ldg(r0 + xi1 * 3 + c) * fx;
                    const float bot = __ldg(r1 + xi0 * 3 + c) * (1.0f - fx) + __ldg(r1 + xi1 * 3 + c) * fx;
                    e[c] = top * (1.0f - fy) + bot * fy;
                }
                col0 = acc0 + mod0 * e[0];
                col1 = acc1 + mod1 * e[1];
                col2 = acc2 + mod2 * e[2];
            }
            sum0 += col0;
            sum1 += col1;
            sum2 += col2;
        }
        float* o = out + pix * 3;
        o[0] = sum0 / (float)K;
        o[1] = sum1 / (float)K;
        o[2] = sum2 / (float)K;
    }

    // counters: warp shuffle sums, then one 64-bit atomic per block
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = 0; c < n_counters; ++c) {
        unsigned long long v = cnt[c];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][c] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n_counters; c += BLOCK) {
        unsigned long long v = 0;
        for (int wi = 0; wi < BLOCK / 32; ++wi) v += red[wi][c];
        if (v) atomicAdd(counters + c, v);
    }
}

}  // namespace

extern "C" int srt_frame_kernel(
    const float* boxes, const int* meta, const float* leaves,
    const float* env, int env_h, int env_w,
    const float* uni, const float* jitters, int K, int W, int H,
    float inv_w, float inv_h, float aspect,
    int bounces, int shadows, int diffuse, float fudge, float mt_eps,
    int max_steps, int stack_depth,
    float* out, unsigned long long* counters, void* stream) {
    const bool cast = shadows != 0 && diffuse != 0;
    const int phases = bounces * (cast ? 2 : 1);
    if (K < 1 || W < 1 || H < 1 || bounces < 0 || phases > MAX_PHASES ||
        stack_depth < 1 || stack_depth > MAX_STACK || env_h < 1 || env_w < 1)
        return (int)cudaErrorInvalidValue;
    Scene s{boxes, meta, leaves, stack_depth, max_steps, mt_eps};
    const long long n = (long long)W * H;
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    frame<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        s, env, env_h, env_w, uni, jitters, K, W, H, inv_w, inv_h, aspect,
        bounces, cast, diffuse != 0, fudge, 1 + 3 * phases, out, counters);
    return (int)cudaGetLastError();
}
