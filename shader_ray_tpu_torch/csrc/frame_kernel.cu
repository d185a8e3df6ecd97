// Fused frame kernel for Hopper (sm_90a): K jittered samples of every
// pixel — pinhole raygen, `bounces` x (closest-hit 8-wide BVH walk,
// Schlick/Lambert shading, lcos-gated any-hit shadow walk), the lat-long
// env term, bad-ray paint — and their linear mean, in one launch.
//
// Replaces the TPU kernel mega_kernel
// (shader_ray_tpu/ops/pallas/kernel_mega.py, pallas_call in
// packet_mega.packet_shade) with its walker make_wide_walker
// (kernel_wide.py), leaf math slot_hit/slot_normal/safe_inv
// (kernel_body.py) and fused env sampler env_window_body /
// env_coords_kernel (envwin.py, trig.py), in both of its forms:
//   which = 0        level-0 bilinear env term, no ray differentials;
//   which = 1        with_grads: raygen seeds dDdx / dDdy
//                    (kernel_mega.py:221-232), each hit transfers them
//                    with the fs:92-93 quirk (:356-366), and the env term
//                    is textureGrad's trilinear, with aniso probes when
//                    aniso > 1 (:407-453);
//   which = 2        with_grads, the dY-differential picture (:393-404).
// One kernel a mode (template argument ENV), so the which = 0 kernel
// carries no differential state.  Each mode also has a given-rays form
// (template argument GIVEN; kernel_mega.py:172-173, :233-241): instead of
// raygen, sample k of pixel p reads P[p] (shared by the K sets), D[k][p]
// and, in the grad modes, dDdx[k][p] and dDdy[k][p] from memory; the
// fused which = 5 frame sends its 25 sub-ray sets through it as one
// launch (the reference's engine_pallas.py:665-702).  Each mode and form
// also has both leaf test forms of the walk (template argument ISECT,
// Config.leaf_isect: Woop test rows, or Moller-Trumbore on v0 and the two
// edges, kernel_mega.py:85 / kernel_body.slot_hit; walk.cuh).  Lane retirement
// (min_contrib > 0, kernel_mega.py:368-381): after a bounce before the
// last, a hit lane whose Schlick modulation is <= min_contrib in every
// component leaves the live set; its shadow ray of that bounce was cast,
// and its env term uses its current direction and modulation.  The grad modes keep the six
// differential floats of each slot in shared memory after the stack
// (+6 KB a block) and read the env through env.cuh's radiance<>, after
// the last barrier of a sample, where the walk's registers are dead.
//
// What bounds it here: operations and the latency of dependent loads in
// divergent walks, not bytes.  The scene (node table + Woop records,
// ~8 MB at 69k triangles) and the env texels a frame reads stay in the
// 50 MB L2; the work is ~200 f32 ops per node pop and ~50 per triangle
// test, in dependent chains with data-dependent branches.  The first design (one
// thread walking one pixel through all its bounces, counters and stack
// in local memory) took 2.64 ms a bench frame where six separate trace
// launches of the same rays took 1.14: a warp waited for its slowest
// pixel through every bounce, and the counter array and the stack
// spilled.  This design (1.06 ms; 1.01 ms with the walk's split leaf
// records, H100 80GB HBM3 at 700 W; PERF.md):
//   * bounces in waves: a block owns a tile of 256 pixels (one thread a
//     pixel) for all K samples: w x 256/w pixels, w = 8, 16 (the
//     default), 32 or 64, and either thread t at (t mod w, t div w) of
//     the tile ("rows", the default) or each warp on an 8x4 brick of it
//     ("bricks"); the launch picks both (Config.frame_tile, frame_warp),
//     and they move only which thread walks which pixel.  Each walk phase compacts the tile's
//     live rays into a dense queue in shared memory (warp ballot + a
//     prefix over the block's warps), so busy lanes walk live rays and
//     dead rays leave whole warps idle;
//   * the ray state (P, D, acc, mod, pending diffuse, bad) lives in
//     shared memory between phases; shading runs right after each
//     closest-hit walk, and only hits with lcos > 0 enter the shadow
//     queue;
//   * the whole stack is in shared memory, entry i of a thread at
//     stack[i * BLOCK + tid] (a lane keeps its own bank whatever its
//     depth): stack_depth * 1 KB a block, 64 KB at the bench scene;
//   * walk counters stay in registers for one walk, are summed over the
//     warp with shuffles into a per-phase counter in shared memory, and
//     leave the block with one 64-bit atomic per counter;
//   * nodes and Woop test rows are read with 16-byte loads, a hit's
//     normal terms once a walk (walk.cuh).
// What holds it now: 107 registers (which = 0 raygen; 100-125 over the
// modes and forms; each slot's pixel index waits in shared memory, so the
// walks' registers do not carry it, while its float coordinates stay in
// registers, which keeps raygen's FMA contractions) and the 64 KB stack
// (+6 KB of differentials in the grad modes)
// allow 2 blocks (16 warps) an SM, and a block waits at each phase's
// barrier for its slowest walk.  Blocks of 128, 64 and 512 threads (16x8,
// 16x4, 32x8, 32x16 and 16x32 tiles), part of the stack in local memory,
// fewer registers and persistent blocks were all slower or no faster
// (PERF.md section 6).
//
// Sums are deterministic: a pixel's owner thread adds its samples in
// order k = 0..K-1 and writes their mean (no atomics on colour).
// Counters (rays cast; per walk phase node pops, leaf visits, triangle
// tests) are exact; a block can also write its own tile's row of them
// (the stats fn), which needs no atomics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (accurate atan2f/acosf/sqrtf/div:
//        no fast math).  Entry points: srt_frame_kernel,
//        srt_frame_kernel_info (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

#include "env.cuh"
#include "walk.cuh"

namespace {

using namespace srt;  // Scene, Walk, walk(), the table constants (walk.cuh); the env lookup (env.cuh)

constexpr int LOG2_BLOCK = 8;
constexpr int BLOCK = 1 << LOG2_BLOCK;  // one thread a pixel of the tile
constexpr int WARPS = BLOCK / 32;
// the tile's width, log2: 8 to 64 pixels, so its height (BLOCK / width)
// holds whole 8x4 bricks
constexpr int LOG2_TILE_MIN = 3, LOG2_TILE_MAX = 6;
constexpr int WARP_ROWS = 0, WARP_BRICKS = 1;  // the warp maps
constexpr int MAX_PHASES = 16;
constexpr int N_COUNTERS = 1 + 3 * MAX_PHASES;
static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "a tile is whole warps");

// the env modes of a frame: BILINEAR (which = 0), GRAD and PROBES
// (which = 1, aniso 1 or more; env.cuh), and the dY picture (which = 2)
constexpr int DY_PICTURE = 3;
constexpr int N_MODES = 4;
constexpr int N_GRAD = 6;  // differential floats a ray: dDdx.xyz, dDdy.xyz

// dynamic shared bytes of a block: the stack, then in the grad modes
// the slots' differentials
constexpr size_t smem_bytes(int mode, int stack_depth) {
    return ((size_t)stack_depth + (mode == BILINEAR ? 0 : N_GRAD)) * BLOCK * sizeof(int);
}

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
constexpr int UNI_JITTER = 52;  // a single frame's jitter (x, y), after the uniforms
constexpr int UNI_BLOCK = 54;

// The uniforms and a single frame's jitter, passed by value: the launch
// copies them into the kernel's parameters, so a frame uploads no table
// (216 bytes of the 4 KB a launch's parameters may take)
struct Uniforms {
    float f[UNI_BLOCK];
};

// ray flags a walker leaves for the slot's owner
constexpr unsigned char ALIVE = 1;    // hit: bounces on
constexpr unsigned char SHADOW = 2;   // and casts a shadow ray first
constexpr unsigned char RETIRED = 4;  // but its modulation is spent: no next bounce

// A thread's stack in shared memory: entry i at sh[i * BLOCK], so the
// lanes of a warp touch 32 different banks whatever their depths.
struct BlockStack {
    int* sh;
    __device__ __forceinline__ int get(int i) const { return sh[i * BLOCK]; }
    __device__ __forceinline__ void set(int i, int v) { sh[i * BLOCK] = v; }
};

// The owners of the flagged slots, in slot order, into q[0..n); returns
// n.  Every thread of the block calls it.
__device__ __forceinline__ int compact(bool flag, short* q, int* wcount) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int c = wcount[w];
        off += w < warp ? c : 0;
        total += c;
    }
    if (flag) q[off + __popc(m & ((1u << lane) - 1u))] = (short)tid;
    __syncthreads();
    return total;
}

// one walk's counts into the block's per-phase counters (ph = node
// pops, ph + 1 leaf visits, ph + 2 triangle tests)
__device__ __forceinline__ void count(unsigned long long* cnt, int ph,
                                      unsigned steps, unsigned leafs, unsigned tris) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        steps += __shfl_down_sync(0xffffffffu, steps, off);
        leafs += __shfl_down_sync(0xffffffffu, leafs, off);
        tris += __shfl_down_sync(0xffffffffu, tris, off);
    }
    if ((threadIdx.x & 31) == 0 && steps) {
        atomicAdd(cnt + ph, (unsigned long long)steps);
        atomicAdd(cnt + ph + 1, (unsigned long long)leafs);
        atomicAdd(cnt + ph + 2, (unsigned long long)tris);
    }
}

// (BLOCK, 1): ptxas then keeps the walk's loads in flight without
// spilling (106-125 registers over the modes); with (BLOCK) alone it
// chose 80 registers and spilled 76 bytes in an earlier form of this
// kernel
// GIVEN: the given-rays form; rays = P (W*H, 3), D and in the grad modes
// dDdx, dDdy (K, W*H, 3), pixel-major rows
struct GivenRays {
    const float* P;
    const float* D;
    const float* gx;
    const float* gy;
};

template <int ENV, bool GIVEN, int ISECT>
__global__ void __launch_bounds__(BLOCK, 1)
frame(Scene s, const float4* __restrict__ env, Levels lv, float aniso,
      const Uniforms uni, const float* __restrict__ jit, GivenRays rays, int K,
      int W, int H, int tiles_x, int log2w, int warp_map,
      float inv_w, float inv_h, float aspect, int bounces,
      bool shadows, bool diffuse, float fudge, float min_contrib, int n_counters,
      float* __restrict__ out, unsigned long long* __restrict__ counters,
      unsigned long long* __restrict__ rows) {
    constexpr bool GRADS = ENV != BILINEAR;
    __shared__ float u[UNI_BLOCK];
    __shared__ unsigned long long cnt[N_COUNTERS];
    // ray state of the tile's slots (slot = owner thread = pixel)
    __shared__ float sP[3][BLOCK], sD[3][BLOCK], sAcc[3][BLOCK], sMod[3][BLOCK];
    __shared__ float sMd[3][BLOCK], sLcos[BLOCK];  // pending diffuse: mod * diffuse, lcos
    __shared__ unsigned char sFlag[BLOCK], sBad[BLOCK];
    __shared__ short q[BLOCK];
    __shared__ int wcount[WARPS];
    __shared__ int sPix[BLOCK];  // each slot's pixel, y * W + x; -1 outside the frame
    extern __shared__ int stack_sh[];  // (stack_depth, BLOCK); grad modes: then (N_GRAD, BLOCK) floats
    // grad modes: the slots' dDdx (rows 0-2) and dDdy (rows 3-5)
    float* const sG = reinterpret_cast<float*>(stack_sh + s.stack_depth * BLOCK);

    const int tid = threadIdx.x;
    if (tid == 0) {
        // constant indices: the parameters are read in place, never copied
        // to local memory
#pragma unroll
        for (int i = 0; i < UNI_BLOCK; ++i) u[i] = uni.f[i];
    }
    for (int c = tid; c < N_COUNTERS; c += BLOCK) cnt[c] = 0;
    __syncthreads();

    BlockStack stack;
    stack.sh = stack_sh + tid;
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

    {
        // this thread's pixel: tile (tx, ty) of the w x 256/w tiles,
        // w = 2^log2w, and in it (lx, ly) by the warp map
        const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
        int lx, ly;
        if (warp_map == WARP_BRICKS) {
            // warp v on the brick (v mod w/8, v div w/8), lane l at (l mod 8, l div 8) in it
            const int v = tid >> 5, l = tid & 31, lb = log2w - 3;
            lx = ((v & ((1 << lb) - 1)) << 3) | (l & 7);
            ly = ((v >> lb) << 2) | (l >> 3);
        } else {
            lx = tid & ((1 << log2w) - 1);
            ly = tid >> log2w;
        }
        const int px = (tx << log2w) + lx;
        const int py = (ty << (LOG2_BLOCK - log2w)) + ly;
        // read back where it is needed, so no register holds it through the walks
        sPix[tid] = px < W && py < H ? py * W + px : -1;
        const float iif = (float)px, jf = (float)py;
        float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f;
        for (int k = 0; k < K; ++k) {
            const int pixel = sPix[tid];
            const bool valid = pixel >= 0;
            if (valid && GIVEN) {
                // given rays (kernel_mega.py:233-241): P of the pixel, D and
                // the differentials of sample k
                const size_t pix = (size_t)pixel;
                const size_t r = (size_t)k * W * H + pix;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    sP[c][tid] = __ldg(rays.P + 3 * pix + c);
                    sD[c][tid] = __ldg(rays.D + 3 * r + c);
                    if constexpr (GRADS) {
                        sG[c * BLOCK + tid] = __ldg(rays.gx + 3 * r + c);
                        sG[(3 + c) * BLOCK + tid] = __ldg(rays.gy + 3 * r + c);
                    }
                    sAcc[c][tid] = 0.0f;
                    sMod[c][tid] = 1.0f;
                }
            } else if (valid) {
                // pinhole raygen (kernel_mega.py:203-220), two normalisations;
                // sample k's jitter from the table, or a single frame's from
                // the uniforms
                const float jx = jit ? __ldg(jit + 2 * k) : u[UNI_JITTER];
                const float jy = jit ? __ldg(jit + 2 * k + 1) : u[UNI_JITTER + 1];
                const float uu = (iif + 0.5f + jx) * inv_w;
                const float vv = 1.0f - (jf + 0.5f + jy) * inv_h;
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
                sD[0][tid] = Dx;
                sD[1][tid] = Dy;
                sD[2][tid] = Dz;
                if constexpr (GRADS) {
                    // seeded differentials (kernel_mega.py:221-232): the camera
                    // matrix's columns at the image plane's pixel spacing
                    const float sx = ipw * inv_w, sy = (ipw * aspect) * inv_h;
                    const float rx = cmx[0] * sx, ry = cmx[3] * sx, rz = cmx[6] * sx;
                    const float ux = cmx[1] * sy, uy = cmx[4] * sy, uz = cmx[7] * sy;
                    const float dr = Dx * rx + Dy * ry + Dz * rz;
                    const float du = Dx * ux + Dy * uy + Dz * uz;
                    sG[0 * BLOCK + tid] = rx - dr * Dx;
                    sG[1 * BLOCK + tid] = ry - dr * Dy;
                    sG[2 * BLOCK + tid] = rz - dr * Dz;
                    sG[3 * BLOCK + tid] = ux - du * Dx;
                    sG[4 * BLOCK + tid] = uy - du * Dy;
                    sG[5 * BLOCK + tid] = uz - du * Dz;
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    sP[c][tid] = u[UNI_CAM_ORIGIN + c];
                    sAcc[c][tid] = 0.0f;
                    sMod[c][tid] = 1.0f;
                }
            }
            sBad[tid] = 0;
            bool live = valid;  // this slot's ray still bounces

            for (int b = 0; b < bounces; ++b) {
                // closest-hit phase over the live rays, shading after each walk
                const int n = compact(live, q, wcount);
                if (n == 0) break;
                const int ph = 1 + 3 * (phase_stride * b);
                if (tid == 0) cnt[0] += (unsigned long long)n;
                unsigned st = 0, lf = 0, tr = 0;
                if (tid < n) {
                    const int r = q[tid];
                    const float Px = sP[0][r], Py = sP[1][r], Pz = sP[2][r];
                    const float Dx = sD[0][r], Dy = sD[1][r], Dz = sD[2][r];
                    const float oPx = m[0] * Px + m[1] * Py + m[2] * Pz + m[3];
                    const float oPy = m[4] * Px + m[5] * Py + m[6] * Pz + m[7];
                    const float oPz = m[8] * Px + m[9] * Py + m[10] * Pz + m[11];
                    const float oDx = nm[0] * Dx + nm[1] * Dy + nm[2] * Dz;
                    const float oDy = nm[3] * Dx + nm[4] * Dy + nm[5] * Dz;
                    const float oDz = nm[6] * Dx + nm[7] * Dy + nm[8] * Dz;
                    const Walk w = walk<false, false, ISECT>(s, oPx, oPy, oPz, oDx, oDy, oDz, stack);
                    st = w.steps;
                    lf = w.leafs;
                    tr = w.tris;
                    unsigned char flag = 0;
                    if (w.bad) {
                        sBad[r] = 1;
                    } else if (w.t < INFINITELY_FAR) {
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
                        sP[0][r] = Px + t * Dx + wnx * fudge;
                        sP[1][r] = Py + t * Dy + wny * fudge;
                        sP[2][r] = Pz + t * Dz + wnz * fudge;
                        const float ddn = Dx * wnx + Dy * wny + Dz * wnz;
                        const float rDx = Dx - 2.0f * ddn * wnx;
                        const float rDy = Dy - 2.0f * ddn * wny;
                        const float rDz = Dz - 2.0f * ddn * wnz;

                        // Schlick in (view . reflected) half-angle form (fs:479-482)
                        const float h = (Dx * rDx + Dy * rDy + Dz * rDz) * 0.5f + 0.5f;
                        const float h2 = h * h;
                        const float fres = h2 * h2 * h;
                        sD[0][r] = rDx;
                        sD[1][r] = rDy;
                        sD[2][r] = rDz;
                        if constexpr (GRADS) {
                            // the fs:92-93 quirk kept verbatim: the SCALAR
                            // 2 dot(dD, n) off each component (kernel_mega.py:356-366)
#pragma unroll
                            for (int g = 0; g < N_GRAD; g += 3) {
                                float* d = sG + g * BLOCK + r;
                                const float gd = d[0] * wnx + d[BLOCK] * wny + d[2 * BLOCK] * wnz;
                                d[0] = d[0] - 2.0f * gd;
                                d[BLOCK] = d[BLOCK] - 2.0f * gd;
                                d[2 * BLOCK] = d[2 * BLOCK] - 2.0f * gd;
                            }
                        }

                        flag = ALIVE;
                        if (diffuse) {
                            const float lcos = fmaxf(wnx * Lx + wny * Ly + wnz * Lz, 0.0f);
                            if (shadows && lcos > 0.0f) {
                                // irr = lcos unless the shadow walk finds a hit
                                flag |= SHADOW;
                                sLcos[r] = lcos;
#pragma unroll
                                for (int c = 0; c < 3; ++c) sMd[c][r] = sMod[c][r] * u[UNI_DIFFUSE + c];
                            } else {
#pragma unroll
                                for (int c = 0; c < 3; ++c)
                                    sAcc[c][r] = sAcc[c][r] + sMod[c][r] * u[UNI_DIFFUSE + c] * lcos;
                            }
                        }
                        float mo[3];
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            const float sc = u[UNI_SPECULAR + c];
                            mo[c] = sMod[c][r] * (sc + (1.0f - sc) * fres);
                            sMod[c][r] = mo[c];
                        }
                        // throughput cutoff (kernel_mega.py:368-381): a NaN
                        // modulation retires too, as the reference's `>` tests
                        if (min_contrib > 0.0f && b + 1 < bounces &&
                            !(mo[0] > min_contrib || mo[1] > min_contrib || mo[2] > min_contrib))
                            flag |= RETIRED;
                    }
                    sFlag[r] = flag;
                }
                count(cnt, ph, st, lf, tr);
                __syncthreads();
                const unsigned char f = sFlag[tid];
                const bool hit = live && (f & ALIVE);
                live = hit && !(f & RETIRED);
                if (!shadows) continue;

                // any-hit phase over the light-facing hits, retired ones included
                const int ns = compact(hit && (f & SHADOW), q, wcount);
                if (ns == 0) continue;
                if (tid == 0) cnt[0] += (unsigned long long)ns;
                st = lf = tr = 0;
                if (tid < ns) {
                    const int r = q[tid];
                    const float Px = sP[0][r], Py = sP[1][r], Pz = sP[2][r];
                    const float sPx = m[0] * Px + m[1] * Py + m[2] * Pz + m[3];
                    const float sPy = m[4] * Px + m[5] * Py + m[6] * Pz + m[7];
                    const float sPz = m[8] * Px + m[9] * Py + m[10] * Pz + m[11];
                    const Walk sw = walk<false, true, ISECT>(s, sPx, sPy, sPz, oLx, oLy, oLz, stack);
                    st = sw.steps;
                    lf = sw.leafs;
                    tr = sw.tris;
                    if (sw.bad) sBad[r] = 1;
                    const float irr = sLcos[r] * (sw.t >= INFINITELY_FAR ? 1.0f : 0.0f);
#pragma unroll
                    for (int c = 0; c < 3; ++c) sAcc[c][r] = sAcc[c][r] + sMd[c][r] * irr;
                }
                count(cnt, ph + 3, st, lf, tr);
            }
            __syncthreads();
            if (sPix[tid] >= 0) {
                float col0 = 1.0f, col1 = 0.0f, col2 = 0.0f;  // bad-ray paint
                if (!sBad[tid]) {
                    const float Dx = sD[0][tid], Dy = sD[1][tid], Dz = sD[2][tid];
                    float g[N_GRAD] = {};
                    if constexpr (GRADS) {
#pragma unroll
                        for (int c = 0; c < N_GRAD; ++c) g[c] = sG[c * BLOCK + tid];
                    }
                    float3 e;
                    if constexpr (ENV == DY_PICTURE) {
                        // |du/dy|, |dv/dy| x 100 (kernel_mega.py:393-404, fs:147-149)
                        const float denom_u = TAU_REF * (Dx * Dx + Dz * Dz);
                        const float denom_v = PI_REF * sqrtf(max_nan(1.0f - Dy * Dy, 1e-12f));
                        e = make_float3(fabsf((Dx * g[5] - Dz * g[3]) / denom_u) * 100.0f,
                                        fabsf(g[4] / denom_v) * 100.0f, 0.0f);
                    } else {
                        // the env lookup of this mode (env.cuh)
                        e = radiance<ENV>(env, lv, Dx, Dy, Dz, g[0], g[1], g[2], g[3], g[4], g[5],
                                          aniso);
                    }
                    col0 = sAcc[0][tid] + sMod[0][tid] * e.x;
                    col1 = sAcc[1][tid] + sMod[1][tid] * e.y;
                    col2 = sAcc[2][tid] + sMod[2][tid] * e.z;
                }
                sum0 += col0;
                sum1 += col1;
                sum2 += col2;
            }
        }
        if (sPix[tid] >= 0) {
            float* o = out + (size_t)sPix[tid] * 3;
            o[0] = sum0 / (float)K;
            o[1] = sum1 / (float)K;
            o[2] = sum2 / (float)K;
        }
    }

    // counters: the block's row where asked, and one 64-bit atomic per
    // counter and block into the frame's
    __syncthreads();
    for (int c = tid; c < n_counters; c += BLOCK) {
        if (rows) rows[(size_t)blockIdx.x * n_counters + c] = cnt[c];
        if (cnt[c]) atomicAdd(counters + c, cnt[c]);
    }
}

using Kernel = void (*)(Scene, const float4*, Levels, float, Uniforms, const float*, GivenRays,
                        int, int, int, int, int, int, float, float, float, int, bool, bool, float,
                        float, int, float*, unsigned long long*, unsigned long long*);
// [isect][form][mode]: isect 0 Woop, 1 Moller-Trumbore (walk.cuh); form 0
// raygen, 1 given rays
constexpr int N_ISECT = 2;
const Kernel KERNELS[N_ISECT][2][N_MODES] = {
    {{frame<BILINEAR, false, ISECT_WOOP>, frame<GRAD, false, ISECT_WOOP>,
      frame<PROBES, false, ISECT_WOOP>, frame<DY_PICTURE, false, ISECT_WOOP>},
     {frame<BILINEAR, true, ISECT_WOOP>, frame<GRAD, true, ISECT_WOOP>,
      frame<PROBES, true, ISECT_WOOP>, frame<DY_PICTURE, true, ISECT_WOOP>}},
    {{frame<BILINEAR, false, ISECT_MT>, frame<GRAD, false, ISECT_MT>,
      frame<PROBES, false, ISECT_MT>, frame<DY_PICTURE, false, ISECT_MT>},
     {frame<BILINEAR, true, ISECT_MT>, frame<GRAD, true, ISECT_MT>,
      frame<PROBES, true, ISECT_MT>, frame<DY_PICTURE, true, ISECT_MT>}},
};

// The stack's dynamic shared memory is above the 48 KB a launch gets
// without asking: raise each kernel's limit to what MAX_STACK entries
// (and its differentials) take, once a device (a launch still asks only
// for its scene's depth).
cudaError_t allow_stack_smem() {
    static std::atomic<unsigned long long> raised{0};  // bit d: device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (raised.load() & bit) return cudaSuccess;
    for (int i = 0; i < N_ISECT * 2 * N_MODES && err == cudaSuccess; ++i)
        err = cudaFuncSetAttribute(KERNELS[i / (2 * N_MODES)][i / N_MODES % 2][i % N_MODES],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(i % N_MODES, MAX_STACK));
    if (err == cudaSuccess) raised.fetch_or(bit);
    return err;
}

// log2 of a tile width of 8, 16, 32 or 64 pixels; -1 for any other
int log2_tile(int tile_w) {
    for (int l = LOG2_TILE_MIN; l <= LOG2_TILE_MAX; ++l)
        if (tile_w == 1 << l) return l;
    return -1;
}

// the kernel of a frame's which (0, 1, 2) and aniso; -1 if none
int env_mode(int which, int aniso) {
    if (aniso < 1) return -1;
    return which == 0 ? BILINEAR : which == 1 ? (aniso > 1 ? PROBES : GRAD)
         : which == 2 ? DY_PICTURE : -1;
}

}  // namespace

// env: the pyramid's texels; levels: host array of n_levels (texel
// offset, height, width) rows, level 0 first.  block: host array of
// UNI_BLOCK floats, the uniforms and a single frame's jitter, copied into
// the launch's parameters before this returns (the caller may rewrite it
// at once).  jitters: the (K, 2) device table for raygen, or null with
// K = 1 for the block's jitter, or null with given rays: rays_P (W*H, 3),
// rays_D (K, W*H, 3) and in the grad modes rays_gx, rays_gy (K, W*H, 3).
// min_contrib: the lane retirement threshold, 0 = none.  counters: the
// (1 + 3 * phases) counter row, zeroed here on the stream before the
// launch.  rows: null, or
// the (tiles, 1 + 3 * phases) per-tile counter rows.  isect: the leaves'
// form, 0 Woop or 1 Moller-Trumbore.  tile_w: the tile's width, 8, 16, 32
// or 64 pixels (its height 256 / tile_w; tiles row-major, and rows so);
// warp_map: 0 rows, 1 8x4 bricks.
extern "C" int srt_frame_kernel(
    const float* nodes, const float* leaves, const float* normals, int isect,
    const void* env, const int* levels, int n_levels, int which, int aniso,
    const float* block, const float* jitters,
    const float* rays_P, const float* rays_D, const float* rays_gx, const float* rays_gy,
    int K, int W, int H,
    float inv_w, float inv_h, float aspect,
    int bounces, int shadows, int diffuse, float fudge, float mt_eps, float min_contrib,
    int max_steps, int stack_depth, int tile_w, int warp_map,
    float* out, unsigned long long* counters, unsigned long long* rows, void* stream) {
    const bool cast = shadows != 0 && diffuse != 0;
    const int phases = bounces * (cast ? 2 : 1);
    const int mode = env_mode(which, aniso);
    const bool given = rays_D != nullptr;
    const bool grads = mode != BILINEAR;
    const int log2w = log2_tile(tile_w);
    Levels lv;
    if (log2w < 0 || (warp_map != WARP_ROWS && warp_map != WARP_BRICKS) ||
        K < 1 || W < 1 || H < 1 || bounces < 0 || phases > MAX_PHASES ||
        stack_depth < 1 || stack_depth > MAX_STACK || mode < 0 || !env_levels(levels, n_levels, lv) ||
        !(min_contrib >= 0.0f) || isect < 0 || isect >= N_ISECT || block == nullptr ||
        (given ? (rays_P == nullptr || jitters != nullptr ||
                  (grads && (rays_gx == nullptr || rays_gy == nullptr)))
               : jitters == nullptr && K != 1))
        return (int)cudaErrorInvalidValue;
    Uniforms uni;
    memcpy(uni.f, block, sizeof uni.f);
    cudaError_t err = allow_stack_smem();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(counters, 0, (size_t)(1 + 3 * phases) * sizeof(unsigned long long),
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    const int tile_h = BLOCK >> log2w;
    const int tiles_x = (W + tile_w - 1) / tile_w;
    const unsigned grid = (unsigned)tiles_x * (unsigned)((H + tile_h - 1) / tile_h);
    Scene s{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(leaves),
            reinterpret_cast<const float4*>(normals), stack_depth, max_steps, mt_eps};
    const GivenRays rays{rays_P, rays_D, rays_gx, rays_gy};
    KERNELS[isect][given][mode]<<<grid, BLOCK, smem_bytes(mode, stack_depth), (cudaStream_t)stream>>>(
        s, static_cast<const float4*>(env), lv, (float)aniso, uni, jitters, rays, K, W, H, tiles_x,
        log2w, warp_map, inv_w, inv_h, aspect, bounces, cast, diffuse != 0, fudge, min_contrib,
        1 + 3 * phases,
        out, counters, rows);
    return (int)cudaGetLastError();
}

// The launch's resources of the kernel of env mode 0 (which = 0), 1
// (which = 1, aniso 1), 2 (which = 1, aniso > 1) or 3 (which = 2) in
// form 0 (raygen) or 1 (given rays) with leaf test isect (0 Woop, 1
// Moller-Trumbore) for a scene's stack bound, launched with tiles tile_w
// pixels wide and warp map warp_map (as srt_frame_kernel takes them), into
// info[0..8): registers a thread, static shared bytes, local bytes a
// thread (stack frame), dynamic shared bytes (the stack and the
// differentials), resident blocks an SM, threads a block, tile width,
// tile height.
extern "C" int srt_frame_kernel_info(int stack_depth, int mode, int given, int isect, int tile_w,
                                     int warp_map, int* info) {
    const int log2w = log2_tile(tile_w);
    if (stack_depth < 1 || stack_depth > MAX_STACK || mode < 0 || mode >= N_MODES || given < 0 ||
        given > 1 || isect < 0 || isect >= N_ISECT || log2w < 0 ||
        (warp_map != WARP_ROWS && warp_map != WARP_BRICKS))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(mode, stack_depth);
    cudaError_t err = allow_stack_smem();
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    const Kernel k = KERNELS[isect][given][mode];
    if ((err = cudaFuncGetAttributes(&a, k)) != cudaSuccess) return (int)err;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, BLOCK,
                                                             smem)) !=
        cudaSuccess)
        return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = (int)smem;
    info[4] = per_sm;
    info[5] = BLOCK;
    info[6] = tile_w;
    info[7] = BLOCK >> log2w;
    return 0;
}
