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
// env_coords_kernel (envwin.py, trig.py), for which = 0.
//
// What bounds it here: operations and the latency of dependent loads in
// divergent walks, not bytes.  The scene (node table + Woop records,
// ~8 MB at 69k triangles) and the 25 MB env level stay in the 50 MB L2;
// the work is ~200 f32 ops per node pop and ~50 per triangle test, in
// dependent chains with data-dependent branches.  The first design (one
// thread walking one pixel through all its bounces, counters and stack
// in local memory) took 2.64 ms a bench frame where six separate trace
// launches of the same rays took 1.14: a warp waited for its slowest
// pixel through every bounce, and the counter array and the stack
// spilled.  This design (1.06 ms; PERF.md):
//   * bounces in waves: a block owns a 16x16 tile of pixels (one thread
//     a pixel) for all K samples.  Each walk phase compacts the tile's
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
//   * nodes and Woop records are read with 16-byte loads (walk.cuh).
// What holds it now: 107 registers and the 64 KB stack allow 2 blocks
// (16 warps) an SM, and a block waits at each phase's barrier for its
// slowest walk.  Tiles of 16x8, 16x4, 32x8, 32x16 and 16x32, part of
// the stack in local memory, fewer registers and persistent blocks were
// all slower or no faster (PERF.md section 6).
//
// Sums are deterministic: a pixel's owner thread adds its samples in
// order k = 0..K-1 and writes their mean (no atomics on colour).
// Counters (rays cast; per walk phase node pops, leaf visits, triangle
// tests) are exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (accurate atan2f/acosf/sqrtf/div:
//        no fast math).  Entry points: srt_frame_kernel,
//        srt_frame_kernel_info (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "walk.cuh"

namespace {

using namespace srt;  // Scene, Walk, walk(), the table constants (walk.cuh)

constexpr int TILE_W = 16, TILE_H = 16;
constexpr int BLOCK = TILE_W * TILE_H;  // one thread a pixel of the tile
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_PHASES = 16;
constexpr int N_COUNTERS = 1 + 3 * MAX_PHASES;
static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "a tile is whole warps");

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

// ray flags a walker leaves for the slot's owner
constexpr unsigned char ALIVE = 1;   // hit: bounces on
constexpr unsigned char SHADOW = 2;  // and casts a shadow ray first

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

// (BLOCK, 1): ptxas then keeps the walk's loads in flight in 107
// registers without spilling; with (BLOCK) alone it chose 80 registers
// and spilled 76 bytes in an earlier form of this kernel
__global__ void __launch_bounds__(BLOCK, 1)
frame(Scene s, const float* __restrict__ env, int eh, int ew,
      const float* __restrict__ uni_g, const float* __restrict__ jit, int K,
      int W, int H, int tiles_x,
      float inv_w, float inv_h, float aspect, int bounces,
      bool shadows, bool diffuse, float fudge, int n_counters,
      float* __restrict__ out, unsigned long long* __restrict__ counters) {
    __shared__ float u[UNI_SIZE];
    __shared__ unsigned long long cnt[N_COUNTERS];
    // ray state of the tile's slots (slot = owner thread = pixel)
    __shared__ float sP[3][BLOCK], sD[3][BLOCK], sAcc[3][BLOCK], sMod[3][BLOCK];
    __shared__ float sMd[3][BLOCK], sLcos[BLOCK];  // pending diffuse: mod * diffuse, lcos
    __shared__ unsigned char sFlag[BLOCK], sBad[BLOCK];
    __shared__ short q[BLOCK];
    __shared__ int wcount[WARPS];
    extern __shared__ int stack_sh[];  // (stack_depth, BLOCK)

    const int tid = threadIdx.x;
    for (int i = tid; i < UNI_SIZE; i += BLOCK) u[i] = uni_g[i];
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
        const int tile = blockIdx.x;
        const int px = (tile % tiles_x) * TILE_W + tid % TILE_W;
        const int py = (tile / tiles_x) * TILE_H + tid / TILE_W;
        const bool valid = px < W && py < H;
        const float iif = (float)px, jf = (float)py;
        float sum0 = 0.0f, sum1 = 0.0f, sum2 = 0.0f;
        for (int k = 0; k < K; ++k) {
            if (valid) {
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
                sD[0][tid] = Dx * inv_d;
                sD[1][tid] = Dy * inv_d;
                sD[2][tid] = Dz * inv_d;
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
                    const Walk w = walk<false, false>(s, oPx, oPy, oPz, oDx, oDy, oDz, stack);
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
#pragma unroll
                        for (int c = 0; c < 3; ++c) {
                            const float sc = u[UNI_SPECULAR + c];
                            sMod[c][r] = sMod[c][r] * (sc + (1.0f - sc) * fres);
                        }
                    }
                    sFlag[r] = flag;
                }
                count(cnt, ph, st, lf, tr);
                __syncthreads();
                live = live && (sFlag[tid] & ALIVE);
                if (!shadows) continue;

                // any-hit phase over the light-facing hits
                const int ns = compact(live && (sFlag[tid] & SHADOW), q, wcount);
                if (ns == 0) continue;
                if (tid == 0) cnt[0] += (unsigned long long)ns;
                st = lf = tr = 0;
                if (tid < ns) {
                    const int r = q[tid];
                    const float Px = sP[0][r], Py = sP[1][r], Pz = sP[2][r];
                    const float sPx = m[0] * Px + m[1] * Py + m[2] * Pz + m[3];
                    const float sPy = m[4] * Px + m[5] * Py + m[6] * Pz + m[7];
                    const float sPz = m[8] * Px + m[9] * Py + m[10] * Pz + m[11];
                    const Walk sw = walk<false, true>(s, sPx, sPy, sPz, oLx, oLy, oLz, stack);
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
            if (valid) {
                float col0 = 1.0f, col1 = 0.0f, col2 = 0.0f;  // bad-ray paint
                if (!sBad[tid]) {
                    const float Dx = sD[0][tid], Dy = sD[1][tid], Dz = sD[2][tid];
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
                    col0 = sAcc[0][tid] + sMod[0][tid] * e[0];
                    col1 = sAcc[1][tid] + sMod[1][tid] * e[1];
                    col2 = sAcc[2][tid] + sMod[2][tid] * e[2];
                }
                sum0 += col0;
                sum1 += col1;
                sum2 += col2;
            }
        }
        if (valid) {
            float* o = out + ((size_t)py * W + px) * 3;
            o[0] = sum0 / (float)K;
            o[1] = sum1 / (float)K;
            o[2] = sum2 / (float)K;
        }
    }

    // counters: one 64-bit atomic per counter and block
    __syncthreads();
    for (int c = tid; c < n_counters; c += BLOCK) {
        if (cnt[c]) atomicAdd(counters + c, cnt[c]);
    }
}

// The stack's dynamic shared memory is above the 48 KB a launch gets
// without asking: raise the kernel's limit to what MAX_STACK entries
// take, once a device (a launch still asks only for its scene's depth).
cudaError_t allow_stack_smem() {
    static std::atomic<unsigned long long> raised{0};  // bit d: device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (raised.load() & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(frame, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_STACK * BLOCK * (int)sizeof(int));
    if (err == cudaSuccess) raised.fetch_or(bit);
    return err;
}

}  // namespace

extern "C" int srt_frame_kernel(
    const float* nodes, const float* leaves,
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
    // the stack takes stack_depth * BLOCK ints: up to 128 KB
    const size_t smem = (size_t)stack_depth * BLOCK * sizeof(int);
    cudaError_t err = allow_stack_smem();
    if (err != cudaSuccess) return (int)err;
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const unsigned grid = (unsigned)tiles_x * (unsigned)((H + TILE_H - 1) / TILE_H);
    Scene s{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(leaves),
            stack_depth, max_steps, mt_eps};
    frame<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        s, env, env_h, env_w, uni, jitters, K, W, H, tiles_x,
        inv_w, inv_h, aspect, bounces, cast, diffuse != 0, fudge, 1 + 3 * phases,
        out, counters);
    return (int)cudaGetLastError();
}

// The launch's resources for a scene's stack bound, into info[0..8):
// registers a thread, static shared bytes, local bytes a thread (stack
// frame), dynamic shared bytes (the stack), resident blocks an SM,
// threads a block, tile width, tile height.
extern "C" int srt_frame_kernel_info(int stack_depth, int* info) {
    if (stack_depth < 1 || stack_depth > MAX_STACK) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)stack_depth * BLOCK * sizeof(int);
    cudaError_t err = allow_stack_smem();
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, frame)) != cudaSuccess) return (int)err;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame, BLOCK, smem)) != cudaSuccess)
        return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = (int)smem;
    info[4] = per_sm;
    info[5] = BLOCK;
    info[6] = TILE_W;
    info[7] = TILE_H;
    return 0;
}
