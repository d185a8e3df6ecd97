// Lat-long environment sampler for Hopper (sm_90a): one thread per ray
// turns a direction (and, in grad mode, its image-plane differentials)
// into radiance.
//
// Replaces the TPU kernels env_window_kernel / env_window_grad_kernel
// (shader_ray_tpu/ops/pallas/envwin.py, pallas_call in
// _run_window_kernel, reached through sample_env_window and
// sample_env_window_grad).  The TPU samples a DMA'd window per ray tile
// and falls back to a coarser level pair when a tile's footprint does
// not fit; here every ray reads exactly the texels it needs, which is
// what that sampler approximates (ops/envmap.sample_environment):
//
//   BILINEAR  level-0 bilinear, REPEAT wrap on both axes (fs:153)
//   GRAD      per-ray lod from the analytic derivatives (fs:135-146),
//             trilinear between floor(lod) and the next level
//   PROBES    grad with aniso > 1: ANISO_PROBES taps along the major
//             footprint axis at the minor-axis lod, averaged
//             (ray.cpp:505-508)
//
// The lookup itself (u, v, wrap, bilinear and trilinear fetch, the grad
// modes' lod and probes) is env.cuh's, shared with the frame kernel.
//
// What bounds it here: bytes, and in grad mode with probes the loads.
// A ray reads 12 (mode 0) or 36 bytes of direction data and writes 12;
// its texels (4 a fetch, 16 bytes each) come from the L2, where
// neighbouring rays share them.  The first design ran 2-5.7x above its
// byte bound on instructions: a signed 64-bit remainder (a software
// routine) for each of the 4 to 32 texel wraps of a ray, a level-table
// load ahead of every fetch, three scalar loads a texel, and runtime
// modes.  This design (0.0072 ms mode 0, 0.0213 ms grad aniso=4 on the
// bench primaries, against 0.0118 and 0.0644; H100 80GB HBM3 at 700 W,
// PERF.md section 6): one kernel a mode, compiled apart, the probe loop
// unrolled so that its fetches are all in flight; the level table a
// kernel parameter; the wrap an exact float remainder by the
// power-of-two level size; a texel one 128-bit load; and the upper level
// of a trilinear fetch skipped where its weight is exactly 0 (lod clamped
// to a level: every bench primary).  Staging the ray I/O through shared
// memory, 8x16 ray tiles, reusing a probe's texels for the next probe in
// the same cell and capping registers for more blocks an SM were
// measured slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (accurate atan2f/acosf/log2f/sqrtf/div:
//        no fast math).  Entry points: srt_env_sample,
//        srt_env_sample_info (C ABI).

#include <cuda_runtime.h>

#include "env.cuh"

namespace {

using namespace srt;  // Levels, radiance<MODE>(), the modes, env_levels() (env.cuh)

constexpr int BLOCK = 128;

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
env_sample(const float4* __restrict__ pyr, Levels lv, const float* __restrict__ D,
           const float* __restrict__ gx, const float* __restrict__ gy,
           long long n, float aniso, float* __restrict__ out) {
    const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (r >= n) return;
    const float* d = D + 3 * r;
    float3 col;
    if (MODE == BILINEAR) {
        col = radiance<MODE>(pyr, lv, __ldg(d), __ldg(d + 1), __ldg(d + 2),
                             0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, aniso);
    } else {
        const float* a = gx + 3 * r;
        const float* b = gy + 3 * r;
        col = radiance<MODE>(pyr, lv, __ldg(d), __ldg(d + 1), __ldg(d + 2),
                             __ldg(a), __ldg(a + 1), __ldg(a + 2),
                             __ldg(b), __ldg(b + 1), __ldg(b + 2), aniso);
    }
    out[3 * r] = col.x;
    out[3 * r + 1] = col.y;
    out[3 * r + 2] = col.z;
}

using Kernel = void (*)(const float4*, Levels, const float*, const float*, const float*,
                        long long, float, float*);
const Kernel KERNELS[3] = {env_sample<BILINEAR>, env_sample<GRAD>, env_sample<PROBES>};

}  // namespace

// levels: host array of n_levels (texel offset, height, width) rows
extern "C" int srt_env_sample(
    const void* pyramid, const int* levels, int n_levels,
    const float* D, const float* dDdx, const float* dDdy, long long n,
    int grad, int aniso, float* out, void* stream) {
    if (n < 1 || aniso < 1 || (grad != 0 && (dDdx == nullptr || dDdy == nullptr)))
        return (int)cudaErrorInvalidValue;
    Levels lv;
    if (!env_levels(levels, n_levels, lv)) return (int)cudaErrorInvalidValue;
    const int mode = grad == 0 ? BILINEAR : aniso > 1 ? PROBES : GRAD;
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    KERNELS[mode]<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        static_cast<const float4*>(pyramid), lv, D, dDdx, dDdy, n, (float)aniso, out);
    return (int)cudaGetLastError();
}

// The launch's resources in mode 0 (BILINEAR), 1 (GRAD) or 2 (PROBES),
// into info[0..6): registers a thread, static shared bytes, local bytes
// a thread, dynamic shared bytes (none), resident blocks an SM, threads
// a block.
extern "C" int srt_env_sample_info(int mode, int* info) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, KERNELS[mode]);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNELS[mode], BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.sharedSizeBytes;
    info[2] = (int)a.localSizeBytes;
    info[3] = 0;
    info[4] = per_sm;
    info[5] = BLOCK;
    return 0;
}
