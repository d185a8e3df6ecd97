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
// The lookup itself (u, v, wrap, bilinear fetch) is env.cuh's, shared
// with the frame kernel.
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

using namespace srt;  // EnvLevel, bilinear(), env_uv(), max_nan / min_nan (env.cuh)

constexpr int BLOCK = 128;
constexpr int MAX_LEVELS = 12;
constexpr int ANISO_PROBES = 4;

enum Mode { BILINEAR = 0, GRAD = 1, PROBES = 2 };

struct Levels {
    EnvLevel l[MAX_LEVELS];
    int top;  // last level
};

// trilinear fetch between levels l0 and l1 at weight frac of l1
__device__ __forceinline__ float3 trilinear(const float4* __restrict__ pyr, const Levels& lv,
                                            int l0, int l1, float frac, float u, float v) {
    const float3 c0 = bilinear<true>(pyr, lv.l[l0], u, v);
    // frac == 0 exactly: c0 * 1 + c1 * 0 is c0 (texels are finite, and a
    // c1 made NaN by its coordinates makes c0 NaN too)
    if (frac == 0.0f) return c0;
    const float3 c1 = bilinear<true>(pyr, lv.l[l1], u, v);
    const float g = 1.0f - frac;
    return make_float3(c0.x * g + c1.x * frac, c0.y * g + c1.y * frac, c0.z * g + c1.z * frac);
}

// the radiance of one ray (envmap.sample_environment, which 0 / 1)
template <int MODE>
__device__ __forceinline__ float3 radiance(const float4* __restrict__ pyr, const Levels& lv,
                                           float x, float y, float z,
                                           float gxx, float gxy, float gxz,
                                           float gyx, float gyy, float gyz, float aniso) {
    float u, v;
    env_uv(x, y, z, u, v);
    if (MODE == BILINEAR) return bilinear<false>(pyr, lv.l[0], u, v);
    // analytic du/dv derivatives (envmap.py:44-53)
    const float denom_u = TAU_REF * (x * x + z * z);
    const float dudx = (x * gxz - z * gxx) / denom_u;
    const float dudy = (x * gyz - z * gyx) / denom_u;
    const float denom_v = PI_REF * sqrtf(max_nan(1.0f - y * y, 1e-12f));
    const float dvdx = gxy / denom_v;
    const float dvdy = gyy / denom_v;
    // footprint in base-level texels
    const float w0 = lv.l[0].w, h0 = lv.l[0].h;
    const float ax = dudx * w0, bx = dvdx * h0, ay = dudy * w0, by = dvdy * h0;
    const float rho_x = sqrtf(ax * ax + bx * bx);
    const float rho_y = sqrtf(ay * ay + by * by);
    float rho, du_maj = 0.0f, dv_maj = 0.0f, spread = 0.0f;
    if (MODE == GRAD) {
        rho = max_nan(rho_x, rho_y);
    } else {
        // aniso_lod_and_probes (envmap.py:82-104)
        const bool use_x = rho_x >= rho_y;
        const float rho_max = max_nan(rho_x, rho_y), rho_min = min_nan(rho_x, rho_y);
        const float n_eff = clamp_nan(rho_max / max_nan(rho_min, 1e-12f), 1.0f, aniso);
        rho = max_nan(rho_min, rho_max / aniso);
        du_maj = use_x ? dudx : dudy;
        dv_maj = use_x ? dvdx : dvdy;
        spread = 1.0f - 1.0f / n_eff;
    }
    const float lod = clamp_nan(log2f(max_nan(rho, 1e-12f)), 0.0f, (float)lv.top);
    const float lf = floorf(lod);
    const int l0 = __float2int_rz(lf);  // NaN -> 0: a level the fetch can read
    const int l1 = min(l0 + 1, lv.top);
    const float frac = lod - lf;
    if (MODE == GRAD) return trilinear(pyr, lv, l0, l1, frac, u, v);
    float3 col = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < ANISO_PROBES; ++i) {
        // (i + 0.5) / P - 0.5 folds to a constant: -0.375, -0.125, 0.125, 0.375
        const float t = (((float)i + 0.5f) / (float)ANISO_PROBES - 0.5f) * spread;
        const float3 c = trilinear(pyr, lv, l0, l1, frac, u + t * du_maj, v + t * dv_maj);
        col = i == 0 ? c : make_float3(col.x + c.x, col.y + c.y, col.z + c.z);
    }
    return make_float3(col.x / (float)ANISO_PROBES, col.y / (float)ANISO_PROBES,
                       col.z / (float)ANISO_PROBES);
}

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

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// levels: host array of n_levels (texel offset, height, width) rows
extern "C" int srt_env_sample(
    const void* pyramid, const int* levels, int n_levels,
    const float* D, const float* dDdx, const float* dDdy, long long n,
    int grad, int aniso, float* out, void* stream) {
    if (n < 1 || n_levels < 1 || n_levels > MAX_LEVELS || aniso < 1 ||
        (grad != 0 && (dDdx == nullptr || dDdy == nullptr)))
        return (int)cudaErrorInvalidValue;
    Levels lv{};
    for (int l = 0; l < n_levels; ++l) {
        const int off = levels[3 * l], h = levels[3 * l + 1], w = levels[3 * l + 2];
        if (off < 0 || !pow2(h) || !pow2(w)) return (int)cudaErrorInvalidValue;
        lv.l[l] = env_level(off, h, w);
    }
    lv.top = n_levels - 1;
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
