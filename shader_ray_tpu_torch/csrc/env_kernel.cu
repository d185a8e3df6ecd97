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
//   mode 0   level-0 bilinear, REPEAT wrap on both axes (fs:153)
//   grad     per-ray lod from the analytic derivatives (fs:135-146),
//            trilinear between floor(lod) and the next level; with
//            aniso > 1, ANISO_PROBES taps along the major footprint axis
//            at the minor-axis lod, averaged (ray.cpp:505-508)
//
// The pyramid is one flat (texels, 3) f32 tensor, level l at texel
// offset table[l][0] with table[l][1] rows of table[l][2] texels.
//
// What bounds it here: bytes and gather latency.  A ray reads 12 to 36
// bytes of direction data, writes 12, and gathers 4 texels (mode 0) or
// 8 per probe (grad) of 12 bytes each; neighbouring rays read
// neighbouring texels and the 33 MB pyramid fits the L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC  (accurate atan2f/acosf/log2f/sqrtf/div:
//        no fast math).  Entry point: srt_env_sample (C ABI).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ANISO_PROBES = 4;
// the reference's pi, kept verbatim (fs:116), rounded to f32 once
constexpr float PI_REF = (float)3.14159265259;
constexpr float TAU_REF = (float)(2.0 * 3.14159265259);

__device__ __forceinline__ int wrap(float x, int n) {
    int i = (int)((long long)x % n);
    return i < 0 ? i + n : i;
}

// bilinear REPEAT fetch of level (off, h, w) at (u, v); v = 1 is row 0
__device__ void bilinear(const float* __restrict__ pyr, const int* __restrict__ tbl,
                         int level, float u, float v, float* out) {
    const int off = __ldg(tbl + 3 * level);
    const int h = __ldg(tbl + 3 * level + 1);
    const int w = __ldg(tbl + 3 * level + 2);
    const float x = u * (float)w - 0.5f;
    const float y = (1.0f - v) * (float)h - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int xi0 = wrap(x0, w), xi1 = wrap(x0 + 1.0f, w);
    const int yi0 = wrap(y0, h), yi1 = wrap(y0 + 1.0f, h);
    const float* r0 = pyr + ((size_t)off + (size_t)yi0 * w) * 3;
    const float* r1 = pyr + ((size_t)off + (size_t)yi1 * w) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float top = __ldg(r0 + xi0 * 3 + c) * (1.0f - fx) + __ldg(r0 + xi1 * 3 + c) * fx;
        const float bot = __ldg(r1 + xi0 * 3 + c) * (1.0f - fx) + __ldg(r1 + xi1 * 3 + c) * fx;
        out[c] = top * (1.0f - fy) + bot * fy;
    }
}

__global__ void __launch_bounds__(BLOCK)
env_sample(const float* __restrict__ pyr, const int* __restrict__ tbl, int n_levels,
           const float* __restrict__ D, const float* __restrict__ gx,
           const float* __restrict__ gy, long long n, bool grad, int aniso,
           float* __restrict__ out) {
    const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (r >= n) return;
    const float x = __ldg(D + 3 * r), y = __ldg(D + 3 * r + 1), z = __ldg(D + 3 * r + 2);
    // u = 1 + atan2(-z, x)/tau, v = 1 - acos(y)/pi (envmap.py:36-41)
    const float u = 1.0f + atan2f(-z, x) / TAU_REF;
    const float v = 1.0f - acosf(fminf(fmaxf(y, -1.0f), 1.0f)) / PI_REF;
    float col[3];
    if (!grad) {
        bilinear(pyr, tbl, 0, u, v, col);
    } else {
        // analytic du/dv derivatives (envmap.py:44-53)
        const float gxx = __ldg(gx + 3 * r), gxy = __ldg(gx + 3 * r + 1), gxz = __ldg(gx + 3 * r + 2);
        const float gyx = __ldg(gy + 3 * r), gyy = __ldg(gy + 3 * r + 1), gyz = __ldg(gy + 3 * r + 2);
        const float denom_u = TAU_REF * (x * x + z * z);
        const float dudx = (x * gxz - z * gxx) / denom_u;
        const float dudy = (x * gyz - z * gyx) / denom_u;
        const float denom_v = PI_REF * sqrtf(fmaxf(1.0f - y * y, 1e-12f));
        const float dvdx = gxy / denom_v;
        const float dvdy = gyy / denom_v;
        // footprint in base-level texels
        const float h0 = (float)__ldg(tbl + 1), w0 = (float)__ldg(tbl + 2);
        const float ax = dudx * w0, bx = dvdx * h0, ay = dudy * w0, by = dvdy * h0;
        const float rho_x = sqrtf(ax * ax + bx * bx);
        const float rho_y = sqrtf(ay * ay + by * by);
        float rho = fmaxf(rho_x, rho_y);
        float du_maj = 0.0f, dv_maj = 0.0f, spread = 0.0f;
        int probes = 1;
        if (aniso > 1) {
            // aniso_lod_and_probes (envmap.py:91-117)
            const bool use_x = rho_x >= rho_y;
            const float rho_max = rho, rho_min = fminf(rho_x, rho_y);
            const float n_eff = fminf(fmaxf(rho_max / fmaxf(rho_min, 1e-12f), 1.0f), (float)aniso);
            rho = fmaxf(rho_min, rho_max / (float)aniso);
            du_maj = use_x ? dudx : dudy;
            dv_maj = use_x ? dvdx : dvdy;
            spread = 1.0f - 1.0f / n_eff;
            probes = ANISO_PROBES;
        }
        const float lod = fminf(fmaxf(log2f(fmaxf(rho, 1e-12f)), 0.0f), (float)(n_levels - 1));
        const float lf = floorf(lod);
        const int l0 = (int)lf;
        const int l1 = l0 + 1 < n_levels ? l0 + 1 : n_levels - 1;
        const float frac = lod - lf;
        col[0] = col[1] = col[2] = 0.0f;
        for (int i = 0; i < probes; ++i) {
            float pu = u, pv = v;
            if (aniso > 1) {
                const float t = (((float)i + 0.5f) / (float)ANISO_PROBES - 0.5f) * spread;
                pu = u + t * du_maj;
                pv = v + t * dv_maj;
            }
            float c0[3], c1[3];
            bilinear(pyr, tbl, l0, pu, pv, c0);
            bilinear(pyr, tbl, l1, pu, pv, c1);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float tri = c0[c] * (1.0f - frac) + c1[c] * frac;
                col[c] = i == 0 ? tri : col[c] + tri;
            }
        }
        if (aniso > 1) {
#pragma unroll
            for (int c = 0; c < 3; ++c) col[c] = col[c] / (float)ANISO_PROBES;
        }
    }
    out[3 * r] = col[0];
    out[3 * r + 1] = col[1];
    out[3 * r + 2] = col[2];
}

}  // namespace

extern "C" int srt_env_sample(
    const float* pyramid, const int* table, int n_levels,
    const float* D, const float* dDdx, const float* dDdy, long long n,
    int grad, int aniso, float* out, void* stream) {
    if (n < 1 || n_levels < 1 || aniso < 1 ||
        (grad != 0 && (dDdx == nullptr || dDdy == nullptr)))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    env_sample<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        pyramid, table, n_levels, D, dDdx, dDdy, n, grad != 0, aniso, out);
    return (int)cudaGetLastError();
}
