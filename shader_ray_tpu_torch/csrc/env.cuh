// The lat-long environment lookup shared by the env sampler
// (env_kernel.cu) and the fused frame kernel (frame_kernel.cu):
// direction -> (u, v), the REPEAT wrap, the bilinear fetch of one
// pyramid level, and the radiance of a ray in each mode: level-0
// bilinear, or textureGrad's trilinear at a lod from the analytic
// derivatives, with aniso probes (radiance<MODE>).  The pyramid is ops/envmap.py's: 16-byte texels (RGB
// and a zero pad, one 128-bit read-only load a texel), level l at texel
// offset off[l] with h[l] rows of w[l] texels, every h and w a power of
// two.  Row 0 is the top scanline; v = 1 maps to it (+y pole).
//
// NaN goes where the reference's jnp.maximum / jnp.clip and torch's
// maximum / clamp take it (max_nan, min_nan): a direction or footprint
// that is not finite yields NaN radiance, and its texel indices are
// clamped into the level, as a JAX gather does, so no read leaves it.

#pragma once

#include <cuda_runtime.h>

namespace srt {

// the reference's pi, kept verbatim (fs:116), rounded to f32 once
constexpr float PI_REF = (float)3.14159265259;
constexpr float TAU_REF = (float)(2.0 * 3.14159265259);

// max / min that return NaN when either operand is NaN (PTX max.NaN,
// sm_80 and later); fmaxf / fminf would drop it
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    return min_nan(max_nan(x, lo), hi);
}

// u = 1 + atan2(-z, x)/tau in [0.5, 1.5], v = 1 - acos(clamp(y))/pi
// (envmap.py:36-41)
__device__ __forceinline__ void env_uv(float x, float y, float z, float& u, float& v) {
    u = 1.0f + atan2f(-z, x) / TAU_REF;
    v = 1.0f - acosf(clamp_nan(y, -1.0f, 1.0f)) / PI_REF;
}

// One level's shape.  w and h are powers of two, so x * inv_w is exact.
struct EnvLevel {
    int off, wi, hi;
    float w, h, inv_w, inv_h;
};

// floor(x) mod n for an integral x and a power of two n: exact for every
// finite x (each step is exact: a power-of-two scale, a floor, and a
// difference that is an integer below n); a non-finite x gives NaN,
// which the conversion turns into 0, inside the level
__device__ __forceinline__ int wrap(float x, float n, float inv_n) {
    return __float2int_rz(fmaf(-floorf(x * inv_n), n, x));
}

// Bilinear REPEAT fetch of level L at (u, v) -> rgb, one 16-byte load a
// texel.  FLOAT_NEXT: the +1 neighbour is wrap(x0 + 1) in float, as
// bilinear_level (a grad probe's x0 may pass 2^24, where x0 + 1 rounds);
// otherwise the next index after wrap(x0), as bilinear_level0 (level 0
// at a direction's own (u, v), |x0| < 2^24).  The two agree wherever
// |x0| < 2^24.
template <bool FLOAT_NEXT>
__device__ __forceinline__ float3 bilinear(const float4* __restrict__ pyr, const EnvLevel& L,
                                           float u, float v) {
    const float x = u * L.w - 0.5f;
    const float y = (1.0f - v) * L.h - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int xi0 = wrap(x0, L.w, L.inv_w), yi0 = wrap(y0, L.h, L.inv_h);
    int xi1, yi1;
    if (FLOAT_NEXT) {
        xi1 = wrap(x0 + 1.0f, L.w, L.inv_w);
        yi1 = wrap(y0 + 1.0f, L.h, L.inv_h);
    } else {
        xi1 = xi0 + 1 == L.wi ? 0 : xi0 + 1;
        yi1 = yi0 + 1 == L.hi ? 0 : yi0 + 1;
    }
    const float4* r0 = pyr + L.off + yi0 * L.wi;
    const float4* r1 = pyr + L.off + yi1 * L.wi;
    const float4 c00 = __ldg(r0 + xi0), c10 = __ldg(r0 + xi1);
    const float4 c01 = __ldg(r1 + xi0), c11 = __ldg(r1 + xi1);
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    return make_float3((c00.x * gx + c10.x * fx) * gy + (c01.x * gx + c11.x * fx) * fy,
                       (c00.y * gx + c10.y * fx) * gy + (c01.y * gx + c11.y * fx) * fy,
                       (c00.z * gx + c10.z * fx) * gy + (c01.z * gx + c11.z * fx) * fy);
}

constexpr int MAX_LEVELS = 12;   // levels a table holds
constexpr int ANISO_PROBES = 4;  // probe taps of the aniso approximation (GL MAX_ANISOTROPY 4)

// the lookup's modes: level-0 bilinear (fs:153); textureGrad (fs:146);
// textureGrad with aniso > 1 probes (ray.cpp:505-508)
enum EnvMode { BILINEAR = 0, GRAD = 1, PROBES = 2 };

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

// a level's shape from its (texel offset, height, width)
inline EnvLevel env_level(int off, int h, int w) {
    return EnvLevel{off, w, h, (float)w, (float)h, 1.0f / (float)w, 1.0f / (float)h};
}

// The level table of n (texel offset, height, width) host rows; false
// unless 1 <= n <= MAX_LEVELS and every size is a power of two.
inline bool env_levels(const int* rows, int n, Levels& lv) {
    if (n < 1 || n > MAX_LEVELS) return false;
    lv = Levels{};
    for (int l = 0; l < n; ++l) {
        const int off = rows[3 * l], h = rows[3 * l + 1], w = rows[3 * l + 2];
        if (off < 0 || h < 1 || (h & (h - 1)) || w < 1 || (w & (w - 1))) return false;
        lv.l[l] = env_level(off, h, w);
    }
    lv.top = n - 1;
    return true;
}

}  // namespace srt
