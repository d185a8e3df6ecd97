// The lat-long environment lookup shared by the env sampler
// (env_kernel.cu) and the fused frame kernel (frame_kernel.cu):
// direction -> (u, v), the REPEAT wrap, and the bilinear fetch of one
// pyramid level.  The pyramid is ops/envmap.py's: 16-byte texels (RGB
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

// a level's shape from its (texel offset, height, width)
inline EnvLevel env_level(int off, int h, int w) {
    return EnvLevel{off, w, h, (float)w, (float)h, 1.0f / (float)w, 1.0f / (float)h};
}

}  // namespace srt
