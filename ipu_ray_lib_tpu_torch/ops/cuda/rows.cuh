// Row-test device functions shared by the shadow kernel (K4, shadow.cu)
// and the closest-hit kernels (K5, K6, intersect.cu): the constants, the
// NaN-propagating min/max, the plane + barycentric chain of one triangle
// row as XLA compiles the JAX kernels' CPU interpret mode, the test of a
// staged block's 128 rows against one ray, and the staging itself.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace rows {

constexpr int TB = 128;          // triangle rows per block
constexpr int BR = 1024;         // rays per bundle = threads per block

__device__ __forceinline__ float kInf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float kBig30() { return __int_as_float(0x7149f2ca); }    // 1e30
__device__ __forceinline__ float kSlabScale() { return __int_as_float(0x3f800003); }  // 1+2g3
__device__ __forceinline__ float kEpsClamp() { return __int_as_float(0x3a83126f); }   // 1e-3
__device__ __forceinline__ float kTiny() { return __int_as_float(0x0da24260); }       // 1e-30
__device__ __forceinline__ float kMachEps() { return __int_as_float(0x33800000); }    // 2^-24
__device__ __forceinline__ float kRayEps() { return __int_as_float(0x38bb8000); }     // 1500*2^-24

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics):
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct V3 {
  float x, y, z;
};
// a0*b0 + a1*b1 + a2*b2 as XLA contracts it: fma(a2, b2, fma(a0, b0, a1*b1)).
__device__ __forceinline__ float dotf(V3 a, V3 b) {
  return __fmaf_rn(a.z, b.z, __fmaf_rn(a.x, b.x, a.y * b.y));
}

// K4's plane + barycentric chain of one row c[16] (shadow_kernel.py:81-110).
struct RowChain {
  float t, b1, b2, on, r;
};
__device__ __forceinline__ RowChain row_chain(const float* c, V3 o, V3 d) {
  const V3 n = {c[3], c[4], c[5]}, g1 = {c[6], c[7], c[8]}, g2 = {c[9], c[10], c[11]};
  const float on = dotf(n, o), dn = dotf(n, d);
  const float r0 = 1.0f / bf16_round(dn);
  const float r = r0 * __fmaf_rn(-dn, r0, 2.0f);
  const float t = (c[0] - on) * r;
  const float b1 = __fmaf_rn(t, dotf(g1, d), dotf(g1, o)) - c[1];
  const float b2 = __fmaf_rn(t, dotf(g2, d), dotf(g2, o)) - c[2];
  return {t, b1, b2, on, r};
}

// The 128 staged rows against one ray: strictly smaller t replaces, so the
// lowest row wins a tie and an earlier block keeps its hit.
__device__ __forceinline__ void test_rows(const float4* rows4, int blk, V3 o, V3 d,
                                          float omag, float tmin, float& best_t,
                                          int& best_row) {
  for (int r = 0; r < TB; ++r) {
    float c[16];
    *reinterpret_cast<float4*>(c + 0) = rows4[r * 4 + 0];
    *reinterpret_cast<float4*>(c + 4) = rows4[r * 4 + 1];
    *reinterpret_cast<float4*>(c + 8) = rows4[r * 4 + 2];
    *reinterpret_cast<float4*>(c + 12) = rows4[r * 4 + 3];
    const RowChain rc = row_chain(c, o, d);
    const float et = (c[14] + fabsf(rc.on)) * fabsf(rc.r);
    const float eps = jmin(__fmaf_rn(c[13], omag + et, c[12]), kEpsClamp());
    const bool ok = jmin(rc.b1, rc.b2) >= -eps && rc.b1 + rc.b2 <= 1.0f + eps &&
                    rc.t > tmin;
    if (ok && rc.t < best_t) {
      best_t = rc.t;
      best_row = blk * TB + r;
    }
  }
}

// Copy block blk's rows into shared memory (512 float4, one per thread of
// the first half); the caller synchronises around it.
__device__ __forceinline__ void stage(const float* p, int blk, float4* rows4) {
  if (threadIdx.x < TB * 4)
    rows4[threadIdx.x] = __ldg(reinterpret_cast<const float4*>(p) + (size_t)blk * TB * 4 +
                               threadIdx.x);
}

}  // namespace rows
