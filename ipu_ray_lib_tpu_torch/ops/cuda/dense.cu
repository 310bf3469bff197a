// The dense triangle closest hit for Hopper (sm_90a), K8: every ray
// against every triangle, one thread per ray.
//
// Replaces the jnp loop ipu_ray_lib_tpu/ops/dense.py `dense_closest_tri`
// (:169) and its block test `_tri_block_best` (:109), which the JAX
// package runs as six MXU matmuls per block of 512 triangles under a
// `lax.fori_loop` (not a Pallas kernel). Each CTA stages one block of 512
// triangle rows (14 of each row's 16 f32: the unit normal, n . p0, the
// barycentric gradients g1, g2 with g . p0, and the acceptance-bound terms
// tS, tG; 28,672 bytes) in shared memory, and each of its threads scans
// them in order against its ray:
//
//   t  = (n . p0 - n . o) / (n . d)
//   b1 = (g1 . o + t * (g1 . d)) - g1 . p0      (b2 alike)
//   eps = min(WATERTIGHT_EPS_SCALE * (tS + tG * (|o|inf + E_t)), 1e-3),
//   E_t = (|n . p0| + |n . o|) / |n . d|
//
// accepting n . d != 0, b1 >= -eps, b2 >= -eps, b1 + b2 <= 1 + eps and
// t_min < t < best. A strictly nearer hit replaces the best, so a ray keeps
// the first row of its strict minimum: within a block the JAX form's
// `argmin`, across blocks its strict `better`. Padding rows (n = 0) never
// hit. The dots reduce as XLA's dots at Precision.HIGHEST do on the CPU,
// fma(a2, b2, fma(a1, b1, a0 * b0)), and the product t * (g . d) fuses into
// its sum, as XLA contracts it (built with -fmad=false otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;   // TRI_BLOCK: triangle rows per stage
constexpr int kCols = 14;     // the staged columns of a row
constexpr int kThreads = 256;

__device__ __forceinline__ float f_bits(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ float kEpsScale() { return f_bits(0x36000000u); }  // 32 * 2^-24
__device__ __forceinline__ float kEpsClamp() { return f_bits(0x3a83126fu); }  // 1e-3

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
}

__global__ void __launch_bounds__(kThreads)
    dense_kernel(const float* __restrict__ rows, const float* __restrict__ origin,
                 const float* __restrict__ dir, const float* __restrict__ t_min,
                 const float* __restrict__ t_max, float* __restrict__ out_t,
                 int* __restrict__ out_i, int R, int T) {
  __shared__ float s[kCols][kBlock];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  float tmin = 0.0f, tmax = -1.0f;
  if (live) {
    o0 = origin[3 * i];
    o1 = origin[3 * i + 1];
    o2 = origin[3 * i + 2];
    d0 = dir[3 * i];
    d1 = dir[3 * i + 1];
    d2 = dir[3 * i + 2];
    tmin = t_min[i];
    tmax = t_max[i];
  }
  // jnp.max(|o|): NaN-propagating.
  const float a0 = fabsf(o0), a1 = fabsf(o1), a2 = fabsf(o2);
  float o_mag = (a0 != a0 || a1 != a1) ? a0 + a1 : fmaxf(a0, a1);
  o_mag = (o_mag != o_mag || a2 != a2) ? o_mag + a2 : fmaxf(o_mag, a2);
  float best = tmax;
  int best_i = -1;
  for (int b0 = 0; b0 < T; b0 += kBlock) {
    __syncthreads();
    for (int k = threadIdx.x; k < kBlock * kCols; k += kThreads) {
      const int row = k / kCols, c = k % kCols;
      s[c][row] = rows[(size_t)(b0 + row) * 16 + c];
    }
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      const float tnp0 = s[3][j];
      const float dn = dot3(d0, d1, d2, s[0][j], s[1][j], s[2][j]);
      const float on = dot3(o0, o1, o2, s[0][j], s[1][j], s[2][j]);
      const float t = (tnp0 - on) / dn;
      const float b1 = __fmaf_rn(t, dot3(d0, d1, d2, s[4][j], s[5][j], s[6][j]),
                                 dot3(o0, o1, o2, s[4][j], s[5][j], s[6][j])) - s[7][j];
      const float b2 = __fmaf_rn(t, dot3(d0, d1, d2, s[8][j], s[9][j], s[10][j]),
                                 dot3(o0, o1, o2, s[8][j], s[9][j], s[10][j])) - s[11][j];
      const float et = (fabsf(tnp0) + fabsf(on)) / fabsf(dn == 0.0f ? 1.0f : dn);
      const float e = kEpsScale() * __fmaf_rn(s[13][j], o_mag + et, s[12][j]);
      const float eps = e > kEpsClamp() ? kEpsClamp() : e;
      if (dn != 0.0f && b1 >= -eps && b2 >= -eps && b1 + b2 <= 1.0f + eps && t > tmin &&
          t < best) {
        best = t;
        best_i = b0 + j;
      }
    }
  }
  if (live) {
    out_t[i] = best;
    out_i[i] = best < tmax ? best_i : -1;
  }
}

}  // namespace

extern "C" int dense_launch(const float* rows, const float* origin, const float* dir,
                            const float* t_min, const float* t_max, float* out_t, int* out_i,
                            int R, int T, void* stream) {
  if (T % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (R + kThreads - 1) / kThreads;
  dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, origin, dir, t_min, t_max, out_t, out_i, R, T);
  return static_cast<int>(cudaGetLastError());
}
