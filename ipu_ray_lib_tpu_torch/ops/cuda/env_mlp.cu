// NIF environment-light MLP for Hopper (sm_90a): escape direction ->
// RGB radiance, for a batch of escaped paths.
//
// Replaces the env branch of the TPU megakernel,
// ipu_ray_lib_tpu/ops/pallas/megakernel.py `_mega_kernel` `_env`
// (:2304-2361, packed by `pack_env_mlp` :2507): equirect UV with the
// polynomial atan2/acos, Fourier features, L dense layers (bf16 inputs and
// weights, f32 accumulation, f32 bias, ReLU, skip-concat of the features),
// decode x*max + mean, exp when log tone-mapped, BGR -> RGB. The TPU
// kernel parks escaped lanes and flushes them through the MXU in batches;
// here the path-trace kernel records escapes (megakernel.cu, record mode)
// and this kernel runs once over all of them.
//
// Arithmetic contract (shared bit for bit with the plain torch version,
// ops/env.py env_mlp_ref):
//   * each dense output is ONE f32 accumulator over the inputs in
//     ascending index, then + bias. A product of two bf16 values has at
//     most 16 significant bits, so it is exact in f32 (short of underflow
//     below 2^-126, which NIF activations and weights do not reach), and
//     fmaf(w, x, acc) rounds exactly as acc + w*x does;
//   * sin, cos and exp are the correctly rounded f32 values, from the
//     float64 functions; everything else is one IEEE rounding per
//     operation (built with -fmad=false; products that must not fuse use
//     the _rn intrinsics).
//
// What bounds it on this card: 2 * sum(cin*cout) FLOP per direction
// (441,280 MACs for the urban_4k NIF), i.e. compute. The tensor cores
// would do it at 989 TFLOP/s but sum in their own order; this first
// kernel keeps the contract on the CUDA cores (67 TFLOP/s f32 peak, one
// FFMA per MAC). Design: a block takes 64 directions; their bf16
// activations live in shared memory (two [64, width] buffers and the
// features); each warp owns 8 directions and each lane two adjacent
// outputs, so a lane does 16 FMAs per input for one 4-byte weight load
// (coalesced across the warp, L1/L2 resident: the weights are 883 KB)
// and eight broadcast shared-memory loads. Tensor-core (wgmma) tiles, with
// their different sum order, are later perf work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                     // directions per block
constexpr int THREADS = 256;                 // 8 warps
constexpr int ROWS = TILE / (THREADS / 32);  // directions per warp
constexpr int MAX_LAYERS = 16;

struct Layer {
  int cin, cout, relu, concat, woff, boff;
};

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// megakernel.py:264-279, one rounding per operation:
__device__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = jmax(ax, ay), mn = jmin(ax, ay);
  const float z = mn / jmax(mx, __int_as_float(0x0da24260));  // 1e-30
  const float z2 = __fmul_rn(z, z);
  // the coefficients as the host's np.float32 values, by bit pattern:
  float a = __fadd_rn(__fmul_rn(z2, __uint_as_float(0xbc400a47u)),  // -0.0117212
                      __int_as_float(0x3d57ab02));                // 0.05265332
  a = __fadd_rn(__fmul_rn(a, z2), __uint_as_float(0xbdee745bu));    // -0.11643287
  a = __fadd_rn(__fmul_rn(a, z2), __int_as_float(0x3e463042));    // 0.19354346
  a = __fadd_rn(__fmul_rn(a, z2), __uint_as_float(0xbeaa4da0u));    // -0.33262347
  a = __fadd_rn(__fmul_rn(a, z2), __int_as_float(0x3f7ffe82));    // 0.99997726
  a = __fmul_rn(a, z);
  if (ay > ax) a = __int_as_float(0x3fc90fdb) - a;  // pi/2
  if (x < 0.0f) a = __int_as_float(0x40490fdb) - a;  // pi
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(THREADS)
env_mlp_kernel(const float* __restrict__ dirs, float* __restrict__ out, int n,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
               const int* __restrict__ table, int L, int E, int width,
               int log_tm, const float* __restrict__ econst) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xb = xa + TILE * width;
  __nv_bfloat16* feats = xb + TILE * width;             // [TILE, 4E]
  float* uvn = reinterpret_cast<float*>(feats + TILE * 4 * E);  // [TILE, 2]
  __shared__ Layer lay[MAX_LAYERS];

  const int tid = threadIdx.x;
  const int base = blockIdx.x * TILE;
  const int F = 4 * E;
  if (tid < L) {
    const int* r = table + tid * 6;
    lay[tid] = {r[0], r[1], r[2], r[3], r[4], r[5]};
  }

  // ---- equirect UV (megakernel.py:2314-2321) ----
  if (tid < TILE) {
    const int i = base + tid;
    float dx = 0.0f, dy = 1.0f, dz = 0.0f;  // padding rows: any finite dir
    if (i < n) {
      dx = dirs[3 * i];
      dy = dirs[3 * i + 1];
      dz = dirs[3 * i + 2];
    }
    const float two_pi = __int_as_float(0x40c90fdb);
    const float cy = jmin(jmax(dy, -1.0f), 1.0f);
    const float theta =
        atan2_poly(sqrtf(jmax(__fadd_rn(1.0f, -__fmul_rn(cy, cy)), 0.0f)), cy);
    float phi = __fadd_rn(atan2_poly(dz, dx), econst[0]);
    if (phi < 0.0f) phi = __fadd_rn(phi, two_pi);
    if (phi > two_pi) phi = __fadd_rn(phi, -two_pi);
    uvn[2 * tid] = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(theta, __int_as_float(0x3ea2f983)), -1.0f));
    uvn[2 * tid + 1] = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(phi, __int_as_float(0x3e22f983)), -1.0f));
  }
  __syncthreads();

  // ---- Fourier features (:2324-2331), layer 0's input ----
  for (int q = tid; q < TILE * E; q += THREADS) {
    const int t = q / E, e = q % E;
    const float c = (float)(1 << e);
    const double pu = (double)__fmul_rn(uvn[2 * t], c);
    const double pv = (double)__fmul_rn(uvn[2 * t + 1], c);
    __nv_bfloat16* f = feats + t * F;
    f[e] = to_bf16((float)sin(pu));
    f[E + e] = to_bf16((float)sin(pv));
    f[2 * E + e] = to_bf16((float)cos(pu));
    f[3 * E + e] = to_bf16((float)cos(pv));
  }
  __syncthreads();
  for (int q = tid; q < TILE * F; q += THREADS) {
    const int t = q / F, f = q % F;
    xa[t * width + f] = feats[t * F + f];
  }
  __syncthreads();

  // ---- the dense stack ----
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = warp * ROWS;
  __nv_bfloat16* xin = xa;
  __nv_bfloat16* xout = xb;
  for (int l = 0; l < L; ++l) {
    const Layer ly = lay[l];
    if (ly.concat) {  // x = [previous output, features]
      const int at = ly.cin - F;
      for (int q = tid; q < TILE * F; q += THREADS) {
        const int t = q / F, f = q % F;
        xin[t * width + at + f] = feats[t * F + f];
      }
      __syncthreads();
    }
    const __nv_bfloat16* wl = w + ly.woff;
    const float* bl = b + ly.boff;
    const bool last = l == L - 1;
    const bool pairs = (ly.cout & 1) == 0;
    for (int o0 = 2 * lane; o0 < ly.cout; o0 += 64) {
      const bool has1 = o0 + 1 < ly.cout;
      float acc0[ROWS], acc1[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc0[r] = acc1[r] = 0.0f;
      for (int i = 0; i < ly.cin; ++i) {
        float w0, w1;
        if (pairs) {
          const float2 wv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(wl + i * ly.cout + o0));
          w0 = wv.x;
          w1 = wv.y;
        } else {
          w0 = __bfloat162float(wl[i * ly.cout + o0]);
          w1 = has1 ? __bfloat162float(wl[i * ly.cout + o0 + 1]) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = __bfloat162float(xin[(t0 + r) * width + i]);
          acc0[r] = fmaf(w0, xv, acc0[r]);
          acc1[r] = fmaf(w1, xv, acc1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int t = t0 + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = o0 + c;
          if (o >= ly.cout) continue;
          float y = __fadd_rn(c == 0 ? acc0[r] : acc1[r], bl[o]);
          if (ly.relu) y = jmax(y, 0.0f);
          if (!last) {
            xout[t * width + o] = to_bf16(y);
          } else if (base + t < n && o < 3) {
            // decode: x*max + mean, exp; channel o is BGR, out is RGB
            float v = __fadd_rn(__fmul_rn(y, econst[1]), econst[2 + o]);
            if (log_tm) v = (float)exp((double)v);
            out[3 * (base + t) + (2 - o)] = v;
          }
        }
      }
    }
    __syncthreads();
    __nv_bfloat16* tmp = xin;
    xin = xout;
    xout = tmp;
  }
}

}  // namespace

extern "C" int env_mlp_smem_bytes(int width, int E) {
  return 2 * TILE * width * 2 + TILE * 4 * E * 2 + TILE * 2 * 4;
}

extern "C" int env_mlp_launch(const float* dirs, float* out, int n,
                              const void* w, const float* b, const int* table,
                              int L, int E, int width, int log_tm,
                              const float* econst, void* stream) {
  if (L > MAX_LAYERS || (width & 1) || n <= 0) return (int)cudaErrorInvalidValue;
  const int smem = env_mlp_smem_bytes(width, E);
  cudaError_t err = cudaFuncSetAttribute(
      env_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE - 1) / TILE;
  env_mlp_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      dirs, out, n, static_cast<const __nv_bfloat16*>(w), b, table, L, E,
      width, log_tm, econst);
  return (int)cudaGetLastError();
}
