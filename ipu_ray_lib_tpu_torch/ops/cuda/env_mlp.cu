// NIF environment-light MLP for Hopper (sm_90a): escape direction ->
// RGB radiance, for a batch of escaped paths, with the dense layers on
// the tensor cores.
//
// Replaces the env branch of the TPU megakernel,
// ipu_ray_lib_tpu/ops/pallas/megakernel.py `_mega_kernel` `_env`
// (:2304-2361, packed by `pack_env_mlp` :2507): equirect UV with the
// polynomial atan2/acos, Fourier features, L dense layers (bf16 inputs and
// weights, f32 accumulation, f32 bias, ReLU, skip-concat of the features),
// decode x*max + mean, exp when log tone-mapped, BGR -> RGB. The TPU
// kernel parks escaped lanes and flushes them through the MXU in batches
// (`dot_general(w, x.astype(bf16), preferred_element_type=f32)`); here
// the path-trace kernel records escapes (megakernel.cu, record mode) and
// this kernel runs once over all of them.
//
// What bounds it on this card: 2 * sum(cin*cout) FLOP per direction
// (441,280 MACs for the urban_4k NIF), i.e. compute on the tensor cores:
// 1.47e13 FLOP for the spheres + NIF flagship's 16.7 M escapes, 14.9 ms at
// 989 TFLOP/s bf16. Directions in and RGB out are ~0.4 GB (0.1 ms).
//
// Design: a block of 512 threads (16 warps) takes a tile of 128
// directions. Their bf16 activations never leave shared memory across
// the layers: the features [128, 4E] in a region of their own, the layer
// outputs in two [128, width] buffers used in turn (83 KB each at width
// 320). Each layer is a bf16 tile product with f32 accumulation by
// `mma.sync.m16n8k16` (A fragments by `ldmatrix` from the activations, B
// fragments from shared memory): warp (wm, wn) owns rows 32*wm..+32 and,
// of a pass of up to 160 output columns, the n-tiles 5*wn..+5, in 40 f32
// accumulators. The weights of a layer do not fit beside the
// activations, so they stream through two shared-memory stages of 4
// k-tiles x 160 columns (20 KB each), each filled by `cp.async` while the
// warps read the other; a barrier per stage, so fewer and deeper stages
// and more warps to hide the operand loads served this card better than
// more stages of fewer k-tiles. The host packs the weights once per NIF
// (ops/env.py `pack_mma`) in the order the kernel reads them and in the
// fragment layout of the instruction, so a stage is one contiguous copy
// and each lane reads its B fragment as one 8-byte load. Weight traffic:
// each tile reads the 0.9 MB of weights once from L2, 115 GB for the
// flagship's escapes; the 128-direction tile is what keeps that below
// the tensor cores' time. Every input width must be a multiple of 16 (the
// instruction's depth); the last layer's 3 outputs are padded to 16 with
// zero weights, and the padding is never written out.
//
// Why the sums differ from the plain version's (ops/env.py env_mlp_ref,
// one f32 accumulator per output over the inputs in ascending order):
// the tensor cores sum each 16-deep slice of products in their own order
// and precision before adding it to the f32 accumulator (they are fused
// multiply-adds by nature, whatever -fmad says), as the TPU's MXU sums in
// its own. The products of two bf16 values are exact either way, so the
// difference is that of summation order. chip_smoke.py measures it
// against the plain version beside a torch.matmul chain's, which sums on
// the same tensor cores. Everything around the sums is kept as it was:
// the bias added after the sum, then ReLU, then bf16 rounding of each
// layer's input; sin, cos and exp correctly rounded (from the float64
// functions); every other operation one IEEE rounding (-fmad=false, the
// _rn intrinsics).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                 // directions per block
constexpr int THREADS = 512;              // 16 warps
constexpr int WARPS_M = 4;                // warps over the rows
constexpr int WARPS_N = 4;                // warps over a pass's columns
constexpr int MT = TILE / 16 / WARPS_M;   // m-tiles (16 rows) per warp
constexpr int NCH = 20;                   // n-tiles (8 columns) per pass
constexpr int WNT = NCH / WARPS_N;        // n-tiles per warp and pass
constexpr int KG = 4;                     // k-tiles (16 deep) per stage
constexpr int STAGES = 2;                 // weight ring depth
constexpr int STAGE_BYTES = KG * NCH * 256;  // one k-tile x n-tile: 256 B
constexpr int MAX_LAYERS = 16;
constexpr int LT = 8;                     // ints per layer-table row
constexpr int ST = 8;                     // ints per stage-table row

// Layer table row: cin, cout, relu, at (inputs below `at` come from the
// previous output, the rest from the features), boff, last.
// Stage table row: off16 (16-byte units into the packed weights), n16,
// layer, n-tile of the pass start, kt0, nkt, nch, flags (1: the pass
// ends here, 2: the layer ends here).

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// D = A * B + D: A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Stage s of the packed weights into ring slot s % STAGES (all threads).
__device__ __forceinline__ void load_stage(unsigned char* ring,
                                           const uint4* __restrict__ wq,
                                           const int* __restrict__ stages,
                                           int s, int tid) {
  const int off16 = __ldg(stages + s * ST), n16 = __ldg(stages + s * ST + 1);
  uint4* dst = reinterpret_cast<uint4*>(ring + (s % STAGES) * STAGE_BYTES);
  const uint4* src = wq + off16;
  for (int i = tid; i < n16; i += THREADS) cp_async16(dst + i, src + i);
}

__global__ void __launch_bounds__(THREADS, 1)
env_mlp_kernel(const float* __restrict__ dirs, float* __restrict__ out, int n,
               const uint4* __restrict__ wq, const float* __restrict__ b,
               const int* __restrict__ ltab, const int* __restrict__ stages,
               int n_stages, int L, int E, int ldx, int log_tm,
               int exact_uv, const float* __restrict__ econst) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  __nv_bfloat16* xa = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);
  __nv_bfloat16* xb = xa + TILE * ldx;
  const int F = 4 * E, ldf = F + 8;
  __nv_bfloat16* feats = xb + TILE * ldx;                       // [TILE, ldf]
  float* uvn = reinterpret_cast<float*>(feats + TILE * ldf);    // [TILE, 2]
  __shared__ int lay[MAX_LAYERS * LT];

  const int tid = threadIdx.x;
  const int base = blockIdx.x * TILE;
  if (tid < L * LT) lay[tid] = ltab[tid];

  // The first stages of the weights start loading under the features.
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(ring, wq, stages, s, tid);
    cp_async_commit();
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
    // exact_uv: the angles of the JAX package's XLA env function
    // (nif/model.py:36-42), correctly rounded from double precision.
    const float theta =
        exact_uv ? (float)acos((double)cy)
                 : atan2_poly(sqrtf(jmax(__fadd_rn(1.0f, -__fmul_rn(cy, cy)), 0.0f)), cy);
    float phi = __fadd_rn(
        exact_uv ? (float)atan2((double)dz, (double)dx) : atan2_poly(dz, dx),
        econst[0]);
    if (phi < 0.0f) phi = __fadd_rn(phi, two_pi);
    if (phi > two_pi) phi = __fadd_rn(phi, -two_pi);
    uvn[2 * tid] = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(theta, __int_as_float(0x3ea2f983)), -1.0f));
    uvn[2 * tid + 1] = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(phi, __int_as_float(0x3e22f983)), -1.0f));
  }
  __syncthreads();

  // ---- Fourier features (:2324-2331), rounded to bf16 ----
  for (int q = tid; q < TILE * E; q += THREADS) {
    const int t = q / E, e = q % E;
    const float c = (float)(1 << e);
    const double pu = (double)__fmul_rn(uvn[2 * t], c);
    const double pv = (double)__fmul_rn(uvn[2 * t + 1], c);
    __nv_bfloat16* f = feats + t * ldf;
    f[e] = __float2bfloat16_rn((float)sin(pu));
    f[E + e] = __float2bfloat16_rn((float)sin(pv));
    f[2 * E + e] = __float2bfloat16_rn((float)cos(pu));
    f[3 * E + e] = __float2bfloat16_rn((float)cos(pv));
  }

  // ---- the dense stack: one pass of the loop per weight stage ----
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int arow = lane & 15, acol = (lane >> 4) * 8;  // ldmatrix addresses
  float acc[MT][WNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < WNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][j][c] = 0.0f;
  __nv_bfloat16* cur = xb;  // the previous layer's output
  __nv_bfloat16* nxt = xa;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s-1's slot and reads are done
    if (s + STAGES - 1 < n_stages)
      load_stage(ring, wq, stages, s + STAGES - 1, tid);
    cp_async_commit();

    const int* st = stages + s * ST;
    const int layer = __ldg(st + 2), nt0 = __ldg(st + 3), kt0 = __ldg(st + 4);
    const int nkt = __ldg(st + 5), nch = __ldg(st + 6), flags = __ldg(st + 7);
    const int* ly = lay + layer * LT;
    const int at = ly[3];
    const uint2* slot = reinterpret_cast<const uint2*>(ring + (s % STAGES) * STAGE_BYTES);

#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= nkt) break;
      const int c = (kt0 + kk) * 16;
      const __nv_bfloat16* src = c < at ? cur + c : feats + (c - at);
      const int ld = c < at ? ldx : ldf;
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(a[mi], src + ((wm * MT + mi) * 16 + arow) * ld + acol);
      const uint2* bw = slot + (kk * nch + wn * WNT) * 32 + lane;
#pragma unroll
      for (int j = 0; j < WNT; ++j) {
        if (wn * WNT + j < nch) {
          const uint2 bf = bw[j * 32];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][j], a[mi], bf);
        }
      }
    }

    if (flags & 1) {  // the pass ends: bias, ReLU, bf16 (or the decode)
      const int cout = ly[1], relu = ly[2], last = ly[5];
      const float* bl = b + ly[4];
#pragma unroll
      for (int j = 0; j < WNT; ++j) {
        if (wn * WNT + j >= nch) continue;
        const int o = (nt0 + wn * WNT + j) * 8 + 2 * (lane & 3);
        const float b0 = o < cout ? __ldg(bl + o) : 0.0f;
        const float b1 = o + 1 < cout ? __ldg(bl + o + 1) : 0.0f;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = (wm * MT + mi) * 16 + (lane >> 2) + 8 * h;
            float y0 = __fadd_rn(acc[mi][j][2 * h], b0);
            float y1 = __fadd_rn(acc[mi][j][2 * h + 1], b1);
            if (relu) {
              y0 = jmax(y0, 0.0f);
              y1 = jmax(y1, 0.0f);
            }
            if (!last) {
              *reinterpret_cast<__nv_bfloat162*>(nxt + t * ldx + o) =
                  __floats2bfloat162_rn(y0, y1);
            } else if (base + t < n) {
              // decode: x*max + mean, exp; channel o is BGR, out is RGB
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int oc = o + k;
                if (oc >= cout) continue;
                float v = __fadd_rn(__fmul_rn(k ? y1 : y0, econst[1]), econst[2 + oc]);
                if (log_tm) v = (float)exp((double)v);
                out[3 * (base + t) + (2 - oc)] = v;
              }
            }
          }
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0f;
        }
      }
    }
    if (flags & 2) {  // the layer ends: its output is the next input
      __nv_bfloat16* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int env_mlp_smem_bytes(int ldx, int E) {
  return STAGES * STAGE_BYTES + 2 * TILE * ldx * 2 + TILE * (4 * E + 8) * 2 +
         TILE * 2 * 4;
}

// `stages_host` is the host's copy of the stage table `stages`: each stage
// must fit the kernel's ring (at most KG k-tiles of at most NCH n-tiles,
// 256 B each) and the n16 16-byte units of `wq`, or the launch is refused.
extern "C" int env_mlp_launch(const float* dirs, float* out, int n,
                              const void* wq, int wq16, const float* b,
                              const int* ltab, const int* stages,
                              const int* stages_host, int n_stages, int L,
                              int E, int ldx, int log_tm, int exact_uv,
                              const float* econst, void* stream) {
  if (L > MAX_LAYERS || n <= 0 || n_stages <= 0 || (ldx % 16) != 8 ||
      (E % 4) != 0)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < n_stages; ++s) {
    const int* st = stages_host + s * ST;
    const int off16 = st[0], n16 = st[1], layer = st[2], nkt = st[5], nch = st[6];
    if (nkt <= 0 || nkt > KG || nch <= 0 || nch > NCH || n16 != nkt * nch * 16 ||
        off16 < 0 || off16 > wq16 - n16 || layer < 0 || layer >= L)
      return (int)cudaErrorInvalidValue;
  }
  const int smem = env_mlp_smem_bytes(ldx, E);
  cudaError_t err = cudaFuncSetAttribute(
      env_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE - 1) / TILE;
  env_mlp_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      dirs, out, n, static_cast<const uint4*>(wq), b, ltab, stages, n_stages,
      L, E, ldx, log_tm, exact_uv, econst);
  return (int)cudaGetLastError();
}
