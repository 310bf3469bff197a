// Closest-hit kernels for Hopper (sm_90a): K5 over a bundle's triangle-block
// list, K6 over its super list (8 blocks per super), for bundles of 1,024
// rays.
//
// Replaces the TPU kernels ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py
// `_dense_kernel` (K5) and ops/pallas/intersect_hbm.py `_hbm_kernel` (K6).
// One thread block of 1,024 threads owns one bundle, one thread per ray,
// and keeps the TPU kernels' per-bundle decisions: it walks the bundle's
// list from the bundle cull (ops/cull.py), nearest first (K6: all 8 member
// blocks of each listed super, in order), and after every CHECK_EVERY
// listed entries (4 blocks for K5, 2 supers for K6) stops once the
// block-wide max of best t is below the next entry's distance bound: no
// later entry can then hold a nearer hit, so the stop changes no result.
// Each tested block's 128 triangle rows (8 KB) are staged in shared memory
// and tested by every thread (rows.cuh, as in the shadow kernel). Ties
// resolve as on the TPU: inside a block the lowest row, across blocks (and
// K6's members) the block first in the walk.
//
// After the walk each thread reads its winner's payload from the `nrm`
// table: the raw shading normal N0 + (dN1*b1 + dN2*b2) with the winner's
// f32 barycentrics (rounded to bf16 when the payload is bf16, as K6 takes
// them from its bf16 table), segment 0's spare rows 3-7 and segment 1's
// column. The arithmetic is the JAX kernels' as XLA compiles their CPU
// interpret mode (rows.cuh); the plain torch version
// (ops/intersect_kernel.py walk_ref) spells out the same operations.
//
// Outputs [Rp] / [8, Rp]: best t (t_max where nothing is hit), winning row
// or -1, n (raw normal, segment-0 rows 3-7), m (segment-1 rows 0-7); zeros
// where nothing is hit; and [nrb] the blocks each bundle tested.
//
// What bounds it on this card: operations. Each tested (bundle, block) pair
// costs 1,024 rays x 128 rows x ~49 f32 operations; the rows are read from
// device memory once per pair (8 KB), far below the operations' time. What
// the design does about it now: nothing beyond keeping the TPU kernels'
// work exactly (no per-ray cull) and shared-memory broadcasts of the rows.

#include "rows.cuh"

namespace {

using namespace rows;

constexpr int SB = 8;  // blocks per super

struct Params {
  const float* p;       // [nb*TB, 16] triangle rows
  const float* nrm;     // [8, nb*3*TB] normal basis + material
  const int* counts;    // [nrb] listed entries per bundle
  const int* order;     // [nrb, nl] entry list, nearest first
  const float* dists;   // [nrb, nl] distance bounds of the list
  const float* rays;    // [8, Rp] origin, direction, t_min, t_max rows
  float* out_t;         // [Rp]
  int* out_i;           // [Rp]
  float* out_n;         // [8, Rp]
  float* out_m;         // [8, Rp]
  int* pairs;           // [nrb] blocks tested per bundle
  int nl, nb, Rp, split;
};

template <bool kSuper>
__global__ void __launch_bounds__(BR) intersect_kernel(const Params P) {
  constexpr int kMembers = kSuper ? SB : 1;
  constexpr int kCheckEvery = kSuper ? 2 : 4;
  __shared__ float4 rows4[TB * 4];
  __shared__ float warp_max[BR / 32];
  __shared__ int stop;

  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t Rp = P.Rp;
  const size_t ray = (size_t)i * BR + lane;
  const V3 o = {P.rays[ray], P.rays[Rp + ray], P.rays[2 * Rp + ray]};
  const V3 d = {P.rays[3 * Rp + ray], P.rays[4 * Rp + ray], P.rays[5 * Rp + ray]};
  const float tmin = P.rays[6 * Rp + ray];
  const float tmax = P.rays[7 * Rp + ray];

  float best_t = tmax;
  int best_row = -1;
  const float omag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  const int count = P.counts[i];
  const int* list = P.order + (size_t)i * P.nl;
  const float* dist_lb = P.dists + (size_t)i * P.nl;
  int j = 0;
  for (; j < count;) {
    const int entry = list[j];
    for (int m = 0; m < kMembers; ++m) {
      const int blk = entry * kMembers + m;
      __syncthreads();  // the previous block's rows are no longer read
      stage(P.p, blk, rows4);
      __syncthreads();
      test_rows(rows4, blk, o, d, omag, tmin, best_t, best_row);
    }
    ++j;
    if (j % kCheckEvery == 0 && j < P.nl) {
      float w = best_t;
      for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
      if ((lane & 31) == 0) warp_max[lane >> 5] = w;
      __syncthreads();
      if (lane < 32) {
        w = warp_max[lane];
        for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
        if (lane == 0) stop = w < dist_lb[j];
      }
      __syncthreads();
      if (stop) break;
    }
  }
  if (lane == 0) P.pairs[i] = kMembers * j;

  float n[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float m[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (best_row >= 0) {
    float c[12];
    const float4* row4 = reinterpret_cast<const float4*>(P.p) + (size_t)best_row * 4;
    *reinterpret_cast<float4*>(c + 0) = __ldg(row4 + 0);
    *reinterpret_cast<float4*>(c + 4) = __ldg(row4 + 1);
    *reinterpret_cast<float4*>(c + 8) = __ldg(row4 + 2);
    const RowChain rc = row_chain(c, o, d);
    const float b1 = P.split ? bf16_round(rc.b1) : rc.b1;
    const float b2 = P.split ? bf16_round(rc.b2) : rc.b2;
    const size_t ncol = (size_t)P.nb * 3 * TB;
    const float* seg0 = P.nrm + (size_t)(best_row / TB) * 3 * TB + best_row % TB;
    for (int r = 0; r < 3; ++r) {
      const float* s = seg0 + r * ncol;
      n[r] = s[0] + (s[TB] * b1 + s[2 * TB] * b2);
    }
    for (int r = 3; r < 8; ++r) n[r] = seg0[r * ncol];
    for (int r = 0; r < 8; ++r) m[r] = seg0[r * ncol + TB];
  }
  P.out_t[ray] = best_t;
  P.out_i[ray] = best_row;
  for (int r = 0; r < 8; ++r) {
    P.out_n[r * Rp + ray] = n[r];
    P.out_m[r * Rp + ray] = m[r];
  }
}

}  // namespace

extern "C" int intersect_launch(const float* p, const float* nrm, const int* counts,
                                const int* order, const float* dists, const float* rays,
                                float* out_t, int* out_i, float* out_n, float* out_m,
                                int* pairs, int nrb, int nl, int nb, int split, int hbm,
                                void* stream) {
  Params P;
  P.p = p;
  P.nrm = nrm;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.rays = rays;
  P.out_t = out_t;
  P.out_i = out_i;
  P.out_n = out_n;
  P.out_m = out_m;
  P.pairs = pairs;
  P.nl = nl;
  P.nb = nb;
  P.Rp = nrb * BR;
  P.split = split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hbm)
    intersect_kernel<true><<<nrb, BR, 0, s>>>(P);
  else
    intersect_kernel<false><<<nrb, BR, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
