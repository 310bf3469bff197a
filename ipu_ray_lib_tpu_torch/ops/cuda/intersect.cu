// Closest-hit kernels for Hopper (sm_90a): K5 over a bundle's triangle-block
// list, K6 over its super list (8 blocks per super), for bundles of 1,024
// rays.
//
// Replaces the TPU kernels ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py
// `_dense_kernel` (K5) and ops/pallas/intersect_hbm.py `_hbm_kernel` (K6).
// Both walk a bundle's list from the bundle cull (ops/cull.py), nearest
// first (K6: all 8 member blocks of each listed super, in order), and
// after every CHECK_EVERY listed entries (4 blocks for K5, 2 supers for
// K6) stop once the bundle's max of best t is below the next entry's
// distance bound: no later entry can then hold a nearer hit, so the stop
// changes no result. Ties resolve as on the TPU: inside a block the
// lowest row, across blocks (and K6's members) the block first in the
// walk.
//
// K5 (`bundle_kernel`) walks each bundle's list with one thread per ray,
// a bundle being one CTA of 1,024 threads (clusters of 2 and 4 CTAs ran
// 20-25% slower over a path-B frame on an H100). Within the bundle's
// decisions, which stay the dense walk's, a lane tests a block only when
// its exact cull admits it (rows.cuh lane_admits): the block is
// unbounded, or its padded box lies in the lane's slab with an entry
// below the lane's best t. Per block each CTA lists its admitting lanes
// and shares their row tests over its warps (rows.cuh walk_step: a warp
// takes 32 listed lanes against one chunk of the block's rows, staged in
// shared memory by cp.async while the previous block is tested). Each
// bundle reports the (lane, block) pairs its lanes tested
// (`lane_pairs`).
//
// K6's walk is split over the whole card, exactly, in waves. A chunk is
// CHECK_EVERY consecutive entries of one bundle's list: the stretch
// between two stop checks. A wave takes the next W chunks of every bundle
// that has not stopped. `chunk_kernel` tests them all at once
// (speculatively: those past the bundle's stop are wasted), each (chunk,
// quarter of the bundle's lanes) an item of a grid-stride loop over the
// card's SMs; per lane it writes the chunk's own first strict minimum
// (t, row), starting from the lane's t_max, to scratch the wrapper
// allocates. `fold_kernel`, one block per bundle, then folds the wave's
// chunks in walk order with the sequential rules: a chunk's hit replaces
// the lane's best only when strictly nearer (an earlier chunk keeps a
// tie), and after each chunk the bundle stops once its max of best t is
// below the next entry's bound. A bundle that has not stopped keeps its
// running best in out_t/out_i and its entries walked in `state` for the
// next wave. So every lane's best t and row, and the blocks the bundle
// tested (`pairs`: 8 * j at the stop), are the sequential walk's,
// bit for bit; the blocks tested past the stop are counted apart
// (`spec`). The host knows the number of waves from the list's width, so
// nothing waits for the device. A chunk's member blocks (8 KB of rows
// each) come into a double buffer in shared memory by bulk copies
// (cp.async.bulk, the TMA engine) completing on an mbarrier, the next
// block's copy in flight while the current one is tested (rows.cuh
// test_rows, every lane against every row).
//
// (K5 took the same split in a trial and ran 11-14% slower over a path-B
// frame, its 128 bundles a launch already spread over the card.)
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
// where nothing is hit; and [nrb] the blocks each bundle's walk tested
// (`pairs`) and the blocks tested beyond its stop (`spec`).
//
// What bounds it on this card: operations. Each tested (bundle, block)
// pair costs 1,024 rays x 128 rows x ~33 f32 instructions; the rows are
// read from L2 once per pair (per quarter bundle in K6: 8 KB), far below
// the operations' time. What the design does about it: K6's bundles no
// longer walk on one SM each (a launch took as long as its longest
// bundle, 39 us per block of it on an H100); K5's lanes test only the
// blocks their exact cull admits (the path-B frame's hits need 5.8% of
// the (lane, block) pairs its bundles walk). K6 keeps the TPU kernel's
// work per bundle (no per-lane cull yet).

#include "rows.cuh"

namespace {

using namespace rows;

constexpr int SB = 8;           // K6: blocks per super
constexpr int kCheckK5 = 4;     // K5: blocks between stop checks
constexpr int kCheckK6 = 2;     // K6: supers between stop checks (a chunk)
constexpr int LG = 256;         // K6: lanes of a chunk item, a quarter bundle
constexpr int NQ = BR / LG;     // K6: items per chunk
constexpr unsigned kBlockBytes = TB * 16 * sizeof(float);

struct Params {
  const float* p;       // [nb*TB, 16] triangle rows
  const float* nrm;     // [8, nb*3*TB] normal basis + material
  const int* counts;    // [nrb] listed entries per bundle
  const int* order;     // [nrb, nl] entry list, nearest first
  const float* dists;   // [nrb, nl] distance bounds of the list
  const float* rays;    // [8, Rp] origin, direction, t_min, t_max rows
  float* part_t;        // K6: [nrb, W, BR] a wave's chunks' own best t
  int* part_i;          // K6: [nrb, W, BR] and their rows
  int* state;           // K6: [nrb] entries walked, or -1 once stopped
  float* out_t;         // [Rp]
  int* out_i;           // [Rp]
  float* out_n;         // [8, Rp]
  float* out_m;         // [8, Rp]
  int* pairs;           // [nrb] blocks the walk tested per bundle
  int* spec;            // [nrb] blocks tested past the bundle's stop
  const float* pbox;    // K5: [nb, 8] padded boxes (ops/tables.py)
  int* lane_pairs;      // [nrb] (lane, block) pairs tested (K5: zeroed)
  unsigned long long* cnt;  // K5: [K_N] counters of a counting launch
  int nl, nb, nrb, Rp, split, W, wave, spread;
};

__device__ __forceinline__ V3 ray_o(const Params& P, size_t ray) {
  return {P.rays[ray], P.rays[P.Rp + ray], P.rays[2 * (size_t)P.Rp + ray]};
}
__device__ __forceinline__ V3 ray_d(const Params& P, size_t ray) {
  const size_t Rp = P.Rp;
  return {P.rays[3 * Rp + ray], P.rays[4 * Rp + ray], P.rays[5 * Rp + ray]};
}

// A lane's outputs: its best t and row, and its winner's payload.
__device__ __forceinline__ void write_hit(const Params& P, size_t ray, V3 o, V3 d,
                                          float best_t, int best_row) {
  const size_t Rp = P.Rp;
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

// K5: a bundle of 1,024 rays per CTA, walking its lanes (rows.cuh
// walk_step).
template <bool kCount>
__global__ void __launch_bounds__(BR) bundle_kernel(const Params P) {
  __shared__ BundleSync<BR, 1> sync;
  extern __shared__ __align__(16) unsigned char smem[];
  WalkSmem<BR>& W = *reinterpret_cast<WalkSmem<BR>*>(smem);

  Cnt C = {};
  long long tc = kCount ? clock64() : 0;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const bool head = tid == 0;
  const size_t Rp = P.Rp;
  const size_t ray = (size_t)i * BR + tid;
  const V3 o = ray_o(P, ray), d = ray_d(P, ray);
  const float tmin = P.rays[6 * Rp + ray];
  const float tmax = P.rays[7 * Rp + ray];
  const float omag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  const LaneRay L = lane_ray(o, d, omag);
  W.ox[tid] = o.x;
  W.oy[tid] = o.y;
  W.oz[tid] = o.z;
  W.dx[tid] = d.x;
  W.dy[tid] = d.y;
  W.dz[tid] = d.z;
  W.tmin[tid] = tmin;
  float best_t = tmax;
  int best_row = -1;
  if (kCount) C.v[K_LIVE_LANES] = tmin < tmax;
  const int count = P.counts[i];
  const int* list = P.order + (size_t)i * P.nl;
  const float* dist_lb = P.dists + (size_t)i * P.nl;
  int tested = 0;  // the bundle's (lane, block) pairs
  int buf = 0, parity = 0, j = 0;
  if (count > 0) stage_async<BR>(W.stage[0], P.p, list[0]);
  tick<kCount>(C, K_CYC_EPILOGUE, tc);
  while (j < count) {
    tested += walk_step<BR, kCount>(W, P.p, P.pbox, list[j], j + 1 < count ? list[j + 1] : -1,
                                    buf, true, L, tmin, best_t, best_row, P.spread, C, tc);
    ++j;
    if (j % kCheckK5 == 0 && j < P.nl) {
      const bool stop = sync.stops(best_t, dist_lb[j], parity);
      tick<kCount>(C, K_CYC_STAGE, tc);
      if (stop) break;
    }
  }
  stage_wait();
  tick<kCount>(C, K_CYC_STAGE, tc);
  if (head) {
    P.pairs[i] = j;
    P.spec[i] = 0;
    P.lane_pairs[i] = tested;
  }
  write_hit(P, ray, o, d, best_t, best_row);
  if (kCount) {
    tick<kCount>(C, K_CYC_EPILOGUE, tc);
    if (head) {
      C.v[K_LANE_PAIRS] = tested;
      C.v[K_BUNDLE_BLOCKS] = j;
      C.v[K_MAX_BUNDLE_BLOCKS] = j;
    }
    flush<kCount>(C, P.cnt);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
}

// Block blk's 8 KB of rows into dst, completing on bar (one thread).
__device__ __forceinline__ void bulk_load(float4* dst, const float* p, int blk,
                                          uint64_t* bar) {
  const float4* src = reinterpret_cast<const float4*>(p) + (size_t)blk * TB * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(kBlockBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(kBlockBytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until bar completes the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// K6, one wave: every (chunk, quarter bundle) of the wave an item.
__global__ void __launch_bounds__(LG) chunk_kernel(const Params P) {
  __shared__ __align__(128) float4 buf[2][TB * 4];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t parity = 0;  // bit s: the parity of bar[s]'s next phase
  const size_t Rp = P.Rp;
  const int n_items = P.nrb * P.W * NQ;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q = item % NQ, c = (item / NQ) % P.W, i = item / (NQ * P.W);
    const int e0 = (P.wave * P.W + c) * kCheckK6;
    const int count = P.counts[i];
    if (e0 >= count || (P.wave > 0 && P.state[i] < 0)) continue;
    const int nblk = (min(e0 + kCheckK6, count) - e0) * SB;
    const int* list = P.order + (size_t)i * P.nl + e0;
    const size_t ray = (size_t)i * BR + q * LG + tid;
    const V3 o = ray_o(P, ray), d = ray_d(P, ray);
    const float tmin = P.rays[6 * Rp + ray];
    float best_t = P.rays[7 * Rp + ray];
    int best_row = -1;
    const float omag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
    if (tid == 0) {
      for (int n = 0; n < 2 && n < nblk; ++n)
        bulk_load(buf[n], P.p, list[n / SB] * SB + n % SB, &bar[n]);
    }
    for (int n = 0; n < nblk; ++n) {
      const int s = n & 1;
      mbar_wait(&bar[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      test_rows(buf[s], list[n / SB] * SB + n % SB, o, d, omag, tmin, best_t, best_row);
      __syncthreads();  // buf[s] is no longer read
      if (tid == 0 && n + 2 < nblk)
        bulk_load(buf[s], P.p, list[(n + 2) / SB] * SB + (n + 2) % SB, &bar[s]);
    }
    const size_t at = ((size_t)i * P.W + c) * BR + q * LG + tid;
    P.part_t[at] = best_t;
    P.part_i[at] = best_row;
  }
}

// K6, one wave: one block per bundle folds the wave's chunks in walk order.
__global__ void __launch_bounds__(BR) fold_kernel(const Params P) {
  __shared__ BundleSync<BR, 1> sync;
  int parity = 0;

  const int i = blockIdx.x;
  if (P.wave > 0 && P.state[i] < 0) return;  // stopped in an earlier wave
  const int lane = threadIdx.x;
  const size_t ray = (size_t)i * BR + lane;
  float best_t = P.wave > 0 ? P.out_t[ray] : P.rays[7 * (size_t)P.Rp + ray];
  int best_row = P.wave > 0 ? P.out_i[ray] : -1;
  const int count = P.counts[i];
  const int c0 = P.wave * P.W;
  const int c1 = min(c0 + P.W, (count + kCheckK6 - 1) / kCheckK6);
  const float* dist_lb = P.dists + (size_t)i * P.nl;
  int j = P.wave > 0 ? P.state[i] : 0;
  bool stopped = false;
  for (int c = c0; c < c1 && !stopped; ++c) {
    const size_t at = ((size_t)i * P.W + (c - c0)) * BR + lane;
    const float pt = P.part_t[at];
    if (pt < best_t) {
      best_t = pt;
      best_row = P.part_i[at];
    }
    j = min(j + kCheckK6, count);
    stopped = j < count && j < P.nl && sync.stops(best_t, dist_lb[j], parity);
  }
  const bool more = !stopped && j < count;  // the next wave goes on
  __syncthreads();  // every lane has read the bundle's state
  if (lane == 0) {
    P.state[i] = more ? j : -1;
    if (!more) {
      P.pairs[i] = SB * j;
      P.lane_pairs[i] = BR * SB * j;
      P.spec[i] = SB * (min(c1 * kCheckK6, count) - j);
    }
  }
  if (more) {
    P.out_t[ray] = best_t;
    P.out_i[ray] = best_row;
  } else {
    write_hit(P, ray, ray_o(P, ray), ray_d(P, ray), best_t, best_row);
  }
}

// Resident chunk blocks on the whole card (computed once).
int chunk_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_kernel, LG, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  return grid;
}

// One K5 launch: nrb bundles, one CTA each.
template <bool kCount>
cudaError_t launch_k5(const Params& P, cudaStream_t s) {
  constexpr int smem = sizeof(WalkSmem<BR>);
  static bool opted = false;  // above 48 KB a kernel opts in once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        bundle_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  bundle_kernel<kCount><<<P.nrb, BR, smem, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int intersect_launch(const float* p, const float* nrm, const int* counts,
                                const int* order, const float* dists, const float* rays,
                                const float* pbox, float* part_t, int* part_i, int* state,
                                float* out_t, int* out_i, float* out_n, float* out_m,
                                int* pairs, int* spec, int* lane_pairs,
                                unsigned long long* cnt, int nrb, int nl, int nb, int split,
                                int W, int n_waves, int hbm, int spread, void* stream) {
  Params P;
  P.p = p;
  P.nrm = nrm;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.rays = rays;
  P.pbox = pbox;
  P.part_t = part_t;
  P.part_i = part_i;
  P.state = state;
  P.out_t = out_t;
  P.out_i = out_i;
  P.out_n = out_n;
  P.out_m = out_m;
  P.pairs = pairs;
  P.spec = spec;
  P.lane_pairs = lane_pairs;
  P.cnt = cnt;
  P.nl = nl;
  P.nb = nb;
  P.nrb = nrb;
  P.Rp = nrb * BR;
  P.split = split;
  P.W = W;
  P.wave = 0;
  P.spread = spread;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!hbm) {
    const cudaError_t err = cnt ? launch_k5<true>(P, s) : launch_k5<false>(P, s);
    return static_cast<int>(err);
  }
  const int grid = min(nrb * W * NQ, chunk_grid());
  for (P.wave = 0; P.wave < n_waves; ++P.wave) {
    chunk_kernel<<<grid, LG, 0, s>>>(P);
    fold_kernel<<<nrb, BR, 0, s>>>(P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
