// Fused shadow-trace kernel for Hopper (sm_90a): primary closest hit, one
// shadow ray to a point light, occlusion, for bundles of 1,024 rays.
//
// Replaces the TPU kernel ipu_ray_lib_tpu/ops/pallas/shadow_kernel.py
// `_shadow_kernel` (K4). A bundle of 1,024 consecutive rays, one thread
// per ray, is a cluster of CL = 4 CTAs of 256 threads (the 64 bundles of
// a 65,536-ray chunk fill the card as 256 CTAs; one CTA of 1,024 threads
// per bundle ran 1.5x slower over the shadow frame on an H100), and keeps
// the TPU kernel's per-bundle decisions:
// - the primary walk walks the bundle's block list (the bundle cull,
//   ops/cull.py) nearest first, and after every CHECK_EVERY = 4 blocks
//   stops once the max of best t over the bundle's 1,024 lanes is below
//   the next block's distance bound (each CTA's max, then the cluster's
//   through distributed shared memory; rows.cuh BundleSync);
// - the occlusion walk walks, in ascending order, every block that any
//   ray of the bundle flags with K4's own conservative slab test of its
//   shadow ray (each CTA's bitmask by warp ballots and atomicOr, then
//   their OR over the cluster through distributed shared memory).
// Within those, a lane tests a block only when its exact cull admits it
// for a hit below its best t (rows.cuh lane_admits: the block is
// unbounded, or its padded box lies in the lane's slab), and a lane
// already occluded tests nothing more. Per block each CTA lists its
// admitting lanes and spreads their row tests over all its threads, the
// rows staged in shared memory by cp.async while the previous block is
// tested (rows.cuh walk_step, as K5's).
// Ties resolve as on the TPU: inside a block the lowest row (strictly
// smaller t replaces, rows ascending), across blocks the block first in
// the walk.
//
// Per ray, every formula is the TPU kernel's as XLA compiles its CPU
// interpret mode, which is what the JAX package's results come from: a
// product feeding a sum is one fused multiply-add there, so those
// places call __fmaf_rn explicitly (a*b + c*d + e*f is
// fma(e, f, fma(a, b, c*d)); x - y*z is fma(-y, z, x)); everything else
// rounds each operation (built with -fmad=false, IEEE division and
// square root). The plain torch version (ops/shadow.py,
// shadow_trace_ref) spells out the same operations and is the check.
// The sphere and disc tests are K4's (the ops/dense.py twins), not K1's
// analytic_hit; the winner's barycentrics stay f32; the slab flags use
// SLAB_SCALE = 1 + 2 gamma_3 and decide zero-direction axes by whether
// the origin lies in the slab.
//
// Outputs (raw decisions and values, as the TPU kernel's): out_f [4, Rp]
// = the winning triangle's raw shading normal xyz, hit t; out_i [4, Rp] =
// triangle row or -1, sphere index or -1, disc index or -1, occluded.
//
// Outputs beside them, per bundle, when `pairs` is given (the checks and
// the measurements; the renderer passes none): pairs [4, nrb] = blocks
// the primary walk walked, blocks in the occlusion union, and the (lane,
// block) pairs each walk's lanes tested.
//
// What bounds it on this card: operations. Each tested (lane, block) pair
// of either walk costs 128 rows x ~33 f32 instructions; the slab flags
// ~30 per (ray, block), the sphere and disc tests ~45 per (ray,
// primitive), twice. The tables (p: 8 KB per block) come through L1/L2,
// far below the operations' time. What the design does about it: the
// lanes test only the pairs their cull admits, and the clusters put the
// 64 bundles of a chunk on 256 CTAs over the card's 132 SMs.

#include "rows.cuh"

namespace {

using namespace rows;

constexpr int CHECK_EVERY = 4;
constexpr int CL = 4;         // CTAs per bundle, a cluster
constexpr int NT = BR / CL;   // threads per CTA

struct Params {
  const float* p;       // [nb*TB, 16] triangle rows
  const float* nrm;     // [8, nb*3*TB] normal basis + material
  const float* baabb;   // [nb, 8] block AABBs
  const float* ap;      // [n_ap, 16] sphere rows [0, n_sph), then disc rows
  const int* counts;    // [nrb] listed blocks per bundle
  const int* order;     // [nrb, nb] block list, nearest first
  const float* dists;   // [nrb, nb] distance bounds of the list
  const float* rays;    // [8, Rp] origin, direction, t_min, t_max rows
  float* out_f;         // [4, Rp]
  int* out_i;           // [4, Rp]
  const float* pbox;    // [nb, 8] padded boxes (ops/tables.py)
  int* pairs;           // [4, nrb] per bundle (zeroed), or null
  unsigned long long* cnt;  // [K_N] counters of a counting launch
  int nb, n_sph, n_dsc, Rp, nrb, spread;
  float lx, ly, lz;     // the point light
};

// Nearest sphere (ops/dense.py dense_spheres twin, shadow_kernel.py:174-211).
__device__ __forceinline__ void sphere_pass(const Params& P, V3 o, V3 d, float tmin,
                                            float& cur_t, int& cur_i, V3& cur_c) {
  const float rd2 = 1.0f / dotf(d, d);
  cur_t = kInf();
  cur_i = 0;
  cur_c = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < P.n_sph; ++s) {
    const float* a = P.ap + s * 16;
    const V3 c = {a[1], a[2], a[3]};
    const float r2 = a[7];
    const V3 oc = {c.x - o.x, c.y - o.y, c.z - o.z};
    const float tca = dotf(oc, d) * rd2;
    const V3 l = {__fmaf_rn(-d.x, tca, oc.x), __fmaf_rn(-d.y, tca, oc.y),
                  __fmaf_rn(-d.z, tca, oc.z)};
    const float l2 = dotf(l, l);
    const float td = sqrtf(jmax(r2 - l2, 0.0f)) * rd2;
    const float t0 = tca - td, t1 = tca + td;
    float t = t0 < tmin ? t1 : t0;
    const bool miss = tca < 0.0f || l2 > r2 || t < tmin || r2 <= 0.0f;
    if (miss || t <= tmin) t = kInf();
    if (t < cur_t) {
      cur_t = t;
      cur_i = s;
      cur_c = c;
    }
  }
}

// Nearest disc (ops/dense.py dense_discs twin, shadow_kernel.py:213-249).
__device__ __forceinline__ void disc_pass(const Params& P, V3 o, V3 d, float tmin,
                                          float& cur_t, int& cur_i, V3& cur_n) {
  cur_t = kInf();
  cur_i = 0;
  cur_n = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < P.n_dsc; ++s) {
    const float* a = P.ap + (P.n_sph + s) * 16;
    const V3 c = {a[1], a[2], a[3]}, n = {a[4], a[5], a[6]};
    const float r2 = a[7], d_off = a[8];
    const float angle = dotf(d, n);
    float t = -(dotf(o, n) + d_off) / angle;
    const V3 h = {__fmaf_rn(d.x, t, o.x) - c.x, __fmaf_rn(d.y, t, o.y) - c.y,
                  __fmaf_rn(d.z, t, o.z) - c.z};
    const float d2 = dotf(h, h);
    const bool ok = angle != 0.0f && t > kMachEps() && d2 < r2 && r2 > 0.0f && t > tmin;
    if (!ok) t = kInf();
    if (t < cur_t) {
      cur_t = t;
      cur_i = s;
      cur_n = n;
    }
  }
}

template <bool kCount>
__global__ void __launch_bounds__(NT) shadow_kernel(const Params P) {
  constexpr unsigned wm = 0xffffffffu;
  __shared__ BundleSync<NT, CL> sync;
  extern __shared__ __align__(16) unsigned char smem[];
  WalkSmem<NT>& W = *reinterpret_cast<WalkSmem<NT>*>(smem);
  // 2 x (nb + 31) / 32 words: this CTA's flags, then the bundle's union
  unsigned* flags = reinterpret_cast<unsigned*>(smem + sizeof(WalkSmem<NT>));

  Cnt C = {};
  long long tc = kCount ? clock64() : 0;
  const int i = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const bool head = blockIdx.x % CL == 0 && tid == 0;
  const int lane = tid & 31;
  const size_t ray = (size_t)i * BR + (blockIdx.x % CL) * NT + tid;
  const int nb = P.nb;
  const float INF = kInf();
  const V3 o = {P.rays[ray], P.rays[P.Rp + ray], P.rays[2 * (size_t)P.Rp + ray]};
  const V3 d = {P.rays[3 * (size_t)P.Rp + ray], P.rays[4 * (size_t)P.Rp + ray],
                P.rays[5 * (size_t)P.Rp + ray]};
  const float tmin = P.rays[6 * (size_t)P.Rp + ray];
  const float tmax = P.rays[7 * (size_t)P.Rp + ray];
  if (kCount) C.v[K_LIVE_LANES] = tmin < tmax;

  // ---- primary walk: the bundle's list, nearest first, early stop ----
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
  const int count = P.counts[i];
  const int* list = P.order + (size_t)i * nb;
  const float* dist_lb = P.dists + (size_t)i * nb;
  int tested = 0, occ_tested = 0;  // this CTA's (lane, block) pairs
  int buf = 0, parity = 0, j = 0;
  if (count > 0) stage_async<NT>(W.stage[0], P.p, list[0]);
  tick<kCount>(C, K_CYC_EPILOGUE, tc);
  while (j < count) {
    tested += walk_step<NT, kCount>(W, P.p, P.pbox, list[j], j + 1 < count ? list[j + 1] : -1,
                                    buf, true, L, tmin, best_t, best_row, P.spread, C, tc);
    ++j;
    if (j % CHECK_EVERY == 0 && j < nb) {
      const bool stop = sync.stops(best_t, dist_lb[j], parity);
      tick<kCount>(C, K_CYC_STAGE, tc);
      if (stop) break;
    }
  }
  stage_wait();
  tick<kCount>(C, K_CYC_STAGE, tc);
  if (kCount && head) {
    C.v[K_BUNDLE_BLOCKS] = j;
    C.v[K_MAX_BUNDLE_BLOCKS] = j;
  }

  const bool found_tri = best_row >= 0;
  float best = found_tri ? best_t : tmax;
  V3 n_raw = {0.0f, 0.0f, 0.0f};
  if (found_tri) {  // shading normal N0 + (dN1*b1 + dN2*b2), f32 barycentrics
    float c[12];
    const float4* row4 = reinterpret_cast<const float4*>(P.p) + (size_t)best_row * 4;
    *reinterpret_cast<float4*>(c + 0) = __ldg(row4 + 0);
    *reinterpret_cast<float4*>(c + 4) = __ldg(row4 + 1);
    *reinterpret_cast<float4*>(c + 8) = __ldg(row4 + 2);
    const RowChain rc = row_chain(c, o, d);
    const size_t ncol = (size_t)nb * 3 * TB;
    const float* seg0 = P.nrm + (size_t)(best_row / TB) * 3 * TB + best_row % TB;
    n_raw.x = seg0[0] + (seg0[TB] * rc.b1 + seg0[2 * TB] * rc.b2);
    n_raw.y = seg0[ncol] + (seg0[ncol + TB] * rc.b1 + seg0[ncol + 2 * TB] * rc.b2);
    n_raw.z = seg0[2 * ncol] + (seg0[2 * ncol + TB] * rc.b1 + seg0[2 * ncol + 2 * TB] * rc.b2);
  }
  tick<kCount>(C, K_CYC_EPILOGUE, tc);

  // ---- spheres, then discs, override when strictly nearer ----
  float st, dt;
  int si, di;
  V3 s_c, d_n;
  sphere_pass(P, o, d, tmin, st, si, s_c);
  const bool sb = st < best;
  if (sb) best = st;
  disc_pass(P, o, d, tmin, dt, di, d_n);
  const bool db = dt < best;
  if (db) best = dt;
  tick<kCount>(C, K_CYC_PRIMS, tc);
  const bool found = found_tri || sb || db;
  const float hit_t = found ? best : tmax;

  // ---- the kernel's own normal, hit point and shadow ray ----
  V3 normal = {0.0f, 0.0f, 1.0f};
  const float hp_t = found ? hit_t : 0.0f;
  const V3 hp = {__fmaf_rn(d.x, hp_t, o.x), __fmaf_rn(d.y, hp_t, o.y),
                 __fmaf_rn(d.z, hp_t, o.z)};
  if (found) {
    if (db) {
      normal = d_n;
    } else if (sb) {
      const V3 v = {hp.x - s_c.x, hp.y - s_c.y, hp.z - s_c.z};
      const float inv = jmax(sqrtf(dotf(v, v)), kTiny());
      normal = {v.x / inv, v.y / inv, v.z / inv};
    } else {
      const float inv = jmax(sqrtf(dotf(n_raw, n_raw)), kTiny());
      normal = {n_raw.x / inv, n_raw.y / inv, n_raw.z / inv};
    }
  }
  const V3 loff = {P.lx - hp.x, P.ly - hp.y, P.lz - hp.z};
  const float dist = sqrtf(dotf(loff, loff));
  const float dinv = jmax(dist, kTiny());
  const V3 sdir = {loff.x / dinv, loff.y / dinv, loff.z / dinv};
  const float mag = 1.0f + jmax(jmax(fabsf(hp.x), fabsf(hp.y)), fabsf(hp.z));
  const float nd = dotf(normal, sdir);
  float sgn = (float)((0.0f < nd) - (nd < 0.0f));  // torch.sign (0 for NaN)
  if (sgn == 0.0f) sgn = 1.0f;
  const float m_off = mag * kRayEps() * sgn;
  const V3 so = {__fmaf_rn(normal.x, m_off, hp.x), __fmaf_rn(normal.y, m_off, hp.y),
                 __fmaf_rn(normal.z, m_off, hp.z)};
  tick<kCount>(C, K_CYC_EPILOGUE, tc);

  // ---- per-bundle block flags: any ray's conservative slab hit ----
  const int n_words = (nb + 31) / 32;
  for (int w = tid; w < n_words; w += NT) flags[w] = 0u;
  __syncthreads();
  const float s_o[3] = {so.x, so.y, so.z}, s_d[3] = {sdir.x, sdir.y, sdir.z};
  for (int b = 0; b < nb; ++b) {
    const float* box = P.baabb + (size_t)b * 8;
    float tin = -INF, tout = INF;
    for (int a = 0; a < 3; ++a) {
      const float lo = __ldg(box + a), hi = __ldg(box + a + 3);
      const float da = s_d[a], oa = s_o[a];
      const float inv = 1.0f / (da == 0.0f ? 1.0f : da);
      const float t1 = (lo - oa) * inv, t2 = (hi - oa) * inv;
      float tn = jmin(t1, t2), tf = jmax(t1, t2) * kSlabScale();
      if (da == 0.0f) {
        const bool inside = oa >= lo && oa <= hi;
        tn = inside ? -INF : INF;
        tf = inside ? INF : -INF;
      }
      tin = jmax(tin, tn);
      tout = jmin(tout, tf);
    }
    const bool hit = tin <= tout && tout >= 0.0f && tin <= dist && __ldg(box) < kBig30();
    const unsigned vote = __ballot_sync(wm, hit);
    if (lane == 0 && vote) atomicOr(&flags[b >> 5], 1u << (b & 31));
  }
  __syncthreads();
  {  // the bundle's union: the OR of its CTAs' flags
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int w = tid; w < n_words; w += NT) {
      unsigned u = 0u;
#pragma unroll
      for (int r = 0; r < CL; ++r) u |= cluster.map_shared_rank(flags, r)[w];
      flags[n_words + w] = u;
    }
    __syncthreads();
  }
  const unsigned* uni = flags + n_words;
  tick<kCount>(C, K_CYC_FLAGS, tc);

  // ---- occlusion walk over the union's blocks, ascending ----
  const float somag = jmax(jmax(fabsf(so.x), fabsf(so.y)), fabsf(so.z));
  const LaneRay SL = lane_ray(so, sdir, somag);
  W.ox[tid] = so.x;
  W.oy[tid] = so.y;
  W.oz[tid] = so.z;
  W.dx[tid] = sdir.x;
  W.dy[tid] = sdir.y;
  W.dz[tid] = sdir.z;
  float s_t = dist;
  int s_row = -1;
  int n_union = 0;
  for (int w = 0; w < n_words; ++w) n_union += __popc(uni[w]);
  // A lane with a hit is occluded already and tests nothing more.
  __syncthreads();  // no thread reads the stage of the primary walk
  int b = next_flag(uni, n_words, -1);
  if (b >= 0) stage_async<NT>(W.stage[buf], P.p, b);
  while (b >= 0) {
    const int nx = next_flag(uni, n_words, b);
    occ_tested += walk_step<NT, kCount>(W, P.p, P.pbox, b, nx, buf, s_row < 0, SL, tmin,
                                        s_t, s_row, P.spread, C, tc);
    b = nx;
  }
  stage_wait();
  if (kCount && head) C.v[K_OCC_BLOCKS] = n_union;
  const bool s_tri = s_row >= 0;
  float s_best = s_tri ? s_t : dist;
  float sst, sdt;
  int unused_i;
  V3 unused_v;
  sphere_pass(P, so, sdir, tmin, sst, unused_i, unused_v);
  const bool ssb = sst < s_best;
  if (ssb) s_best = sst;
  disc_pass(P, so, sdir, tmin, sdt, unused_i, unused_v);
  const bool sdb = sdt < s_best;
  if (sdb) s_best = sdt;
  tick<kCount>(C, K_CYC_PRIMS, tc);
  const bool s_found = s_tri || ssb || sdb;
  const bool occ = s_found && ((s_found ? s_best : dist) < dist);

  const size_t Rp = P.Rp;
  P.out_f[ray] = n_raw.x;
  P.out_f[Rp + ray] = n_raw.y;
  P.out_f[2 * Rp + ray] = n_raw.z;
  P.out_f[3 * Rp + ray] = hit_t;
  P.out_i[ray] = best_row;
  P.out_i[Rp + ray] = sb ? si : -1;
  P.out_i[2 * Rp + ray] = db ? di : -1;
  P.out_i[3 * Rp + ray] = occ ? 1 : 0;
  if (head && P.pairs) {
    P.pairs[i] = j;
    P.pairs[P.nrb + i] = n_union;
  }
  if (tid == 0 && P.pairs) {
    atomicAdd(P.pairs + 2 * P.nrb + i, tested);
    atomicAdd(P.pairs + 3 * P.nrb + i, occ_tested);
  }
  if (kCount) {
    tick<kCount>(C, K_CYC_EPILOGUE, tc);
    if (tid == 0) {
      C.v[K_LANE_PAIRS] = tested;
      C.v[K_OCC_LANE_PAIRS] = occ_tested;
    }
    flush<kCount>(C, P.cnt);
  }
  cooperative_groups::this_cluster().sync();  // DSMEM reads done
}

// One K4 launch: nrb bundles, a cluster of CL CTAs each.
template <bool kCount>
cudaError_t launch_k4(const Params& P, int flag_bytes, cudaStream_t s) {
  const int smem = (int)sizeof(WalkSmem<NT>) + flag_bytes;
  static int opted = 0;  // the dynamic shared memory a kernel opted in to
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        shadow_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.nrb * CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, shadow_kernel<kCount>, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();  // a refused cluster launch never runs
}

}  // namespace

extern "C" int shadow_smem_bytes(int nb) { return 2 * ((nb + 31) / 32) * 4; }

extern "C" int shadow_launch(const float* p, const float* nrm, const float* baabb,
                             const float* ap, const float* pbox, const int* counts,
                             const int* order, const float* dists, const float* rays,
                             float* out_f, int* out_i, int* pairs, unsigned long long* cnt,
                             int nrb, int nb, int n_sph, int n_dsc, int spread,
                             float lx, float ly, float lz, void* stream) {
  Params P;
  P.p = p;
  P.nrm = nrm;
  P.baabb = baabb;
  P.ap = ap;
  P.pbox = pbox;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.rays = rays;
  P.out_f = out_f;
  P.out_i = out_i;
  P.pairs = pairs;
  P.cnt = cnt;
  P.nb = nb;
  P.n_sph = n_sph;
  P.n_dsc = n_dsc;
  P.Rp = nrb * BR;
  P.nrb = nrb;
  P.spread = spread;
  P.lx = lx;
  P.ly = ly;
  P.lz = lz;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = shadow_smem_bytes(nb);
  const cudaError_t err = cnt ? launch_k4<true>(P, smem, s) : launch_k4<false>(P, smem, s);
  return static_cast<int>(err);
}
