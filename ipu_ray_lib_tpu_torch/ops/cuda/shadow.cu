// Fused shadow-trace kernel for Hopper (sm_90a): primary closest hit, one
// shadow ray to a point light, occlusion, for bundles of 1,024 rays.
//
// Replaces the TPU kernel ipu_ray_lib_tpu/ops/pallas/shadow_kernel.py
// `_shadow_kernel` (K4). One thread block of 1,024 threads owns one bundle
// of 1,024 consecutive rays, one thread per ray, and keeps the TPU
// kernel's per-bundle decisions:
// - the primary walk tests the bundle's block list (the bundle cull,
//   ops/cull.py) nearest first, and after every CHECK_EVERY = 4 tested
//   blocks stops once the block-wide max of best t is below the next
//   block's distance bound (shared-memory max, __syncthreads);
// - the occlusion walk tests, in ascending order, every block that any
//   ray of the bundle flags with K4's own conservative slab test of its
//   shadow ray (a shared bitmask, warp ballots and atomicOr).
// Each tested block's 128 triangle rows (8 KB) are staged in shared memory,
// so all threads test the same rows without divergence. Ties resolve as
// on the TPU: inside a block the lowest row (strictly smaller t replaces,
// rows ascending), across blocks the block first in the walk.
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
// What bounds it on this card: operations. Each admitted (bundle, block)
// pair of either walk costs 1,024 rays x 128 rows x ~49 f32 operations;
// the slab flags ~30 per (ray, block), the sphere and disc tests ~45 per
// (ray, primitive), twice. The tables (p: 8 KB per block) are read from
// device memory once per pair, which is far below the operations' time.
// What the design does about it now: the per-bundle walk keeps the TPU
// kernel's work exactly (no per-ray cull), the staging makes row reads
// shared-memory broadcasts; nothing more yet.

#include "rows.cuh"

namespace {

using namespace rows;

constexpr int CHECK_EVERY = 4;

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
  int nb, n_sph, n_dsc, Rp;
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

__global__ void __launch_bounds__(BR) shadow_kernel(const Params P) {
  __shared__ float4 rows4[TB * 4];
  __shared__ float warp_max[BR / 32];
  __shared__ int stop;
  extern __shared__ unsigned flags[];  // (nb + 31) / 32 words

  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t ray = (size_t)i * BR + lane;
  const int nb = P.nb;
  const float INF = kInf();
  const V3 o = {P.rays[ray], P.rays[P.Rp + ray], P.rays[2 * (size_t)P.Rp + ray]};
  const V3 d = {P.rays[3 * (size_t)P.Rp + ray], P.rays[4 * (size_t)P.Rp + ray],
                P.rays[5 * (size_t)P.Rp + ray]};
  const float tmin = P.rays[6 * (size_t)P.Rp + ray];
  const float tmax = P.rays[7 * (size_t)P.Rp + ray];

  // ---- primary walk: the bundle's list, nearest first, early stop ----
  float best_t = tmax;
  int best_row = -1;
  const float omag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  const int count = P.counts[i];
  const int* list = P.order + (size_t)i * nb;
  const float* dist_lb = P.dists + (size_t)i * nb;
  for (int j = 0; j < count;) {
    const int blk = list[j];
    __syncthreads();  // the previous block's rows are no longer read
    stage(P.p, blk, rows4);
    __syncthreads();
    test_rows(rows4, blk, o, d, omag, tmin, best_t, best_row);
    ++j;
    if (j % CHECK_EVERY == 0 && j < nb) {
      float m = best_t;
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((lane & 31) == 0) warp_max[lane >> 5] = m;
      __syncthreads();
      if (lane < 32) {
        float w = warp_max[lane];
        for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
        if (lane == 0) stop = w < dist_lb[j];
      }
      __syncthreads();
      if (stop) break;
    }
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

  // ---- per-bundle block flags: any ray's conservative slab hit ----
  const int n_words = (nb + 31) / 32;
  for (int w = lane; w < n_words; w += BR) flags[w] = 0u;
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
    const unsigned vote = __ballot_sync(0xffffffffu, hit);
    if ((lane & 31) == 0 && vote) atomicOr(&flags[b >> 5], 1u << (b & 31));
  }
  __syncthreads();

  // ---- occlusion walk over the flagged blocks, ascending ----
  const float somag = jmax(jmax(fabsf(so.x), fabsf(so.y)), fabsf(so.z));
  float s_t = dist;
  int s_row = -1;
  for (int w = 0; w < n_words; ++w) {
    unsigned bits = flags[w];
    while (bits) {
      const int b = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
      __syncthreads();
      stage(P.p, b, rows4);
      __syncthreads();
      // A ray with a hit is occluded already; further rows only lower t.
      if (s_row < 0) test_rows(rows4, b, so, sdir, somag, tmin, s_t, s_row);
    }
  }
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
}

}  // namespace

extern "C" int shadow_smem_bytes(int nb) { return ((nb + 31) / 32) * 4; }

extern "C" int shadow_launch(const float* p, const float* nrm, const float* baabb,
                             const float* ap, const int* counts, const int* order,
                             const float* dists, const float* rays, float* out_f,
                             int* out_i, int nrb, int nb, int n_sph, int n_dsc,
                             float lx, float ly, float lz, void* stream) {
  Params P;
  P.p = p;
  P.nrm = nrm;
  P.baabb = baabb;
  P.ap = ap;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.rays = rays;
  P.out_f = out_f;
  P.out_i = out_i;
  P.nb = nb;
  P.n_sph = n_sph;
  P.n_dsc = n_dsc;
  P.Rp = nrb * BR;
  P.lx = lx;
  P.ly = ly;
  P.lz = lz;
  shadow_kernel<<<nrb, BR, shadow_smem_bytes(nb), static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
