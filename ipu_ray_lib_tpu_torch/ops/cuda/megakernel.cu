// Path-trace megakernel for Hopper (sm_90a): the whole bounce loop of a
// pool of ray slots in one kernel.
//
// Replaces the TPU kernel ipu_ray_lib_tpu/ops/pallas/megakernel.py
// `_mega_kernel` in VMEM mode (K1) and in HBM mode (K3, `hbm=True`,
// :1056-1549), which advances lane-major bundles of slots in lockstep and
// walks triangle blocks flagged for the whole bundle. Here one thread owns
// one slot and loops
// over the slot's K = J*spp paths on its own: camera ray, per-lane block
// cull, watertight triangle walk, deferred payload, sphere/disc tests,
// emission, BxDF sampling, roulette, banking into the slot's accumulator
// column, regeneration. Each lane's arithmetic in the TPU kernel is
// independent of the other lanes, so this per-thread loop reproduces it:
// the same counter-hash random numbers, the same operation order (built
// with -fmad=false and IEEE division/sqrt), the same tie rules. The plain
// torch version beside it (ops/megakernel.py, megakernel_path_trace_ref)
// is the check.
//
// The two modes differ only in the triangle walk and the payload
// (template parameter kHbm):
// - VMEM (K1): a lane tests every block whose AABB its slab admits, and
//   rounds the winner's barycentrics to bf16 before the payload;
// - HBM (K3): a lane walks the super-group AABBs, the 8 supers of each
//   admitted group, then refines each admitted super's 8 member blocks
//   against their AABBs and its best t at the super's entry (tin *
//   SLAB_LO < best_t, :1150-1162) and tests the rows of the blocks that
//   pass, in ascending order; the payload takes the winner's f32
//   barycentrics (:1362-1365, 1403-1405).
// Both walks run per warp: every lane of the warp takes the blocks (K3:
// the groups and supers) in ascending order in step, each lane with a
// live segment testing only the boxes its own walk would test, with its
// own best t, and the others taking part with nothing to test. A block
// that few of the warp's lanes need is tested with its rows spread over
// the warp, one needing lane at a time: every lane tests that lane's ray
// against rows lane, lane + 32, ... in order, and the warp reduces to the
// least t and, among equal t, the least row; a block that many lanes
// need is tested by each of them over its rows in order (`warp_rows`).
// Either way a lane's best t and row come out as its own walk over the
// same blocks, rows in ascending order with strict `<`, gives them, bit
// for bit. K1 reads the rows through the read-only cache (L1 broadcasts a
// row the whole warp reads and coalesces the spread rows); K3 stages the
// union of the member blocks its lanes need into shared memory, 64 rows
// at a time with coalesced 16-byte loads, so a block several lanes need
// is read from L2 or HBM once. The TPU streams each flagged super through
// VMEM by DMA and culls per bundle; here each lane culls for itself. The
// walks' shuffles and barriers take the whole warp, so no lane leaves the
// kernel early: the bounce loop runs while any lane of the warp is live,
// and a lane whose paths are done (or past the pool) only joins the
// walks.
//
// What bounds it on this card: the dense row test, ~50 f32 operations per
// (ray, triangle) pair with no FMA (so each is one instruction: half the
// card's 67 TFLOP/s, which counts an FMA as two), over the rows of every
// block the lane's walk admits; in HBM mode also ~15 per slab test at
// each level. The tables (p: 64 B per triangle row) stay in L1/L2 for
// small scenes; at millions of triangles a lane's blocks come from L2 or
// HBM (33 MB of rows at the grid-512 stress scene). Counting launches
// (kCount, only chip_smoke.py and the experiments make them) add
// clock64() cycles split between the group scan, the super and member
// slab tests, the row tests (staging included) and the rest of the
// bounce (payload, shading, banking), and the blocks each warp walks
// against the sum over its lanes.
//
// Accumulation: accum[(j*3 + c)*R + slot]; a slot's column is written by
// its own thread only, so no atomics and the per-pixel summation order is
// the reference's (paths in k order).
//
// Record mode (rec != nullptr; the NIF environment light, the env branch
// of the same TPU kernel, :2362-2413): where a finished path would be
// banked, its record is written instead, at rec[f*K*R + k*R + slot]:
// f = 0-2 colour, 3-5 throughput, 6 escaped (1 or 0), 7-9 the escape
// direction. The environment term never steers a path, so trajectories,
// random numbers and `done` are those of the direct mode. The env MLP
// (env_mlp.cu) then replaces 7-9 of the escaped records by their RGB
// radiance, and `bank` below adds each slot's records in k order:
// c = colour (+ throughput * env when escaped, per component, as at
// :2409-2413), accum[j(k)] += c. Without escapes that is bit for bit the
// direct mode's banking.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TB = 128;  // triangle rows per block
constexpr int SB = 8;    // blocks per super, supers per super-group

// f32 constants by bit pattern, equal to the host's np.float32 values:
__device__ __forceinline__ float kInf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float kBig() { return __int_as_float(0x7cf0bdc2); }        // 1e37
__device__ __forceinline__ float kSlabScale() { return __int_as_float(0x3f800005); }  // 1+6e-7
__device__ __forceinline__ float kSlabLo() { return __int_as_float(0x3f7ffff6); }     // 1-6e-7
__device__ __forceinline__ float kEpsClamp() { return __int_as_float(0x3a83126f); }   // 1e-3
__device__ __forceinline__ float kTiny() { return __int_as_float(0x0da24260); }       // 1e-30
__device__ __forceinline__ float kU1Min() { return __int_as_float(0x2b8cbccc); }      // 1e-12
__device__ __forceinline__ float kTwoPi() { return __int_as_float(0x40c90fdb); }
__device__ __forceinline__ float kPiBy2() { return __int_as_float(0x3fc90fdb); }
__device__ __forceinline__ float kPiBy4() { return __int_as_float(0x3f490fdb); }
__device__ __forceinline__ float kRayEps() { return __int_as_float(0x38bb8000); }     // 1500*2^-24

struct Params {
  const float* p;      // [nb*TB, 16] triangle rows
  const float* nrm;    // [8, nb*3*TB] normal basis + material
  const float* baabb;  // [nb, 8] block AABBs
  const float* saabb;  // [ns, 8] super AABBs (HBM mode)
  const float* sgaabb; // [ng, 8] super-group AABBs (HBM mode)
  const float* ap;     // [n_ap, 16] sphere/disc rows
  const float* apay;   // [16, n_ap] sphere/disc payload
  const float* rows;   // [J*R] pixel rows of the stream
  const float* cols;   // [J*R] pixel columns
  float* accum;        // [J*3*R] radiance sums (zeroed), or nullptr
  float* rec;          // [10, K, R] path records, or nullptr: bank directly
  int* done;           // [R] finished paths per slot
  unsigned long long* cnt;  // [N_COUNT] walk counters (counting launches)
  int R, J, spp, K_tot, nb, ns, ng, n_ap;
  int max_path_length, roulette_start_depth, max_iters;
  int spread_max;  // a block at most this many lanes need is tested spread
  uint32_t seed;
  int n_valid, j0, s0;  // s0: the first slot's index in the pool
  float sx, sy, inv_w, inv_h, aa;
};

// ---- counter-hash RNG (ops/rng.py; uint32 arithmetic wraps as JAX's) ----
__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}
__device__ __forceinline__ uint32_t absorb(uint32_t h, uint32_t s) {
  return mix(h ^ (s * 0x27D4EB2Fu + 0x9E3779B9u));
}
__device__ __forceinline__ float bits_to_u01(uint32_t h) {
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}
__device__ __forceinline__ float u01(uint32_t a, uint32_t b, uint32_t c) {
  return bits_to_u01(mix(absorb(absorb(absorb(0x811C9DC5u, a), b), c)));
}
__device__ __forceinline__ float u01(uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  return bits_to_u01(
      mix(absorb(absorb(absorb(absorb(0x811C9DC5u, a), b), c), d)));
}

// ---- float helpers with the reference's NaN semantics ----
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float inv_sqrt(float x) {
  return 1.0f / sqrtf(jmax(x, kTiny()));
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// 1/bf16(x) in f32 refined by one Newton step (the reference's
// pl.reciprocal(approx=True) off the TPU):
__device__ __forceinline__ float recip_approx(float x) {
  const float r = 1.0f / bf16_round(x);
  return r * (2.0f - x * r);
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 normalize(V3 v) {
  const float il = inv_sqrt(dot(v, v));
  return {v.x * il, v.y * il, v.z * il};
}

// ---- camera ray of path k (megakernel.py:482-509) ----
__device__ __forceinline__ void camera_ray(const Params& P, int s, uint32_t pid,
                                           int k, V3& o, V3& d) {
  const int j = k / P.spp;
  const float pr = P.rows[(size_t)j * P.R + s];
  const float pc = P.cols[(size_t)j * P.R + s];
  const float u1 = jmax(u01(pid, P.seed, 0xCA3u, 0xA5u), kU1Min());
  const float u2 = u01(pid, P.seed, 0xCA3u, 0x5Au);
  const float r = sqrtf(-2.0f * logf(u1));
  const float th = u2 * kTwoPi();
  const float g1 = r * cosf(th), g2 = r * sinf(th);
  const float pu = pr + g1 * P.aa;
  const float pv = pc + g2 * P.aa;
  const float xn = pv * P.inv_w - 0.5f;
  const float yn = pu * P.inv_h - 0.5f;
  d = normalize({xn * P.sx, yn * P.sy, -1.0f});
  o = {0.0f, 0.0f, -kRayEps()};
}

// ---- BxDFs (megakernel.py:237-311) ----
__device__ __forceinline__ V3 sample_diffuse(V3 n, float u1, float u2) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  V3 v2;
  if (use_x) {
    const float il = inv_sqrt(n.x * n.x + n.z * n.z);
    v2 = {-n.z * il, 0.0f, n.x * il};
  } else {
    const float il = inv_sqrt(n.y * n.y + n.z * n.z);
    v2 = {0.0f, n.z * il, -n.y * il};
  }
  const V3 v3 = {n.y * v2.z - n.z * v2.y, n.z * v2.x - n.x * v2.z,
                 n.x * v2.y - n.y * v2.x};
  const float ux = 2.0f * u1 - 1.0f;
  const float uy = 2.0f * u2 - 1.0f;
  float x = 0.0f, y = 0.0f;
  if (!(ux == 0.0f && uy == 0.0f)) {
    const bool use_ux = fabsf(ux) > fabsf(uy);
    const float r = use_ux ? ux : uy;
    const float th = use_ux ? (uy / (ux == 0.0f ? 1.0f : ux)) * kPiBy4()
                            : kPiBy2() - (ux / (uy == 0.0f ? 1.0f : uy)) * kPiBy4();
    x = r * cosf(th);
    y = r * sinf(th);
  }
  const float z = sqrtf(jmax(1.0f - x * x - y * y, 0.0f));
  return {(v2.x * x + v3.x * y) + n.x * z, (v2.y * x + v3.y * y) + n.y * z,
          (v2.z * x + v3.z * y) + n.z * z};
}

__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  const float m = -2.0f * dot(d, n);
  return normalize({d.x + n.x * m, d.y + n.y * m, d.z + n.z * m});
}

__device__ __forceinline__ V3 dielectric(V3 d, V3 n_in, float ior, float u1,
                                         bool& refracted) {
  const bool entering = dot(n_in, d) <= 0.0f;
  const V3 n = entering ? n_in : V3{n_in.x * -1.0f, n_in.y * -1.0f,
                                    n_in.z * -1.0f};
  const float ri = entering ? 1.0f / ior : ior;
  const float cost1 = -dot(n, d);
  const float cost2 = 1.0f - ri * ri * (1.0f - cost1 * cost1);
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  const float base = 1.0f - cost1;
  const float schlick = r0 + (1.0f - r0) * base * base * base * base * base;
  refracted = (cost2 > 0.0f) && (u1 > schlick);
  if (refracted) {
    const V3 rp = {(d.x + n.x * cost1) * ri, (d.y + n.y * cost1) * ri,
                   (d.z + n.z * cost1) * ri};
    const float par = -sqrtf(fabsf(1.0f - dot(rp, rp)));
    return {rp.x + n.x * par, rp.y + n.y * par, rp.z + n.z * par};
  }
  return reflect(d, n);
}

// ---- the watertight dense row test (megakernel.py:898-956) ----
struct RowTest {
  float t, b1, b2, on, r;
};
__device__ __forceinline__ RowTest row_chain(const float* c, V3 o, V3 d) {
  const float on = c[3] * o.x + c[4] * o.y + c[5] * o.z;
  const float dn = c[3] * d.x + c[4] * d.y + c[5] * d.z;
  const float og1 = c[6] * o.x + c[7] * o.y + c[8] * o.z;
  const float dg1 = c[6] * d.x + c[7] * d.y + c[8] * d.z;
  const float og2 = c[9] * o.x + c[10] * o.y + c[11] * o.z;
  const float dg2 = c[9] * d.x + c[10] * d.y + c[11] * d.z;
  const float r = recip_approx(dn);
  const float t = (c[0] - on) * r;
  return {t, og1 + t * dg1 - c[1], og2 + t * dg2 - c[2], on, r};
}

// Slab test of one AABB (lo.xyz, hi.xyz; megakernel.py:576-615): admits
// when tin <= tout and the box is not an inverted padding box; tin is the
// entry bound.
__device__ __forceinline__ bool slab(const float* box, V3 o, float ix,
                                     float iy, float iz, float& tin) {
  float tout = kBig();
  tin = 0.0f;
  {
    const float t0 = (__ldg(box + 0) - o.x) * ix, t1 = (__ldg(box + 3) - o.x) * ix;
    tin = jmax(tin, jmin(t0, t1));
    tout = jmin(tout, jmax(t0, t1) * kSlabScale());
  }
  {
    const float t0 = (__ldg(box + 1) - o.y) * iy, t1 = (__ldg(box + 4) - o.y) * iy;
    tin = jmax(tin, jmin(t0, t1));
    tout = jmin(tout, jmax(t0, t1) * kSlabScale());
  }
  {
    const float t0 = (__ldg(box + 2) - o.z) * iz, t1 = (__ldg(box + 5) - o.z) * iz;
    tin = jmax(tin, jmin(t0, t1));
    tout = jmin(tout, jmax(t0, t1) * kSlabScale());
  }
  return tin <= tout && __ldg(box + 0) < kBig();
}

// Walk counters of a counting launch (cnt[], summed over lanes):
enum {
  C_CYC_GROUP,    // cycles in the group scan
  C_CYC_SLAB,     // cycles in the super and member slab tests
  C_CYC_ROWS,     // cycles in the row tests (block staging included)
  C_CYC_OTHER,    // cycles outside the walk (payload, shading, banking)
  C_SEGMENTS,     // walks, one per lane and segment
  C_GROUP_TESTS,  // slab tests at each level, per lane
  C_SUPER_TESTS,
  C_MEMBER_TESTS,
  C_LANE_BLOCKS,  // blocks walked, summed over lanes
  C_WARP_WALKS,   // walks of a warp with a live lane (counted by lane 0)
  C_WARP_LANES,   // live lanes walking together, summed over warp walks
  C_UNION_BLOCKS, // blocks a warp walk stages: the union over its lanes
  C_SPREAD_BLOCKS,  // of those, the blocks tested with rows spread over lanes
  N_COUNT
};

struct Counts {
  unsigned long long v[N_COUNT];
};

// Adds the cycles since t to counter k, on a live lane only (a lane whose
// paths are done spends its cycles waiting for the warp).
template <bool kCount>
__device__ __forceinline__ void tick(Counts& C, int k, long long& t,
                                     bool live = true) {
  if (kCount) {
    const long long now = clock64();
    if (live) C.v[k] += (unsigned long long)(now - t);
    t = now;
  }
}

constexpr int STAGE_ROWS = 64;  // rows a warp stages at a time (4 KB)
// A block is tested with its rows spread over the warp when at most
// P.spread_max lanes need it (ops/cuda/build.py sets it per walk).

// One float4 of a row: through the read-only cache from the table
// (kGlobal), or from a row staged in shared memory.
template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if (kGlobal) return __ldg(p);
  return *p;
}

// The acceptance of the row c4 (4 float4) for ray (o, d): the arithmetic
// of K1's row test, its t in t_out.
template <bool kGlobal>
__device__ __forceinline__ bool row_hit(const float4* c4, V3 o, V3 d,
                                        float omag, float& t_out) {
  float c[16];
  *reinterpret_cast<float4*>(c + 0) = ld4<kGlobal>(c4 + 0);
  *reinterpret_cast<float4*>(c + 4) = ld4<kGlobal>(c4 + 1);
  *reinterpret_cast<float4*>(c + 8) = ld4<kGlobal>(c4 + 2);
  *reinterpret_cast<float4*>(c + 12) = ld4<kGlobal>(c4 + 3);
  const RowTest rt = row_chain(c, o, d);
  const float et = (c[14] + fabsf(rt.on)) * fabsf(rt.r);
  const float eps = jmin(c[12] + c[13] * (omag + et), kEpsClamp());
  t_out = rt.t;
  return (jmin(rt.b1, rt.b2) >= -eps) && (rt.b1 + rt.b2 <= 1.0f + eps) &&
         (rt.t > 0.0f);
}

// The rows [0, kRows) at src (row r at src + 4r, global row row0 + r),
// tested by all 32 lanes of a warp together for the lanes of `needers`
// (this lane's bit: `mine`): spread, one needing lane at a time, its rows
// over the warp (each lane tests rows lane, lane + 32, ... in order, then
// the warp takes the least t and, among equal t, the least row: t > 0, so
// its bits order as the floats do); or each needing lane over all rows in
// order. Either way a lane's best t and row come out as its own pass over
// the rows in ascending order with strict `<` gives them.
template <bool kGlobal, int kRows>
__device__ __forceinline__ void warp_rows(const float4* src, int row0,
                                          bool spread, unsigned needers,
                                          bool mine, V3 o, V3 d, float omag,
                                          float& best_t, int& best_row) {
  constexpr unsigned wm = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (spread) {
    for (unsigned q = needers; q != 0u; q &= q - 1u) {
      const int ql = __ffs(q) - 1;
      const V3 qo = {__shfl_sync(wm, o.x, ql), __shfl_sync(wm, o.y, ql),
                     __shfl_sync(wm, o.z, ql)};
      const V3 qd = {__shfl_sync(wm, d.x, ql), __shfl_sync(wm, d.y, ql),
                     __shfl_sync(wm, d.z, ql)};
      const float qm = __shfl_sync(wm, omag, ql);
      unsigned tb = __float_as_uint(kInf()), rb = 0xffffffffu;
#pragma unroll
      for (int r = lane; r < kRows; r += 32) {
        float rt_t;
        if (row_hit<kGlobal>(src + r * 4, qo, qd, qm, rt_t) &&
            __float_as_uint(rt_t) < tb) {
          tb = __float_as_uint(rt_t);
          rb = (unsigned)r;
        }
      }
      const unsigned tmin = __reduce_min_sync(wm, tb);
      const unsigned rmin = __reduce_min_sync(wm, tb == tmin ? rb : 0xffffffffu);
      if (lane == ql && __uint_as_float(tmin) < best_t) {
        best_t = __uint_as_float(tmin);
        best_row = row0 + (int)rmin;
      }
    }
  } else if (mine) {
    for (int r = 0; r < kRows; ++r) {
      float rt_t;
      if (row_hit<kGlobal>(src + r * 4, o, d, omag, rt_t) && rt_t < best_t) {
        best_t = rt_t;
        best_row = row0 + r;
      }
    }
  }
}

// The HBM walk, called by all 32 lanes of a warp together (see the
// header note): groups and supers in ascending order in step, each `live`
// lane testing what its own walk tests; the union of the member blocks
// its lanes need staged into `stage` (this warp's STAGE_ROWS rows of
// shared memory) and tested there for the lanes that need them, with the
// rows spread over the warp or each needing lane over all of them. A lane
// that is not live tests no box and takes no hit, but stages and spreads
// rows with the others.
template <bool kCount>
__device__ __forceinline__ void warp_walk(const Params& P, float4* stage,
                                          bool live, V3 o, V3 d, float ix,
                                          float iy, float iz, float omag,
                                          float& best_t, int& best_row,
                                          Counts& C, long long& t) {
  constexpr unsigned wm = 0xffffffffu;
  constexpr int nl = 32;
  const int lane = threadIdx.x & 31;
  const unsigned lm = __ballot_sync(wm, live);
  if (kCount && lane == 0) {
    C.v[C_WARP_WALKS] += 1;
    C.v[C_WARP_LANES] += __popc(lm);
  }
  for (int g = 0; g < P.ng; ++g) {
    float tin;
    const bool ga = live && slab(P.sgaabb + (size_t)g * 8, o, ix, iy, iz, tin);
    const unsigned gm = __ballot_sync(wm, ga);
    if (kCount) C.v[C_GROUP_TESTS] += live;
    tick<kCount>(C, C_CYC_GROUP, t, live);
    if (gm == 0u) continue;
    const int s_end = min((g + 1) * SB, P.ns);
    for (int sp = g * SB; sp < s_end; ++sp) {
      const bool sa = ga && slab(P.saabb + (size_t)sp * 8, o, ix, iy, iz, tin);
      unsigned need = 0u;
      if (sa) {
        for (int m = 0; m < SB; ++m) {
          if (slab(P.baabb + ((size_t)sp * SB + m) * 8, o, ix, iy, iz, tin) &&
              tin * kSlabLo() < best_t)
            need |= 1u << m;
        }
      }
      const unsigned un = __reduce_or_sync(wm, need);
      if (kCount) {
        C.v[C_SUPER_TESTS] += ga;
        C.v[C_MEMBER_TESTS] += sa ? SB : 0;
        C.v[C_LANE_BLOCKS] += __popc(need);
        if (lane == 0) C.v[C_UNION_BLOCKS] += __popc(un);
      }
      tick<kCount>(C, C_CYC_SLAB, t, live);
      for (unsigned u = un; u != 0u; u &= u - 1u) {
        const int m = __ffs(u) - 1;
        const int b = sp * SB + m;
        const bool mine = (need >> m) & 1u;
        const unsigned needers = __ballot_sync(wm, mine);
        const bool spread = __popc(needers) <= P.spread_max;
        if (kCount && lane == 0 && spread) C.v[C_SPREAD_BLOCKS] += 1;
        const float4* src = reinterpret_cast<const float4*>(P.p) + (size_t)b * TB * 4;
        for (int h = 0; h < TB; h += STAGE_ROWS) {
          for (int i = lane; i < STAGE_ROWS * 4; i += nl)
            stage[i] = __ldg(src + h * 4 + i);
          __syncwarp(wm);
          warp_rows<false, STAGE_ROWS>(stage, b * TB + h, spread, needers, mine,
                                       o, d, omag, best_t, best_row);
          __syncwarp(wm);
        }
      }
      tick<kCount>(C, C_CYC_ROWS, t, live);
    }
  }
}

// K1's walk, called by all 32 lanes of a warp together: the blocks in
// ascending order, each `live` lane testing every block its own slab
// admits (no refinement by its best t, as the reference's VMEM walk); a
// block no lane admits is skipped, and one that some lanes admit is
// tested for them (warp_rows) with its rows read through the read-only
// cache from the table: L1 broadcasts a row the whole warp reads, and
// coalesces the spread rows (staging them in shared memory as K3 does ran
// 1-2% slower on an H100, the Cornell 1440^2 spp 64 launch).
template <bool kCount>
__device__ __forceinline__ void warp_walk_vmem(const Params& P, bool live,
                                               V3 o, V3 d, float ix,
                                               float iy, float iz, float omag,
                                               float& best_t, int& best_row,
                                               Counts& C, long long& t) {
  constexpr unsigned wm = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (kCount) {
    const unsigned lm = __ballot_sync(wm, live);
    if (lane == 0) {
      C.v[C_WARP_WALKS] += 1;
      C.v[C_WARP_LANES] += __popc(lm);
    }
  }
  for (int b = 0; b < P.nb; ++b) {
    float tin;
    const bool mine = live && slab(P.baabb + b * 8, o, ix, iy, iz, tin);
    const unsigned needers = __ballot_sync(wm, mine);
    const bool spread = __popc(needers) <= P.spread_max;
    if (kCount) {
      C.v[C_LANE_BLOCKS] += mine;
      if (lane == 0) {
        C.v[C_UNION_BLOCKS] += needers != 0u;
        C.v[C_SPREAD_BLOCKS] += needers != 0u && spread;
      }
    }
    tick<kCount>(C, C_CYC_SLAB, t, live);
    if (needers == 0u) continue;
    warp_rows<true, TB>(reinterpret_cast<const float4*>(P.p) + b * TB * 4, b * TB,
                        spread, needers, mine, o, d, omag, best_t, best_row);
    tick<kCount>(C, C_CYC_ROWS, t, live);
  }
}

template <bool kHbm, bool kCount>
__global__ void __launch_bounds__(128) megakernel(const Params P) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  // The warp walks take every lane of the warp: a lane past the pool
  // stays, with no path to trace.
  const bool in_pool = s < P.R;
  const int K = P.J * P.spp;
  const float INF = kInf(), BIG = kBig();

  // Path budget: pixels s + (j0 + j)*R, j < J, below n_valid.
  const int diff = s - P.n_valid;
  const int q = diff >= 0 ? diff / P.R : -((-diff + P.R - 1) / P.R);
  const int vj = min(max(-q - P.j0, 0), P.J);
  const int k_cap = vj * P.spp;
  const uint32_t pid_base =
      (uint32_t)(s + P.s0) * (uint32_t)P.K_tot + (uint32_t)(P.j0 * P.spp);
  // Table offsets: 64-bit in HBM mode (p holds 134 M floats at grid
  // 2048); 32-bit in VMEM mode (K1 visits every block of its scene for
  // every segment, so its scenes stay small).
  using Off = typename std::conditional<kHbm, size_t, int>::type;
  const Off ncol = (Off)P.nb * 3 * TB;
  extern __shared__ float4 stage_all[];  // kHbm: STAGE_ROWS rows per warp
  float4* stage = stage_all + (threadIdx.x >> 5) * STAGE_ROWS * 4;
  Counts C;
  long long t_clk = 0;
  if (kCount) {
    for (int i = 0; i < N_COUNT; ++i) C.v[i] = 0;
    t_clk = clock64();
  }

  int k = 0, bounce = 0, done = 0;
  bool active = k_cap > 0 && in_pool;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 1.0f};
  if (in_pool) camera_ray(P, s, pid_base, 0, o, d);
  V3 tp = {1.0f, 1.0f, 1.0f}, color = {0.0f, 0.0f, 0.0f};

  // While any lane of the warp is live, every lane goes round (the
  // walks' shuffles and barriers take the whole warp); a lane whose
  // paths are done only joins the walks.
  for (int it = 0; it < P.max_iters && __any_sync(0xffffffffu, active); ++it) {
    const float omag = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
    const uint32_t pid = pid_base + (uint32_t)k;

    // ---- triangle walk ----
    float best_t = INF;
    int best_row = -1;
    const float ix = 1.0f / (d.x == 0.0f ? kTiny() : d.x);
    const float iy = 1.0f / (d.y == 0.0f ? kTiny() : d.y);
    const float iz = 1.0f / (d.z == 0.0f ? kTiny() : d.z);
    tick<kCount>(C, C_CYC_OTHER, t_clk, active);
    if (kCount) C.v[C_SEGMENTS] += active;
    if (kHbm)
      warp_walk<kCount>(P, stage, active, o, d, ix, iy, iz, omag, best_t, best_row,
                        C, t_clk);
    else
      warp_walk_vmem<kCount>(P, active, o, d, ix, iy, iz, omag, best_t, best_row,
                             C, t_clk);
    if (!active) continue;

    // ---- payload of the winning triangle (bf16 barycentrics in VMEM
    // mode, f32 in HBM mode) ----
    V3 nxyz = {0.0f, 0.0f, 0.0f}, albedo = {0.0f, 0.0f, 0.0f};
    V3 emission = {0.0f, 0.0f, 0.0f};
    float tpk = 0.0f, ior = 0.0f;
    if (best_row >= 0) {
      float c[16];
      const float4* row4 = reinterpret_cast<const float4*>(P.p) + (size_t)best_row * 4;
      *reinterpret_cast<float4*>(c + 0) = __ldg(row4 + 0);
      *reinterpret_cast<float4*>(c + 4) = __ldg(row4 + 1);
      *reinterpret_cast<float4*>(c + 8) = __ldg(row4 + 2);
      const RowTest rt = row_chain(c, o, d);
      const float b1b = kHbm ? rt.b1 : bf16_round(rt.b1);
      const float b2b = kHbm ? rt.b2 : bf16_round(rt.b2);
      const Off c0 = (Off)(best_row / TB) * 3 * TB + best_row % TB;
      const float* seg0 = P.nrm + c0;
      const float* seg1 = seg0 + TB;
      const float* seg2 = seg0 + 2 * TB;
      nxyz.x = seg0[0] + (seg1[0] * b1b + seg2[0] * b2b);
      nxyz.y = seg0[ncol] + (seg1[ncol] * b1b + seg2[ncol] * b2b);
      nxyz.z = seg0[2 * ncol] + (seg1[2 * ncol] * b1b + seg2[2 * ncol] * b2b);
      albedo = {seg0[3 * ncol], seg0[4 * ncol], seg0[5 * ncol]};
      tpk = seg1[3 * ncol];
      ior = seg1[4 * ncol];
      emission = {seg1[5 * ncol], seg1[6 * ncol], seg1[7 * ncol]};
    }
    V3 normal = normalize(nxyz);
    int tpacked = (int)rintf(tpk);

    // ---- spheres and discs (megakernel.py:2133-2191) ----
    float bt_ap = INF;
    int bi_ap = 0;
    for (int i = 0; i < P.n_ap; ++i) {
      const float* a = P.ap + i * 16;
      const float kind = a[0], r2 = a[7];
      const V3 cc = {a[1], a[2], a[3]}, nn = {a[4], a[5], a[6]};
      const float ocx = cc.x - o.x, ocy = cc.y - o.y, ocz = cc.z - o.z;
      const float tca = ocx * d.x + ocy * d.y + ocz * d.z;
      const float l2 = ocx * ocx + ocy * ocy + ocz * ocz - tca * tca;
      const float td = sqrtf(jmax(r2 - l2, 0.0f));
      const float t0 = tca - td;
      const float t_sph = t0 < 0.0f ? tca + td : t0;
      const bool ok_sph = kind == 1.0f && tca >= 0.0f && l2 <= r2 && t_sph > 0.0f;
      const float dn = nn.x * d.x + nn.y * d.y + nn.z * d.z;
      const float on = nn.x * o.x + nn.y * o.y + nn.z * o.z;
      const float t_dsc = -(on + a[8]) / (dn == 0.0f ? 1.0f : dn);
      const float hx = o.x + d.x * t_dsc - cc.x;
      const float hy = o.y + d.y * t_dsc - cc.y;
      const float hz = o.z + d.z * t_dsc - cc.z;
      const float d2 = hx * hx + hy * hy + hz * hz;
      const bool ok_dsc = kind == 2.0f && dn != 0.0f && t_dsc > 0.0f && d2 < r2;
      float t_ap = (ok_sph || ok_dsc) ? (kind == 1.0f ? t_sph : t_dsc) : INF;
      if (!(t_ap < best_t)) t_ap = INF;
      if (t_ap < bt_ap) {
        bt_ap = t_ap;
        bi_ap = i;
      }
    }
    if (bt_ap < best_t) {
      const float* pay = P.apay + bi_ap;
      const int np = P.n_ap;
      best_t = bt_ap;
      albedo = {pay[0], pay[np], pay[2 * np]};
      ior = pay[3 * np];
      tpacked = (int)rintf(pay[4 * np]);
      emission = {pay[5 * np], pay[6 * np], pay[7 * np]};
      if (pay[14 * np] > 1.5f) {
        normal = {pay[11 * np], pay[12 * np], pay[13 * np]};
      } else {
        const V3 hp = {o.x + d.x * best_t, o.y + d.y * best_t, o.z + d.z * best_t};
        normal = normalize({hp.x - pay[8 * np], hp.y - pay[9 * np], hp.z - pay[10 * np]});
      }
    }

    // ---- shading, roulette ----
    bool term;
    const bool escaped = !(best_t < BIG && best_t > 0.0f);
    if (escaped) {
      term = true;
    } else {
      if (tpacked >= 4) {
        color = {color.x + tp.x * emission.x, color.y + tp.y * emission.y,
                 color.z + tp.z * emission.z};
      }
      const uint32_t rng_b = (uint32_t)bounce + 7u + P.seed;
      const float u0 = u01(pid, rng_b, 0u), u1 = u01(pid, rng_b, 1u);
      const float u2 = u01(pid, rng_b, 2u), u3 = u01(pid, rng_b, 3u);
      const V3 hit = {o.x + d.x * best_t, o.y + d.y * best_t, o.z + d.z * best_t};
      const int mtype = tpacked & 3;
      V3 nd;
      bool scale_tp;
      if (mtype == 0) {
        nd = sample_diffuse(normal, u0, u1);
        scale_tp = true;
      } else if (mtype == 1) {
        nd = reflect(d, normal);
        scale_tp = true;
      } else {
        bool refracted;
        nd = dielectric(d, normal, ior, u2, refracted);
        scale_tp = mtype == 2 && refracted;
      }
      if (scale_tp) tp = {tp.x * albedo.x, tp.y * albedo.y, tp.z * albedo.z};
      // Next-segment origin pushed off the surface (ops/bxdf.py
      // offset_ray_origin):
      const float mag = 1.0f + jmax(jmax(fabsf(hit.x), fabsf(hit.y)), fabsf(hit.z));
      const float nd_dot = dot(normal, nd);
      float sgn = (float)((0.0f < nd_dot) - (nd_dot < 0.0f));
      if (sgn == 0.0f) sgn = 1.0f;
      const float m_off = mag * kRayEps() * sgn;
      o = {hit.x + normal.x * m_off, hit.y + normal.y * m_off, hit.z + normal.z * m_off};
      d = nd;
      const float p_r = jmax(jmax(tp.x, tp.y), tp.z);
      const bool stop_r = p_r == 0.0f || u3 > p_r;
      const bool use_roulette = bounce > P.roulette_start_depth;
      if (use_roulette && !stop_r) tp = {tp.x / p_r, tp.y / p_r, tp.z / p_r};
      ++bounce;
      term = (use_roulette && stop_r) || bounce >= P.max_path_length;
    }
    if (!term) continue;

    // ---- bank (or record) the finished path, regenerate ----
    if (P.rec != nullptr) {
      const size_t KR = (size_t)K * P.R;
      float* r = P.rec + (size_t)k * P.R + s;
      r[0] = color.x;
      r[KR] = color.y;
      r[2 * KR] = color.z;
      r[3 * KR] = tp.x;
      r[4 * KR] = tp.y;
      r[5 * KR] = tp.z;
      r[6 * KR] = escaped ? 1.0f : 0.0f;
      r[7 * KR] = d.x;
      r[8 * KR] = d.y;
      r[9 * KR] = d.z;
    } else {
      float* acc = P.accum + (size_t)(k / P.spp) * 3 * P.R + s;
      acc[0] += color.x;
      acc[P.R] += color.y;
      acc[2 * (size_t)P.R] += color.z;
    }
    ++done;
    k = min(k + 1, K);
    bounce = 0;
    color = {0.0f, 0.0f, 0.0f};
    active = k < k_cap;
    if (!active) tick<kCount>(C, C_CYC_OTHER, t_clk);  // its last bounce
    if (active) {
      camera_ray(P, s, pid_base + (uint32_t)k, k, o, d);
      tp = {1.0f, 1.0f, 1.0f};
    }
  }
  if (!in_pool) return;
  P.done[s] = done;
  if (kCount) {
    tick<kCount>(C, C_CYC_OTHER, t_clk, active);
    for (int i = 0; i < N_COUNT; ++i) atomicAdd(P.cnt + i, C.v[i]);
  }
}

// One thread per slot: add the slot's done[s] records in k order.
__global__ void __launch_bounds__(128)
bank_kernel(const float* __restrict__ rec, const int* __restrict__ done,
            float* __restrict__ accum, int R, int K, int spp) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= R) return;
  const size_t KR = (size_t)K * R;
  float* acc = accum + s;
  const int n = done[s];
  for (int k = 0; k < n; ++k) {
    const float* r = rec + (size_t)k * R + s;
    float cx = r[0], cy = r[KR], cz = r[2 * KR];
    if (r[6 * KR] != 0.0f) {
      cx = __fadd_rn(cx, __fmul_rn(r[3 * KR], r[7 * KR]));
      cy = __fadd_rn(cy, __fmul_rn(r[4 * KR], r[8 * KR]));
      cz = __fadd_rn(cz, __fmul_rn(r[5 * KR], r[9 * KR]));
    }
    const int j = k / spp;
    acc[(size_t)(j * 3 + 0) * R] += cx;
    acc[(size_t)(j * 3 + 1) * R] += cy;
    acc[(size_t)(j * 3 + 2) * R] += cz;
  }
}

}  // namespace

extern "C" int megakernel_launch(
    const float* p, const float* nrm, const float* baabb, const float* saabb,
    const float* sgaabb, const float* ap, const float* apay, const float* rows,
    const float* cols, float* accum, float* rec, int* done, int R, int J,
    int spp, int K_tot, int nb, int ns, int ng, int n_ap, int max_path_length,
    int roulette_start_depth, int max_iters, unsigned int seed, int n_valid,
    int j0, int s0, int hbm, unsigned long long* counters, int spread_max,
    float sx, float sy, float inv_w, float inv_h, float aa, void* stream) {
  Params P;
  P.p = p;
  P.nrm = nrm;
  P.baabb = baabb;
  P.saabb = saabb;
  P.sgaabb = sgaabb;
  P.ap = ap;
  P.apay = apay;
  P.rows = rows;
  P.cols = cols;
  P.accum = accum;
  P.rec = rec;
  P.done = done;
  P.cnt = counters;
  P.R = R;
  P.J = J;
  P.spp = spp;
  P.K_tot = K_tot;
  P.nb = nb;
  P.ns = ns;
  P.ng = ng;
  P.n_ap = n_ap;
  P.max_path_length = max_path_length;
  P.roulette_start_depth = roulette_start_depth;
  P.max_iters = max_iters;
  P.seed = seed;
  P.n_valid = n_valid;
  P.j0 = j0;
  P.s0 = s0;
  P.sx = sx;
  P.sy = sy;
  P.inv_w = inv_w;
  P.inv_h = inv_h;
  P.aa = aa;
  P.spread_max = spread_max;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (threads / 32) * STAGE_ROWS * 4 * (int)sizeof(float4);
  const bool count = counters != nullptr;
  if (!hbm) {
    if (count)
      megakernel<false, true><<<blocks, threads, 0, st>>>(P);
    else
      megakernel<false, false><<<blocks, threads, 0, st>>>(P);
  } else if (count) {
    megakernel<true, true><<<blocks, threads, smem, st>>>(P);
  } else {
    megakernel<true, false><<<blocks, threads, smem, st>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bank_launch(const float* rec, const int* done, float* accum,
                           int R, int K, int spp, void* stream) {
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  bank_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, done, accum, R, K, spp);
  return static_cast<int>(cudaGetLastError());
}
