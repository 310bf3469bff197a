// Row-test device functions shared by the shadow kernel (K4, shadow.cu)
// and the closest-hit kernels (K5, K6, intersect.cu): the constants, the
// NaN-propagating min/max, the plane + barycentric chain of one triangle
// row as XLA compiles the JAX kernels' CPU interpret mode, the test of a
// staged block's 128 rows against one ray (K6), and for the culled walks
// of K4 and K5: the lane's exact cull (`lane_admits`), one block's step
// of a walk over a CTA's lanes (`walk_step`), the bundle-wide stop check
// over a cluster of CTAs (`BundleSync`), and the counters of a counting
// launch.
//
// The exactness contract of the per-lane cull. A bundle keeps every
// decision of the dense walk (its list and order, its stop check on the
// max of best t over all 1,024 lanes, `pairs`, K4's occlusion union);
// within those, a lane skips a block only when no row of it can accept a
// hit with t < the lane's best t, so no best t, tie or stop changes. The
// host proves it per block (ops/tables.py padded_boxes, from the rows' own
// coefficients): an accepted hit at t lies in its row's triangle widened
// by the eps clamp (1e-3) and the rounding of b1/b2, moved off the plane
// by t's rounding; its point o + t d then lies in the block's padded box
// grown by m = kappa (T D + omag) (T >= |t|: max(|t_min|, |best t|), or
// what the box's own distance allows; D = |d|inf, omag = |o|inf: the dots'
// and t's roundings grow with them). Half of m
// is spare, more than the f32 slab below needs (4 U T D), so the slab of
// the box grown by m enters at or before t < best t and leaves at or after
// t > t_min. Blocks with a row the proof does not cover (a singular or
// ill-conditioned [n; g1; g2]: the sliver triangles that accept hits
// anywhere on their plane) are `unbounded`: every lane tests them.
#pragma once

#include <cooperative_groups.h>
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

// Counters of a counting launch of K4/K5 (ops/cuda/build.py K45_COUNTERS):
enum {
  K_CYC_STAGE,     // cycles waiting for staged rows, at barriers and stop checks
  K_CYC_ROWS,      // cycles in row tests
  K_CYC_FLAGS,     // K4: cycles in the occlusion slab flags and their union
  K_CYC_PRIMS,     // K4: cycles in the sphere/disc passes
  K_CYC_EPILOGUE,  // cycles in the epilogue (payload, shadow ray, outputs)
  K_CYC_CULL,      // cycles in the lanes' padded-box tests and the listing
  K_LANE_PAIRS,    // (lane, block) pairs of the primary walk a lane tested
  K_OCC_LANE_PAIRS,  // K4: (lane, block) pairs of the occlusion walk tested
  K_BUNDLE_BLOCKS,   // blocks the primary walks walked, summed over bundles
  K_OCC_BLOCKS,      // K4: blocks in the occlusion unions, summed
  K_MAX_BUNDLE_BLOCKS,  // the most blocks one bundle walked
  K_CTA_BLOCKS,    // (CTA, block) pairs some lane of the CTA tested
  K_WORK_ITEMS,    // warp items (32 listed lanes against one chunk of rows)
  K_WORK_ROUNDS,   // rounds of up to NT / 32 warp items the CTAs ran
  K_LIVE_LANES,    // lanes with t_min < t_max
  K_N
};

struct Cnt {
  unsigned long long v[K_N];
};

template <bool kCount>
__device__ __forceinline__ void tick(Cnt& C, int k, long long& t) {
  if (kCount) {
    const long long now = clock64();
    C.v[k] += (unsigned long long)(now - t);
    t = now;
  }
}

// Adds this thread's counters into out (a warp sum, then one atomic per
// warp; K_MAX_BUNDLE_BLOCKS by atomicMax). Called by every thread.
template <bool kCount>
__device__ __forceinline__ void flush(const Cnt& C, unsigned long long* out) {
  if constexpr (kCount) {
    for (int k = 0; k < K_N; ++k) {
      unsigned long long v = C.v[k];
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, off);
        v = k == K_MAX_BUNDLE_BLOCKS ? (w > v ? w : v) : v + w;
      }
      if ((threadIdx.x & 31) == 0 && v) {
        if (k == K_MAX_BUNDLE_BLOCKS) atomicMax(out + k, v);
        else atomicAdd(out + k, v);
      }
    }
  }
}

// One staged row (4 float4) against one ray: whether test_rows would
// accept it, and its t.
__device__ __forceinline__ bool row_accepts(const float4* c4, V3 o, V3 d, float omag,
                                            float tmin, float& t) {
  float c[16];
  *reinterpret_cast<float4*>(c + 0) = c4[0];
  *reinterpret_cast<float4*>(c + 4) = c4[1];
  *reinterpret_cast<float4*>(c + 8) = c4[2];
  *reinterpret_cast<float4*>(c + 12) = c4[3];
  const RowChain rc = row_chain(c, o, d);
  const float et = (c[14] + fabsf(rc.on)) * fabsf(rc.r);
  const float eps = jmin(__fmaf_rn(c[13], omag + et, c[12]), kEpsClamp());
  t = rc.t;
  return jmin(rc.b1, rc.b2) >= -eps && rc.b1 + rc.b2 <= 1.0f + eps && rc.t > tmin;
}

// The 128 staged rows against one ray: strictly smaller t replaces, so the
// lowest row wins a tie and an earlier block keeps its hit.
__device__ __forceinline__ void test_rows(const float4* rows4, int blk, V3 o, V3 d,
                                          float omag, float tmin, float& best_t,
                                          int& best_row) {
  for (int r = 0; r < TB; ++r) {
    float t;
    if (row_accepts(rows4 + r * 4, o, d, omag, tmin, t) && t < best_t) {
      best_t = t;
      best_row = blk * TB + r;
    }
  }
}

// A lane's ray as its cull reads it (once per ray).
struct LaneRay {
  V3 o, d, inv;   // inv: 1/d on the axes that are not flat
  float D, omag;  // |d|inf, |o|inf
  int ax;         // the first axis with |d_a| = D
  unsigned flat;  // bit a: |d_a| <= D 2^-30 (the slab takes o_a against the box)
  bool cull;      // finite o and d, D >= 2^-60; else the lane tests every block
};

__device__ __forceinline__ LaneRay lane_ray(V3 o, V3 d, float omag) {
  LaneRay L;
  L.o = o;
  L.d = d;
  L.omag = omag;
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  L.D = fmaxf(fmaxf(ax, ay), az);
  L.ax = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  const float big = __int_as_float(0x7f7fffff);
  L.cull = fabsf(o.x) <= big && fabsf(o.y) <= big && fabsf(o.z) <= big && ax <= big &&
           ay <= big && az <= big && L.D >= __int_as_float(0x21800000);  // 2^-60
  const float lim = L.D * __int_as_float(0x30800000);                    // 2^-30
  L.flat = (ax <= lim ? 1u : 0u) | (ay <= lim ? 2u : 0u) | (az <= lim ? 4u : 0u);
  L.inv = {1.0f / ((L.flat & 1u) ? 1.0f : d.x), 1.0f / ((L.flat & 2u) ? 1.0f : d.y),
           1.0f / ((L.flat & 4u) ? 1.0f : d.z)};
  return L;
}

// Whether the lane must test the block whose padded box is `box` (pbox
// row: lo.xyz, hi.xyz, kappa, kind) for a hit in (tmin, best_t): the
// contract in the header. ops/intersect_kernel.py lane_admits is the same
// test in plain torch, operation for operation.
__device__ __forceinline__ bool lane_admits(const float* box, const LaneRay& L, float tmin,
                                            float best_t) {
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(box) + 1);
  if (!(tmin < best_t) || b1.w < 0.0f) return false;  // no hit can be kept; empty
  if (b1.w > 0.0f || !L.cull) return true;            // unbounded; not culled
  const float lo[3] = {b0.x, b0.y, b0.z}, hi[3] = {b0.w, b1.x, b1.y};
  const float o[3] = {L.o.x, L.o.y, L.o.z}, inv[3] = {L.inv.x, L.inv.y, L.inv.z};
  // T bounds |t| of a hit: by t_min and best t, and by the box itself along
  // the axis of |d|inf (|t| D (1 - kappa) <= its farthest face + kappa omag,
  // kappa <= 1e-2, so 1.02 covers 1 / (1 - kappa) and the rounding here).
  const float far = fmaxf(fabsf(lo[L.ax] - o[L.ax]), fabsf(hi[L.ax] - o[L.ax]));
  const float T = fminf(fmaxf(fabsf(tmin), fabsf(best_t)),
                        fmaxf(fabsf(tmin), (far + b1.z * L.omag) * 1.02f / L.D));
  if (!(T <= __int_as_float(0x7f7fffff))) return true;
  const float m = b1.z * (T * L.D + L.omag);
  float tin = -kInf(), tout = kInf();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo_a = lo[a] - m, hi_a = hi[a] + m;
    if ((L.flat >> a) & 1u) {
      if (!(o[a] >= lo_a && o[a] <= hi_a)) return false;
    } else {
      const float t1 = (lo_a - o[a]) * inv[a], t2 = (hi_a - o[a]) * inv[a];
      tin = fmaxf(tin, fminf(t1, t2));
      tout = fminf(tout, fmaxf(t1, t2));
    }
  }
  return tin <= tout && tin < best_t && tout > tmin;
}

// Order key of a t that a row accepted (finite): unsigned order is t's
// order, +0 and -0 one key.
__device__ __forceinline__ unsigned t_key(float t) {
  const unsigned u = __float_as_uint(t == 0.0f ? 0.0f : t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory of a culled walk over a CTA's NT lanes: the block being
// tested and the next one (staged by cp.async), the lanes' rays (the ray
// being walked: the primary ray, then K4's shadow ray), and per block the
// compacted list of admitting lanes with each one's least (key of t, row).
template <int NT>
struct WalkSmem {
  float4 stage[2][TB * 4];
  float ox[NT], oy[NT], oz[NT], dx[NT], dy[NT], dz[NT], tmin[NT];
  unsigned long long slot[NT];
  unsigned short list[NT];
  int wcnt[NT / 32];
};

// Block blk's 128 rows into a stage, 16 bytes per cp.async (one group).
template <int NT>
__device__ __forceinline__ void stage_async(float4* dst, const float* p, int blk) {
  const float4* src = reinterpret_cast<const float4*>(p) + (size_t)blk * TB * 4;
  for (int i = threadIdx.x; i < TB * 4; i += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(smem_u32(dst + i)), "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One block of a culled walk, called by all NT threads of the CTA: thread
// i owns lane i (its ray in L and W, its best t and row in registers;
// `live`: the lane may still take a hit). The block's rows are in
// W.stage[buf]; the next block's (`next` >= 0) are staged into the other
// buffer meanwhile. Each lane that may hit the block (lane_admits) is
// listed; then the CTA's warps share the listed lanes' rows: a warp item
// is 32 listed lanes (one per thread) against one of `spread` chunks of
// consecutive rows, so the warp reads each row as one broadcast. A thread
// keeps its lane's first strict minimum over the chunk by the key of t
// and folds (key, row, sign of t) into the lane's slot by an atomic
// minimum: the least key, then the least row. The lane then takes
// that row's t (the key with its sign) if strictly below its best t: its
// own pass over the rows in order with strict `<`, bit for bit. Returns
// the lanes listed.
template <int NT, bool kCount>
__device__ __forceinline__ int walk_step(WalkSmem<NT>& W, const float* p, const float* pbox,
                                         int blk, int next, int& buf, bool live,
                                         const LaneRay& L, float tmin, float& best_t,
                                         int& best_row, int spread, Cnt& C, long long& tc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_wait();
  __syncthreads();  // the stage is in place; the last step's slots are read
  if (next >= 0) stage_async<NT>(W.stage[buf ^ 1], p, next);
  tick<kCount>(C, K_CYC_STAGE, tc);
  const bool mine = live && lane_admits(pbox + (size_t)blk * 8, L, tmin, best_t);
  const unsigned bal = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) W.wcnt[warp] = __popc(bal);
  __syncthreads();
  int pos = 0, n = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = W.wcnt[w];
    pos += w < warp ? c : 0;
    n += c;
  }
  pos += __popc(bal & ((1u << lane) - 1u));
  if (mine) {
    W.list[pos] = (unsigned short)tid;
    W.slot[pos] = ~0ull;
  }
  __syncthreads();
  tick<kCount>(C, K_CYC_CULL, tc);
  // Warp items: 32 listed lanes (one per thread, its ray in registers)
  // against one chunk of rows, which the warp reads as broadcasts.
  constexpr int NW = NT / 32;
  const int items = ((n + 31) >> 5) * spread;
  if (kCount && tid == 0 && n > 0) {
    C.v[K_CTA_BLOCKS] += 1;
    C.v[K_WORK_ITEMS] += items;
    C.v[K_WORK_ROUNDS] += (items + NW - 1) / NW;
  }
  const float4* rows4 = W.stage[buf];
  for (int wi = warp; wi < items; wi += NW) {
    const int g = wi / spread, c = wi - g * spread;
    const int k = g * 32 + lane;
    if (k < n) {
      const int q = W.list[k];
      const V3 o = {W.ox[q], W.oy[q], W.oz[q]}, d = {W.dx[q], W.dy[q], W.dz[q]};
      const float om = jmax(jmax(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
      const float tq = W.tmin[q];
      unsigned kb = 0xffffffffu, rb = 0;
      const int r1 = ((c + 1) * TB) / spread;
      for (int r = (c * TB) / spread; r < r1; ++r) {
        float t;
        if (row_accepts(rows4 + r * 4, o, d, om, tq, t) && t_key(t) < kb) {
          kb = t_key(t);
          rb = ((unsigned)r << 1) | (__float_as_uint(t) >> 31);
        }
      }
      if (kb != 0xffffffffu) atomicMin(&W.slot[k], ((unsigned long long)kb << 32) | rb);
    }
  }
  __syncthreads();
  tick<kCount>(C, K_CYC_ROWS, tc);
  if (mine) {
    const unsigned long long v = W.slot[pos];
    if (v != ~0ull) {
      const unsigned key = (unsigned)(v >> 32), lo = (unsigned)v;
      const unsigned u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
      const float t = __uint_as_float(u | (lo << 31));  // the sign of a zero t
      if (t < best_t) {
        best_t = t;
        best_row = blk * TB + (int)((lo >> 1) & 0x7fu);
      }
    }
  }
  buf ^= 1;
  return n;
}

// The index of the first set bit of the bitmask w[0, n_words) after
// `after`, or -1.
__device__ __forceinline__ int next_flag(const unsigned* w, int n_words, int after) {
  int b = after + 1;
  for (int k = b >> 5; k < n_words; ++k) {
    const unsigned bits = w[k] & (k == (b >> 5) ? (0xffffffffu << (b & 31)) : 0xffffffffu);
    if (bits) return k * 32 + __ffs(bits) - 1;
  }
  return -1;
}

// The bundle-wide stop check of the culled walks: the max of best t over
// the bundle's CL CTAs of NT threads, below `bound`. Called by every
// thread of the bundle at the same point of the walk. One CTA (CL = 1)
// reduces through shared memory with two barriers; a cluster's CTAs each
// reduce their own, then read the others' through distributed shared
// memory after one cluster barrier (the CTA maxima alternate between two
// slots, so the next check cannot overwrite a slot still being read).
template <int NT, int CL>
struct BundleSync {
  float warp_max[NT / 32];
  float cta_max[2];
  int stop;

  __device__ __forceinline__ bool stops(float best_t, float bound, int& parity) {
    constexpr unsigned wm = 0xffffffffu;
    const int t = threadIdx.x;
    float w = best_t;
    for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(wm, w, off));
    if ((t & 31) == 0) warp_max[t >> 5] = w;
    __syncthreads();
    if (t < 32) {
      w = warp_max[t % (NT / 32)];
      for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(wm, w, off));
      if (t == 0) {
        if (CL == 1) stop = w < bound;
        else cta_max[parity] = w;
      }
    }
    if constexpr (CL == 1) {
      __syncthreads();
      return stop;
    } else {
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      float m = *cluster.map_shared_rank(&cta_max[parity], 0);
#pragma unroll
      for (int r = 1; r < CL; ++r) m = fmaxf(m, *cluster.map_shared_rank(&cta_max[parity], r));
      parity ^= 1;
      return m < bound;
    }
  }
};

}  // namespace rows
