// The threaded-BVH walk for Hopper (sm_90a), K7: closest hit and any hit,
// one thread per ray.
//
// Replaces the jnp loops ipu_ray_lib_tpu/ops/traversal.py `bvh_intersect`
// (:102), `bvh_occluded` (:154) and their leaf test `_leaf_prim_t` (:56),
// which the JAX package runs as a `lax.while_loop` over every ray in
// lockstep (they are not Pallas kernels). The BVH is threaded with miss
// links at build time, so a ray walks it without a stack:
//
//   next = box_hit && inner ? cur + 1 : miss[cur]
//
// until it runs off the end. A step tests the node's box [lo, lo + ext]
// (the f16 extent widened exactly, added in f32) against [t_min, t1], t1
// the ray's best t (closest hit) or its t_max (any hit), and at a leaf the
// test of its one primitive: the watertight triangle (t_far = inf), the
// sphere (with t_min) or the disc. A hit is accepted when t_min < t < t1,
// strictly, in visit order. The any-hit walk stops at its first accepted
// primitive; its flag equals the JAX walk's, which walks on with the flag
// unchanged. Rays with t_max = -1 (dead lanes) miss the root.
//
// The arithmetic is the plain version's (ops/bvh.py, ops/intersect.py), as
// XLA compiles the JAX functions under jit on the CPU: built with
// -fmad=false, with __fmaf_rn exactly where XLA contracts a product into
// a sum; a reduction over a vector's 3 components as XLA reduces it,
// fma(a2, b2, fma(a1, b1, a0 * b0)); the slab selects as `? :`, so a NaN
// from inf * 0 resolves as the JAX `where` does. `zero_origin` marks
// camera rays from (0, 0, 0), whose origin XLA folds into the loop: the
// disc test's hit point then fuses into its difference.
//
// Nodes are 32 bytes (ops/bvh.py): lo.xyz f32, the f16 extents x | y << 16
// and z, meta (a leaf's primitive id), geom (a leaf's geometry id,
// 0xFFFF inner), miss; read as two 16-byte loads through the read-only
// cache (a grid-512 heightfield's ~1 M nodes, 33 MB, fit the H100's L2).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidGeom = 0xFFFF;
constexpr int kThreads = 128;
constexpr int kMesh = 0, kSphere = 1;

__device__ __forceinline__ float f_bits(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ float kInf() { return f_bits(0x7f800000u); }
__device__ __forceinline__ float kSlabScale() { return f_bits(0x3f800003u); }  // 1 + 2 gamma(3)
__device__ __forceinline__ float kGamma2() { return f_bits(0x34000001u); }
__device__ __forceinline__ float kGamma3() { return f_bits(0x34400002u); }
__device__ __forceinline__ float kGamma5() { return f_bits(0x34a00003u); }
__device__ __forceinline__ float kMachEps() { return f_bits(0x33800000u); }    // 2^-24

// NaN-propagating max (jnp.maximum / torch.maximum).
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float amax3(float a, float b, float c) {
  return jmax(jmax(fabsf(a), fabsf(b)), fabsf(c));
}

struct V3 {
  float v[3];
};
// sum(a * b, axis=-1) of one row, as XLA reduces it (ops/vec3.py sum3).
__device__ __forceinline__ float sum3(const V3& a, const V3& b) {
  return __fmaf_rn(a.v[2], b.v[2], __fmaf_rn(a.v[1], b.v[1], a.v[0] * b.v[0]));
}
__device__ __forceinline__ V3 load3(const float* p) { return {{p[0], p[1], p[2]}}; }

struct Params {
  const int4* nodes;
  const int* geom_type;
  const int* geom_index;
  const int* mesh_first_tri;
  const int* tri_v;
  const float* verts;
  const float* spheres;
  const float* discs;
  const float* origin;
  const float* dir;
  const float* t_min;
  const float* t_max;
  float* out_t;
  int* out_g;
  int* out_p;
  unsigned long long* cnt;  // [2]: node visits, leaf tests (a counting launch)
  int R, N, G, M, T, S, D;
  int zero_origin;
};

struct Ray {
  V3 o, d, inv;
  int perm[3];
  float sx, sy, sz;
};

// ops/intersect.py intersect_triangle_watertight (t_far = inf): t, 0 on a miss.
__device__ float triangle_t(const Ray& r, const V3& p0, const V3& p1, const V3& p2) {
  const V3* ps[3] = {&p0, &p1, &p2};
  float qz[3], px[3], py[3];
  for (int k = 0; k < 3; ++k) {
    const float qx = ps[k]->v[r.perm[0]] - r.o.v[r.perm[0]];
    const float qy = ps[k]->v[r.perm[1]] - r.o.v[r.perm[1]];
    qz[k] = ps[k]->v[r.perm[2]] - r.o.v[r.perm[2]];
    px[k] = __fmaf_rn(r.sx, qz[k], qx);
    py[k] = __fmaf_rn(r.sy, qz[k], qy);
  }
  const float e0 = __fmaf_rn(px[1], py[2], -(py[1] * px[2]));
  const float e1 = __fmaf_rn(px[2], py[0], -(py[2] * px[0]));
  const float e2 = __fmaf_rn(px[0], py[1], -(py[0] * px[1]));
  const float max_xt = amax3(px[0], px[1], px[2]);
  const float max_yt = amax3(py[0], py[1], py[2]);
  const float max_zt0 = amax3(qz[0], qz[1], qz[2]);
  const float dx0 = kGamma5() * (max_xt + max_zt0);
  const float dy0 = kGamma5() * (max_yt + max_zt0);
  const float de = 2.0f * __fmaf_rn(dx0, max_yt, __fmaf_rn(kGamma2() * max_xt, max_yt, dy0 * max_xt));
  const bool mixed = (e0 < -de || e1 < -de || e2 < -de) && (e0 > de || e1 > de || e2 > de);
  const float det = e0 + e1 + e2;
  const float pz0 = qz[0] * r.sz, pz1 = qz[1] * r.sz, pz2 = qz[2] * r.sz;
  const float ts = __fmaf_rn(e2, pz2, __fmaf_rn(e0, pz0, e1 * pz1));
  const float far_det = kInf() * det;
  const bool bad_neg = det < 0.0f && (ts >= 0.0f || ts < far_det);
  const bool bad_pos = det > 0.0f && (ts <= 0.0f || ts > far_det);
  const float inv_det = 1.0f / det;
  const float t = ts * inv_det;
  const float max_z = amax3(pz0, pz1, pz2);
  const float delta_z = kGamma3() * max_z;
  const float delta_x = kGamma5() * (max_xt + max_z);
  const float delta_y = kGamma5() * (max_yt + max_z);
  const float delta_e =
      2.0f * __fmaf_rn(delta_x, max_yt, __fmaf_rn(kGamma2() * max_xt, max_yt, delta_y * max_xt));
  const float max_e = amax3(e0, e1, e2);
  const float delta_t =
      3.0f * __fmaf_rn(delta_z, max_e, __fmaf_rn(kGamma3() * max_e, max_z, delta_e * max_z)) *
      fabsf(inv_det);
  const bool miss = mixed || det == 0.0f || bad_neg || bad_pos || t <= delta_t;
  return miss ? 0.0f : t;
}

// ops/intersect.py intersect_sphere: t, 0 on a miss. XLA contracts the
// radius's square into r * r - l2 (the leaf test squares it in the same
// fused computation), and compares l2 with the rounded square.
__device__ float sphere_t(const Ray& r, float t_min, const float* sp) {
  const float r2 = sp[3] * sp[3];
  const V3 f = {{sp[0] - r.o.v[0], sp[1] - r.o.v[1], sp[2] - r.o.v[2]}};
  const float rd2 = 1.0f / sum3(r.d, r.d);
  const float tca = sum3(f, r.d) * rd2;
  V3 l;
  for (int a = 0; a < 3; ++a) l.v[a] = __fmaf_rn(-r.d.v[a], tca, f.v[a]);
  const float l2 = sum3(l, l);
  const float x = __fmaf_rn(sp[3], sp[3], -l2);
  const float td = sqrtf(x != x ? x : fmaxf(x, 0.0f)) * rd2;
  const float t0 = tca - td, t1 = tca + td;
  const float t = t0 < t_min ? t1 : t0;
  const bool miss = tca < 0.0f || l2 > r2 || t < t_min;
  return miss ? 0.0f : t;
}

// ops/intersect.py intersect_disc (the plane offset |c . n|): t, 0 on a miss.
__device__ float disc_t(const Ray& r, const float* dc, bool zero_origin) {
  const V3 n = load3(dc), c = load3(dc + 3);
  const float r2 = dc[6] * dc[6];
  const float angle = sum3(n, r.d);
  const float d_off = fabsf(sum3(c, n));
  const float t = -(sum3(n, r.o) + d_off) / angle;
  V3 dd;
  for (int a = 0; a < 3; ++a)
    dd.v[a] = zero_origin ? __fmaf_rn(r.d.v[a], t, -c.v[a])
                          : __fmaf_rn(r.d.v[a], t, r.o.v[a]) - c.v[a];
  const float d2 = sum3(dd, dd);
  const bool ok = angle != 0.0f && t > kMachEps() && d2 < r2;
  return ok ? t : 0.0f;
}

// ops/bvh.py leaf_t: the test of the leaf primitive (gid, pid).
__device__ float leaf_t(const Params& P, const Ray& r, float t_min, int gid, int pid) {
  const int g = min(max(gid, 0), P.G - 1);
  const int type = P.geom_type[g];
  const int gi = P.geom_index[g];
  if (type == kMesh) {
    const int mi = min(max(gi, 0), P.M - 1);
    const int tri = min(max(P.mesh_first_tri[mi] + pid, 0), P.T - 1);
    const int* v = P.tri_v + 3 * tri;
    return triangle_t(r, load3(P.verts + 3 * v[0]), load3(P.verts + 3 * v[1]),
                      load3(P.verts + 3 * v[2]));
  }
  if (type == kSphere) return sphere_t(r, t_min, P.spheres + 4 * min(max(gi, 0), P.S - 1));
  return disc_t(r, P.discs + 7 * min(max(gi, 0), P.D - 1), P.zero_origin != 0);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) bvh_kernel(Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.R) return;
  Ray r;
  r.o = load3(P.origin + 3 * i);
  r.d = load3(P.dir + 3 * i);
  for (int a = 0; a < 3; ++a) r.inv.v[a] = 1.0f / r.d.v[a];
  // The shear: z the axis of the largest |d| (the first on ties).
  const float a0 = fabsf(r.d.v[0]), a1 = fabsf(r.d.v[1]), a2 = fabsf(r.d.v[2]);
  const int iz = (a1 > a0 && a1 >= a2) ? 1 : ((a2 > a0 && a2 > a1) ? 2 : 0);
  const int ix = iz == 2 ? 0 : iz + 1;
  const int iy = ix == 2 ? 0 : ix + 1;
  r.perm[0] = ix;
  r.perm[1] = iy;
  r.perm[2] = iz;
  r.sz = 1.0f / r.d.v[iz];
  r.sx = -r.d.v[ix] * r.sz;
  r.sy = -r.d.v[iy] * r.sz;

  const float t_min = P.t_min[i];
  const float t_max = P.t_max[i];
  float best = t_max;
  int best_g = kInvalidGeom, best_p = -1;
  bool occ = false;
  unsigned long long visits = 0, leaves = 0;
  int cur = 0;
  while (cur < P.N) {
    const int4 w0 = __ldg(P.nodes + 2 * cur);
    const int4 w1 = __ldg(P.nodes + 2 * cur + 1);
    const float lo[3] = {__int_as_float(w0.x), __int_as_float(w0.y), __int_as_float(w0.z)};
    const __half2 exy = *reinterpret_cast<const __half2*>(&w0.w);
    const __half2 ez = *reinterpret_cast<const __half2*>(&w1.x);
    const float ext[3] = {__low2float(exy), __high2float(exy), __low2float(ez)};
    const int meta = w1.y, gid = w1.z, miss = w1.w;
    // ops/intersect.py intersect_box_slab:
    float t0 = t_min, t1 = kAnyHit ? t_max : best;
    for (int a = 0; a < 3; ++a) {
      float tn = (lo[a] - r.o.v[a]) * r.inv.v[a];
      float tf = ((lo[a] + ext[a]) - r.o.v[a]) * r.inv.v[a];
      if (tn > tf) {
        const float s = tn;
        tn = tf;
        tf = s;
      }
      tf = tf * kSlabScale();
      t0 = tn > t0 ? tn : t0;
      t1 = tf < t1 ? tf : t1;
    }
    const bool box_hit = t0 <= t1;
    const bool is_leaf = gid != kInvalidGeom;
    ++visits;
    if (box_hit && is_leaf) {
      ++leaves;
      const float lim = kAnyHit ? t_max : best;
      const float tp = leaf_t(P, r, t_min, gid, meta);
      if (tp > t_min && tp < lim) {
        if (kAnyHit) {
          occ = true;
          break;
        }
        best = tp;
        best_g = gid;
        best_p = meta;
      }
    }
    cur = (box_hit && !is_leaf) ? cur + 1 : miss;
  }
  if (P.cnt) {
    atomicAdd(P.cnt, visits);
    atomicAdd(P.cnt + 1, leaves);
  }
  if (kAnyHit) {
    P.out_g[i] = occ ? 1 : 0;
  } else {
    P.out_t[i] = best;
    P.out_g[i] = best_g;
    P.out_p[i] = best_p;
  }
}

}  // namespace

extern "C" int bvh_launch(const int* nodes, const int* geom_type, const int* geom_index,
                          const int* mesh_first_tri, const int* tri_v, const float* verts,
                          const float* spheres, const float* discs, const float* origin,
                          const float* dir, const float* t_min, const float* t_max,
                          float* out_t, int* out_g, int* out_p, unsigned long long* cnt, int R,
                          int N, int G, int M, int T, int S, int D, int any_hit,
                          int zero_origin, void* stream) {
  Params P;
  P.nodes = reinterpret_cast<const int4*>(nodes);
  P.geom_type = geom_type;
  P.geom_index = geom_index;
  P.mesh_first_tri = mesh_first_tri;
  P.tri_v = tri_v;
  P.verts = verts;
  P.spheres = spheres;
  P.discs = discs;
  P.origin = origin;
  P.dir = dir;
  P.t_min = t_min;
  P.t_max = t_max;
  P.out_t = out_t;
  P.out_g = out_g;
  P.out_p = out_p;
  P.cnt = cnt;
  P.R = R;
  P.N = N;
  P.G = G;
  P.M = M;
  P.T = T;
  P.S = S;
  P.D = D;
  P.zero_origin = zero_origin;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (R + kThreads - 1) / kThreads;
  if (any_hit)
    bvh_kernel<true><<<grid, kThreads, 0, s>>>(P);
  else
    bvh_kernel<false><<<grid, kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
