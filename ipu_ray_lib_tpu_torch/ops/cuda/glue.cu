// The shadow frame's glue for Hopper (sm_90a), around the fused shadow
// kernel (K4, shadow.cu), the threaded-BVH walk (K7, bvh.cu) and the HBM
// closest hit (K6, intersect.cu). Around K4: before it, the camera rays and
// the bundle cull; after it, the shading and the AOV stores: with K4, three
// launches per chunk of rays. Around K7's two walks: the rays before the
// closest hit, the shadow ray between it and the any hit, the shading
// after: with K7, five launches. Around K6's two queries: the prologue
// against the super AABBs, the shadow rays and their super cull between,
// the occlusion and the shading after: with K6, three glue launches.
//
// Replaces the work that XLA fuses around the TPU kernel `_shadow_kernel`:
// the glue of `fused_shadow_trace_arrays` / `fused_shadow_trace`
// (ipu_ray_lib_tpu/ops/pallas/shadow_kernel.py:366-524: the padded rays,
// the lists, and after the kernel the id resolution, normals, hit point,
// light direction, albedo, lambert and rgb) and `bundle_cull`
// (ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py:46-150). Both are XLA,
// not Pallas, in the JAX package; the port's plain torch versions stay
// (ops/shadow.py `shadow_inputs`, `shadow_epilogue`; ops/cull.py
// `bundle_cull`; ops/camera.py `scaled_ray_dir`) for CPU tensors and as
// the checks of these kernels.
//
// - rays_cull_kernel (the prologue), one CTA of 256 threads per bundle of
//   1,024 rays: each ray's direction from its pixel (scaled_ray_dir) or
//   from the caller's rays, the padding lanes (direction 1, t_max -1),
//   the rays [8, Rp] as K4 reads them; the bundle's interval box of its
//   live lanes' origins and directions (a block reduction); the slab test
//   of that box against every block AABB with interval products, the
//   SLAB_SCALE widening and the padding-block test; each kept block's
//   distance bound (the squared gaps summed as the port's fma), culled
//   blocks at inf; and the blocks ordered by bound as a stable argsort
//   does: a block's rank is the count of smaller bounds plus the count of
//   equal bounds at a lower index (NaN sorts last, as torch sorts it).
// - shade_kernel (the epilogue), one thread per ray: K4's out_f / out_i
//   into the ids (resolve_hit), the kernel, sphere or disc normal, the hit
//   point and the light direction (light_ray), albedo, lambert and rgb
//   (shade), written straight into each AOV the caller asks for (the
//   renderer's stream-order buffers at the chunk's rows, or fresh
//   tensors), escaped too.
// - bvh_rays_kernel, one thread per ray: the camera ray's direction
//   (scaled_ray_dir, as the prologue makes it) or none (the caller's), the
//   zero origin K7 reads for rays from (0, 0, 0), t_min 0 and t_max inf.
// - bvh_light_kernel, one thread per ray, after K7's closest hit: the
//   shading normal (ops/traversal.py hit_normal: the watertight test's
//   barycentrics over the mesh's vertex normals, or its geometric normal;
//   the sphere's or the disc's), the hit point and the light ray
//   (light_ray), the origin pushed off the surface (ops/bxdf_loop.py
//   offset_ray_origin): the shadow ray K7's any hit walks, and the normal.
// - bvh_shade_kernel, one thread per ray, after K7's any hit: the light
//   ray again from the hit, and shade_kernel's shading and stores.
// - rays_cull_kernel again before K6's closest hit, its boxes the super
//   AABBs (ops/cull.py super_cull_lists_bundle).
// - hbm_light_kernel, one CTA of 256 threads per bundle as the prologue,
//   after K6's closest hit: per ray the spheres and discs against K6's t
//   (ops/dense.py dense_spheres / dense_discs), the ids and normal
//   (resolve_hit), the light ray and the offset origin: the shadow rays,
//   padded as ops/intersect_kernel.py intersect_inputs pads them; per
//   bundle their box over the lanes with t_max > 0, the amax of t_max, and
//   the prologue's cull stage against the super AABBs (the device
//   functions fold_bundle and cull_bundle, which both kernels share).
// - hbm_shade_kernel, one thread per ray, after K6's occlusion query: the
//   shadow ray's spheres and discs bounded by K6's t, occluded where a hit
//   lies nearer than the light (ops/traversal.py scene_occluded), then
//   shade_kernel's shading and stores (shade_ray).
// They replace the torch glue of render/shadow.py's glue branch (the JAX
// package's `shadow_trace`, ipu_ray_lib_tpu/render/shadow.py:66-100, which
// XLA fuses), whose plain torch chain stays for CPU tensors and as their
// check.
//
// Every formula is the port's plain torch version, operation for
// operation, so the outputs equal it byte for byte. The port's `fma`
// (ops/vec3.py) is not one rounding: it multiplies in double (exact for
// two floats), adds in double and rounds to float; xfma below does the
// same (__fmaf_rn would differ in about 2^-29 of the cases). Every other
// operation rounds once in f32, as torch's kernels do: built with
// -fmad=false, IEEE division and square root (the port's f32 sqrt through
// double rounds as sqrtf does). A ray whose origins are all zero (camera
// rays, `origins` None) takes the folded forms, as XLA folds the zero
// origin: the hit point d * t, the light offset fma(-d, t, L), the sphere
// offset fma(d, t, -c).
//
// What bounds them on this card: bytes. Per ray the prologue reads its
// pixel (8 B) and writes the rays (32 B); the epilogue reads rays, out_f
// and out_i (56 B) and writes the six AOVs (48 B); ~300 MB over a 1440^2
// frame, 0.09 ms at 3.35 TB/s. Their operations (~60 f32 and ~20 f64 per
// ray, plus per bundle ~50 per block and the rank's nb compares per
// block) are a fraction of that. What the design does about it: each
// ray's values stay in registers from its read to its stores, every array
// is read and written once with neighbouring threads on neighbouring
// addresses, and the per-bundle work (box, slab test, rank) runs in
// shared memory inside the CTA that made the bundle's rays. Measured on an
// H100 over a 1440^2 frame (PERF.md §6): 0.31 and 0.22 ms; the prologue's
// 64 CTAs a chunk leave most of the card's 132 SMs idle. The BVH route's
// three kernels read and write per ray 40, 64 and 88 B (the camera ray;
// K7's hit and the shadow ray; the shadow test, the normal and the six
// AOVs): ~400 MB over a 1440^2 frame, 0.12 ms; hit_normal's table reads
// stay in L2. The HBM route's per ray: the prologue's 40 B; the light
// kernel reads the rays and K6's t, row and normal (52 B) and writes the
// shadow ray and the hit (60 B); the shade kernel reads the rays, the hit,
// the shadow ray and K6's t and row (92 B) and writes the six AOVs (48 B);
// per bundle the lists of 511 supers (4 KB) twice, and the rank's 511^2
// compares in shared memory.

#include "rows.cuh"

namespace {

using rows::BR;
using rows::jmax;
using rows::jmin;
using rows::kBig30;
using rows::kInf;
using rows::kMachEps;
using rows::kRayEps;
using rows::kSlabScale;
using rows::kTiny;
using rows::V3;

constexpr int NT = 256;          // threads of a prologue CTA
constexpr int LPT = BR / NT;     // rays per prologue thread
constexpr int NW = NT / 32;
constexpr int ST = 256;          // threads of an epilogue CTA
constexpr int kInvalidGeom = 0xFFFF;  // bvh/builder.py INVALID_GEOM_ID
constexpr int kMesh = 0, kSphere = 1;  // ops/ids.py GEOM_MESH, GEOM_SPHERE

// The port's fma: a*b exact in double, + c rounded in double, then to f32.
__device__ __forceinline__ float xfma(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ops/vec3.py sum3 (rowdot): fma(a2, b2, fma(a1, b1, a0*b0)).
__device__ __forceinline__ float sum3(V3 a, V3 b) {
  return xfma(a.z, b.z, xfma(a.y, b.y, a.x * b.x));
}

// ops/vec3.py unit: v / max(sqrt(sum3(v, v)), 1e-30), NaN kept.
__device__ __forceinline__ V3 unit(V3 v) {
  const float l = jmax(sqrtf(sum3(v, v)), kTiny());
  return {v.x / l, v.y / l, v.z / l};
}

__device__ __forceinline__ V3 load_v3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // torch.clamp: hi wins
}

struct RaysParams {
  const float* baabb;  // [nb, 8] block AABBs (lo.xyz, hi.xyz)
  const float* rows;   // camera: [R] pixel rows; null: the caller's rays
  const float* cols;   // camera: [R] pixel columns
  const float* sxp;    // camera: 0-d image-plane factors on the card, or
  const float* syp;    //   null for sx, sy below
  float sx, sy, inv_w, inv_h;
  const float* origins;  // rays: [R, 3], or null for (0, 0, 0)
  const float* dirs;     // rays: [R, 3]
  float* rays;    // [8, Rp] origin, direction, t_min, t_max rows
  int* counts;    // [nrb] kept blocks per bundle
  int* order;     // [nrb, nb] block list, nearest first
  float* dists;   // [nrb, nb] its distance bounds
  int R, Rp, nb;
};

// ops/camera.py scaled_ray_dir(x=col, y=row): a camera ray's direction.
__device__ __forceinline__ void camera_dir(float row, float col, float inv_w, float inv_h,
                                           float sx, float sy, float d[3]) {
  const float xn = xfma(col, inv_w, -0.5f);
  const float yn = xfma(row, inv_h, -0.5f);
  const float dx = xn * sx, dy = yn * sy;
  const float n = sqrtf(xfma(dy, dy, dx * dx) + 1.0f);
  d[0] = dx / n;
  d[1] = dy / n;
  d[2] = -1.0f / n;
}

// One ray of the prologue: (origin, direction) of lane i < R.
__device__ __forceinline__ void make_ray(const RaysParams& P, int i, float sx, float sy,
                                         float o[3], float d[3]) {
  if (P.rows) {
    camera_dir(P.rows[i], P.cols[i], P.inv_w, P.inv_h, sx, sy, d);
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  for (int c = 0; c < 3; ++c) {
    d[c] = P.dirs[i * 3 + c];
    o[c] = P.origins ? P.origins[i * 3 + c] : 0.0f;
  }
}

// torch's sort order of floats: NaN after everything, NaNs equal.
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a < b || (b != b && a == a);
}
__device__ __forceinline__ bool sorts_equal(float a, float b) {
  return a == b || (a != a && b != b);
}

// ---- the bundle cull, shared by the prologue and the HBM light kernel ----

// Where the bundle cull folds component c of a lane's values: the box's
// origin lo, origin hi, direction lo, direction hi (min, max, min, max),
// then, where given, the amax of t_max over every lane.
__device__ __forceinline__ bool folds_min(int c) { return c < 12 && (c % 6) < 3; }
__device__ __forceinline__ float fold(int c, float a, float b) {
  return folds_min(c) ? jmin(a, b) : jmax(a, b);
}

// The empty box: +inf for the minima, -inf for the maxima.
template <int K>
__device__ __forceinline__ void empty_box(float v[K]) {
  for (int c = 0; c < K; ++c) v[c] = folds_min(c) ? kInf() : -kInf();
}

// A live lane's origin and direction into the box.
__device__ __forceinline__ void grow_box(float* box, const float o[3], const float d[3]) {
  for (int c = 0; c < 3; ++c) {
    box[c] = jmin(box[c], o[c]);
    box[3 + c] = jmax(box[3 + c], o[c]);
    box[6 + c] = jmin(box[6 + c], d[c]);
    box[9 + c] = jmax(box[9 + c], d[c]);
  }
}

// The CTA's fold of each thread's values v[K] and live flag (ops/cull.py
// bundle_cull's amin / amax over the bundle): a warp's shuffles, then
// every warp's row through shared memory; every thread ends with the
// bundle's values. s_v: [NW][K], s_live: [NW].
template <int K>
__device__ __forceinline__ void fold_bundle(float v[K], int& live_any, float (*s_v)[K],
                                            int* s_live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int c = 0; c < K; ++c) v[c] = fold(c, v[c], __shfl_xor_sync(0xffffffffu, v[c], off));
  }
  live_any = __any_sync(0xffffffffu, live_any);
  if (lane == 0) {
    for (int c = 0; c < K; ++c) s_v[warp][c] = v[c];
    s_live[warp] = live_any;
  }
  __syncthreads();
  for (int w = 0; w < NW; ++w) {
    for (int c = 0; c < K; ++c) v[c] = fold(c, v[c], s_v[w][c]);
    live_any |= s_live[w];
  }
}

// The bundle b's cull against the boxes aabb [nb, 8] (ops/cull.py
// bundle_cull): each box's interval slab test and distance bound into
// s_dist [nb] (culled boxes at inf), then the boxes ordered by bound as a
// stable argsort orders them, into order / dists [nb] and the kept count.
// box: the bundle's origin and direction ranges over its live lanes;
// tmax_hi, tmin_lo: the amax of t_max over every lane, the amin of t_min
// over the live ones. s_kept starts at 0 before the CTA's last barrier.
__device__ __forceinline__ void cull_bundle(const float* aabb, int nb, const float box[12],
                                            float tmax_hi, float tmin_lo, float* s_dist,
                                            int* s_kept, int* counts, int* order, float* dists,
                                            int b) {
  const int tid = threadIdx.x;
  const float* olo = box;
  const float* ohi = box + 3;
  const float* dlo = box + 6;
  const float* dhi = box + 9;
  for (int j = tid; j < nb; j += NT) {
    const float* bx = aabb + j * 8;
    float enter = -kInf(), exit_ = kInf(), d2 = 0.0f;
    for (int a = 0; a < 3; ++a) {
      const bool same = dlo[a] > 0.0f || dhi[a] < 0.0f;
      const float i1 = 1.0f / (same ? dlo[a] : 1.0f);
      const float i2 = 1.0f / (same ? dhi[a] : 1.0f);
      const float ilo = jmin(i1, i2), ihi = jmax(i1, i2);
      const float blo = bx[a], bhi = bx[a + 3];
      const float s1lo = blo - ohi[a], s1hi = blo - olo[a];
      const float s2lo = bhi - ohi[a], s2hi = bhi - olo[a];
      const float p1 = s1lo * ilo, p2 = s1lo * ihi, p3 = s1hi * ilo, p4 = s1hi * ihi;
      const float q1 = s2lo * ilo, q2 = s2lo * ihi, q3 = s2hi * ilo, q4 = s2hi * ihi;
      const float lo1 = jmin(jmin(p1, p2), jmin(p3, p4));
      const float hi1 = jmax(jmax(p1, p2), jmax(p3, p4));
      const float lo2 = jmin(jmin(q1, q2), jmin(q3, q4));
      const float hi2 = jmax(jmax(q1, q2), jmax(q3, q4));
      enter = jmax(enter, same ? jmin(lo1, lo2) : -kInf());
      exit_ = jmin(exit_, same ? jmax(hi1, hi2) * kSlabScale() : kInf());
      const float gap = jmax(jmax(blo - ohi[a], olo[a] - bhi), 0.0f);
      d2 = xfma(gap, gap, d2);
    }
    const bool hit = enter <= exit_ && enter <= tmax_hi && exit_ >= tmin_lo &&
                     bx[0] < kBig30();
    s_dist[j] = hit ? sqrtf(d2) : kInf();
    if (hit) atomicAdd(s_kept, 1);
  }
  __syncthreads();

  // ---- the stable order by bound ----
  for (int i = tid; i < nb; i += NT) {
    const float di = s_dist[i];
    int rank = 0;
    for (int j = 0; j < nb; ++j) {
      const float dj = s_dist[j];
      rank += sorts_before(dj, di) || (j < i && sorts_equal(dj, di));
    }
    order[b * nb + rank] = i;
    dists[b * nb + rank] = di;
  }
  if (tid == 0) counts[b] = *s_kept;
}

__global__ void __launch_bounds__(NT) rays_cull_kernel(const RaysParams P) {
  extern __shared__ float s_dist[];  // [nb] each block's bound
  __shared__ float s_box[NW][12];    // per warp: o lo, o hi, d lo, d hi
  __shared__ int s_live[NW];
  __shared__ int s_kept;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float sx = P.sxp ? *P.sxp : P.sx, sy = P.syp ? *P.syp : P.sy;
  if (tid == 0) s_kept = 0;

  // ---- the bundle's rays, and its box over the live lanes (ops/shadow.py
  // shadow_inputs; ops/cull.py bundle_cull's amin / amax) ----
  float box[12];
  empty_box<12>(box);
  int live_any = 0;
  for (int k = 0; k < LPT; ++k) {
    const int i = b * BR + k * NT + tid;
    const bool live = i < P.R;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {1.0f, 1.0f, 1.0f};
    if (live) make_ray(P, i, sx, sy, o, d);
    for (int c = 0; c < 3; ++c) {
      P.rays[c * P.Rp + i] = o[c];
      P.rays[(3 + c) * P.Rp + i] = d[c];
    }
    P.rays[6 * P.Rp + i] = 0.0f;
    P.rays[7 * P.Rp + i] = live ? kInf() : -1.0f;
    if (live) {
      live_any = 1;
      grow_box(box, o, d);
    }
  }
  fold_bundle<12>(box, live_any, s_box, s_live);
  // amax of t_max over every lane, amin of t_min over the live ones:
  cull_bundle(P.baabb, P.nb, box, live_any ? kInf() : -1.0f, live_any ? 0.0f : kInf(), s_dist,
              &s_kept, P.counts, P.order, P.dists, b);
}

struct ShadeParams {
  const float* rays;    // [8, Rp] as the prologue wrote them
  const float* out_f;   // [4, Rp] K4: raw kernel normal, hit t
  const int* out_i;     // [4, Rp] K4: triangle row, sphere, disc, occluded
  const int* tri_geom;  // [n_tri]
  const int* tri_prim;  // [n_tri]
  const int* sphere_geom;  // [n_sph]
  const int* disc_geom;    // [n_dsc]
  const float* ap;         // [n_ap, 16] sphere rows, then disc rows
  const int* mat_id;       // [n_geom]
  const float* mat_albedo;  // [n_mat, 3]
  float* rgb;      // [R, 3] or null (each AOV: the caller's rows)
  float* t;        // [R]
  int* geom;       // [R]
  int* prim;       // [R]
  float* normal;   // [R, 3]
  float* hit_p;    // [R, 3]
  unsigned char* escaped;  // [R] bool
  int R, Rp, n_tri, n_sph, n_dsc, n_geom, n_mat, zero_origin;
  float lx, ly, lz, ambient;
};

// unit(from_hit(o, d, t, c, -1)) (ops/traversal.py): the normal at the hit
// on the sphere of centre c; rays from the origin take the folded form.
__device__ __forceinline__ V3 sphere_normal(const float* c, V3 o, V3 d, float t,
                                            bool zero_origin) {
  return unit(zero_origin
                  ? V3{xfma(d.x, t, -c[0]), xfma(d.y, t, -c[1]), xfma(d.z, t, -c[2])}
                  : V3{-(c[0] - xfma(d.x, t, o.x)), -(c[1] - xfma(d.y, t, o.y)),
                       -(c[2] - xfma(d.z, t, o.z))});
}

// ops/shadow.py light_ray at hp_t (the hit t, or 0 where nothing is hit):
// the hit point, the unit direction to the light l and the light's distance.
__device__ __forceinline__ void light_ray(V3 o, V3 d, float hp_t, bool zero_origin, V3 l,
                                          V3& hp, V3& sdir, float& dist) {
  V3 lo;
  if (zero_origin) {
    hp = {d.x * hp_t, d.y * hp_t, d.z * hp_t};
    lo = {xfma(-d.x, hp_t, l.x), xfma(-d.y, hp_t, l.y), xfma(-d.z, hp_t, l.z)};
  } else {
    hp = {xfma(d.x, hp_t, o.x), xfma(d.y, hp_t, o.y), xfma(d.z, hp_t, o.z)};
    lo = {l.x - hp.x, l.y - hp.y, l.z - hp.z};
  }
  dist = sqrtf(sum3(lo, lo));
  const float dinv = jmax(dist, kTiny());
  sdir = {lo.x / dinv, lo.y / dinv, lo.z / dinv};
}

// ops/shadow.py shade: albedo, lambert and rgb of row i, written into each
// AOV the caller asks for.
__device__ __forceinline__ void shade_store(const ShadeParams& P, int i, bool found, int geom,
                                            int prim, float hit_t, V3 nrm, V3 hp, V3 sdir,
                                            bool occ) {
  int m = P.mat_id[clampi(geom, 0, P.n_geom - 1)];
  if (m < 0) m += P.n_mat;  // torch's index wraps
  const float* alb = P.mat_albedo + m * 3;
  const float lam = occ ? 0.0f : sum3(sdir, nrm);
  if (P.rgb) {
    for (int c = 0; c < 3; ++c)
      P.rgb[i * 3 + c] = found ? xfma(alb[c], P.ambient, lam * alb[c]) : 0.0f;
  }
  if (P.t) P.t[i] = found ? hit_t : kInf();
  if (P.geom) P.geom[i] = found ? geom : kInvalidGeom;
  if (P.prim) P.prim[i] = prim;
  if (P.normal) {
    P.normal[i * 3] = nrm.x;
    P.normal[i * 3 + 1] = nrm.y;
    P.normal[i * 3 + 2] = nrm.z;
  }
  if (P.hit_p) {
    P.hit_p[i * 3] = found ? hp.x : 0.0f;
    P.hit_p[i * 3 + 1] = found ? hp.y : 0.0f;
    P.hit_p[i * 3 + 2] = found ? hp.z : 0.0f;
  }
  if (P.escaped) P.escaped[i] = found ? 0 : 1;
}

// The epilogue of ray i < R (shade_kernel; hbm_shade_kernel): out_f / out_i
// rows 0-2 (the raw kernel normal and hit t; triangle row, sphere, disc)
// into the ids (resolve_hit), the kernel, sphere or disc normal, the hit
// point and the light direction (light_ray), then shade_store with occ.
__device__ __forceinline__ void shade_ray(const ShadeParams& P, int i, bool occ) {
  const int Rp = P.Rp;
  const V3 o = {P.rays[i], P.rays[Rp + i], P.rays[2 * Rp + i]};
  const V3 d = {P.rays[3 * Rp + i], P.rays[4 * Rp + i], P.rays[5 * Rp + i]};
  const float hit_t = P.out_f[3 * Rp + i];
  const int tri = P.out_i[i], si_b = P.out_i[Rp + i], di_b = P.out_i[2 * Rp + i];

  // ---- ops/traversal.py resolve_hit ----
  const bool sb = si_b >= 0, db = di_b >= 0;
  int geom = kInvalidGeom, prim = -1;
  if (tri >= 0) {
    const int ts = clampi(tri, 0, P.n_tri - 1);
    geom = P.tri_geom[ts];
    prim = P.tri_prim[ts];
  }
  const int si_c = clampi(sb ? si_b : 0, 0, P.n_sph - 1);
  const int di_c = clampi(db ? di_b : 0, 0, P.n_dsc - 1);
  if (sb) {
    geom = P.sphere_geom[si_c];
    prim = 0;
  }
  if (db) {
    geom = P.disc_geom[di_c];
    prim = 0;
  }
  const bool found = geom != kInvalidGeom;
  V3 nrm = unit({P.out_f[i], P.out_f[Rp + i], P.out_f[2 * Rp + i]});
  if (sb) nrm = sphere_normal(P.ap + si_c * 16 + 1, o, d, hit_t, P.zero_origin);
  if (db) {
    const float* n = P.ap + (P.n_sph + di_c) * 16 + 4;
    nrm = {n[0], n[1], n[2]};
  }
  if (!found) nrm = {0.0f, 0.0f, 1.0f};

  V3 hp, sdir;
  float dist;
  light_ray(o, d, found ? hit_t : 0.0f, P.zero_origin, {P.lx, P.ly, P.lz}, hp, sdir, dist);
  shade_store(P, i, found, geom, prim, hit_t, nrm, hp, sdir, occ);
}

__global__ void __launch_bounds__(ST) shade_kernel(const ShadeParams P) {
  const int i = blockIdx.x * ST + threadIdx.x;
  if (i >= P.R) return;
  shade_ray(P, i, P.out_i[3 * P.Rp + i] != 0);
}

// ---- the HBM route's glue around K6's two queries (intersect.cu) ----

// ops/dense.py sphere_pass with its default dots (dense_spheres, the glue
// route's spheres; K4's own are shadow.cu's): the nearest sphere's t (inf
// where none) and index over ap rows [0, n_sph).
__device__ __forceinline__ void dense_sphere_pass(const float* ap, int n_sph, V3 o, V3 d,
                                                  float tmin, float& cur_t, int& cur_i) {
  const float rd2 = 1.0f / sum3(d, d);
  cur_t = kInf();
  cur_i = 0;
  for (int s = 0; s < n_sph; ++s) {
    const float* a = ap + s * 16;
    const float r2 = a[7];
    const V3 oc = {a[1] - o.x, a[2] - o.y, a[3] - o.z};
    const float tca = sum3(oc, d) * rd2;
    const V3 l = {xfma(-d.x, tca, oc.x), xfma(-d.y, tca, oc.y), xfma(-d.z, tca, oc.z)};
    const float l2 = sum3(l, l);
    const float td = sqrtf(jmax(r2 - l2, 0.0f)) * rd2;
    const float t0 = tca - td, t1 = tca + td;
    float t = t0 < tmin ? t1 : t0;
    const bool miss = tca < 0.0f || l2 > r2 || t < tmin || r2 <= 0.0f;
    if (miss || t <= tmin) t = kInf();
    if (t < cur_t) {
      cur_t = t;
      cur_i = s;
    }
  }
}

// ops/dense.py disc_pass with its default dots and the plane offset |c . n|
// computed (dense_discs): the nearest disc's t and index over ap rows
// [n_sph, n_sph + n_dsc).
__device__ __forceinline__ void dense_disc_pass(const float* ap, int n_sph, int n_dsc, V3 o,
                                                V3 d, float tmin, float& cur_t, int& cur_i) {
  cur_t = kInf();
  cur_i = 0;
  for (int s = 0; s < n_dsc; ++s) {
    const float* a = ap + (n_sph + s) * 16;
    const V3 c = {a[1], a[2], a[3]}, n = {a[4], a[5], a[6]};
    const float r2 = a[7];
    const float d_off = fabsf(sum3(c, n));
    const float angle = sum3(d, n);
    float t = -(sum3(o, n) + d_off) / angle;
    const V3 h = {xfma(d.x, t, o.x) - c.x, xfma(d.y, t, o.y) - c.y, xfma(d.z, t, o.z) - c.z};
    const float d2 = sum3(h, h);
    const bool ok = angle != 0.0f && t > kMachEps() && d2 < r2 && r2 > 0.0f && t > tmin;
    if (!ok) t = kInf();
    if (t < cur_t) {
      cur_t = t;
      cur_i = s;
    }
  }
}

// ops/traversal.py pallas_scene_intersect after the triangle kernel: K6's
// (t, row) of a ray, t = t_max where no row is hit, then every sphere and
// every disc, each overriding when strictly nearer. Returns the hit t and
// sets the sphere and disc that won (-1 where none) and the geometry id
// (resolve_hit's; INVALID_GEOM_ID where nothing is hit).
__device__ __forceinline__ float hbm_closest(const ShadeParams& P, V3 o, V3 d, float tmin,
                                             float tmax, float k6_t, int tri, int& si,
                                             int& di, int& geom) {
  float best = tri >= 0 ? k6_t : tmax;
  float st, dt;
  int s_i, d_i;
  dense_sphere_pass(P.ap, P.n_sph, o, d, tmin, st, s_i);
  const bool sb = st < best;
  if (sb) best = st;
  dense_disc_pass(P.ap, P.n_sph, P.n_dsc, o, d, tmin, dt, d_i);
  const bool db = dt < best;
  if (db) best = dt;
  si = sb ? s_i : -1;
  di = db ? d_i : -1;
  geom = kInvalidGeom;
  if (tri >= 0) geom = P.tri_geom[clampi(tri, 0, P.n_tri - 1)];
  if (sb) geom = P.sphere_geom[clampi(s_i, 0, P.n_sph - 1)];
  if (db) geom = P.disc_geom[clampi(d_i, 0, P.n_dsc - 1)];
  return best;
}

struct HbmLightParams {
  ShadeParams S;  // rays: the camera query's [8, Rp]; the scene's tables;
                  // R, Rp, zero_origin, the light
  float* hit_f;   // [4, Rp] the raw kernel normal, the hit t;
  int* hit_i;     // [3, Rp] the row, sphere and disc (-1 where none): the
                  //   out_f / out_i that hbm_shade_kernel's epilogue reads
  const float* k6_t;  // [Rp] K6's closest hit of the rays: t,
  const int* k6_i;    // [Rp]   its row or -1,
  const float* k6_n;  // [8, Rp] the raw kernel normal in rows 0-2
  const float* saabb;  // [ns, 8] the super AABBs
  float* srays;   // [8, Rp] the shadow rays as K6 reads them
  int* counts;    // [nrb] their super lists: kept supers,
  int* order;     // [nrb, ns] the supers nearest first,
  float* dists;   // [nrb, ns] their distance bounds
  int ns;
};

// One CTA per bundle, as the prologue: each ray's closest hit after K6
// (spheres, discs, resolve_hit's ids and normal), the light ray and the
// origin pushed off the surface (ops/shadow.py light_ray, ops/bxdf_loop.py
// offset_ray_origin): the shadow ray, padded as intersect_inputs pads it
// (origin 0, direction 1, t_min 0, t_max -1); then the bundle's super
// cull of the shadow rays against saabb, t_max their light distances
// (ops/cull.py super_cull_lists_bundle).
__global__ void __launch_bounds__(NT) hbm_light_kernel(const HbmLightParams P) {
  extern __shared__ float s_dist[];  // [ns] each super's bound
  __shared__ float s_box[NW][13];    // per warp: o lo, o hi, d lo, d hi, t_max hi
  __shared__ int s_live[NW];
  __shared__ int s_kept;
  const ShadeParams& S = P.S;
  const int b = blockIdx.x, tid = threadIdx.x, Rp = S.Rp;
  if (tid == 0) s_kept = 0;

  float box[13];
  empty_box<13>(box);
  int live_any = 0;
  for (int k = 0; k < LPT; ++k) {
    const int i = b * BR + k * NT + tid;
    float so[3] = {0.0f, 0.0f, 0.0f}, sd[3] = {1.0f, 1.0f, 1.0f}, tmax = -1.0f;
    if (i < S.R) {
      const V3 o = {S.rays[i], S.rays[Rp + i], S.rays[2 * Rp + i]};
      const V3 d = {S.rays[3 * Rp + i], S.rays[4 * Rp + i], S.rays[5 * Rp + i]};
      const int tri = P.k6_i[i];
      int si, di, geom;
      const float hit_t = hbm_closest(S, o, d, S.rays[6 * Rp + i], S.rays[7 * Rp + i],
                                      P.k6_t[i], tri, si, di, geom);
      const bool found = geom != kInvalidGeom;
      const V3 raw = {P.k6_n[i], P.k6_n[Rp + i], P.k6_n[2 * Rp + i]};
      V3 nrm = unit(raw);
      if (si >= 0) nrm = sphere_normal(S.ap + si * 16 + 1, o, d, hit_t, S.zero_origin);
      if (di >= 0) nrm = load_v3(S.ap + (S.n_sph + di) * 16 + 4);
      if (!found) nrm = {0.0f, 0.0f, 1.0f};
      V3 hp, sdir;
      light_ray(o, d, found ? hit_t : 0.0f, S.zero_origin, {S.lx, S.ly, S.lz}, hp, sdir, tmax);
      // offset_ray_origin(hp, sdir, nrm); torch.sign of a NaN or a zero is
      // 0, which the where makes 1
      const float mag = 1.0f + jmax(jmax(fabsf(hp.x), fabsf(hp.y)), fabsf(hp.z));
      const float m = mag * kRayEps() * (sum3(nrm, sdir) < 0.0f ? -1.0f : 1.0f);
      so[0] = xfma(nrm.x, m, hp.x);
      so[1] = xfma(nrm.y, m, hp.y);
      so[2] = xfma(nrm.z, m, hp.z);
      sd[0] = sdir.x;
      sd[1] = sdir.y;
      sd[2] = sdir.z;
      P.hit_f[i] = raw.x;
      P.hit_f[Rp + i] = raw.y;
      P.hit_f[2 * Rp + i] = raw.z;
      P.hit_f[3 * Rp + i] = hit_t;
      P.hit_i[i] = tri;
      P.hit_i[Rp + i] = si;
      P.hit_i[2 * Rp + i] = di;
    }
    for (int c = 0; c < 3; ++c) {
      P.srays[c * Rp + i] = so[c];
      P.srays[(3 + c) * Rp + i] = sd[c];
    }
    P.srays[6 * Rp + i] = 0.0f;
    P.srays[7 * Rp + i] = tmax;
    // bundle_cull: the box over the lanes with t_max > 0, the amax of
    // t_max over every lane (a NaN distance propagates, as amax does)
    box[12] = jmax(box[12], tmax);
    if (tmax > 0.0f) {
      live_any = 1;
      grow_box(box, so, sd);
    }
  }
  fold_bundle<13>(box, live_any, s_box, s_live);
  cull_bundle(P.saabb, P.ns, box, box[12], live_any ? 0.0f : kInf(), s_dist, &s_kept,
              P.counts, P.order, P.dists, b);
}

struct HbmShadeParams {
  ShadeParams S;  // rays: the camera query's; out_f / out_i: hbm_light_kernel's
  const float* srays;  // [8, Rp] the shadow rays
  const float* k6_t;   // [Rp] K6's closest hit of the shadow rays: t,
  const int* k6_i;     // [Rp]   its row or -1
};

// One thread per ray, after K6's occlusion query: the shadow ray's closest
// hit (ops/traversal.py scene_occluded: K6's row, the spheres and discs
// bounded by its t), occluded where something is hit nearer than the light,
// then the epilogue's shading and stores.
__global__ void __launch_bounds__(ST) hbm_shade_kernel(const HbmShadeParams P) {
  const ShadeParams& S = P.S;
  const int i = blockIdx.x * ST + threadIdx.x;
  if (i >= S.R) return;
  const int Rp = S.Rp;
  const V3 so = {P.srays[i], P.srays[Rp + i], P.srays[2 * Rp + i]};
  const V3 sd = {P.srays[3 * Rp + i], P.srays[4 * Rp + i], P.srays[5 * Rp + i]};
  const float dist = P.srays[7 * Rp + i];
  int si, di, geom;
  const float t = hbm_closest(S, so, sd, P.srays[6 * Rp + i], dist, P.k6_t[i], P.k6_i[i], si,
                              di, geom);
  shade_ray(S, i, geom != kInvalidGeom && t < dist);
}

// ---- the BVH route's glue around K7 (bvh.cu) ----

struct BvhRaysParams {
  const float* rows;  // camera: [R] pixel rows; null: the caller's directions
  const float* cols;  // camera: [R] pixel columns
  const float* sxp;   // camera: 0-d image-plane factors on the card, or
  const float* syp;   //   null for sx, sy below
  float sx, sy, inv_w, inv_h;
  float* zeros;   // [R, 3] written with (0, 0, 0), the origin K7 reads; or null
  float* dirs;    // camera: [R, 3] written; null otherwise
  float* t_min;   // [R] written with 0
  float* t_max;   // [R] written with inf
  int R;
};

__global__ void __launch_bounds__(ST) bvh_rays_kernel(const BvhRaysParams P) {
  const int i = blockIdx.x * ST + threadIdx.x;
  if (i >= P.R) return;
  if (P.rows) {
    float d[3];
    camera_dir(P.rows[i], P.cols[i], P.inv_w, P.inv_h, P.sxp ? *P.sxp : P.sx,
               P.syp ? *P.syp : P.sy, d);
    for (int c = 0; c < 3; ++c) P.dirs[i * 3 + c] = d[c];
  }
  if (P.zeros) {
    for (int c = 0; c < 3; ++c) P.zeros[i * 3 + c] = 0.0f;
  }
  P.t_min[i] = 0.0f;
  P.t_max[i] = kInf();
}

// The scene's tables that hit_normal reads (scene/build.py, "bvh" scenes).
struct BvhGeom {
  const int* geom_type;         // [G]
  const int* geom_index;        // [G]
  const int* mesh_first_tri;    // [M]
  const int* mesh_has_normals;  // [M]
  const int* tri_v;             // [T, 3]
  const float* verts;           // [V, 3]
  const float* normals;         // [V, 3]
  const float* spheres;         // [S, 4] centre, radius
  const float* discs;           // [D, 7] normal, centre, radius
  int G, M, T, S, D;
};

__device__ __forceinline__ float comp(V3 v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

// ops/intersect.py intersect_triangle_watertight's barycentrics (b0, b1, b2)
// of the ray (o, d) against (p0, p1, p2), through make_ray_shear.
__device__ __forceinline__ V3 barycentrics(V3 o, V3 d, V3 p0, V3 p1, V3 p2) {
  const float a0 = fabsf(d.x), a1 = fabsf(d.y), a2 = fabsf(d.z);
  const int iz = (a1 > a0 && a1 >= a2) ? 1 : ((a2 > a0 && a2 > a1) ? 2 : 0);
  const int ix = iz == 2 ? 0 : iz + 1;
  const int iy = ix == 2 ? 0 : ix + 1;
  const float sz = 1.0f / comp(d, iz);
  const float sx = -comp(d, ix) * sz, sy = -comp(d, iy) * sz;
  const V3 q[3] = {{p0.x - o.x, p0.y - o.y, p0.z - o.z},
                   {p1.x - o.x, p1.y - o.y, p1.z - o.z},
                   {p2.x - o.x, p2.y - o.y, p2.z - o.z}};
  float px[3], py[3];
  for (int k = 0; k < 3; ++k) {
    const float qz = comp(q[k], iz);
    px[k] = xfma(sx, qz, comp(q[k], ix));
    py[k] = xfma(sy, qz, comp(q[k], iy));
  }
  const float e0 = xfma(px[1], py[2], -(py[1] * px[2]));
  const float e1 = xfma(px[2], py[0], -(py[2] * px[0]));
  const float e2 = xfma(px[0], py[1], -(py[0] * px[1]));
  const float inv_det = 1.0f / (e0 + e1 + e2);
  return {e0 * inv_det, e1 * inv_det, e2 * inv_det};
}

// ops/traversal.py hit_normal of the hit (t, gid, prim) of the ray (o, d):
// the mesh's vertex normals weighted by the barycentrics, or its geometric
// normal; the sphere's from its centre; the disc's own; (0, 0, 1) where
// nothing is hit. Only the branch the torch version selects is computed.
__device__ V3 hit_normal(const BvhGeom& G, V3 o, V3 d, float t, int gid, int prim,
                         bool zero_origin) {
  if (gid == kInvalidGeom) return {0.0f, 0.0f, 1.0f};
  const int g = clampi(gid, 0, G.G - 1);
  const int type = G.geom_type[g], gi = G.geom_index[g];
  if (type == kMesh) {
    const int mi = clampi(gi, 0, G.M - 1);
    const int* v = G.tri_v + 3 * clampi(G.mesh_first_tri[mi] + prim, 0, G.T - 1);
    const V3 p0 = load_v3(G.verts + 3 * v[0]), p1 = load_v3(G.verts + 3 * v[1]),
             p2 = load_v3(G.verts + 3 * v[2]);
    if (G.mesh_has_normals[mi] != 0) {
      const V3 b = barycentrics(o, d, p0, p1, p2);
      const V3 n0 = load_v3(G.normals + 3 * v[0]), n1 = load_v3(G.normals + 3 * v[1]),
               n2 = load_v3(G.normals + 3 * v[2]);
      return unit({xfma(n2.x, b.z, xfma(n0.x, b.x, n1.x * b.y)),
                   xfma(n2.y, b.z, xfma(n0.y, b.x, n1.y * b.y)),
                   xfma(n2.z, b.z, xfma(n0.z, b.x, n1.z * b.y))});
    }
    const V3 a = {p1.x - p0.x, p1.y - p0.y, p1.z - p0.z};
    const V3 b = {p2.x - p0.x, p2.y - p0.y, p2.z - p0.z};
    return unit({xfma(a.y, b.z, -(a.z * b.y)), xfma(a.z, b.x, -(a.x * b.z)),
                 xfma(a.x, b.y, -(a.y * b.x))});
  }
  if (type == kSphere) return sphere_normal(G.spheres + 4 * clampi(gi, 0, G.S - 1), o, d, t,
                                            zero_origin);
  return load_v3(G.discs + 7 * clampi(gi, 0, G.D - 1));
}

struct BvhLightParams {
  BvhGeom geo;
  const float* origins;  // [R, 3], or null for (0, 0, 0) (the folded forms)
  const float* dirs;     // [R, 3]
  const float* hit_t;    // [R] K7's closest hit: t (t_max where nothing is hit),
  const int* hit_geom;   //   geometry id (INVALID_GEOM_ID),
  const int* hit_prim;   //   primitive id
  float* sorig;   // [R, 3] the shadow ray: its origin pushed off the surface,
  float* sdir;    // [R, 3]   its unit direction to the light,
  float* dist;    // [R]      the light's distance (the any hit's t_max)
  float* normal;  // [R, 3] hit_normal
  float lx, ly, lz;
  int R;
};

__global__ void __launch_bounds__(ST) bvh_light_kernel(const BvhLightParams P) {
  const int i = blockIdx.x * ST + threadIdx.x;
  if (i >= P.R) return;
  const bool zero_origin = P.origins == nullptr;
  const V3 o = zero_origin ? V3{0.0f, 0.0f, 0.0f} : load_v3(P.origins + 3 * i);
  const V3 d = load_v3(P.dirs + 3 * i);
  const float t = P.hit_t[i];
  const int gid = P.hit_geom[i];
  const V3 nrm = hit_normal(P.geo, o, d, t, gid, P.hit_prim[i], zero_origin);
  V3 hp, sdir;
  float dist;
  light_ray(o, d, gid != kInvalidGeom ? t : 0.0f, zero_origin, {P.lx, P.ly, P.lz}, hp, sdir,
            dist);
  // ops/bxdf_loop.py offset_ray_origin(hp, sdir, nrm); torch.sign of a NaN
  // or a zero is 0, which the where makes 1
  const float mag = 1.0f + jmax(jmax(fabsf(hp.x), fabsf(hp.y)), fabsf(hp.z));
  const float m = mag * kRayEps() * (sum3(nrm, sdir) < 0.0f ? -1.0f : 1.0f);
  const V3 so = {xfma(nrm.x, m, hp.x), xfma(nrm.y, m, hp.y), xfma(nrm.z, m, hp.z)};
  for (int c = 0; c < 3; ++c) {
    P.sorig[i * 3 + c] = comp(so, c);
    P.sdir[i * 3 + c] = comp(sdir, c);
    P.normal[i * 3 + c] = comp(nrm, c);
  }
  P.dist[i] = dist;
}

struct BvhShadeParams {
  ShadeParams S;  // the material tables, the AOVs, R, zero_origin, light, ambient
  const float* origins;  // [R, 3], or null for (0, 0, 0)
  const float* dirs;     // [R, 3]
  const float* hit_t;    // [R] K7's closest hit
  const int* hit_geom;   // [R]
  const int* hit_prim;   // [R]
  const float* normal;   // [R, 3] bvh_light_kernel's
  const int* occ;        // [R] K7's any hit: 1 where occluded
};

__global__ void __launch_bounds__(ST) bvh_shade_kernel(const BvhShadeParams P) {
  const int i = blockIdx.x * ST + threadIdx.x;
  if (i >= P.S.R) return;
  const bool zero_origin = P.origins == nullptr;
  const V3 o = zero_origin ? V3{0.0f, 0.0f, 0.0f} : load_v3(P.origins + 3 * i);
  const V3 d = load_v3(P.dirs + 3 * i);
  const float t = P.hit_t[i];
  const int geom = P.hit_geom[i];
  const bool found = geom != kInvalidGeom;
  V3 hp, sdir;
  float dist;
  light_ray(o, d, found ? t : 0.0f, zero_origin, {P.S.lx, P.S.ly, P.S.lz}, hp, sdir, dist);
  shade_store(P.S, i, found, geom, P.hit_prim[i], t, load_v3(P.normal + 3 * i), hp, sdir,
              P.occ[i] != 0);
}

}  // namespace

extern "C" int rays_cull_launch(const float* baabb, const float* rows, const float* cols,
                                const float* sxp, const float* syp, float sx, float sy,
                                float inv_w, float inv_h, const float* origins,
                                const float* dirs, float* rays, int* counts, int* order,
                                float* dists, int R, int nb, void* stream) {
  RaysParams P;
  P.baabb = baabb;
  P.rows = rows;
  P.cols = cols;
  P.sxp = sxp;
  P.syp = syp;
  P.sx = sx;
  P.sy = sy;
  P.inv_w = inv_w;
  P.inv_h = inv_h;
  P.origins = origins;
  P.dirs = dirs;
  P.rays = rays;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.R = R;
  const int nrb = (R + BR - 1) / BR;
  P.Rp = nrb * BR;
  P.nb = nb;
  rays_cull_kernel<<<nrb, NT, nb * sizeof(float), static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The epilogue's tables, rays and light (the AOV pointers left null).
ShadeParams shade_params(const float* rays, const int* tri_geom, const int* tri_prim,
                         const int* sphere_geom, const int* disc_geom, const float* ap, int R,
                         int Rp, int n_tri, int n_sph, int n_dsc, int zero_origin, float lx,
                         float ly, float lz) {
  ShadeParams P = {};
  P.rays = rays;
  P.tri_geom = tri_geom;
  P.tri_prim = tri_prim;
  P.sphere_geom = sphere_geom;
  P.disc_geom = disc_geom;
  P.ap = ap;
  P.R = R;
  P.Rp = Rp;
  P.n_tri = n_tri;
  P.n_sph = n_sph;
  P.n_dsc = n_dsc;
  P.zero_origin = zero_origin;
  P.lx = lx;
  P.ly = ly;
  P.lz = lz;
  return P;
}

// The AOVs the caller asks for (null: not written), the material tables.
void shade_outs(ShadeParams& P, const int* mat_id, const float* mat_albedo, float* rgb,
                float* t, int* geom, int* prim, float* normal, float* hit_p,
                unsigned char* escaped, int n_geom, int n_mat, float ambient) {
  P.mat_id = mat_id;
  P.mat_albedo = mat_albedo;
  P.rgb = rgb;
  P.t = t;
  P.geom = geom;
  P.prim = prim;
  P.normal = normal;
  P.hit_p = hit_p;
  P.escaped = escaped;
  P.n_geom = n_geom;
  P.n_mat = n_mat;
  P.ambient = ambient;
}

}  // namespace

extern "C" int shade_launch(const float* rays, const float* out_f, const int* out_i,
                            const int* tri_geom, const int* tri_prim, const int* sphere_geom,
                            const int* disc_geom, const float* ap, const int* mat_id,
                            const float* mat_albedo, float* rgb, float* t, int* geom,
                            int* prim, float* normal, float* hit_p, unsigned char* escaped,
                            int R, int Rp, int n_tri, int n_sph, int n_dsc, int n_geom,
                            int n_mat, int zero_origin, float lx, float ly, float lz,
                            float ambient, void* stream) {
  ShadeParams P = shade_params(rays, tri_geom, tri_prim, sphere_geom, disc_geom, ap, R, Rp,
                               n_tri, n_sph, n_dsc, zero_origin, lx, ly, lz);
  P.out_f = out_f;
  P.out_i = out_i;
  shade_outs(P, mat_id, mat_albedo, rgb, t, geom, prim, normal, hit_p, escaped, n_geom, n_mat,
             ambient);
  shade_kernel<<<(R + ST - 1) / ST, ST, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hbm_light_launch(const float* rays, const float* k6_t, const int* k6_i,
                                const float* k6_n, const int* tri_geom, const int* sphere_geom,
                                const int* disc_geom, const float* ap, const float* saabb,
                                float* srays, int* counts, int* order, float* dists,
                                float* hit_f, int* hit_i, int R, int ns, int n_tri, int n_sph,
                                int n_dsc, int zero_origin, float lx, float ly, float lz,
                                void* stream) {
  const int nrb = (R + BR - 1) / BR;
  HbmLightParams P;
  P.S = shade_params(rays, tri_geom, nullptr, sphere_geom, disc_geom, ap, R, nrb * BR, n_tri,
                     n_sph, n_dsc, zero_origin, lx, ly, lz);
  P.hit_f = hit_f;
  P.hit_i = hit_i;
  P.k6_t = k6_t;
  P.k6_i = k6_i;
  P.k6_n = k6_n;
  P.saabb = saabb;
  P.srays = srays;
  P.counts = counts;
  P.order = order;
  P.dists = dists;
  P.ns = ns;
  hbm_light_kernel<<<nrb, NT, ns * sizeof(float), static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hbm_shade_launch(const float* rays, const float* hit_f, const int* hit_i,
                                const float* srays, const float* k6_t, const int* k6_i,
                                const int* tri_geom, const int* tri_prim, const int* sphere_geom,
                                const int* disc_geom, const float* ap, const int* mat_id,
                                const float* mat_albedo, float* rgb, float* t, int* geom,
                                int* prim, float* normal, float* hit_p, unsigned char* escaped,
                                int R, int n_tri, int n_sph, int n_dsc, int n_geom, int n_mat,
                                int zero_origin, float lx, float ly, float lz, float ambient,
                                void* stream) {
  HbmShadeParams P;
  P.S = shade_params(rays, tri_geom, tri_prim, sphere_geom, disc_geom, ap, R,
                     (R + BR - 1) / BR * BR, n_tri, n_sph, n_dsc, zero_origin, lx, ly, lz);
  P.S.out_f = hit_f;
  P.S.out_i = hit_i;
  shade_outs(P.S, mat_id, mat_albedo, rgb, t, geom, prim, normal, hit_p, escaped, n_geom, n_mat,
             ambient);
  P.srays = srays;
  P.k6_t = k6_t;
  P.k6_i = k6_i;
  hbm_shade_kernel<<<(R + ST - 1) / ST, ST, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_rays_launch(const float* rows, const float* cols, const float* sxp,
                               const float* syp, float sx, float sy, float inv_w, float inv_h,
                               float* zeros, float* dirs, float* t_min, float* t_max, int R,
                               void* stream) {
  BvhRaysParams P;
  P.rows = rows;
  P.cols = cols;
  P.sxp = sxp;
  P.syp = syp;
  P.sx = sx;
  P.sy = sy;
  P.inv_w = inv_w;
  P.inv_h = inv_h;
  P.zeros = zeros;
  P.dirs = dirs;
  P.t_min = t_min;
  P.t_max = t_max;
  P.R = R;
  bvh_rays_kernel<<<(R + ST - 1) / ST, ST, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_light_launch(const float* origins, const float* dirs, const float* hit_t,
                                const int* hit_geom, const int* hit_prim, const int* geom_type,
                                const int* geom_index, const int* mesh_first_tri,
                                const int* mesh_has_normals, const int* tri_v,
                                const float* verts, const float* normals,
                                const float* spheres, const float* discs, float* sorig,
                                float* sdir, float* dist, float* normal, int R, int G, int M,
                                int T, int S, int D, float lx, float ly, float lz,
                                void* stream) {
  BvhLightParams P;
  P.geo.geom_type = geom_type;
  P.geo.geom_index = geom_index;
  P.geo.mesh_first_tri = mesh_first_tri;
  P.geo.mesh_has_normals = mesh_has_normals;
  P.geo.tri_v = tri_v;
  P.geo.verts = verts;
  P.geo.normals = normals;
  P.geo.spheres = spheres;
  P.geo.discs = discs;
  P.geo.G = G;
  P.geo.M = M;
  P.geo.T = T;
  P.geo.S = S;
  P.geo.D = D;
  P.origins = origins;
  P.dirs = dirs;
  P.hit_t = hit_t;
  P.hit_geom = hit_geom;
  P.hit_prim = hit_prim;
  P.sorig = sorig;
  P.sdir = sdir;
  P.dist = dist;
  P.normal = normal;
  P.lx = lx;
  P.ly = ly;
  P.lz = lz;
  P.R = R;
  bvh_light_kernel<<<(R + ST - 1) / ST, ST, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_shade_launch(const float* origins, const float* dirs, const float* hit_t,
                                const int* hit_geom, const int* hit_prim, const float* normal,
                                const int* occ, const int* mat_id, const float* mat_albedo,
                                float* rgb, float* t, int* geom, int* prim, float* normal_out,
                                float* hit_p_out, unsigned char* escaped, int R, int n_geom,
                                int n_mat, float lx, float ly, float lz, float ambient,
                                void* stream) {
  BvhShadeParams P = {};
  P.S.mat_id = mat_id;
  P.S.mat_albedo = mat_albedo;
  P.S.rgb = rgb;
  P.S.t = t;
  P.S.geom = geom;
  P.S.prim = prim;
  P.S.normal = normal_out;
  P.S.hit_p = hit_p_out;
  P.S.escaped = escaped;
  P.S.R = R;
  P.S.n_geom = n_geom;
  P.S.n_mat = n_mat;
  P.S.zero_origin = origins == nullptr;
  P.S.lx = lx;
  P.S.ly = ly;
  P.S.lz = lz;
  P.S.ambient = ambient;
  P.origins = origins;
  P.dirs = dirs;
  P.hit_t = hit_t;
  P.hit_geom = hit_geom;
  P.hit_prim = hit_prim;
  P.normal = normal;
  P.occ = occ;
  bvh_shade_kernel<<<(R + ST - 1) / ST, ST, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
