// Device code shared by the kernels of the PyTorch/CUDA port: lane math,
// the RNG, the samplers, ray-object intersection (with the paged walk of
// paged_walk.cuh above 128 triangles), next-event estimation, the fog
// march, one bounce of the gpu contract, the scene tables in shared memory
// and the launch plumbing.  Included by render_pass.cu (the regeneration
// loop) and classic.cu (the classic per-sample loop and kernel B3), which
// ops/cuda_trace.py builds into one library each.
//
// Floating point: built without --use_fast_math and with --fmad=false, so
// every add, multiply, divide and sqrt is one IEEE-rounded operation as in
// the plain version's separate tensor ops; min/max propagate NaN like
// torch.minimum/maximum; rintf rounds half to even like torch.round.
//
// Operation counting build (-DPT_COUNT_OPS, used only to compute the
// kernels' bounds and their split): every f32 add, sub, mul, div, min, max,
// sqrt, int->float conversion and transcendental call that a lane executes
// adds 1, tallied per code block by hand; OPS_WALK does so for the paged walk
// and keeps the walk's own sum beside it, and WALK_CLOCK(call) adds the
// cycles of one call of the walk.  RNG(n) counts n rounds of the hash (one a
// draw, one a skipped draw, one a seed).  STAGE_BEGIN/STAGE_END add the
// cycles of a stage of a loop into its slot (STAGE_*),
// NEE_ENTRY counts the lanes of a warp that enter next-event estimation
// together, LANE_DONE stamps the end of a lane's last segment.  In the normal
// build these macros expand to nothing (or to the bare call) and the
// kernels' code is unchanged.
//
// Every kernel writes its traced segments into counters[0] of N_COUNTERS
// uint64; the counting build also fills [1] the f32 operation count, [2] the
// part of it done inside the paged walk, [3] the clock cycles that lanes
// spent inside the paged walk, [4] the cycles they spent in all, [5] the
// fog march's lane cycles (STAGE_FOG: the fog kernel, or the classic loop's
// in-trace march), [6..9] the cycles of the loop's
// stages, [10] the lanes that entered NEE summed over warp
// entries and [11] those entries, [12] the warp tail (cycles from the end of
// a lane's last segment to the end of its warp's), [13] the hash rounds,
// [14..17] the launch's first block start, first block end (both stored
// bit-inverted, so that atomicMax keeps the least), last block end and last
// block start, in ns of %globaltimer, [18] and [19] the classic loop's
// state advance and its jitter + camera ray (STAGE_ADVANCE, STAGE_CAMERA),
// [20] each warp's most segments of one thread times 32, summed (the
// segments the warps' loops run for, against [0]), and the fog march's own
// split: [21..24] the lane cycles of its primary hit, its noise, its light
// sampling with the shadow tests and the shadow tests alone (STAGE_MHIT,
// STAGE_MNOISE, STAGE_MLIGHT, STAGE_MSHADOW: each timed as the warp runs
// it, to the __syncwarp of the lanes that began it, so that a lane waiting
// for the others counts in the stage it waits in), [25] the lanes present
// at a light's shadow test and [26] those that run it, summed over warp
// iterations, [27] the iterations in which any lane runs it, [28] the tests
// that come back blocked, [29] the objects and triangles and [30] the BVH
// nodes that the tests visit before they return (the paged walk's not
// counted), [31] the noise's sinf calls and [32] those whose argument lies
// past 105,615 in magnitude (CUDA's slow Payne-Hanek reduction), [33] the
// march's warp tail (MARCH_DONE), [34] the part of [13] that kernel B3's
// state advance runs (classic.cu, advance_kernel).  counters[CURSOR] is the
// next lane of a launch whose blocks take lanes as they go.  After it, the
// warp sweep's own counts of the paged walk alone (pt_paged_walk; SWEEP in
// paged_walk.cuh): [36] its working sets, [37] the pages they visit, [38]
// the rays that want each visited page, summed, [39] the lane slots the
// sets issue for (ray, row) pairs (rounds of the row loop times the set's
// lanes), [40] the pairs their rays need, [41] the box tests.
//
// The profiling build (-DPT_PROF=bits, ops/cuda_trace.py::prof_bits; for
// profiling only, its images are wrong by design): bit PROF_NO_MESH_HIT
// leaves the mesh out of every closest-hit query (PATHTRACER_PROF_NO_MESH_HIT),
// PROF_NO_MESH_LITE out of the lite query of a paged mesh (_LITE),
// PROF_NO_MESH_OCCL out of every any-hit query (_OCCL), the fog march's
// included; PROF_WALK_ALL (PATHTRACER_NO_WALK_SKIP) lets a bounce's lanes
// that discard a query run it: NEE for every lane that hit, the
// specular-NEE query wherever the scene has rough metal, their results
// dropped (the same radiance; the draws are the same, D7).  A lane whose
// path has ended has left its loop and runs nothing, and a missed ray
// shades nothing, where the plain version's dead and missed lanes still
// walk.  PT_PROF 0 is the shipped build: the constants below fold, and its
// machine code is the same as without them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

// the stages whose cycles the counting build keeps (the fog march in its own
// kernel or in the classic loop's trace, the bounce loop's, the classic
// loop's state advance and camera ray)
constexpr int STAGE_FOG = 0, STAGE_ISECT = 1, STAGE_NEE = 2, STAGE_LITE = 3, STAGE_LOOP = 4, STAGE_ADVANCE = 5,
              STAGE_CAMERA = 6, STAGE_MHIT = 7, STAGE_MNOISE = 8, STAGE_MLIGHT = 9, STAGE_MSHADOW = 10, N_STAGES = 11;
constexpr int N_COUNTERS = 42, CURSOR = 35, ADVANCE_ROUNDS = 34, SWEEP_COUNTS = 36;

// the profiling build's bits and its gates: in the shipped build (PT_PROF 0) each gate expands to its
// argument alone, so that the code is the same token for token
#ifndef PT_PROF
#define PT_PROF 0
#endif
#define PROF_NO_MESH_HIT 1
#define PROF_NO_MESH_LITE 2
#define PROF_NO_MESH_OCCL 4
#define PROF_WALK_ALL 8
#if PT_PROF & PROF_NO_MESH_HIT
#define MESH_HIT_GATE(c) false && (c)
#else
#define MESH_HIT_GATE(c) c
#endif
#if PT_PROF & PROF_NO_MESH_LITE
#define MESH_LITE_GATE(c) (c) && !lite
#else
#define MESH_LITE_GATE(c) c
#endif
#if PT_PROF & PROF_WALK_ALL
#define WALK_ALL_OR(c) true
#define WALK_ALL_AND(c) && (c)
#else
#define WALK_ALL_OR(c) c
#define WALK_ALL_AND(c)
#endif

#ifdef PT_COUNT_OPS
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct OpsCount {
  unsigned long long all, walk, walk_cycles;
  long long t0;      // the lane's start, in clock cycles
  long long t_last;  // the end of its last segment (0: it traced none)
  unsigned long long ns0;  // the thread's start, in ns of %globaltimer
  unsigned long long stage[N_STAGES];
  unsigned long long nee_active, nee_entries, rng;
  long long t_march;  // the end of the lane's fog march (0: it marched none)
  unsigned long long shadow_lanes, shadow_active, shadow_entries, shadow_blocked, prims, nodes, sin_calls, sin_large;
  // the warp sweep's counts (SWEEP): working sets, visited pages, wanting rays, lane slots, pairs, box tests
  unsigned long long w_sets, w_pages, w_want, w_slots, w_pairs, w_boxes;
};
__device__ __forceinline__ OpsCount ops_start() {
  OpsCount o = {};
  o.t0 = clock64();
  o.ns0 = global_ns();
  return o;
}
#define OPS_DECL OpsCount ops = ops_start()
#define OPS(n) (ops.all += (unsigned long long)(n))
#define OPS_WALK(n) (ops.all += (unsigned long long)(n), ops.walk += (unsigned long long)(n))
#define OPS_PARAM , OpsCount& ops
#define OPS_ARG , ops
#define WALK_CLOCK(call)                          \
  do {                                            \
    long long walk_t0 = clock64();                \
    call;                                         \
    ops.walk_cycles += clock64() - walk_t0;       \
  } while (0)
#define RNG(n) (ops.rng += (unsigned long long)(n))
#define STAGE_BEGIN(v) const long long v = clock64()
#define STAGE_END(v, k) (ops.stage[k] += clock64() - (v))
#define NEE_ENTRY()                                              \
  do {                                                           \
    const unsigned nee_m = __activemask();                       \
    if ((threadIdx.x & 31) == __ffs(nee_m) - 1) {                \
      ops.nee_active += __popc(nee_m);                           \
      ops.nee_entries += 1;                                      \
    }                                                            \
  } while (0)
#define LANE_DONE() (ops.t_last = clock64())
// a stage of the fog march timed as the warp runs it: from its start to the
// __syncwarp of the lanes that began it together
#define WSTAGE_BEGIN(v)                   \
  const unsigned v##_mask = __activemask(); \
  const long long v = clock64()
#define WSTAGE_END(v, k) (__syncwarp(v##_mask), ops.stage[k] += clock64() - (v))
// the fog march's shadow test as the warp runs it: the lanes present, those
// that test, and the cycles until the lanes that began it together meet
#define SHADOW_BEGIN(valid)                                         \
  const unsigned sh_mask = __activemask();                          \
  const unsigned sh_testing = __ballot_sync(sh_mask, valid);        \
  if ((threadIdx.x & 31) == __ffs(sh_mask) - 1) {                   \
    ops.shadow_lanes += __popc(sh_mask);                            \
    ops.shadow_active += __popc(sh_testing);                        \
    ops.shadow_entries += sh_testing != 0u;                         \
  }                                                                 \
  const long long sh_t0 = clock64()
#define SHADOW_END(blocked)                                                          \
  (ops.shadow_blocked += (blocked), __syncwarp(sh_mask), ops.stage[STAGE_MSHADOW] += \
   clock64() - sh_t0)
#define MARCH_DONE() (ops.t_march = clock64())
#define SIN_ARG(x) (ops.sin_calls += 1, ops.sin_large += fabsf(x) > F(105615.0) ? 1 : 0)
#define VISIT_PRIM() (ops.prims += 1)
#define VISIT_NODE() (ops.nodes += 1)
#define SWEEP(x) (x)
#else
#define OPS_DECL
#define OPS(n) ((void)0)
#define OPS_WALK(n) ((void)0)
#define OPS_PARAM
#define OPS_ARG
#define WALK_CLOCK(call) call
#define RNG(n) ((void)0)
#define STAGE_BEGIN(v)
#define STAGE_END(v, k) ((void)0)
#define NEE_ENTRY() ((void)0)
#define LANE_DONE() ((void)0)
#define WSTAGE_BEGIN(v)
#define WSTAGE_END(v, k) ((void)0)
#define SHADOW_BEGIN(valid)
#define SHADOW_END(blocked) ((void)0)
#define MARCH_DONE() ((void)0)
#define SIN_ARG(x) ((void)0)
#define VISIT_PRIM() ((void)0)
#define VISIT_NODE() ((void)0)
#define SWEEP(x) ((void)0)
#endif

namespace {

constexpr float BIG_T = 1e20f;
constexpr int MAT_STRIDE = 20;
constexpr int OBJ_STRIDE = 12;
constexpr int TRI_STRIDE = 24;
constexpr int MAT_LAMBERT = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2, MAT_EMISSIVE = 3, MAT_MIRROR = 4;
constexpr int OBJ_SPHERE = 0, OBJ_PLANE = 1, OBJ_BOX = 2, OBJ_TRIANGLE = 3;
constexpr int MAX_LIGHTS = 8;
constexpr int BLOCK = 128;
constexpr int BASIS_LEN = 19;

// flag bits (must match ops/cuda_trace.py)
constexpr int FLAG_APERTURE = 1, FLAG_LENS_DISK = 2, FLAG_ROUGH_METAL = 4, FLAG_DIELECTRIC = 8,
              FLAG_FOG_ONCE = 16, FLAG_NORMALIZE = 32, FLAG_NEE = 64, FLAG_TRI_EMISSIVE = 128,
              FLAG_CPU = 256, FLAG_FOG_TRACE = 512;
// PATHTRACER_BVH_DROP (integrator.py::TraceConfig.debug_drop, for timing only): the bounce's closest hit, NEE's
// shadow rays and the specular-NEE query of a paged mesh skip their walk, as rays whose result is discarded do;
// a launch that carries one runs the kernels' DROP instances
constexpr int FLAG_DROP_CLOSEST = 1024, FLAG_DROP_SHADOW = 2048, FLAG_DROP_SPEC = 4096;
constexpr int FLAG_DROP_ANY = FLAG_DROP_CLOSEST | FLAG_DROP_SHADOW | FLAG_DROP_SPEC;

#ifdef PT_COUNT_OPS
// per-call f32 operation counts of the fixed-cost helpers below
constexpr int C_DRAW = 3, C_NORMALIZE = 11, C_DOT = 5, C_REFLECT = 12;
constexpr int C_UNIT_BALL = 36, C_UNIT_DISK = 24, C_COSINE_DIR = 73, C_SPHERE_SURF = 29;
constexpr int C_GGX = 131, C_REFRACT = 34, C_SCHLICK = 12, C_LUM_CLAMP = 10, C_BACKGROUND = 14;
constexpr int C_HASH31 = 21, C_PHASE = 11, C_RAY_SETUP = 9, C_SPHERE = 24, C_PLANE = 2, C_BOX = 32;
constexpr int C_NODE = 23, C_TRI = 46, C_COSINE_ONB = 71, C_CULL = 58;
#endif

struct V {
  float x, y, z;
};
__device__ __forceinline__ V mk(float x, float y, float z) { V r; r.x = x; r.y = y; r.z = z; return r; }
__device__ __forceinline__ V add(V a, V b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V sub(V a, V b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V mul(V a, V b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V muls(V a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V cross(V a, V b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// NaN-propagating min/max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return nmin(nmax(x, lo), hi); }
__device__ __forceinline__ V normalize(V a) {
  float inv = 1.0f / sqrtf(nmax(dot(a, a), F(1e-20)));
  return muls(a, inv);
}
__device__ __forceinline__ float signf(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x); }
__device__ __forceinline__ float max_comp(V a) { return nmax(a.x, nmax(a.y, a.z)); }
__device__ __forceinline__ bool any_positive(V a) { return a.x > 0.0f || a.y > 0.0f || a.z > 0.0f; }

#include "paged_walk.cuh"

// ---- RNG: the shader's hash (gpu.go:444-458), bit-exact with ops/rng.py ----
__device__ __forceinline__ uint32_t hash_u(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}
__device__ __forceinline__ uint32_t seed_lane(uint32_t px, uint32_t py, uint32_t seed) {
  return hash_u((px * 1973u) ^ (py * 9277u) ^ seed);
}
__device__ __forceinline__ float next_u(uint32_t& s) {
  s = hash_u(s);
  return (float)(int32_t)s * F(2.3283064365386963e-10) + 0.5f;
}
__device__ __forceinline__ void skip_u(uint32_t& s, int n) {
  for (int i = 0; i < n; ++i) s = hash_u(s);
}

// ---- sampling (ops/sampling.py) ----
__device__ __forceinline__ void sincos_2pi(float u, float& s, float& c) {
  const float S1 = F(-1.6666654611e-1), S2 = F(8.3321608736e-3), S3 = F(-1.9515295891e-4);
  const float C1 = F(4.166664568298827e-2), C2 = F(-1.388731625493765e-3), C3 = F(2.443315711809948e-5);
  float t = u * 4.0f;
  float kf = rintf(t);
  float r = (t - kf) * F(1.5707963267948966);
  float r2 = r * r;
  float sin_r = r + r * r2 * (S1 + r2 * (S2 + r2 * S3));
  float cos_r = 1.0f - 0.5f * r2 + r2 * r2 * (C1 + r2 * (C2 + r2 * C3));
  int k = (int)kf;
  bool swap = (k & 1) != 0;
  s = swap ? cos_r : sin_r;
  c = swap ? sin_r : cos_r;
  bool k2 = (k & 2) != 0;
  if (k2) s = -s;
  if (k2 != swap) c = -c;
}

__device__ V unit_ball(float u1, float u2, float u3) {
  float z = 1.0f - 2.0f * u1;
  float r = sqrtf(nmax(1.0f - z * z, 0.0f));
  float sp, cp;
  sincos_2pi(u2, sp, cp);
  float rad = expf(logf(nmax(u3, F(1e-30))) * F(1.0 / 3.0));
  return mk(r * cp * rad, r * sp * rad, z * rad);
}

__device__ V unit_disk(float u1, float u2) {
  float r = sqrtf(u1);
  float sp, cp;
  sincos_2pi(u2, sp, cp);
  return mk(r * cp, r * sp, 0.0f);
}

__device__ V cosine_direction(V n, float u1, float u2) {
  float sp, cp;
  sincos_2pi(u1, sp, cp);
  float cos_t = sqrtf(u2);
  float sin_t = sqrtf(nmax(1.0f - u2, 0.0f));
  bool use_y = fabsf(n.x) > F(0.9);
  V axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  V v = normalize(cross(n, axis));
  float lx = sin_t * cp, ly = sin_t * sp;
  V d = add(add(muls(axis, lx), muls(v, ly)), muls(n, cos_t));
  return normalize(d);
}

__device__ V sphere_surface(float u1, float u2) {
  float z = 1.0f - 2.0f * u1;
  float r = sqrtf(nmax(1.0f - z * z, 0.0f));
  float sp, cp;
  sincos_2pi(u2, sp, cp);
  return mk(r * cp, r * sp, z);
}

__device__ V reflect(V v, V n) { return sub(v, muls(n, 2.0f * dot(v, n))); }

__device__ V sample_ggx(V inc, V n, float rough, float u1, float u2) {
  float alpha = rough * rough;
  float alpha2 = alpha * alpha;
  float cos_t = sqrtf(nmax((1.0f - u2) / (1.0f + (alpha2 - 1.0f) * u2), 0.0f));
  float sin_t = sqrtf(nmax(1.0f - cos_t * cos_t, 0.0f));
  float sp, cp;
  sincos_2pi(u1, sp, cp);
  bool use_x = fabsf(n.z) >= F(0.999);
  V up = use_x ? mk(1.0f, 0.0f, 0.0f) : mk(0.0f, 0.0f, 1.0f);
  V tangent = normalize(cross(up, n));
  V bitangent = cross(n, tangent);
  V h = normalize(add(add(muls(tangent, sin_t * cp), muls(bitangent, sin_t * sp)), muls(n, cos_t)));
  V refl = sub(inc, muls(h, 2.0f * dot(inc, h)));
  bool below = dot(refl, n) <= 0.0f;
  V mirror = sub(inc, muls(n, 2.0f * dot(inc, n)));
  return normalize(below ? mirror : refl);
}

// ---- optics (ops/optics.py) ----
__device__ V refract(V v, V n, float eta) {
  float cos_t = nmin(dot(mk(-v.x, -v.y, -v.z), n), 1.0f);
  float sin2 = 1.0f - cos_t * cos_t;
  bool tir = (eta * eta * sin2) > 1.0f;
  V r_perp = muls(add(v, muls(n, cos_t)), eta);
  float len2 = dot(r_perp, r_perp);
  float par = sqrtf(nmax(1.0f - nmin(len2, 1.0f), 0.0f));
  V refracted = sub(r_perp, muls(n, par));
  return tir ? reflect(v, n) : refracted;
}

__device__ __forceinline__ float schlick(float cosine, float rel) {
  float r0 = (rel - 1.0f) / (rel + 1.0f);
  r0 = r0 * r0;
  float x = 1.0f - cosine;
  float x5 = x * x * x * x * x;
  return r0 + (1.0f - r0) * x5;
}

// ---- scene tables in shared memory ----
struct Scene {
  const float* mat;
  const float* obj;
  const float* sky;
  const float* fog;
  const float* basis;
  const float* tri;
  const float* bounds;
  const int* lights;
  const int* topo;  // miss[B], first[B], count[B]
  int n_obj, n_lights, n_nodes;
  Pages pages;        // meshes above 128 triangles (n_pages == 0 otherwise)
  bool tri_emissive;  // some mesh triangle carries an emissive material
};

struct Hit {
  bool hit;
  float t;
  V p, normal;
  bool front_face;
  int obj_idx, obj_type, mat_idx, mtyp;
};

// distance to one analytic object (ops/geometry.py::_object_candidates):
// the sphere's near root, or its far root when the near one lies before
// t_min; the plane's crossing; the box's entry.  Returns whether it counts.
__device__ __forceinline__ bool object_t(const float* ob, int typ, V o, V d, float a, float inv_a, float inv_dx,
                                         float inv_dy, float inv_dz, float t_min, float& t) {
  float cx = ob[4], cy = ob[5], cz = ob[6], sx = ob[8], sy = ob[9], sz = ob[10];
  bool ok;
  if (typ == OBJ_SPHERE) {
    float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
    float half_b = ocx * d.x + ocy * d.y + ocz * d.z;
    float c = ocx * ocx + ocy * ocy + ocz * ocz - sx * sx;
    float disc = half_b * half_b - a * c;
    ok = disc >= F(1e-8);
    float sq = sqrtf(nmax(disc, 0.0f));
    float rn = (-half_b - sq) * inv_a;
    float rf = (-half_b + sq) * inv_a;
    t = rn >= t_min ? rn : rf;
    ok = ok && t >= t_min;
  } else if (typ == OBJ_PLANE) {
    ok = fabsf(d.y) >= F(1e-6);
    t = (cy - o.y) * inv_dy;
    ok = ok && t >= t_min;
  } else {
    float hx = sx * 0.5f, hy = sy * 0.5f, hz = sz * 0.5f;
    float n1x = (cx - hx - o.x) * inv_dx, n2x = (cx + hx - o.x) * inv_dx;
    float n1y = (cy - hy - o.y) * inv_dy, n2y = (cy + hy - o.y) * inv_dy;
    float n1z = (cz - hz - o.z) * inv_dz, n2z = (cz + hz - o.z) * inv_dz;
    float t0 = nmax(nmax(nmin(n1x, n2x), nmin(n1y, n2y)), nmax(nmin(n1z, n2z), t_min));
    float t1 = nmin(nmin(nmax(n1x, n2x), nmax(n1y, n2y)), nmax(n1z, n2z));
    ok = t1 > t0;
    t = t0;
  }
  return ok;
}

// closest hit (ops/geometry.py::intersect_world); exclude < 0 = none.
// ``lite``: the caller acts only on an emissive winner and reads only hit,
// t, normal, mtyp and mat_idx of it (the specular-NEE ray).  On a paged
// mesh without emissive triangles the mesh can then only hide the object
// sweep's winner: a ray whose object winner is not emissive walks nothing,
// the others take the any-hit walk up to that winner's t, and a hidden or
// non-emissive winner comes back as no hit.
// DROP (PATHTRACER_BVH_DROP's instances only): ``walk`` false skips the paged
// walk as for a ray whose result is discarded (the plain version's
// ``skip``): the mesh hides nothing from a lite query, whose answer is then
// no hit, and adds nothing to a closest hit.  Without DROP ``walk`` is not
// read, and the code is the walk's alone.
// PAGED is a template argument of the whole kernel: launches without pages
// run code that holds nothing of the paged walk, so the walk's registers
// and code do not weigh on scenes that have no large mesh.
template <bool PAGED, bool DROP = false>
__device__ Hit intersect(const Scene& S, V o, V d, int exclude, bool lite, bool walk OPS_PARAM) {
  const float t_min = F(0.001);
  float a = dot(d, d);
  float inv_a = 1.0f / a;
  float inv_dx = 1.0f / d.x, inv_dy = 1.0f / d.y, inv_dz = 1.0f / d.z;
  OPS(C_RAY_SETUP);
  float best_t = BIG_T;
  int best_m = 0, best_obj = 0;
  for (int m = 0; m < S.n_obj; ++m) {
    const float* ob = S.obj + m * OBJ_STRIDE;
    int typ = (int)ob[0];
    float t;
    OPS(typ == OBJ_SPHERE ? C_SPHERE : (typ == OBJ_PLANE ? C_PLANE : C_BOX));
    bool ok = object_t(ob, typ, o, d, a, inv_a, inv_dx, inv_dy, inv_dz, t_min, t);
    if (ok && m != exclude && t < best_t) {
      best_t = t;
      best_m = m;
      best_obj = m;
    }
  }
  bool obj_hit = best_t < BIG_T;
  bool is_tri = false, is_paged = false;
  int best_tri = 0, paged_mat = 0;
  float best_u = 0.0f, best_v = 0.0f;
  V paged_n = mk(0.0f, 0.0f, 0.0f);
  if constexpr (MESH_HIT_GATE(PAGED)) {
    const V inv = mk(inv_dx, inv_dy, inv_dz);
    if (lite && !S.tri_emissive) {
      bool seen = obj_hit && (int)S.mat[(int)S.obj[best_obj * OBJ_STRIDE + 1] * MAT_STRIDE] == MAT_EMISSIVE;
      if (MESH_LITE_GATE(seen))
        WALK_CLOCK(seen = (!DROP || walk) && !paged_occluded(S.pages, o, d, inv, t_min, best_t OPS_ARG));
      if (!seen) {
        Hit h;
        h.hit = false;
        h.t = BIG_T;
        h.p = o;
        h.normal = mk(0.0f, 1.0f, 0.0f);
        h.front_face = false;
        h.obj_idx = h.obj_type = h.mat_idx = h.mtyp = 0;
        return h;
      }
    } else if (MESH_LITE_GATE(!DROP || walk)) {
      PagedWinner w;
      WALK_CLOCK(w = paged_traverse(S.pages, o, d, inv, t_min, best_t, __int_as_float(0x7f800000),
                                    (float)exclude OPS_ARG));
      if (w.hit && w.t < best_t) {
        best_t = w.t;
        best_m = (int)w.obj;
        paged_mat = (int)w.mat;
        paged_n = mk(w.nx, w.ny, w.nz);
        is_tri = is_paged = true;
      }
    }
  } else if (MESH_HIT_GATE(S.n_nodes > 0)) {
    int nd = 0;
    while (nd < S.n_nodes) {
      const float* bn = S.bounds + nd * 6;
      OPS(C_NODE);
      float t1x = (bn[0] - o.x) * inv_dx, t2x = (bn[3] - o.x) * inv_dx;
      float t1y = (bn[1] - o.y) * inv_dy, t2y = (bn[4] - o.y) * inv_dy;
      float t1z = (bn[2] - o.z) * inv_dz, t2z = (bn[5] - o.z) * inv_dz;
      float t0 = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
      float t1 = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
      bool box_hit = (t1 >= t0) && (t1 >= t_min) && (t0 < best_t);
      int count = S.topo[2 * S.n_nodes + nd];
      if (count > 0) {
        if (box_hit) {
          int first = S.topo[S.n_nodes + nd];
          for (int k = 0; k < count; ++k) {
            const float* r = S.tri + (first + k) * TRI_STRIDE;
            OPS(C_TRI);
            float e1x = r[3], e1y = r[4], e1z = r[5], e2x = r[6], e2y = r[7], e2z = r[8];
            float px = d.y * e2z - d.z * e2y;
            float py = d.z * e2x - d.x * e2z;
            float pz = d.x * e2y - d.y * e2x;
            float det = e1x * px + e1y * py + e1z * pz;
            bool ok = fabsf(det) > F(1e-9);
            float inv_det = 1.0f / (ok ? det : 1.0f);
            float tvx = o.x - r[0], tvy = o.y - r[1], tvz = o.z - r[2];
            float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
            float qx = tvy * e1z - tvz * e1y;
            float qy = tvz * e1x - tvx * e1z;
            float qz = tvx * e1y - tvy * e1x;
            float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
            float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min;
            int tri_obj = (int)r[10];
            if (ok && tri_obj != exclude && t < best_t) {
              best_t = t;
              best_m = tri_obj;
              best_tri = first + k;
              best_u = u;
              best_v = v;
              is_tri = true;
            }
          }
        }
        nd += 1;
      } else {
        nd = box_hit ? nd + 1 : S.topo[nd];
      }
    }
  }

  Hit h;
  h.hit = best_t < BIG_T;
  h.t = h.hit ? best_t : BIG_T;
  if (!h.hit) {
    h.p = o;
    h.normal = mk(0.0f, 1.0f, 0.0f);
    h.front_face = false;
    h.obj_idx = h.obj_type = h.mat_idx = h.mtyp = 0;
    return h;
  }
  h.p = add(o, muls(d, best_t));
  OPS(6 + 8);  // p; front-face test and flip
  float nx, ny, nz;
  if (is_paged) {
    h.obj_type = OBJ_TRIANGLE;
    h.mat_idx = paged_mat;
    nx = paged_n.x; ny = paged_n.y; nz = paged_n.z;
  } else if (is_tri) {
    const float* r = S.tri + best_tri * TRI_STRIDE;
    h.obj_type = OBJ_TRIANGLE;
    h.mat_idx = (int)r[9];
    OPS(r[11] != 0.0f ? 27 : 19);
    if (r[11] != 0.0f) {
      float w0 = 1.0f - best_u - best_v;
      nx = w0 * r[12] + best_u * r[15] + best_v * r[18];
      ny = w0 * r[13] + best_u * r[16] + best_v * r[19];
      nz = w0 * r[14] + best_u * r[17] + best_v * r[20];
      float nlen = sqrtf(nmax(nx * nx + ny * ny + nz * nz, F(1e-30)));
      nx = nx / nlen;
      ny = ny / nlen;
      nz = nz / nlen;
    } else {
      float e1x = r[3], e1y = r[4], e1z = r[5], e2x = r[6], e2y = r[7], e2z = r[8];
      float gnx = e1y * e2z - e1z * e2y;
      float gny = e1z * e2x - e1x * e2z;
      float gnz = e1x * e2y - e1y * e2x;
      float glen = sqrtf(nmax(gnx * gnx + gny * gny + gnz * gnz, F(1e-30)));
      nx = gnx / glen;
      ny = gny / glen;
      nz = gnz / glen;
    }
  } else {
    const float* ob = S.obj + best_obj * OBJ_STRIDE;
    h.obj_type = (int)ob[0];
    h.mat_idx = (int)ob[1];
    V c = obj_hit ? mk(ob[4], ob[5], ob[6]) : mk(0.0f, 0.0f, 0.0f);
    V s = obj_hit ? mk(ob[8], ob[9], ob[10]) : mk(0.0f, 0.0f, 0.0f);
    OPS(h.obj_type == OBJ_PLANE ? 0 : 7);
    if (h.obj_type == OBJ_SPHERE) {
      float inv_r = 1.0f / (s.x != 0.0f ? s.x : 1.0f);
      V ns = muls(sub(h.p, c), inv_r);
      nx = ns.x; ny = ns.y; nz = ns.z;
    } else if (h.obj_type == OBJ_PLANE) {
      nx = 0.0f; ny = 1.0f; nz = 0.0f;
    } else {
      V l = sub(h.p, c);
      bool on_x = fabsf(fabsf(l.x) - s.x * 0.5f) < F(1e-4);
      bool on_y = fabsf(fabsf(l.y) - s.y * 0.5f) < F(1e-4);
      nx = on_x ? signf(l.x) : 0.0f;
      ny = (!on_x && on_y) ? signf(l.y) : 0.0f;
      nz = (!on_x && !on_y) ? signf(l.z) : 0.0f;
    }
  }
  h.front_face = (d.x * nx + d.y * ny + d.z * nz) < 0.0f;
  float sgn = h.front_face ? 1.0f : -1.0f;
  h.normal = mk(nx * sgn, ny * sgn, nz * sgn);
  h.obj_idx = best_m;
  h.mtyp = (int)S.mat[h.mat_idx * MAT_STRIDE];
  return h;
}

// any hit before t_max (ops/geometry.py::occluded).  CULL: only the
// objects m < 31 whose bit m of `cull` is set, every object from 31 on, and
// the mesh's node walk only where bit 31 is set (shadow_cull below).  The
// result is an OR over the primitives, so leaving out primitives that no
// ray of the call can hit changes nothing.
template <bool PAGED, bool CULL = false>
__device__ bool occluded(const Scene& S, V o, V d, float t_max, uint32_t cull OPS_PARAM) {
  const float t_min = F(0.001);
  float a = dot(d, d);
  float inv_a = 1.0f / a;
  float inv_dx = 1.0f / d.x, inv_dy = 1.0f / d.y, inv_dz = 1.0f / d.z;
  OPS(C_RAY_SETUP);
  auto blocks = [&](int m) {
    const float* ob = S.obj + m * OBJ_STRIDE;
    int typ = (int)ob[0];
    float t;
    OPS(typ == OBJ_SPHERE ? C_SPHERE : (typ == OBJ_PLANE ? C_PLANE : C_BOX));
    VISIT_PRIM();
    bool ok = object_t(ob, typ, o, d, a, inv_a, inv_dx, inv_dy, inv_dz, t_min, t);
    return ok && t <= t_max;
  };
  if (CULL && S.n_obj <= 31) {
    for (uint32_t mm = cull & ((1u << S.n_obj) - 1u); mm; mm &= mm - 1u)
      if (blocks(__ffs(mm) - 1)) return true;
  } else {  // shadow_cull culls nothing above 31 objects
    for (int m = 0; m < S.n_obj; ++m)
      if (blocks(m)) return true;
  }
#if PT_PROF & PROF_NO_MESH_OCCL
  return false;
#endif
  if constexpr (PAGED) {
    bool blocked;
    WALK_CLOCK(blocked = paged_occluded(S.pages, o, d, mk(inv_dx, inv_dy, inv_dz), t_min, t_max OPS_ARG));
    return blocked;
  }
  if (CULL && !(cull >> 31)) return false;
  int nd = 0;
  while (nd < S.n_nodes) {
    const float* bn = S.bounds + nd * 6;
    OPS(C_NODE);
    VISIT_NODE();
    float t1x = (bn[0] - o.x) * inv_dx, t2x = (bn[3] - o.x) * inv_dx;
    float t1y = (bn[1] - o.y) * inv_dy, t2y = (bn[4] - o.y) * inv_dy;
    float t1z = (bn[2] - o.z) * inv_dz, t2z = (bn[5] - o.z) * inv_dz;
    float t0 = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    float t1 = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    bool box_hit = (t1 >= t0) && (t1 >= t_min) && (t0 < BIG_T);
    int count = S.topo[2 * S.n_nodes + nd];
    if (count > 0) {
      if (box_hit) {
        int first = S.topo[S.n_nodes + nd];
        for (int k = 0; k < count; ++k) {
          const float* r = S.tri + (first + k) * TRI_STRIDE;
          OPS(C_TRI);
          VISIT_PRIM();
          float e1x = r[3], e1y = r[4], e1z = r[5], e2x = r[6], e2y = r[7], e2z = r[8];
          float px = d.y * e2z - d.z * e2y;
          float py = d.z * e2x - d.x * e2z;
          float pz = d.x * e2y - d.y * e2x;
          float det = e1x * px + e1y * py + e1z * pz;
          bool ok = fabsf(det) > F(1e-9);
          float inv_det = 1.0f / (ok ? det : 1.0f);
          float tvx = o.x - r[0], tvy = o.y - r[1], tvz = o.z - r[2];
          float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
          float qx = tvy * e1z - tvz * e1y;
          float qy = tvz * e1x - tvx * e1z;
          float qz = tvx * e1y - tvy * e1x;
          float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
          float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min;
          if (ok && t <= t_max) return true;
        }
      }
      nd += 1;
    } else {
      nd = box_hit ? nd + 1 : S.topo[nd];
    }
  }
  return false;
}

__device__ __forceinline__ V luminance_clamp(V c) {
  float lum = c.x * F(0.2126) + c.y * F(0.7152) + c.z * F(0.0722);
  float scale = lum > 500.0f ? 500.0f / nmax(lum, F(1e-6)) : 1.0f;
  return muls(c, scale);
}

// estimateDirectLight (ops/lights.py): every light when there are at most
// 8, two draws each; above that one draw for the start of a window of 8
// consecutive lights (modulo the count), two draws and one shadow ray per
// slot, the sum scaled by count/8.  Non-sphere lights contribute nothing.
// DROP and ``walk`` false: the shadow rays skip the paged walk, and a
// skipped ray counts as blocked (the plain version's ``skip``).
template <bool PAGED, bool DROP = false>
__device__ V direct_light(const Scene& S, V p, V n, V albedo, uint32_t& st, bool walk OPS_PARAM) {
  V total = mk(0.0f, 0.0f, 0.0f);
  const float PI4 = 4.0f * F(3.14159265359);
  const int count = S.n_lights;
  const bool window = count > MAX_LIGHTS;
  int start = 0;
  if (window) {
    float us = next_u(st);
    OPS(C_DRAW + 2);
    RNG(1);
    start = (int)(us * (float)count) % count;
  }
  const int n_slots = window ? MAX_LIGHTS : count;
  for (int j = 0; j < n_slots; ++j) {
    const int i = window ? (start + j) % count : j;
    float u1 = next_u(st), u2 = next_u(st);
    OPS(2 * C_DRAW);
    RNG(2);
    const float* ob = S.obj + S.lights[i] * OBJ_STRIDE;
    if ((int)ob[0] != OBJ_SPHERE) continue;
    const float* mt = S.mat + (int)ob[1] * MAT_STRIDE;
    float radius = ob[8];
    V ln = sphere_surface(u1, u2);
    OPS(C_SPHERE_SURF + 6 + 3 + 3 + C_DOT + 2 + 1 + 3 + 6 + 7);
    V lp = mk(ob[4] + radius * ln.x, ob[5] + radius * ln.y, ob[6] + radius * ln.z);
    // the window's slots take the light's area as 4 pi (r r), like the
    // gathered form of the plain version
    float inv_pdf = nmax(window ? PI4 * (radius * radius) : PI4 * radius * radius, F(1e-20));
    V to_l = sub(lp, p);
    float dist_sq = dot(to_l, to_l);
    bool valid = dist_sq > F(1e-6);
    float dist = sqrtf(nmax(dist_sq, F(1e-20)));
    V wi = muls(to_l, 1.0f / dist);
    float cos_s = nmax(dot(n, wi), 0.0f);
    float cos_l = nmax(-dot(ln, wi), 0.0f);
    valid = valid && cos_s > 0.0f && cos_l > 0.0f;
    if (!valid) continue;
    OPS(7);
    if ((DROP && !walk) || occluded<PAGED>(S, add(p, muls(n, F(0.001))), wi, dist - F(0.002), ~0u OPS_ARG)) continue;
    OPS(13 + C_LUM_CLAMP + 3);
    float inv_d2 = 1.0f / nmax(dist_sq, F(1e-6));
    float w = cos_s * cos_l * inv_d2 * nmin(inv_pdf, F(1e6));
    V contrib = muls(mul(albedo, mk(mt[8], mt[9], mt[10])), w * F(1.0 / 3.14159265359));
    total = add(total, luminance_clamp(contrib));
  }
  OPS(3);
  if (window) {
    OPS(3);
    total = muls(total, F((double)count / MAX_LIGHTS));
  }
  return muls(total, F(1.0 / count));
}

// ---- fog (ops/fog.py) ----
__device__ __forceinline__ float hash31(V p OPS_PARAM) {
  float qx = p.x * F(127.1) + p.y * F(311.7) + p.z * F(74.7);
  float qy = p.x * F(269.5) + p.y * F(183.3) + p.z * F(246.1);
  float qz = p.x * F(113.5) + p.y * F(271.9) + p.z * F(124.6);
  float q = qx + qy + qz;
  SIN_ARG(q);
  float s = sinf(q) * F(43758.5453);
  return s - floorf(s);
}

struct Fog {
  float sigma_s, sigma_a, hetero, k, octaves, noise_scale, g;
};

__device__ Fog fog_params(const float* fb) {
  Fog f;
  float base_s = nmax(fb[8], 0.0f), base_a = nmax(fb[9], 0.0f);
  float density = fb[0];
  float scatter = clampf(fb[1], 0.0f, 1.0f);
  if (base_s <= 0.0f && base_a <= 0.0f && density > 0.0f) {
    f.sigma_s = density * scatter;
    f.sigma_a = nmax(density - f.sigma_s, 0.0f);
  } else {
    f.sigma_s = base_s;
    f.sigma_a = base_a;
  }
  if (f.sigma_s + f.sigma_a <= 0.0f) f.sigma_s = f.sigma_a = 0.0f;
  f.hetero = fb[11];
  f.k = clampf(f.hetero, 0.0f, 1.0f);
  f.octaves = clampf(fb[13], 1.0f, 5.0f);
  f.noise_scale = fb[12];
  f.g = fb[10];
  return f;
}

__device__ float volume_noise(V p, const Fog& f OPS_PARAM) {
  float amp = 1.0f, freq = f.noise_scale, total = 0.0f, norm = 0.0f;
  for (int i = 0; i < 5; ++i) {
    OPS(2);
    if ((float)i < f.octaves) {
      OPS(3 + C_HASH31 + 3);
      total = total + hash31(muls(p, freq) OPS_ARG) * amp;
      norm = norm + amp;
    }
    amp = amp * 0.5f;
    freq = freq * 2.0f;
  }
  OPS(2);
  return norm > 0.0f ? total / nmax(norm, F(1e-20)) : 1.0f;
}

__device__ __forceinline__ float phase_hg(float cos_theta, float g) {
  float gg = g * g;
  float denom = (1.0f + gg) - (2.0f * g) * cos_theta;
  return (1.0f - gg) / (4.0f * F(3.14159265359) * denom * sqrtf(nmax(denom, F(1e-6))));
}

// ---- the shadow cull of the fog march ----
// A float's bits mapped to an unsigned key that orders as the floats do
// (NaN keys sort beyond the infinities), and back.
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// whether the box c +- h, which lies in the ball (c, rad), may touch the
// hull of ball (c1, r1) and ball (c2, r2) grown by eps: the hull lies in
// the capsule of radius max(r1, r2) around segment c1-c2 and in the box of
// both balls
__device__ __forceinline__ bool hull_may_touch(V c, V h, float rad, V c1, float r1, V c2, float r2, float eps) {
  const V lo = sub(c, h), hi = add(c, h);
  const V hlo = mk(nmin(c1.x - r1, c2.x - r2) - eps, nmin(c1.y - r1, c2.y - r2) - eps,
                   nmin(c1.z - r1, c2.z - r2) - eps);
  const V hhi = mk(nmax(c1.x + r1, c2.x + r2) + eps, nmax(c1.y + r1, c2.y + r2) + eps,
                   nmax(c1.z + r1, c2.z + r2) + eps);
  if (hi.x < hlo.x || lo.x > hhi.x || hi.y < hlo.y || lo.y > hhi.y || hi.z < hlo.z || lo.z > hhi.z) return false;
  // the ball against the capsule
  const V v = sub(c2, c1), w = sub(c, c1);
  const float vv = dot(v, v);
  const float u = vv > 0.0f ? clampf(dot(w, v) / vv, 0.0f, 1.0f) : 0.0f;
  const V q = sub(w, muls(v, u));
  const float reach = rad + nmax(r1, r2) + eps;
  return !(dot(q, q) > reach * reach);
}

// the box of the march positions of the lanes `mask` of a warp (all of
// which run this together), its ball and the scale of its coordinates
struct PosBox {
  unsigned mask;
  V c;
  float r, ext;
};

__device__ __forceinline__ PosBox pos_box(V pos, unsigned mask) {
  const V lo = mk(key_float(__reduce_min_sync(mask, float_key(pos.x))),
                  key_float(__reduce_min_sync(mask, float_key(pos.y))),
                  key_float(__reduce_min_sync(mask, float_key(pos.z))));
  const V hi = mk(key_float(__reduce_max_sync(mask, float_key(pos.x))),
                  key_float(__reduce_max_sync(mask, float_key(pos.y))),
                  key_float(__reduce_max_sync(mask, float_key(pos.z))));
  const V e = muls(sub(hi, lo), 0.5f);
  PosBox b;
  b.mask = mask;
  b.c = muls(add(lo, hi), 0.5f);
  b.r = sqrtf(dot(e, e));
  b.ext = nmax(max_comp(mk(fabsf(lo.x), fabsf(lo.y), fabsf(lo.z))), max_comp(mk(fabsf(hi.x), fabsf(hi.y), fabsf(hi.z))));
  return b;
}

// The primitives that a shadow ray of the warp toward the sphere light (lc,
// lr), light number `light`, could hit, for the fog march (bit m: object
// m < 31; bit 31: the mesh).  It is exact: it leaves out only primitives
// that cannot report a hit for any ray of the warp, rounding included
// (u = 2^-24; --fmad=false, so each operation rounds once):
// - the rays.  Every lane that runs this together marches toward the same
//   light (checked; lanes of several lights cull nothing) from a position
//   in pb (the box of the positions of the lanes that made it together at
//   this step, checked, or else made again over these lanes).  A ray's end
//   o + t_max d lies within a few u of its coordinates of the segment from
//   o to its point on the light's sphere, so every ray lies in the hull H
//   of pb's ball and the light's ball, up to those few u.
// - a plane or a box reports a hit only at a t within a few u (relative) of
//   a t at which the exact ray meets its faces moved by a few u of their
//   coordinates: within a few u of the coordinates of H.
// - a sphere's disc cancels: half_b^2 - a (|oc|^2 - r^2) is off by at most
//   some 20u a (|oc|^2 + r^2), so the point o + t d of a reported hit lies
//   within R = sqrt(r^2 + CULL_SPHERE_ERR (D^2 + r^2)) of the centre, D the
//   largest |oc| of the warp (from pb's ball; no square root: D^2 <=
//   2 |c - pb.c|^2 + 2 pb.r^2).  2^-16 is 256u; a test holds the
//   plain sphere test's hits (the same float32 arithmetic) from D up to
//   5,000 to 16u (tests/test_torch_render.py).
// - the mesh: a triangle's computed hit has no such bound (its
//   barycentrics' error grows as 1 / det for a grazing ray), but the walk
//   tests no triangle of a ray that misses the root node's box, and that
//   slab test takes the whole forward ray, with the rounding of a box's.
//   Where the balls lie apart along the axis a from pb's centre to the
//   light's, every ray's part beyond its light point lies in the
//   half-space (x - lc).a >= -lr; so the mesh is left out where its root
//   box lies farther than eps from H and wholly below -lr - eps along a.
// A primitive is kept where its box (a sphere's ball grown to R) lies
// within eps of H, eps = 1e-2 + 1e-4 S, S the largest magnitude among the
// positions, the light and the primitive's own coordinates: some 1,700u S,
// far above the few u of the terms above and of this function's own
// arithmetic.  The lanes share out the primitives (each tests every n-th),
// and the warp ORs their bits.  Above 31 objects, where a coordinate is
// not finite, and for the paged walk, nothing is left out.
constexpr float CULL_SPHERE_ERR = 1.52587890625e-5f;  // 2^-16

__device__ __forceinline__ uint32_t shadow_cull(const Scene& S, V pos, PosBox pb, int light, V lc, float lr
                                                OPS_PARAM) {
  const unsigned m = __activemask();
  if (!__all_sync(m, __shfl_sync(m, light, __ffs(m) - 1) == light)) return ~0u;
  if (!__all_sync(m, (m & ~pb.mask) == 0u)) pb = pos_box(pos, m);
  lr = fabsf(lr);
  const float ext = nmax(pb.ext, max_comp(mk(fabsf(lc.x), fabsf(lc.y), fabsf(lc.z))) + lr);
  if (S.n_obj > 31 || !isfinite(ext)) return ~0u;
  const int rank = __popc(m & ((1u << (threadIdx.x & 31)) - 1u)), lanes = __popc(m);
  uint32_t bits = 0u;
  for (int k = rank; k < 32; k += lanes) {
    bool keep = false;
    if (k < S.n_obj) {
      const float* ob = S.obj + k * OBJ_STRIDE;
      const int typ = (int)ob[0];
      const V c = mk(ob[4], ob[5], ob[6]);
      if (typ == OBJ_PLANE) {  // the plane y = c.y (object_t reads nothing else) against H's span in y
        const float eps = F(1e-2) + F(1e-4) * nmax(ext, fabsf(c.y));
        keep = !(c.y < nmin(pb.c.y - pb.r, lc.y - lr) - eps || c.y > nmax(pb.c.y + pb.r, lc.y + lr) + eps);
      } else {
        V h;
        float rad;
        if (typ == OBJ_SPHERE) {  // the ball grown to R, D^2 <= 2 |c - pb.c|^2 + 2 pb.r^2
          const float r = fabsf(ob[8]);
          const V w = sub(c, pb.c);
          rad = sqrtf(r * r + CULL_SPHERE_ERR * (2.0f * dot(w, w) + 2.0f * pb.r * pb.r + r * r));
          h = mk(rad, rad, rad);
        } else {
          h = mk(fabsf(ob[8] * 0.5f), fabsf(ob[9] * 0.5f), fabsf(ob[10] * 0.5f));
          rad = sqrtf(dot(h, h));
        }
        const float scale = max_comp(mk(fabsf(c.x), fabsf(c.y), fabsf(c.z))) + max_comp(h);
        const float eps = F(1e-2) + F(1e-4) * nmax(ext, scale);
        keep = hull_may_touch(c, h, rad, pb.c, pb.r, lc, lr, eps);
      }
      OPS(C_CULL);
    } else if (k == 31 && S.n_nodes > 0) {  // the root node's box
      const V lo = mk(S.bounds[0], S.bounds[1], S.bounds[2]), hi = mk(S.bounds[3], S.bounds[4], S.bounds[5]);
      const V c = muls(add(lo, hi), 0.5f), h = muls(sub(hi, lo), 0.5f);
      const float scale = max_comp(mk(fabsf(c.x), fabsf(c.y), fabsf(c.z))) + max_comp(h);
      const float eps = F(1e-2) + F(1e-4) * nmax(ext, scale);
      // apart: |axis| > lr + pb.r + eps; below: the box's reach along the
      // axis, times |axis|, under -(lr + eps) |axis| (both squared)
      const V axis = sub(lc, pb.c);
      const float ll = dot(axis, axis), apart = lr + pb.r + eps, below = lr + eps;
      const float ahead = dot(sub(c, lc), axis) + fabsf(axis.x) * h.x + fabsf(axis.y) * h.y + fabsf(axis.z) * h.z;
      keep = !(ll > apart * apart && ahead < 0.0f && ahead * ahead > below * below * ll) ||
             hull_may_touch(c, h, sqrtf(dot(h, h)), pb.c, pb.r, lc, lr, eps);
      OPS(C_CULL);
    }
    bits |= (uint32_t)keep << k;
  }
  return __reduce_or_sync(m, bits);
}

// estimateVolumeLight (ops/fog.py); every light of the list, 2 draws each
template <bool PAGED>
__device__ V volume_light(const Scene& S, V pos, const PosBox& pb, V view, float g, uint32_t& st OPS_PARAM) {
  V out = mk(0.0f, 0.0f, 0.0f);
  const float PI4 = 4.0f * F(3.14159265359);
  for (int i = 0; i < S.n_lights; ++i) {
    float u1 = next_u(st), u2 = next_u(st);
    OPS(2 * C_DRAW);
    RNG(2);
    const float* ob = S.obj + S.lights[i] * OBJ_STRIDE;
    if ((int)ob[0] != OBJ_SPHERE) continue;
    const float* mt = S.mat + (int)ob[1] * MAT_STRIDE;
    float radius = ob[8];
    V ln = sphere_surface(u1, u2);
    OPS(C_SPHERE_SURF + 6 + 4 + 3 + C_DOT + 2 + 1 + 3 + 7);
    V lp = mk(ob[4] + radius * ln.x, ob[5] + radius * ln.y, ob[6] + radius * ln.z);
    float inv_pdf = nmin(nmax(PI4 * radius * radius, F(1e-20)), F(1e6));
    V to_l = sub(lp, pos);
    float dist_sq = dot(to_l, to_l);
    bool valid = dist_sq > F(1e-6);
    float dist = sqrtf(nmax(dist_sq, F(1e-20)));
    V wi = muls(to_l, 1.0f / dist);
    float cos_l = nmax(-dot(ln, wi), 0.0f);
    valid = valid && cos_l > 0.0f;
    SHADOW_BEGIN(valid);
    const uint32_t cull = shadow_cull(S, pos, pb, i, mk(ob[4], ob[5], ob[6]), radius OPS_ARG);
    bool blocked = false;
    if (valid) {
      OPS(1);
      blocked = occluded<PAGED, true>(S, pos, wi, dist - F(0.002), cull OPS_ARG);
    }
    SHADOW_END(blocked);
    if (!valid || blocked) continue;
    OPS(C_DOT + C_PHASE + 2 + 2 + 6);
    float phase = phase_hg(-dot(wi, view), g);
    float geom = cos_l / nmax(dist_sq, F(1e-6));
    float w = geom * phase * inv_pdf;
    out = add(out, mk(mt[8] * w, mt[9] * w, mt[10] * w));
  }
  OPS(3 + C_LUM_CLAMP);
  out = luminance_clamp(muls(out, 2.0f));
  return S.fog[1] > 0.0f ? out : mk(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void camera_ray(const Scene& S, float u, float v, bool aperture, bool disk,
                                           uint32_t& st, V& o, V& d OPS_PARAM) {
  const float* b = S.basis;
  OPS(15 + (aperture ? 3 * C_DRAW + (disk ? C_UNIT_DISK : C_UNIT_BALL) + 3 + 9 + 3 + 3 + C_NORMALIZE
                     : C_NORMALIZE));
  float dx = b[3] + u * b[6] + v * b[9] - b[0];
  float dy = b[4] + u * b[7] + v * b[10] - b[1];
  float dz = b[5] + u * b[8] + v * b[11] - b[2];
  if (aperture) {
    float u1 = next_u(st), u2 = next_u(st), u3 = next_u(st);
    RNG(3);
    V rd = muls(disk ? unit_disk(u1, u2) : unit_ball(u1, u2, u3), b[18]);
    float offx = rd.x * b[12] + rd.y * b[15];
    float offy = rd.x * b[13] + rd.y * b[16];
    float offz = rd.x * b[14] + rd.y * b[17];
    o = mk(b[0] + offx, b[1] + offy, b[2] + offz);
    d = normalize(mk(dx - offx, dy - offy, dz - offz));
  } else {
    o = mk(b[0], b[1], b[2]);
    d = normalize(mk(dx, dy, dz));
  }
}

__device__ V background(const Scene& S, V ud) {
  const float* sk = S.sky;
  if ((int)rintf(sk[0]) == 2) {
    float t = clampf((ud.y + 1.0f) * 0.5f, 0.0f, 1.0f);
    float om = 1.0f - t;
    return mk(sk[8] * om + sk[12] * t, sk[9] * om + sk[13] * t, sk[10] * om + sk[14] * t);
  }
  return mk(sk[4], sk[5], sk[6]);
}

struct Params {
  int n_mat, n_obj, n_lights, n_tri_rows, n_nodes, n_pages, n_sub;
  int n_lanes;
  uint32_t frame_seed;
  int width, height, n_strata, samples, n_passes, max_depth, rr_threshold, flags;
};
// the device tables of one launch, as ops/cuda_trace.py passes them
struct Tables {
  const float *mat, *obj, *sky, *fog, *tri, *bounds, *basis, *tiles, *boxes;
  const int *lights, *topo;
};

// dynamic shared memory that load_scene() fills
inline size_t scene_smem_bytes(const Params& P) {
  return sizeof(float) * (size_t)(P.n_mat * MAT_STRIDE + P.n_obj * OBJ_STRIDE + 32 + BASIS_LEN +
                                  P.n_tri_rows * TRI_STRIDE + P.n_nodes * 6 + P.n_pages * P.n_sub * 6) +
         sizeof(int) * (size_t)(P.n_lights + 3 * P.n_nodes);
}

// copy the scene tables into shared memory, every thread of the block taking
// part, and return the Scene that reads them there (page tiles stay in
// device memory)
__device__ __forceinline__ Scene load_scene(const Tables& T, const Params& P, float* smem) {
  float* s_mat = smem;
  float* s_obj = s_mat + P.n_mat * MAT_STRIDE;
  float* s_sky = s_obj + P.n_obj * OBJ_STRIDE;
  float* s_fog = s_sky + 16;
  float* s_basis = s_fog + 16;
  float* s_tri = s_basis + BASIS_LEN;
  float* s_bounds = s_tri + P.n_tri_rows * TRI_STRIDE;
  float* s_boxes = s_bounds + P.n_nodes * 6;
  int* s_lights = (int*)(s_boxes + P.n_pages * P.n_sub * 6);
  int* s_topo = s_lights + P.n_lights;
  for (int i = threadIdx.x; i < P.n_mat * MAT_STRIDE; i += blockDim.x) s_mat[i] = T.mat[i];
  for (int i = threadIdx.x; i < P.n_obj * OBJ_STRIDE; i += blockDim.x) s_obj[i] = T.obj[i];
  for (int i = threadIdx.x; i < 16; i += blockDim.x) { s_sky[i] = T.sky[i]; s_fog[i] = T.fog[i]; }
  for (int i = threadIdx.x; i < BASIS_LEN; i += blockDim.x) s_basis[i] = T.basis[i];
  for (int i = threadIdx.x; i < P.n_tri_rows * TRI_STRIDE; i += blockDim.x) s_tri[i] = T.tri[i];
  for (int i = threadIdx.x; i < P.n_nodes * 6; i += blockDim.x) s_bounds[i] = T.bounds[i];
  for (int i = threadIdx.x; i < P.n_pages * P.n_sub * 6; i += blockDim.x) s_boxes[i] = T.boxes[i];
  for (int i = threadIdx.x; i < P.n_lights; i += blockDim.x) s_lights[i] = T.lights[i];
  for (int i = threadIdx.x; i < 3 * P.n_nodes; i += blockDim.x) s_topo[i] = T.topo[i];
  __syncthreads();

  Scene S;
  S.mat = s_mat; S.obj = s_obj; S.sky = s_sky; S.fog = s_fog; S.basis = s_basis;
  S.tri = s_tri; S.bounds = s_bounds; S.lights = s_lights; S.topo = s_topo;
  S.n_obj = P.n_obj; S.n_lights = P.n_lights; S.n_nodes = P.n_nodes;
  S.pages.tiles = T.tiles; S.pages.boxes = s_boxes; S.pages.n_pages = P.n_pages; S.pages.n_sub = P.n_sub;
  S.tri_emissive = P.flags & FLAG_TRI_EMISSIVE;
  return S;
}

// draws of one gpu-contract surface interaction (integrator.py::_shade_gpu):
// 2 Lambert, then NEE (2 per light, or 1 + 2 * 8 for the window above 8
// lights), 2 GGX with rough metal, 1 Fresnel with glass
inline __host__ __device__ int nee_draws_of(int flags, int n_lights) {
  return (flags & FLAG_NEE) && n_lights > 0 ? (n_lights > MAX_LIGHTS ? 1 + 2 * MAX_LIGHTS : 2 * n_lights) : 0;
}
inline __host__ __device__ int shade_draws_of(int flags, int n_lights) {
  return 2 + nee_draws_of(flags, n_lights) + ((flags & FLAG_ROUGH_METAL) ? 2 : 0) + ((flags & FLAG_DIELECTRIC) ? 1 : 0);
}

// what one launch's gpu-contract bounces take from the flags and the scene
struct Shading {
  bool nee, rough_metal, dielectric, sky_fog;
  int nee_draws, shade_draws;
};

__device__ __forceinline__ Shading make_shading(const Scene& S, const Params& P) {
  Shading D;
  D.nee = (P.flags & FLAG_NEE) && P.n_lights > 0;
  D.rough_metal = P.flags & FLAG_ROUGH_METAL;
  D.dielectric = P.flags & FLAG_DIELECTRIC;
  D.sky_fog = S.fog[0] > 0.0f && S.fog[2] > 0.5f;
  D.nee_draws = nee_draws_of(P.flags, P.n_lights);
  D.shade_draws = shade_draws_of(P.flags, P.n_lights);
  return D;
}

constexpr int FOG_STEPS = 24;

// single-scatter march along a ray through the medium fp (integrator.py::
// _fog_prepass, gpu.go:1311-1341): FOG_STEPS fixed steps to min(first hit,
// 40), each estimating the in-fog light; 2 draws per light and step from st
template <bool PAGED>
__device__ __forceinline__ V fog_march(const Scene& S, const Fog& fp, V o, V d, uint32_t& st OPS_PARAM) {
  WSTAGE_BEGIN(hit_t0);
  Hit h = intersect<PAGED>(S, o, d, -1, false, true OPS_ARG);
  WSTAGE_END(hit_t0, STAGE_MHIT);
  float t_max = nmin(h.hit ? h.t : F(40.0), F(40.0));
  float step = t_max * F(1.0 / FOG_STEPS);
  V rad = mk(0.0f, 0.0f, 0.0f);
  for (int i = 0; i < FOG_STEPS; ++i) {
    float t = ((float)i + 0.5f) * step;
    V pos = add(o, muls(d, t));
    OPS(2 + 6 + 5 + 3 + 3 + 2 + 9);
    WSTAGE_BEGIN(noise_t0);
    float n = volume_noise(pos, fp OPS_ARG);
    WSTAGE_END(noise_t0, STAGE_MNOISE);
    float scale = fp.hetero > 0.0f ? (1.0f - fp.k) * (1.0f - n) + (1.0f + fp.k) * n : 1.0f;
    float sigma_s = fp.sigma_s * scale, sigma_a = fp.sigma_a * scale;
    float sigma_t = sigma_s + sigma_a;
    float tr = expf(-sigma_t * t);
    WSTAGE_BEGIN(light_t0);
    const PosBox pb = pos_box(pos, __activemask());
    V ls = volume_light<PAGED>(S, pos, pb, d, fp.g, st OPS_ARG);
    WSTAGE_END(light_t0, STAGE_MLIGHT);
    float w = sigma_s * tr * step;
    if (sigma_t > 0.0f && sigma_s > 0.0f && step > 0.0f)
      rad = add(rad, mk(S.fog[4] * ls.x * w, S.fog[5] * ls.y * w, S.fog[6] * ls.z * w));
  }
  MARCH_DONE();
  return rad;
}

// one bounce of the gpu contract at path depth dep (integrator.py::_bounce_gpu):
// closest hit, sky on a miss, shading with NEE, the glass state, russian
// roulette; every lane draws D.shade_draws + 1 uniforms, whatever it does
// (PHYSICS.md D7).  Returns whether the path goes on (a path also ends where
// depth dep + 1 reaches max_depth); the ray and throughput then move on.
// DROP: the instance that reads PATHTRACER_BVH_DROP's flags (a paged launch
// whose flags carry one); the others hold the walks alone.
template <bool PAGED, bool DROP = false>
__device__ __forceinline__ bool gpu_bounce(const Scene& S, const Params& P, const Shading& D, int dep, V& orig,
                                           V& dir, V& thr, V& col, uint32_t& st, int& glass_obj,
                                           float& glass_dist OPS_PARAM) {
  STAGE_BEGIN(isect_t0);
  Hit h = intersect<PAGED, DROP>(S, orig, dir, D.dielectric ? glass_obj : -1, false, !(P.flags & FLAG_DROP_CLOSEST)
                                 OPS_ARG);
  STAGE_END(isect_t0, STAGE_ISECT);
  if (!h.hit) {
    OPS(C_NORMALIZE + C_BACKGROUND + 6 + (D.sky_fog ? 11 : 0));
    V bg = background(S, normalize(dir));
    if (D.sky_fog) {
      float att = expf(-S.fog[0] * 50.0f);
      float om = 1.0f - att;
      bg = mk(bg.x * att + S.fog[4] * om, bg.y * att + S.fog[5] * om, bg.z * att + S.fog[6] * om);
    }
    col = add(col, mul(thr, bg));
    skip_u(st, D.shade_draws + 1);
    RNG(D.shade_draws + 1);
    return false;
  }

  // ---- shade (integrator.py::_shade_gpu)
  const float* mt = S.mat + h.mat_idx * MAT_STRIDE;
  const int typ = h.mtyp;
  const bool is_lambert = typ == MAT_LAMBERT, is_metal = typ == MAT_METAL;
  const bool is_mirror = typ == MAT_MIRROR, is_diel = typ == MAT_DIELECTRIC;
  const bool is_emissive = typ == MAT_EMISSIVE;
  const V n = h.normal, p = h.p;
  const V albedo = mk(mt[4], mt[5], mt[6]);
  const V view = normalize(dir);

  if (is_emissive) col = add(col, mul(thr, mk(mt[8], mt[9], mt[10])));

  float lu1 = next_u(st), lu2 = next_u(st);
  RNG(2);
  OPS(C_NORMALIZE + (is_emissive ? 6 : 0) + 2 * C_DRAW + (is_lambert ? C_COSINE_DIR + 6 : 0) + 1 +
      C_REFLECT + 7 + 6 + 5 + 3 + 3 + 3 + 9);
  V lambert_dir = is_lambert ? cosine_direction(n, lu1, lu2) : n;

  const float smooth = mt[3];
  const float metal_rough = smooth > 0.0f ? 1.0f - smooth : mt[1];
  const float eff_refl = mt[7] > 0.0f ? mt[7] : 1.0f;
  const bool is_rough_metal = is_metal && metal_rough > F(1e-4);

  V direct = mk(0.0f, 0.0f, 0.0f);
  if (D.nee) {
    if (WALK_ALL_OR(is_lambert || is_rough_metal)) {
      NEE_ENTRY();
      STAGE_BEGIN(nee_t0);
      direct = direct_light<PAGED, DROP>(S, p, n, albedo, st, !(P.flags & FLAG_DROP_SHADOW) OPS_ARG);
      STAGE_END(nee_t0, STAGE_NEE);
    } else {
      skip_u(st, D.nee_draws);
      RNG(D.nee_draws);
    }
  }
  if (is_lambert) col = add(col, mul(thr, direct));

  V mirror_dir = reflect(view, n);
  V metal_dir = mirror_dir;
  if (D.rough_metal) {
    float gu1 = next_u(st), gu2 = next_u(st);
    RNG(2);
    OPS(2 * C_DRAW + (is_rough_metal ? C_GGX + 11 : 0));
    if (is_rough_metal) metal_dir = sample_ggx(view, n, metal_rough, gu1, gu2);
  }
  const float mr2 = metal_rough * metal_rough;
  const float spec_w = clampf(1.0f / (1.0f + mr2 * 2.0f), F(0.1), F(0.9));
  const float diff_w = 1.0f - spec_w;
  if (is_rough_metal) col = add(col, muls(mul(thr, direct), diff_w * eff_refl * 0.5f));
  V atten_metal = is_rough_metal ? muls(albedo, spec_w * eff_refl + diff_w * F(0.3)) : muls(albedo, eff_refl);
  const bool metal_dead = (is_metal || is_mirror) && dot(metal_dir, n) <= F(1e-6);

  if (D.rough_metal && D.nee && WALK_ALL_OR(is_rough_metal && !metal_dead)) {
    OPS(6);
    STAGE_BEGIN(lite_t0);
    Hit r = intersect<PAGED, DROP>(S, add(p, muls(n, F(0.001))), mirror_dir, -1, true, !(P.flags & FLAG_DROP_SPEC)
                                   OPS_ARG);
    STAGE_END(lite_t0, STAGE_LITE);
    if (r.hit && r.mtyp == MAT_EMISSIVE WALK_ALL_AND(is_rough_metal && !metal_dead)) {
      OPS(24);
      const float* rm = S.mat + r.mat_idx * MAT_STRIDE;
      float dist_sq = nmax(r.t * r.t, F(1e-20));
      float cos_l = nmax(-dot(r.normal, mirror_dir), 0.0f);
      V dr = muls(mk(rm[8], rm[9], rm[10]), cos_l / dist_sq);
      col = add(col, muls(mul(mul(thr, dr), albedo), 0.5f));
    }
  }

  bool enter_glass = false, exit_glass = false;
  float travel = 0.0f;
  V atten_diel = mk(1.0f, 1.0f, 1.0f), diel_dir = mirror_dir;
  const V tint = mk(mt[16], mt[17], mt[18]);
  const V tint_mul = any_positive(tint) ? tint : mk(1.0f, 1.0f, 1.0f);
  const V eff_abs = muls(mk(mt[12], mt[13], mt[14]), mt[15]);
  if (D.dielectric) {
    float u_fresnel = next_u(st);
    RNG(1);
    OPS(C_DRAW);
    if (is_diel) {
      OPS(6 + 4 + 2 + 1 + C_SCHLICK + 1 + C_REFRACT + C_NORMALIZE);
      const float ior = mt[2];
      float cos_t = nmin(-dot(view, n), 1.0f);
      float sin_t = sqrtf(nmax(1.0f - cos_t * cos_t, 0.0f));
      bool entering = h.front_face;
      float inv_ior = 1.0f / nmax(ior, F(1e-6));
      float eta = entering ? inv_ior : ior;
      float rel_ior = entering ? ior : inv_ior;
      bool tir = eta * sin_t > 1.0f;
      float rp = schlick(cos_t, rel_ior);
      if (!entering) rp = nmax(rp, F(0.05));
      bool do_reflect = tir || (u_fresnel < rp);
      diel_dir = normalize(do_reflect ? reflect(view, n) : refract(view, n, eta));
      enter_glass = !do_reflect && entering;
      exit_glass = !do_reflect && !entering;
      if (enter_glass) {
        const float* ob = S.obj + h.obj_idx * OBJ_STRIDE;
        V eo = add(p, muls(diel_dir, F(0.001)));
        OPS(h.obj_type == OBJ_BOX ? 41 : (h.obj_type == OBJ_SPHERE ? 26 : 6));
        if (h.obj_type == OBJ_BOX) {
          V c = mk(ob[4], ob[5], ob[6]);
          V half = muls(mk(ob[8], ob[9], ob[10]), 0.5f);
          V bmin = sub(c, half), bmax = add(c, half);
          float ix = 1.0f / diel_dir.x, iy = 1.0f / diel_dir.y, iz = 1.0f / diel_dir.z;
          float nx0 = (bmin.x - eo.x) * ix, fx0 = (bmax.x - eo.x) * ix;
          float ny0 = (bmin.y - eo.y) * iy, fy0 = (bmax.y - eo.y) * iy;
          float nz0 = (bmin.z - eo.z) * iz, fz0 = (bmax.z - eo.z) * iz;
          float t0 = nmax(nmax(nmin(nx0, fx0), nmin(ny0, fy0)), nmax(nmin(nz0, fz0), F(0.001)));
          float t1 = nmin(nmin(nmax(nx0, fx0), nmax(ny0, fy0)), nmax(nz0, fz0));
          if (t1 > t0 && t1 >= F(0.001)) travel = t1;
        } else if (h.obj_type == OBJ_SPHERE) {
          V oc = sub(eo, mk(ob[4], ob[5], ob[6]));
          float half_b = dot(oc, diel_dir);
          float c = dot(oc, oc) - ob[8] * ob[8];
          float disc = half_b * half_b - c;
          float exit_t = -half_b + sqrtf(nmax(disc, 0.0f));
          if (disc > 0.0f && exit_t > F(0.001)) travel = exit_t;
        }
        if (travel > 0.0f) {
          OPS(15);
          V ab = mul(eff_abs, mk(travel, travel, travel));
          V absorb = mk(expf(-ab.x), expf(-ab.y), expf(-ab.z));
          atten_diel = mul(add(muls(absorb, F(0.9)), mk(F(0.1), F(0.1), F(0.1))), tint_mul);
        }
      }
    }
  }

  V new_dir = is_lambert ? lambert_dir : (is_diel ? diel_dir : metal_dir);
  V att = is_lambert ? albedo : (is_diel ? atten_diel : ((is_metal || is_mirror) ? atten_metal : albedo));
  const bool scattered_ok = !(is_emissive || metal_dead);

  if (D.dielectric) {
    if (exit_glass && glass_dist > 0.0f) {
      OPS(18);
      V ab = mul(eff_abs, mk(glass_dist, glass_dist, glass_dist));
      V absorb = mk(expf(-ab.x), expf(-ab.y), expf(-ab.z));
      att = mul(att, mul(add(muls(absorb, F(0.9)), mk(F(0.1), F(0.1), F(0.1))), tint_mul));
    }
    if (enter_glass) {
      glass_obj = h.obj_idx;
      if (travel > 0.0f) glass_dist = travel;
    } else if (exit_glass) {
      glass_obj = -1;
      glass_dist = 0.0f;
    }
  }

  // russian roulette on per-lane remaining depth (gpu.go:1648-1660)
  const int remaining = P.max_depth - dep;
  float u_rr = next_u(st);
  RNG(1);
  float mc = max_comp(att);
  bool rr_active = remaining <= P.rr_threshold;
  float rr_prob = nmin(mc, F(0.95));
  bool rr_kill = rr_active && (mc < F(1e-6) || u_rr > rr_prob);
  if (rr_active && !rr_kill) att = muls(att, 1.0f / nmax(rr_prob, F(1e-6)));
  OPS(rr_active && !rr_kill ? 5 : 0);

  const bool alive = scattered_ok && !rr_kill && dep + 1 < P.max_depth;
  if (alive) {
    thr = mul(thr, att);
    orig = add(p, muls(n, F(0.001)));
    dir = new_dir;
  }
  return alive;
}

// add each lane's segments (and, in the counting build, its tallies) into
// counters: warp sums, one shared atomic per warp, one global atomic per
// block.  Every thread of the block calls it, after s_segs was zeroed.
__device__ __forceinline__ void add_counters(unsigned long long segs, unsigned long long* s_segs,
                                             unsigned long long* segs_out OPS_PARAM) {
#ifdef PT_COUNT_OPS
  const unsigned long long cycles = (unsigned long long)(clock64() - ops.t0);  // before this function's atomics
  // the segments the warp's loop ran for: its busiest thread's, per thread
  unsigned long long warp_segs = segs;
  for (int off = 16; off > 0; off >>= 1) warp_segs = max(warp_segs, __shfl_xor_sync(0xffffffffu, warp_segs, off));
  if ((threadIdx.x & 31) == 0 && warp_segs) atomicAdd(segs_out + 20, 32ull * warp_segs);
#endif
  for (int off = 16; off > 0; off >>= 1) segs += __shfl_down_sync(0xffffffffu, segs, off);
  if ((threadIdx.x & 31) == 0 && segs) atomicAdd(s_segs, segs);
#ifdef PT_COUNT_OPS
  // the warp tail: the warp's last segment end less the lane's own
  long long warp_end = ops.t_last;
  for (int off = 16; off > 0; off >>= 1) warp_end = max(warp_end, __shfl_xor_sync(0xffffffffu, warp_end, off));
  const unsigned long long tail = ops.t_last ? (unsigned long long)(warp_end - ops.t_last) : 0ull;
  // the classic loop's advance and camera-ray cycles into counters[18..19]
  for (int k = STAGE_ADVANCE; k <= STAGE_CAMERA; ++k) {
    unsigned long long c = ops.stage[k];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(segs_out + 18 + (k - STAGE_ADVANCE), c);
  }
  // the fog march's warp tail: the warp's last march end less the lane's own
  long long march_end = ops.t_march;
  for (int off = 16; off > 0; off >>= 1) march_end = max(march_end, __shfl_xor_sync(0xffffffffu, march_end, off));
  const unsigned long long march_tail = ops.t_march ? (unsigned long long)(march_end - ops.t_march) : 0ull;
  // the counting build adds the lane's counts into counters[1..13] and the
  // march's into [21..33]
  unsigned long long tally[26] = {ops.all, ops.walk, ops.walk_cycles, cycles,
                                  ops.stage[0], ops.stage[1], ops.stage[2], ops.stage[3], ops.stage[4],
                                  ops.nee_active, ops.nee_entries, tail, ops.rng,
                                  ops.stage[STAGE_MHIT], ops.stage[STAGE_MNOISE], ops.stage[STAGE_MLIGHT],
                                  ops.stage[STAGE_MSHADOW], ops.shadow_lanes, ops.shadow_active, ops.shadow_entries,
                                  ops.shadow_blocked, ops.prims, ops.nodes, ops.sin_calls, ops.sin_large, march_tail};
  for (int c = 0; c < 26; ++c) {
    for (int off = 16; off > 0; off >>= 1) tally[c] += __shfl_down_sync(0xffffffffu, tally[c], off);
    if ((threadIdx.x & 31) == 0 && tally[c]) atomicAdd(segs_out + (c < 13 ? 1 + c : 21 + (c - 13)), tally[c]);
  }
#endif
  __syncthreads();
  if (threadIdx.x == 0 && *s_segs) atomicAdd(segs_out, *s_segs);
#ifdef PT_COUNT_OPS
  if (threadIdx.x == 0) {
    const unsigned long long end = global_ns();
    atomicMax(segs_out + 14, ~ops.ns0);
    atomicMax(segs_out + 15, ~end);
    atomicMax(segs_out + 16, end);
    atomicMax(segs_out + 17, ops.ns0);
  }
#endif
}

// the shared memory of a launch: refused above one SM's 227 KB, opted into
// above 48 KB
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace

// the scene arguments that every entry point takes first, in this order
// (ops/cuda_trace.py::_scene_args), and their unpacking
#define PT_SCENE_PARAMS                                                                                     \
  const float *mat, int n_mat, const float *obj, int n_obj, const int *lights, int n_lights, const float *sky, \
      const float *fog, const float *tri, int n_tri_rows, const float *bounds, const int *topo, int n_nodes,  \
      const float *basis, const float *tiles, const float *boxes, int n_pages, int n_sub
#define PT_SCENE_UNPACK(T, P)                                                                               \
  Tables T = {mat, obj, sky, fog, tri, bounds, basis, tiles, boxes, lights, topo};                          \
  Params P = {};                                                                                            \
  P.n_mat = n_mat; P.n_obj = n_obj; P.n_lights = n_lights; P.n_tri_rows = n_tri_rows; P.n_nodes = n_nodes; \
  P.n_pages = n_pages; P.n_sub = n_sub

extern "C" const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
