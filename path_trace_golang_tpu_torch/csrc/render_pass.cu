// Whole progressive pass of the gpu physics contract, one thread per pixel lane.
//
// Replaces: path_trace_golang_tpu/ops/pallas_trace.py::render_pass_pallas
// (the Pallas kernel that runs render.pass_body_grid -> the fog-once march
// and integrator.pass_regen_gpu for a block of 32x128 lanes).
//
// What bounds it on an H100: f32 arithmetic outside the tensor cores
// (67 TFLOP/s at 700 W), not bytes.  Each lane reads two int32 pixel
// coordinates and writes three floats, while it runs tens to hundreds of
// thousands of float operations: ray-object tests, the BVH walk over the
// mesh (the node walk up to 128 triangles, the paged walk of
// paged_walk.cuh above), shadow rays for NEE, the fog march with its hash
// noise.
//
// What the design does about that: one thread owns one lane for the whole
// pass window, so the merged sample+bounce loop keeps its state in
// registers and never touches device memory between bounces; the scene
// tables (materials, objects, lights, mesh rows, BVH nodes, camera basis)
// are copied once per block into shared memory, where every thread reads
// them.  Work whose result a lane does not use is skipped (NEE for lanes
// that neither are Lambert nor rough metal, shadow rays whose cosine terms
// already rule them out, shading of missed rays), but every lane still
// advances its RNG state by exactly the draws that the JAX package and the
// plain PyTorch version make on that loop iteration (PHYSICS.md D7), so
// lanes agree one for one with them.  Tuning (occupancy, a wavefront split,
// warp-coherent scheduling) is later work.
//
// Floating point: built without --use_fast_math and with --fmad=false, so
// every add, multiply, divide and sqrt is one IEEE-rounded operation as in
// the plain version's separate tensor ops; min/max propagate NaN like
// torch.minimum/maximum; rintf rounds half to even like torch.round.
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
//        -Xcompiler -fPIC -o render_pass.so render_pass.cu
// and bound with ctypes through the plain C functions pt_render_pass() and
// pt_paged_walk() (the paged walk alone, one thread per given ray).
// ``segs`` points at five uint64 counters: [0] receives the traced segments;
// the -DPT_COUNT_OPS build also fills [1] the f32 operation count, [2] the
// part of it done inside the paged walk, [3] the clock cycles that lanes
// spent inside the paged walk and [4] the cycles they spent in all.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

// Operation counting build (-DPT_COUNT_OPS, used only to compute the
// kernel's bound): every f32 add, sub, mul, div, min, max, sqrt, int->float
// conversion and transcendental call that a lane executes adds 1, tallied
// per code block by hand; OPS_WALK does so for the paged walk and keeps the
// walk's own sum beside it, and WALK_CLOCK(call) adds the cycles of one call
// of the walk.  In the normal build these macros expand to nothing (or to
// the bare call) and the kernel's code is unchanged.
#ifdef PT_COUNT_OPS
struct OpsCount {
  unsigned long long all, walk, walk_cycles;
};
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
#else
#define OPS(n) ((void)0)
#define OPS_WALK(n) ((void)0)
#define OPS_PARAM
#define OPS_ARG
#define WALK_CLOCK(call) call
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
              FLAG_FOG_ONCE = 16, FLAG_NORMALIZE = 32, FLAG_NEE = 64, FLAG_TRI_EMISSIVE = 128;

#ifdef PT_COUNT_OPS
// per-call f32 operation counts of the fixed-cost helpers below
constexpr int C_DRAW = 3, C_NORMALIZE = 11, C_DOT = 5, C_REFLECT = 12;
constexpr int C_UNIT_BALL = 36, C_UNIT_DISK = 24, C_COSINE_DIR = 73, C_SPHERE_SURF = 29;
constexpr int C_GGX = 131, C_REFRACT = 34, C_SCHLICK = 12, C_LUM_CLAMP = 10, C_BACKGROUND = 14;
constexpr int C_HASH31 = 21, C_PHASE = 11, C_RAY_SETUP = 9, C_SPHERE = 24, C_PLANE = 2, C_BOX = 32;
constexpr int C_NODE = 23, C_TRI = 46;
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

// closest hit (ops/geometry.py::intersect_world); exclude < 0 = none.
// ``lite``: the caller acts only on an emissive winner and reads only hit,
// t, normal, mtyp and mat_idx of it (the specular-NEE ray).  On a paged
// mesh without emissive triangles the mesh can then only hide the object
// sweep's winner: a ray whose object winner is not emissive walks nothing,
// the others take the any-hit walk up to that winner's t, and a hidden or
// non-emissive winner comes back as no hit.
// PAGED is a template argument of the whole kernel: launches without pages
// run code that holds nothing of the paged walk, so the walk's registers
// and code do not weigh on scenes that have no large mesh.
template <bool PAGED>
__device__ Hit intersect(const Scene& S, V o, V d, int exclude, bool lite OPS_PARAM) {
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
    float cx = ob[4], cy = ob[5], cz = ob[6], sx = ob[8], sy = ob[9], sz = ob[10];
    float t;
    bool ok;
    OPS(typ == OBJ_SPHERE ? C_SPHERE : (typ == OBJ_PLANE ? C_PLANE : C_BOX));
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
  if constexpr (PAGED) {
    const V inv = mk(inv_dx, inv_dy, inv_dz);
    if (lite && !S.tri_emissive) {
      bool seen = obj_hit && (int)S.mat[(int)S.obj[best_obj * OBJ_STRIDE + 1] * MAT_STRIDE] == MAT_EMISSIVE;
      if (seen) WALK_CLOCK(seen = !paged_occluded(S.pages, o, d, inv, t_min, best_t OPS_ARG));
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
    } else {
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
  } else if (S.n_nodes > 0) {
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

// any hit before t_max (ops/geometry.py::occluded)
template <bool PAGED>
__device__ bool occluded(const Scene& S, V o, V d, float t_max OPS_PARAM) {
  const float t_min = F(0.001);
  float a = dot(d, d);
  float inv_a = 1.0f / a;
  float inv_dx = 1.0f / d.x, inv_dy = 1.0f / d.y, inv_dz = 1.0f / d.z;
  OPS(C_RAY_SETUP);
  for (int m = 0; m < S.n_obj; ++m) {
    const float* ob = S.obj + m * OBJ_STRIDE;
    int typ = (int)ob[0];
    float cx = ob[4], cy = ob[5], cz = ob[6], sx = ob[8], sy = ob[9], sz = ob[10];
    float t;
    bool ok;
    OPS(typ == OBJ_SPHERE ? C_SPHERE : (typ == OBJ_PLANE ? C_PLANE : C_BOX));
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
    if (ok && t <= t_max) return true;
  }
  if constexpr (PAGED) {
    bool blocked;
    WALK_CLOCK(blocked = paged_occluded(S.pages, o, d, mk(inv_dx, inv_dy, inv_dz), t_min, t_max OPS_ARG));
    return blocked;
  }
  int nd = 0;
  while (nd < S.n_nodes) {
    const float* bn = S.bounds + nd * 6;
    OPS(C_NODE);
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
template <bool PAGED>
__device__ V direct_light(const Scene& S, V p, V n, V albedo, uint32_t& st OPS_PARAM) {
  V total = mk(0.0f, 0.0f, 0.0f);
  const float PI4 = 4.0f * F(3.14159265359);
  const int count = S.n_lights;
  const bool window = count > MAX_LIGHTS;
  int start = 0;
  if (window) {
    float us = next_u(st);
    OPS(C_DRAW + 2);
    start = (int)(us * (float)count) % count;
  }
  const int n_slots = window ? MAX_LIGHTS : count;
  for (int j = 0; j < n_slots; ++j) {
    const int i = window ? (start + j) % count : j;
    float u1 = next_u(st), u2 = next_u(st);
    OPS(2 * C_DRAW);
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
    if (occluded<PAGED>(S, add(p, muls(n, F(0.001))), wi, dist - F(0.002) OPS_ARG)) continue;
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
__device__ __forceinline__ float hash31(V p) {
  float qx = p.x * F(127.1) + p.y * F(311.7) + p.z * F(74.7);
  float qy = p.x * F(269.5) + p.y * F(183.3) + p.z * F(246.1);
  float qz = p.x * F(113.5) + p.y * F(271.9) + p.z * F(124.6);
  float s = sinf(qx + qy + qz) * F(43758.5453);
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
      total = total + hash31(muls(p, freq)) * amp;
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

// estimateVolumeLight (ops/fog.py); every light of the list, 2 draws each
template <bool PAGED>
__device__ V volume_light(const Scene& S, V pos, V view, float g, uint32_t& st OPS_PARAM) {
  V out = mk(0.0f, 0.0f, 0.0f);
  const float PI4 = 4.0f * F(3.14159265359);
  for (int i = 0; i < S.n_lights; ++i) {
    float u1 = next_u(st), u2 = next_u(st);
    OPS(2 * C_DRAW);
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
    if (!valid) continue;
    OPS(1);
    if (occluded<PAGED>(S, pos, wi, dist - F(0.002) OPS_ARG)) continue;
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

template <bool PAGED>
__global__ void __launch_bounds__(BLOCK) render_pass_kernel(
    const float* __restrict__ g_mat, const float* __restrict__ g_obj, const int* __restrict__ g_lights,
    const float* __restrict__ g_sky, const float* __restrict__ g_fog, const float* __restrict__ g_tri,
    const float* __restrict__ g_bounds, const int* __restrict__ g_topo, const float* __restrict__ g_basis,
    const float* __restrict__ g_tiles, const float* __restrict__ g_boxes, const int* __restrict__ g_px, const int* __restrict__ g_py, Params P, float* __restrict__ out,
    unsigned long long* __restrict__ segs_out) {
  // ---- scene tables -> shared memory ----
  extern __shared__ float smem[];
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
  __shared__ unsigned long long s_segs;
  for (int i = threadIdx.x; i < P.n_mat * MAT_STRIDE; i += blockDim.x) s_mat[i] = g_mat[i];
  for (int i = threadIdx.x; i < P.n_obj * OBJ_STRIDE; i += blockDim.x) s_obj[i] = g_obj[i];
  for (int i = threadIdx.x; i < 16; i += blockDim.x) { s_sky[i] = g_sky[i]; s_fog[i] = g_fog[i]; }
  for (int i = threadIdx.x; i < BASIS_LEN; i += blockDim.x) s_basis[i] = g_basis[i];
  for (int i = threadIdx.x; i < P.n_tri_rows * TRI_STRIDE; i += blockDim.x) s_tri[i] = g_tri[i];
  for (int i = threadIdx.x; i < P.n_nodes * 6; i += blockDim.x) s_bounds[i] = g_bounds[i];
  for (int i = threadIdx.x; i < P.n_pages * P.n_sub * 6; i += blockDim.x) s_boxes[i] = g_boxes[i];
  for (int i = threadIdx.x; i < P.n_lights; i += blockDim.x) s_lights[i] = g_lights[i];
  for (int i = threadIdx.x; i < 3 * P.n_nodes; i += blockDim.x) s_topo[i] = g_topo[i];
  if (threadIdx.x == 0) s_segs = 0ull;
  __syncthreads();

  Scene S;
  S.mat = s_mat; S.obj = s_obj; S.sky = s_sky; S.fog = s_fog; S.basis = s_basis;
  S.tri = s_tri; S.bounds = s_bounds; S.lights = s_lights; S.topo = s_topo;
  S.n_obj = P.n_obj; S.n_lights = P.n_lights; S.n_nodes = P.n_nodes;
  S.pages.tiles = g_tiles; S.pages.boxes = s_boxes; S.pages.n_pages = P.n_pages; S.pages.n_sub = P.n_sub;
  S.tri_emissive = P.flags & FLAG_TRI_EMISSIVE;

  const bool aperture = P.flags & FLAG_APERTURE, disk = P.flags & FLAG_LENS_DISK;
  const bool rough_metal = P.flags & FLAG_ROUGH_METAL, dielectric = P.flags & FLAG_DIELECTRIC;
  const bool nee = (P.flags & FLAG_NEE) && P.n_lights > 0;

  unsigned long long segs = 0ull;
#ifdef PT_COUNT_OPS
  OpsCount ops = {0ull, 0ull, 0ull};
  const long long lane_t0 = clock64();
#endif
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n_lanes) {
    const uint32_t px = (uint32_t)g_px[lane], py = (uint32_t)g_py[lane];
    const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
    const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
    const float pxf = (float)(int)px;
    const float fy = (float)(P.height - 1) - (float)(int)py;
    const float inv_strata = F(1.0 / P.n_strata);
    const int total = P.samples * P.n_passes;
    // NEE draws: 2 per light, or 1 + 2 * 8 for the window above 8 lights
    const int nee_draws = !nee ? 0 : (P.n_lights > MAX_LIGHTS ? 1 + 2 * MAX_LIGHTS : 2 * P.n_lights);
    const int shade_draws = 2 + nee_draws + (rough_metal ? 2 : 0) + (dielectric ? 1 : 0);
    const bool sky_fog = S.fog[0] > 0.0f && S.fog[2] > 0.5f;

    V col = mk(0.0f, 0.0f, 0.0f);

    // ---- fog once per pass on its own counter stream (render.py:232-266)
    if (P.flags & FLAG_FOG_ONCE) {
      Fog fp = fog_params(S.fog);
      const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
      for (int p = 0; p < P.n_passes; ++p) {
        uint32_t fst = seed_lane(px, py, (P.frame_seed + (uint32_t)p) ^ 0x9E3779B9u);
        float jx = next_u(fst), jy = next_u(fst);
        OPS(2 * C_DRAW + 4 + 2 + 9);
        V o, d;
        camera_ray(S, (pxf + jx) * inv_w, (fy + jy) * inv_h, aperture, disk, fst, o, d OPS_ARG);
        Hit h = intersect<PAGED>(S, o, d, -1, false OPS_ARG);
        float t_max = nmin(h.hit ? h.t : F(40.0), F(40.0));
        float step = t_max * F(1.0 / 24.0);
        V rad = mk(0.0f, 0.0f, 0.0f);
        for (int i = 0; i < 24; ++i) {
          float t = ((float)i + 0.5f) * step;
          V pos = add(o, muls(d, t));
          OPS(2 + 6 + 5 + 3 + 3 + 2 + 9);
          float n = volume_noise(pos, fp OPS_ARG);
          float scale = fp.hetero > 0.0f ? (1.0f - fp.k) * (1.0f - n) + (1.0f + fp.k) * n : 1.0f;
          float sigma_s = fp.sigma_s * scale, sigma_a = fp.sigma_a * scale;
          float sigma_t = sigma_s + sigma_a;
          float tr = expf(-sigma_t * t);
          V ls = volume_light<PAGED>(S, pos, d, fp.g, fst OPS_ARG);
          float w = sigma_s * tr * step;
          if (sigma_t > 0.0f && sigma_s > 0.0f && step > 0.0f)
            rad = add(rad, mk(S.fog[4] * ls.x * w, S.fog[5] * ls.y * w, S.fog[6] * ls.z * w));
        }
        col = add(col, muls(muls(rad, gate), (float)P.samples));
      }
    }

    // ---- merged sample + bounce loop with regeneration (integrator.py:523-744)
    uint32_t st = seed_lane(px, py, P.frame_seed);
    int s = 0, dep = 0, glass_obj = -1;
    float glass_dist = 0.0f;
    bool alive = false;
    V orig = mk(0.0f, 0.0f, 0.0f), dir = orig, thr = mk(1.0f, 1.0f, 1.0f);
    while (alive || s < total) {
      const bool regen = !alive;
      int stratum = s;
      if (P.n_passes > 1) {
        int pidx = s / P.samples;
        stratum = s - pidx * P.samples;
        if (regen && s > 0 && stratum == 0) st = seed_lane(px, py, P.frame_seed + (uint32_t)pidx);
      }
      float jx = next_u(st), jy = next_u(st);
      OPS(2 * C_DRAW);
      if (regen) {
        OPS(10);
        float su = jx, sv = jy;
        if (P.n_strata > 1) {
          su = ((float)(stratum % P.n_strata) + jx) * inv_strata;
          sv = ((float)(stratum / P.n_strata) + jy) * inv_strata;
        }
        camera_ray(S, (pxf + su) * inv_w, (fy + sv) * inv_h, aperture, disk, st, orig, dir OPS_ARG);
        thr = mk(1.0f, 1.0f, 1.0f);
        dep = 0;
        glass_obj = -1;
        glass_dist = 0.0f;
        s += 1;
      } else if (aperture) {
        skip_u(st, 3);
      }
      alive = true;
      segs += 1;

      Hit h = intersect<PAGED>(S, orig, dir, dielectric ? glass_obj : -1, false OPS_ARG);
      if (!h.hit) {
        OPS(C_NORMALIZE + C_BACKGROUND + 6 + (sky_fog ? 11 : 0));
        V bg = background(S, normalize(dir));
        if (sky_fog) {
          float att = expf(-S.fog[0] * 50.0f);
          float om = 1.0f - att;
          bg = mk(bg.x * att + S.fog[4] * om, bg.y * att + S.fog[5] * om, bg.z * att + S.fog[6] * om);
        }
        col = add(col, mul(thr, bg));
        alive = false;
        skip_u(st, shade_draws + 1);
        continue;
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
      OPS(C_NORMALIZE + (is_emissive ? 6 : 0) + 2 * C_DRAW + (is_lambert ? C_COSINE_DIR + 6 : 0) + 1 +
          C_REFLECT + 7 + 6 + 5 + 3 + 3 + 3 + 9);
      V lambert_dir = is_lambert ? cosine_direction(n, lu1, lu2) : n;

      const float smooth = mt[3];
      const float metal_rough = smooth > 0.0f ? 1.0f - smooth : mt[1];
      const float eff_refl = mt[7] > 0.0f ? mt[7] : 1.0f;
      const bool is_rough_metal = is_metal && metal_rough > F(1e-4);

      V direct = mk(0.0f, 0.0f, 0.0f);
      if (nee) {
        if (is_lambert || is_rough_metal) direct = direct_light<PAGED>(S, p, n, albedo, st OPS_ARG);
        else skip_u(st, nee_draws);
      }
      if (is_lambert) col = add(col, mul(thr, direct));

      V mirror_dir = reflect(view, n);
      V metal_dir = mirror_dir;
      if (rough_metal) {
        float gu1 = next_u(st), gu2 = next_u(st);
        OPS(2 * C_DRAW + (is_rough_metal ? C_GGX + 11 : 0));
        if (is_rough_metal) metal_dir = sample_ggx(view, n, metal_rough, gu1, gu2);
      }
      const float mr2 = metal_rough * metal_rough;
      const float spec_w = clampf(1.0f / (1.0f + mr2 * 2.0f), F(0.1), F(0.9));
      const float diff_w = 1.0f - spec_w;
      if (is_rough_metal) col = add(col, muls(mul(thr, direct), diff_w * eff_refl * 0.5f));
      V atten_metal = is_rough_metal ? muls(albedo, spec_w * eff_refl + diff_w * F(0.3)) : muls(albedo, eff_refl);
      const bool metal_dead = (is_metal || is_mirror) && dot(metal_dir, n) <= F(1e-6);

      if (rough_metal && nee && is_rough_metal && !metal_dead) {
        OPS(6);
        Hit r = intersect<PAGED>(S, add(p, muls(n, F(0.001))), mirror_dir, -1, true OPS_ARG);
        if (r.hit && r.mtyp == MAT_EMISSIVE) {
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
      if (dielectric) {
        float u_fresnel = next_u(st);
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

      if (dielectric) {
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
      float mc = max_comp(att);
      bool rr_active = remaining <= P.rr_threshold;
      float rr_prob = nmin(mc, F(0.95));
      bool rr_kill = rr_active && (mc < F(1e-6) || u_rr > rr_prob);
      if (rr_active && !rr_kill) att = muls(att, 1.0f / nmax(rr_prob, F(1e-6)));
      OPS(rr_active && !rr_kill ? 5 : 0);

      dep += 1;
      alive = scattered_ok && !rr_kill && dep < P.max_depth;
      if (alive) {
        thr = mul(thr, att);
        orig = add(p, muls(n, F(0.001)));
        dir = new_dir;
      }
    }
    if (P.flags & FLAG_NORMALIZE) col = muls(col, F(1.0 / P.samples));
    out[lane] = col.x;
    out[P.n_lanes + lane] = col.y;
    out[2 * P.n_lanes + lane] = col.z;
  }

  // ---- segment count: block reduction, one atomic per block
  for (int off = 16; off > 0; off >>= 1) segs += __shfl_down_sync(0xffffffffu, segs, off);
  if ((threadIdx.x & 31) == 0 && segs) atomicAdd(&s_segs, segs);
#ifdef PT_COUNT_OPS
  // the counting build adds the lane's counts into segs_out[1..4]
  unsigned long long tally[4] = {ops.all, ops.walk, ops.walk_cycles, (unsigned long long)(clock64() - lane_t0)};
  for (int c = 0; c < 4; ++c) {
    for (int off = 16; off > 0; off >>= 1) tally[c] += __shfl_down_sync(0xffffffffu, tally[c], off);
    if ((threadIdx.x & 31) == 0 && tally[c]) atomicAdd(segs_out + 1 + c, tally[c]);
  }
#endif
  __syncthreads();
  if (threadIdx.x == 0 && s_segs) atomicAdd(segs_out, s_segs);
}

}  // namespace

extern "C" int pt_render_pass(const float* mat, int n_mat, const float* obj, int n_obj, const int* lights,
                              int n_lights, const float* sky, const float* fog, const float* tri, int n_tri_rows,
                              const float* bounds, const int* topo, int n_nodes, const float* basis,
                              const float* tiles, const float* boxes, int n_pages, int n_sub, const int* px,
                              const int* py, int n_lanes, unsigned int frame_seed, int width, int height, int n_strata,
                              int samples, int n_passes, int max_depth, int rr_threshold, int flags, float* out,
                              unsigned long long* segs, void* stream) {
  if (n_lanes <= 0) return 0;
  Params P;
  P.n_mat = n_mat; P.n_obj = n_obj; P.n_lights = n_lights; P.n_tri_rows = n_tri_rows; P.n_nodes = n_nodes;
  P.n_pages = n_pages; P.n_sub = n_sub;
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.n_strata = n_strata; P.samples = samples; P.n_passes = n_passes; P.max_depth = max_depth;
  P.rr_threshold = rr_threshold; P.flags = flags;
  size_t smem = sizeof(float) * (size_t)(n_mat * MAT_STRIDE + n_obj * OBJ_STRIDE + 32 + BASIS_LEN +
                                         n_tri_rows * TRI_STRIDE + n_nodes * 6 + n_pages * n_sub * 6) +
                sizeof(int) * (size_t)(n_lights + 3 * n_nodes);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;  // the tables must fit one SM's shared memory
  auto kernel = n_pages > 0 ? render_pass_kernel<true> : render_pass_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = (n_lanes + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(mat, obj, lights, sky, fog, tri, bounds, topo,
                                                                   basis, tiles, boxes, px, py, P, out, segs);
  return (int)cudaGetLastError();
}

// The paged walk alone (paged_walk.cuh): any_hit = 0 writes the closest
// hit's key, page, t, normal, mat and obj, any_hit = 1 writes blocked.
extern "C" int pt_paged_walk(const float* tiles, const float* boxes, int n_pages, int n_sub, const float* rays,
                             const float* excl, const unsigned char* skip, int n, float t_min, int any_hit,
                             int* out_i, float* out_f, unsigned char* blocked, unsigned long long* ops,
                             void* stream) {
  if (n <= 0) return 0;
  paged_walk_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      tiles, boxes, n_pages, n_sub, rays, excl, skip, n, t_min, any_hit, out_i, out_f, blocked, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
