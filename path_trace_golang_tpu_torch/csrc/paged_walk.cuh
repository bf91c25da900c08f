// The paged BVH walk for meshes above 128 triangles, one thread per ray.
//
// Replaces: path_trace_golang_tpu/ops/bvh.py::_traverse_gather (closest
// hit) and ::_occluded_gather (any hit), the per-lane walk that the Pallas
// kernels run for n_triangles > 128, and with them the tables and passes
// that exist only to feed it: build_gather_table, _gather_sel,
// _page_prepass_bucketed and the mask-word machinery.
//
// The contract it keeps (ops/bvh.py of the port is the plain version):
// the mesh is cut into pages of 128 triangles, each triangle stored in
// plane form in a 32-float row (unit normal, plane offset, two barycentric
// duals, material, object id, smooth flag, valid flag, vertex normals).  A
// ray enters a page when it passes one of the page's boxes before the
// distance it came in with.  Every row of an entered page is tested;
// pages go in ascending order.  The loop carries one winner key per ray,
// the f32 bits of the hit distance with the low 7 bits replaced by the
// row's slot: the least key is the closest hit, and hits inside one 2^-16
// bucket go to the lower slot.  The bound ``tt < t_upper`` is the key as
// it stood before the page, for all 128 rows alike, so that a row cannot
// lock out a later row of the same bucket and a lower slot.  The winner's
// exact distance (a true division) and its normal are recomputed from its
// row at the end.
//
// Why a thread loads its own page instead of gathering by matrix product:
// a TPU lane cannot address memory on its own, so the Pallas walk builds a
// one-hot (pages x lanes) matrix per round and multiplies it with a table
// of bf16 limbs to fetch 128 lanes' pages at once.  A CUDA thread simply
// indexes tiles[page][row] with four 16-byte loads; the threads of a warp
// that sweep the same page read the same addresses, which the load unit
// serves as one broadcast, and a 10,240-triangle mesh (80 pages x 16 KB =
// 1.3 MB) stays in the 50 MB L2.
//
// What bounds it on an H100: f32 arithmetic outside the tensor cores (67
// TFLOP/s at 700 W): 22 operations per box test and 32 per (row, ray)
// pair, against 64 bytes read per pair from L2.  What it really pays is
// divergence: a warp sweeps the union of its 32 rays' pages, 128 rows
// each, while the rays that did not enter the page idle.  A per-thread
// stack over a tree above the pages, warp-cooperative sweeps and tiles
// staged in shared memory are later work.
//
// Included by common.cuh after its vector helpers and OPS macros;
// intersect() and occluded() there call paged_traverse()/paged_occluded()
// when the launch carries pages.  pt_paged_walk() in render_pass.cu launches
// the same device functions alone (paged_walk_kernel below), one thread per
// given ray.

#pragma once

constexpr int PAGE_TRIS = 128;
constexpr int PAGE_ATTRS = 32;
constexpr int KEY_SLOT_MASK = PAGE_TRIS - 1;
constexpr float PAGED_BIG_T = 3e38f;
#ifdef PT_COUNT_OPS
// f32 operations: one box slab test; one (row, ray) pair; the winner's
// exact distance; the smooth normal on top of it
constexpr int C_PAGE_BOX = 22, C_PAGE_TRI = 32, C_PAGE_RESOLVE = 12, C_PAGE_SMOOTH = 45;
#endif

struct Pages {
  const float* tiles;  // f32[n_pages, 128, 32], device memory
  const float* boxes;  // f32[n_pages, n_sub, 6], shared or device memory
  int n_pages, n_sub;
};

struct PagedWinner {
  bool hit;  // a triangle beat the incoming best_t's key
  int key, page;
  float t, nx, ny, nz, mat, obj;
};

__device__ __forceinline__ int paged_big_key() { return __float_as_int(PAGED_BIG_T) | KEY_SLOT_MASK; }

// a ray enters page p: one of its boxes is hit in [t_min, ..) before best_t
// and not after t_max (ops/bvh.py::_page_wants)
__device__ __forceinline__ bool page_wanted(const Pages& G, int p, V o, V inv, float t_min, float best_t,
                                            float t_max OPS_PARAM) {
  bool want = false;
  for (int s = 0; s < G.n_sub; ++s) {
    const float* b = G.boxes + (p * G.n_sub + s) * 6;
    OPS_WALK(C_PAGE_BOX);
    float t1x = (b[0] - o.x) * inv.x, t2x = (b[3] - o.x) * inv.x;
    float t1y = (b[1] - o.y) * inv.y, t2y = (b[4] - o.y) * inv.y;
    float t1z = (b[2] - o.z) * inv.z, t2z = (b[5] - o.z) * inv.z;
    float t0 = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    float t1 = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    want = want || ((t1 >= t0) && (t1 >= t_min) && (t0 < best_t) && (t0 <= t_max));
  }
  return want;
}

// plane-form test of row k of page p (ops/bvh.py::_mt_key); returns the
// pair's key, or the big key
__device__ __forceinline__ int page_row_key(const float* __restrict__ tiles, int p, int k, V o, V d, float t_min,
                                            float t_upper, float t_max, float excl OPS_PARAM) {
  const float4* r = reinterpret_cast<const float4*>(tiles + ((size_t)p * PAGE_TRIS + k) * PAGE_ATTRS);
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), e = __ldg(r + 3);
  OPS_WALK(C_PAGE_TRI);
  float denom = a.x * d.x + a.y * d.y + a.z * d.z;
  float t_num = a.w - (a.x * o.x + a.y * o.y + a.z * o.z);
  bool ok = (e.w > 0.5f) && (fabsf(denom) > F(1e-12));
  float rcp = 1.0f / (ok ? denom : 1.0f);
  float tt = t_num * rcp;
  float hx = o.x + tt * d.x, hy = o.y + tt * d.y, hz = o.z + tt * d.z;
  float u = b.x * hx + b.y * hy + b.z * hz + b.w;
  float v = c.x * hx + c.y * hy + c.z * hz + c.w;
  ok = ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (tt >= t_min) && (tt < t_upper) && (tt <= t_max) &&
       (e.y != excl);
  int key = (__float_as_int(tt) & ~KEY_SLOT_MASK) | k;
  return ok ? key : paged_big_key();
}

// closest hit (ops/bvh.py::traverse_triangles_paged).  ``excl``: object id
// that may not be hit, as a float (-1 = none); t_max = +inf for no far limit
__device__ PagedWinner paged_traverse(const Pages& G, V o, V d, V inv, float t_min, float best_t, float t_max,
                                      float excl OPS_PARAM) {
  PagedWinner w;
  // a triangle wins only by beating the incoming distance (the + o.x * 0
  // keeps the plain version's NaN behaviour)
  int best_key = __float_as_int(best_t + o.x * 0.0f) | KEY_SLOT_MASK;
  OPS_WALK(2);
  int best_page = -1;
  for (int p = 0; p < G.n_pages; ++p) {
    if (!page_wanted(G, p, o, inv, t_min, best_t, t_max OPS_ARG)) continue;
    const float t_upper = __int_as_float(best_key | KEY_SLOT_MASK);
    int page_key = paged_big_key();
    for (int k = 0; k < PAGE_TRIS; ++k) {
      int key = page_row_key(G.tiles, p, k, o, d, t_min, t_upper, t_max, excl OPS_ARG);
      page_key = key < page_key ? key : page_key;
    }
    if (page_key < best_key) {
      best_key = page_key;
      best_page = p;
    }
  }
  w.hit = best_page >= 0;
  w.key = best_key;
  w.page = best_page;
  w.t = PAGED_BIG_T;
  w.nx = w.ny = w.nz = w.mat = w.obj = 0.0f;
  if (!w.hit) return w;

  // winner resolve (ops/bvh.py::_winner_math)
  const float* r = G.tiles + ((size_t)best_page * PAGE_TRIS + (best_key & KEY_SLOT_MASK)) * PAGE_ATTRS;
  OPS_WALK(C_PAGE_RESOLVE);
  float gnx = r[0], gny = r[1], gnz = r[2];
  float denom = gnx * d.x + gny * d.y + gnz * d.z;
  bool safe = fabsf(denom) > F(1e-12);
  float t_exact = (r[3] - (gnx * o.x + gny * o.y + gnz * o.z)) / (safe ? denom : 1.0f);
  w.t = safe ? t_exact : PAGED_BIG_T;
  w.nx = gnx; w.ny = gny; w.nz = gnz;
  w.mat = r[12];
  w.obj = r[13];
  if (r[14] > 0.5f) {
    OPS_WALK(C_PAGE_SMOOTH);
    float hx = o.x + w.t * d.x, hy = o.y + w.t * d.y, hz = o.z + w.t * d.z;
    float u = r[4] * hx + r[5] * hy + r[6] * hz + r[7];
    float v = r[8] * hx + r[9] * hy + r[10] * hz + r[11];
    float w0 = 1.0f - u - v;
    float sx = w0 * r[16] + u * r[19] + v * r[22];
    float sy = w0 * r[17] + u * r[20] + v * r[23];
    float sz = w0 * r[18] + u * r[21] + v * r[24];
    float slen = sqrtf(nmax(sx * sx + sy * sy + sz * sz, F(1e-30)));
    w.nx = sx / slen;
    w.ny = sy / slen;
    w.nz = sz / slen;
  }
  return w;
}

// any hit in [t_min, t_max] (ops/bvh.py::occluded_triangles_paged); stops
// at the first
__device__ bool paged_occluded(const Pages& G, V o, V d, V inv, float t_min, float t_max OPS_PARAM) {
  const float t_upper = __int_as_float(paged_big_key());
  for (int p = 0; p < G.n_pages; ++p) {
    if (!page_wanted(G, p, o, inv, t_min, PAGED_BIG_T, t_max OPS_ARG)) continue;
    for (int k = 0; k < PAGE_TRIS; ++k)
      if (page_row_key(G.tiles, p, k, o, d, t_min, t_upper, t_max, -1.0f OPS_ARG) < paged_big_key()) return true;
  }
  return false;
}

// ---- the walk alone: one thread per given ray ----
// rays f32[8, n]: ox oy oz dx dy dz best_t t_max; excl f32[n]; skip u8[n]
// (closest: such rays enter no page; any hit: rays that come in blocked).
// out_i i32[2, n]: key, page; out_f f32[6, n]: t nx ny nz mat obj;
// blocked u8[n].  ops: one uint64, written by the counting build only.
__global__ void __launch_bounds__(128) paged_walk_kernel(const float* __restrict__ tiles,
                                                         const float* __restrict__ boxes, int n_pages, int n_sub,
                                                         const float* __restrict__ rays, const float* __restrict__ excl,
                                                         const unsigned char* __restrict__ skip, int n, float t_min,
                                                         int any_hit, int* __restrict__ out_i,
                                                         float* __restrict__ out_f, unsigned char* __restrict__ blocked,
                                                         unsigned long long* __restrict__ ops_out) {
#ifdef PT_COUNT_OPS
  OpsCount ops = {0ull, 0ull, 0ull};
#endif
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    Pages G;
    G.tiles = tiles; G.boxes = boxes; G.n_pages = n_pages; G.n_sub = n_sub;
    V o = mk(rays[i], rays[n + i], rays[2 * n + i]);
    V d = mk(rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
    V inv = mk(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
    OPS(3);
    float best_t = rays[6 * n + i], t_max = rays[7 * n + i];
    if (skip[i]) G.n_pages = 0;
    if (any_hit) {
      blocked[i] = skip[i] || paged_occluded(G, o, d, inv, t_min, t_max OPS_ARG);
    } else {
      PagedWinner w = paged_traverse(G, o, d, inv, t_min, best_t, t_max, excl[i] OPS_ARG);
      out_i[i] = w.key;
      out_i[n + i] = w.page;
      out_f[i] = w.t;
      out_f[n + i] = w.nx;
      out_f[2 * n + i] = w.ny;
      out_f[3 * n + i] = w.nz;
      out_f[4 * n + i] = w.mat;
      out_f[5 * n + i] = w.obj;
    }
  }
#ifdef PT_COUNT_OPS
  unsigned long long all = ops.all;
  for (int off = 16; off > 0; off >>= 1) all += __shfl_down_sync(0xffffffffu, all, off);
  if ((threadIdx.x & 31) == 0 && all) atomicAdd(ops_out, all);
#endif
}
