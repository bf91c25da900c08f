// The paged BVH walk for meshes above 128 triangles: the warp's rays walk
// their pages together, and the (ray, row) pairs of a page are spread over
// the warp's lanes.
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
// Why a thread loads rows itself instead of gathering by matrix product:
// a TPU lane cannot address memory on its own, so the Pallas walk builds a
// one-hot (pages x lanes) matrix per round and multiplies it with a table
// of bf16 limbs to fetch 128 lanes' pages at once.  A CUDA thread simply
// indexes tiles[page][row] with four 16-byte loads, and a 10,240-triangle
// mesh (80 pages x 16 KB = 1.3 MB) stays in the 50 MB L2.
//
// The warp-cooperative sweep (paged_traverse, paged_occluded).  A walk of
// one thread per ray makes a warp run the union of its 32 rays' pages,
// 128 rows each, while the lanes whose ray did not enter the page idle: on
// incoherent rays the warp executed 7.1x the operations its rays need
// (perf probe T2).  Here the lanes that reach the walk together
// (``__activemask()``) walk as one working set:
//   1. pages go in windows of 32: each lane tests its own ray against the
//      window's page boxes (page_wanted against its incoming best_t,
//      unchanged) into a bit mask of the pages it enters, all lanes in
//      step;
//   2. the set visits the least page left in any lane's mask
//      (``__reduce_min_sync``), so every ray still meets its pages in
//      ascending order;
//   3. the visited page's (ray, row) pairs are shared out: with nw of the
//      set's |set| rays wanting the page, each wanting ray gets s = |set| /
//      nw lanes (the lanes past nw * s idle), and its lane of place m tests
//      rows m, m + s, ... with that ray's origin, direction, limits,
//      excluded object and t_upper (``__shfl_sync`` from the ray's lane);
//      an integer ``__reduce_min_sync`` over the ray's lanes folds their
//      keys into its page key, and the ray's own lane merges it exactly as
//      the per-thread walk does;
//   4. any hit: the rows go in rounds, a ``__ballot_sync`` after each; a
//      ray's lanes stop at its first hit, and a blocked ray drops its
//      pages;
//   5. the winner's resolve stays per lane.
// Step 1 keeps the box tests in step: a cursor that each lane advances on
// its own runs them one resumed lane at a time.  Step 3
// spreads the pairs evenly (about 128 nw / |set| rows a lane, where the
// per-thread walk made every lane sweep 128) and still reads each row of
// the page once per round for all the rays at once: the lanes of every ray
// take the same rows in the same round, so one load instruction touches s
// rows, not |set|.  (Giving every wanting ray the whole set in turn read
// the page once per wanting ray and ran coherent rays 4x slower than the
// per-thread walk.)  Lanes whose ray is done keep helping until no lane has
// a page left: no lane of the set leaves it early, and every warp
// intrinsic names the set (or one ray's lanes of it), never the full warp.
// Bit-safety: every (ray, row) key is the same float arithmetic on the
// same inputs as in the per-thread walk (--fmad=false, IEEE division); an
// integer minimum is exact in any order; each ray sees the same pages in
// the same order with the same t_upper.  The counting build
// (-DPT_COUNT_OPS) counts, on each lane, the pairs that lane evaluates, so
// the warp's sum is the pairs the rays need, as before; any hit counts the
// rows up to a ray's first hit and the box tests up to its blocking page.
// It also counts the sweep itself (SWEEP; read through pt_paged_walk, one
// thread a given ray, so that a warp is 32 consecutive rays): each working
// set once, the pages it visits, the rays that want each of them (nw), the
// lane slots it issues for (ray, row) pairs, a round of the row loop times
// the set's lanes (closest hit: ceil(128 / s) rounds a page), against the
// pairs its rays need (step 3's idle lanes are the difference), and each
// lane's box tests.  Where the rays' page masks are known, the closest
// hit's visits, nw and slots follow from them alone
// (tools/perf/page_stats.py holds them to this count).
// The one-thread-per-ray walk's key loop stays as paged_keys_lane: perf
// probe T2's `gather` variant runs it, beside `real`, which runs this one.
//
// What bounds it on an H100: f32 arithmetic outside the tensor cores (67
// TFLOP/s at 700 W): 22 operations per box test and 32 per (row, ray)
// pair, against 64 bytes read per pair from L2 or L1; and what the sharing
// costs: per visited page a vote, ten shuffles and a reduction, lanes left
// idle when |set| is not a multiple of nw, every lane testing every box of
// a window.  A tree above the pages and near-to-far order are later work
// (ROADMAP Queue B).
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
  const float* tiles;  // f32[n_pages, 128, 32], device memory, the same for every lane of a launch
  const float* boxes;  // f32[n_pages, n_sub, 6], shared or device memory
  int n_pages, n_sub;  // n_pages may be 0 on a lane whose ray walks nothing
};

struct PagedWinner {
  bool hit;  // a triangle beat the incoming best_t's key
  int key, page;
  float t, nx, ny, nz, mat, obj;
};

__device__ __forceinline__ int paged_big_key() { return __float_as_int(PAGED_BIG_T) | KEY_SLOT_MASK; }

// the working set of a cooperative walk: the lanes that call it together
struct WalkSet {
  unsigned mask, below;  // the set; its lanes below this one
  int lane, rank, width;  // this lane, its place in the set, the set's size
};

__device__ __forceinline__ WalkSet walk_set() {
  WalkSet W;
  W.mask = __activemask();
  __syncwarp(W.mask);
  asm("mov.u32 %0, %%laneid;" : "=r"(W.lane));
  W.below = W.mask & ((1u << W.lane) - 1u);
  W.rank = __popc(W.below);
  W.width = __popc(W.mask);
  return W;
}

// the lane of the n-th (from 0) set bit of m; n < popc(m)
__device__ __forceinline__ int nth_lane(unsigned m, int n) {
  int lane = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      lane += w;
    }
  }
  return lane;
}

// how the set shares out the (ray, row) pairs of a page that the rays of
// `want` enter (``mine``: this lane's ray is one of them)
struct PageShare {
  int s;         // lanes a wanting ray gets
  int q, m;      // the wanting ray this lane serves (by its order among them) and the lane's place among its lanes
  bool busy;     // q < nw; the lanes past nw * s idle
  int ray_lane;  // the lane that holds ray q
  int home;      // the first lane that served this lane's own ray (wanting lanes)
};

__device__ __forceinline__ PageShare page_share(const WalkSet& W, unsigned want, bool mine) {
  PageShare S;
  const int nw = __popc(want);
  S.s = W.width / nw;
  S.q = W.rank / S.s;
  S.m = W.rank - S.q * S.s;
  S.busy = S.q < nw;
  S.ray_lane = S.busy ? nth_lane(want, S.q) : W.lane;
  S.home = nth_lane(W.mask, (mine ? __popc(want & W.below) : 0) * S.s);
  return S;
}

// what every lane needs to visit the page that the set's vote chose
// (``mine``: this lane's ray enters it): how the page's pairs are shared
// out, and the ray that this lane serves there, its origin, direction and
// limits broadcast from its lane.  The vote and the loop's exit stay in
// the callers: with them inside, ptxas gave B1's paged instance 168
// registers instead of 96 and B1 on the mesh frame ran 16% slower.
struct PageVisit {
  bool mine;
  PageShare S;
  V o, d;  // of ray S.q (on lane S.ray_lane)
  float t_min, t_max;
};

__device__ __forceinline__ PageVisit page_visit(const WalkSet& W, bool mine, V o, V d, float t_min, float t_max) {
  PageVisit P;
  P.mine = mine;
  P.S = page_share(W, __ballot_sync(W.mask, mine), mine);
  const int j = P.S.ray_lane;
  P.o = mk(__shfl_sync(W.mask, o.x, j), __shfl_sync(W.mask, o.y, j), __shfl_sync(W.mask, o.z, j));
  P.d = mk(__shfl_sync(W.mask, d.x, j), __shfl_sync(W.mask, d.y, j), __shfl_sync(W.mask, d.z, j));
  P.t_min = __shfl_sync(W.mask, t_min, j);
  P.t_max = __shfl_sync(W.mask, t_max, j);
  return P;
}

// a ray enters page p: one of its boxes is hit in [t_min, ..) before best_t
// and not after t_max (ops/bvh.py::_page_wants); the caller counts the
// G.n_sub box tests (C_PAGE_BOX each)
__device__ __forceinline__ bool page_enters(const Pages& G, int p, V o, V inv, float t_min, float best_t,
                                            float t_max) {
  bool want = false;
  for (int s = 0; s < G.n_sub; ++s) {
    const float* b = G.boxes + (p * G.n_sub + s) * 6;
    float t1x = (b[0] - o.x) * inv.x, t2x = (b[3] - o.x) * inv.x;
    float t1y = (b[1] - o.y) * inv.y, t2y = (b[4] - o.y) * inv.y;
    float t1z = (b[2] - o.z) * inv.z, t2z = (b[5] - o.z) * inv.z;
    float t0 = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    float t1 = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    want = want || ((t1 >= t0) && (t1 >= t_min) && (t0 < best_t) && (t0 <= t_max));
  }
  return want;
}

__device__ __forceinline__ bool page_wanted(const Pages& G, int p, V o, V inv, float t_min, float best_t,
                                            float t_max OPS_PARAM) {
  OPS_WALK(C_PAGE_BOX * G.n_sub);
  return page_enters(G, p, o, inv, t_min, best_t, t_max);
}

// the pages of [base, base + 32) that the ray enters, as bits (the caller
// counts the box tests)
__device__ __forceinline__ unsigned window_enters(const Pages& G, int base, V o, V inv, float t_min, float best_t,
                                                  float t_max) {
  unsigned bits = 0u;
  const int n = min(32, G.n_pages - base);
  for (int i = 0; i < n; ++i)
    if (page_enters(G, base + i, o, inv, t_min, best_t, t_max)) bits |= 1u << i;
  return bits;
}

// plane-form test of row k of page p (ops/bvh.py::_mt_key); returns the
// pair's key, or the big key.  The caller counts the pair (C_PAGE_TRI).
__device__ __forceinline__ int page_row_key(const float* __restrict__ tiles, int p, int k, V o, V d, float t_min,
                                            float t_upper, float t_max, float excl) {
  const float4* r = reinterpret_cast<const float4*>(tiles + ((size_t)p * PAGE_TRIS + k) * PAGE_ATTRS);
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), e = __ldg(r + 3);
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

// the least key over the 128 rows of page p, one thread
__device__ __forceinline__ int page_key_lane(const float* __restrict__ tiles, int p, V o, V d, float t_min,
                                             float t_upper, float t_max, float excl OPS_PARAM) {
  int page_key = paged_big_key();
  for (int k = 0; k < PAGE_TRIS; ++k) {
    OPS_WALK(C_PAGE_TRI);
    int key = page_row_key(tiles, p, k, o, d, t_min, t_upper, t_max, excl);
    page_key = key < page_key ? key : page_key;
  }
  return page_key;
}

// the ray's running key as it enters the walk: a triangle wins only by
// beating the incoming distance (the + o.x * 0 keeps the plain version's
// NaN behaviour)
__device__ __forceinline__ int paged_start_key(float best_t, V o OPS_PARAM) {
  OPS_WALK(2);
  return __float_as_int(best_t + o.x * 0.0f) | KEY_SLOT_MASK;
}

// the closest-hit key loop of one thread: the ray sweeps the pages it
// enters, in ascending order (the per-thread walk)
__device__ __forceinline__ void paged_keys_lane(const Pages& G, V o, V d, V inv, float t_min, float best_t,
                                                float t_max, float excl, int& best_key, int& best_page OPS_PARAM) {
  for (int p = 0; p < G.n_pages; ++p) {
    if (!page_wanted(G, p, o, inv, t_min, best_t, t_max OPS_ARG)) continue;
    const int page_key = page_key_lane(G.tiles, p, o, d, t_min, __int_as_float(best_key | KEY_SLOT_MASK), t_max,
                                       excl OPS_ARG);
    if (page_key < best_key) {
      best_key = page_key;
      best_page = p;
    }
  }
}

// the closest-hit key loop of the working set (see the note at the top)
__device__ __forceinline__ void paged_keys_warp(const Pages& G, V o, V d, V inv, float t_min, float best_t,
                                                float t_max, float excl, int& best_key, int& best_page OPS_PARAM) {
  const WalkSet W = walk_set();
  SWEEP(ops.w_sets += W.rank == 0);
  for (int base = 0; __any_sync(W.mask, base < G.n_pages); base += 32) {
    unsigned wanted = window_enters(G, base, o, inv, t_min, best_t, t_max);
    OPS_WALK(C_PAGE_BOX * G.n_sub * max(0, min(32, G.n_pages - base)));
    SWEEP(ops.w_boxes += G.n_sub * max(0, min(32, G.n_pages - base)));
    for (;;) {
      const int next = wanted ? __ffs(wanted) - 1 : 32;
      const int i = __reduce_min_sync(W.mask, next);  // the least page left in the set's windows
      if (i == 32) break;
      const int p = base + i;
      const PageVisit P = page_visit(W, next == i, o, d, t_min, t_max);
      const PageShare& S = P.S;
      const float excl_j = __shfl_sync(W.mask, excl, S.ray_lane);
      const float t_upper = __int_as_float(__shfl_sync(W.mask, best_key, S.ray_lane) | KEY_SLOT_MASK);
      int key = paged_big_key();
#ifdef PT_COUNT_OPS
      {
        const int nw = __popc(__ballot_sync(W.mask, P.mine));
        if (W.rank == 0) {
          ops.w_pages += 1;
          ops.w_want += nw;
          ops.w_slots += (unsigned long long)W.width * ((PAGE_TRIS + S.s - 1) / S.s);
        }
      }
#endif
      if (S.busy) {
        for (int k = S.m; k < PAGE_TRIS; k += S.s) {
          OPS_WALK(C_PAGE_TRI);
          SWEEP(ops.w_pairs += 1);
          const int row_key = page_row_key(G.tiles, p, k, P.o, P.d, P.t_min, t_upper, P.t_max, excl_j);
          key = row_key < key ? row_key : key;
        }
      }
      if (S.s > 1) key = __reduce_min_sync(__match_any_sync(W.mask, S.q), key);
      key = __shfl_sync(W.mask, key, S.home);
      if (P.mine) {
        if (key < best_key) {
          best_key = key;
          best_page = p;
        }
        wanted &= wanted - 1u;
      }
    }
  }
}

// winner resolve (ops/bvh.py::_winner_math), per lane
__device__ __forceinline__ PagedWinner paged_resolve(const Pages& G, V o, V d, int best_key, int best_page
                                                     OPS_PARAM) {
  PagedWinner w;
  w.hit = best_page >= 0;
  w.key = best_key;
  w.page = best_page;
  w.t = PAGED_BIG_T;
  w.nx = w.ny = w.nz = w.mat = w.obj = 0.0f;
  if (!w.hit) return w;
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

// closest hit (ops/bvh.py::traverse_triangles_paged), the working set of
// the lanes that call it together.  ``excl``: object id that may not be
// hit, as a float (-1 = none); t_max = +inf for no far limit
__device__ PagedWinner paged_traverse(const Pages& G, V o, V d, V inv, float t_min, float best_t, float t_max,
                                      float excl OPS_PARAM) {
  int best_key = paged_start_key(best_t, o OPS_ARG), best_page = -1;
  paged_keys_warp(G, o, d, inv, t_min, best_t, t_max, excl, best_key, best_page OPS_ARG);
  return paged_resolve(G, o, d, best_key, best_page OPS_ARG);
}

// any hit in [t_min, t_max] (ops/bvh.py::occluded_triangles_paged), the
// working set of the lanes that call it together
__device__ bool paged_occluded(const Pages& G, V o, V d, V inv, float t_min, float t_max OPS_PARAM) {
  const WalkSet W = walk_set();
  SWEEP(ops.w_sets += W.rank == 0);
  const float t_upper = __int_as_float(paged_big_key());
  int blocked_at = -1;  // the page whose row blocked the ray
  for (int base = 0; __any_sync(W.mask, blocked_at < 0 && base < G.n_pages); base += 32) {
    SWEEP(ops.w_boxes += blocked_at < 0 ? G.n_sub * max(0, min(32, G.n_pages - base)) : 0);
    unsigned wanted = blocked_at < 0 ? window_enters(G, base, o, inv, t_min, PAGED_BIG_T, t_max) : 0u;
    for (;;) {
      const int next = wanted ? __ffs(wanted) - 1 : 32;
      const int i = __reduce_min_sync(W.mask, next);  // the least page left in the set's windows
      if (i == 32) break;
      const int p = base + i;
      const PageVisit P = page_visit(W, next == i, o, d, t_min, t_max);
      const PageShare& S = P.S;
      const unsigned lanes = S.s > 1 ? __match_any_sync(W.mask, S.q) : 1u << W.lane;  // ray q's lanes
      bool hit = false;  // a row of ray q hit, as far as its lanes have tested
#ifdef PT_COUNT_OPS
      {
        const int nw = __popc(__ballot_sync(W.mask, P.mine));
        if (W.rank == 0) {
          ops.w_pages += 1;
          ops.w_want += nw;
        }
      }
#endif
      for (int k0 = 0; k0 < PAGE_TRIS; k0 += S.s) {
        SWEEP(ops.w_slots += W.rank == 0 ? W.width : 0);
        const int k = k0 + S.m;
        const bool test = S.busy && !hit && k < PAGE_TRIS;
        const bool row_hit =
            test && page_row_key(G.tiles, p, k, P.o, P.d, P.t_min, t_upper, P.t_max, -1.0f) < paged_big_key();
        const unsigned hits = __ballot_sync(W.mask, row_hit) & lanes;
        // the rows a ray needs end at its first hit: count those alone
        if (test && (hits & W.below) == 0u) {
          OPS_WALK(C_PAGE_TRI);
          SWEEP(ops.w_pairs += 1);
        }
        hit = hit || hits != 0u;
        if (!__any_sync(W.mask, S.busy && !hit)) break;
      }
      hit = __shfl_sync(W.mask, hit, S.home);
      if (P.mine) {
        if (hit) blocked_at = p;
        wanted = hit ? 0u : wanted & (wanted - 1u);
      }
    }
  }
  // the box tests a ray needs end at its blocking page
  OPS_WALK(C_PAGE_BOX * G.n_sub * (blocked_at >= 0 ? blocked_at + 1 : max(0, G.n_pages)));
  return blocked_at >= 0;
}

// ---- the walk alone: one thread per given ray ----
// rays f32[8, n]: ox oy oz dx dy dz best_t t_max; excl f32[n]; skip u8[n]
// (closest: such rays enter no page; any hit: rays that come in blocked).
// out_i i32[2, n]: key, page; out_f f32[6, n]: t nx ny nz mat obj;
// blocked u8[n].  counters: N_COUNTERS uint64, written by the counting
// build only: [1] the f32 operations, [2] those of the walk (all of them),
// [SWEEP_COUNTS..+5] the sweep's counts (common.cuh).
__global__ void __launch_bounds__(128) paged_walk_kernel(const float* __restrict__ tiles,
                                                         const float* __restrict__ boxes, int n_pages, int n_sub,
                                                         const float* __restrict__ rays, const float* __restrict__ excl,
                                                         const unsigned char* __restrict__ skip, int n, float t_min,
                                                         int any_hit, int* __restrict__ out_i,
                                                         float* __restrict__ out_f, unsigned char* __restrict__ blocked,
                                                         unsigned long long* __restrict__ counters) {
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
  unsigned long long tally[8] = {ops.all, ops.walk, ops.w_sets, ops.w_pages, ops.w_want,
                                 ops.w_slots, ops.w_pairs, ops.w_boxes};
  for (int c = 0; c < 8; ++c) {
    for (int off = 16; off > 0; off >>= 1) tally[c] += __shfl_down_sync(0xffffffffu, tally[c], off);
    if ((threadIdx.x & 31) == 0 && tally[c]) atomicAdd(counters + (c < 2 ? 1 + c : SWEEP_COUNTS + c - 2), tally[c]);
  }
#endif
}
