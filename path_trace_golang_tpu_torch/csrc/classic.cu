// The classic per-sample loop: kernel B3 (trace given rays) and the classic
// instance of the whole-pass kernel.
//
// Replaces: path_trace_golang_tpu/ops/pallas_trace.py::trace_grid_pallas
// (kernel B3: integrator._trace_cpu or _trace_gpu on the rays the caller
// gives, reached through integrator.trace_grid and trace()), and the
// classic branch of render_pass_pallas (render.pass_body_grid's per-sample
// loop, which the Pallas kernel runs for the cpu contract and for faithful
// fog).  Both run the same per-lane device code: the cpu contract's bounce
// (cpu_bounce below: exit scan, no NEE, no fog), or the gpu contract's
// (gpu_bounce of common.cuh) after the fog march on the trace's own stream.
//
// What bounds it on an H100: f32 arithmetic outside the tensor cores (67
// TFLOP/s at 700 W; half of that for multiply-adds built with --fmad=false)
// and the hash rounds of the RNG, not bytes: B3 reads 32 bytes a ray and
// writes 20.  On a call of a few hundred thousand rays B3 also waits on its
// longest path: no launch ends before its slowest ray, and the state
// advance cannot start before every path has ended (PERF.md: the longest
// path traced alone takes 70-97% of the call on the cpu contract).  A
// lane's whole path lives in registers, the scene tables sit in shared
// memory, and meshes of any size go through intersect<PAGED> and
// occluded<PAGED> as in the regeneration kernel.
//
// What differs from the regeneration loop, and why the state needs care:
// the classic loop of the JAX package runs while any lane of the call is
// alive, and every lane, dead or alive, draws one bounce's quota on every
// trip (PHYSICS.md D7).  A lane's returned state is therefore its state
// after its own L bounces advanced by (T - L) more quotas, where T, the
// trips of the call (for the Renderer: of the lane's chunk), is the longest
// path among its lanes.  A thread stops at its own path's end, writes L and
// raises T with atomicMax; since T is known only when every block has
// finished, the rest is done by a later launch: for B3 pt_trace_grid's
// advance_kernel, for the whole-pass instance the next sample's launch,
// which begins with that advance.  Draws per trip: the gpu contract's shade
// draws + 1, the cpu contract's 9.  The fog march of faithful fog draws 2
// per light and step first.
//
// What the design does about it:
// - B3 (pt_trace_grid) runs the in-trace fog march, where the call has one,
//   as a launch of its own at the march's register budget
//   (trace_march_kernel), then the bounces (trace_bounce_kernel: with pages
//   in persistent blocks whose threads take the next ray as soon as their
//   path ends), then advance_kernel; it reads the rays in place and writes
//   the states as int64, so that trace() launches nothing but these;
// - with one sample a pass (the cpu contract) no lane waits on another's
//   path: classic_window_kernel runs a window of passes over all of a
//   frame's lanes in one launch of persistent blocks, one bounce an
//   iteration of one flat loop, so that a thread starts its lane's next
//   pass as soon as the last one ends and then takes the next lane (a
//   nested loop would wait for the warp's longest path every pass; depth 80
//   has a long tail), and adds each pass's radiance into the Renderer's
//   accumulator in pass order, one f32 add a pass as the plain version's
//   accum += col;
// - with several samples a pass (faithful fog), a sample is two launches
//   over all of a frame's chunks: classic_march_kernel (the state advance,
//   the camera ray and the fog march, most of the work, in step on every
//   lane, its shadow tests culled warp by warp: common.cuh, shadow_cull)
//   and classic_sample_kernel (the bounces), each lane reading the
//   longest path of its own chunk (trips[chunk][sample]); the last sample
//   adds the pass into the accumulator.
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py like render_pass.cu
// (its own nvcc, its own library) and bound with ctypes through
// pt_trace_grid(), pt_classic_window() and pt_classic_samples().

#include <algorithm>

#include "common.cuh"

namespace {

// the blocks of 128 threads an SM that ptxas must leave room for (registers
// at most 65,536 / (128 x blocks)), by kernel and instance (PERF.md, the
// occupancy A/B): faithful fog's march and bounces gain from 64 registers
// and 8 blocks despite their spills (-9% and -4% of a pass; the march with
// its shadow cull again: 6, 12 and 16 blocks lose 2-26%); the cpu
// window's kernel moves by less than the runs' spread from 48 to 80
// registers, and keeps ptxas' choice (72, 95 with pages); the paged march
// and bounces, which no measured cell runs, keep ptxas' choice (a minimum of 1)
constexpr int MARCH_MIN_BLOCKS = 8, SAMPLE_MIN_BLOCKS = 8;
// kernel B3's bounces, page-free and paged (PERF.md, the occupancy A/B): the
// page-free instances keep ptxas' count (122 registers gpu, 72 cpu; 5 and 6
// blocks, 96 and 80 registers, spill and move nothing); the paged gpu
// instance gains 3% from 128 registers (143 by ptxas' count)
constexpr int TRACE_MIN_BLOCKS = 1, TRACE_PAGED_MIN_BLOCKS = 4;

constexpr int CPU_DRAWS = 9;  // 2 + 3 Lambert, 2 metal lobe, 1 Fresnel, 1 russian roulette

#ifdef PT_COUNT_OPS
constexpr int C_EXIT_CAND = 9 + 3 + 1 + 5 + 3 + 5;  // hit point, facing test, distance test
#endif

inline __host__ __device__ int trip_draws(int flags, int n_lights) {
  return (flags & FLAG_CPU) ? CPU_DRAWS : shade_draws_of(flags, n_lights) + 1;
}

// cosine-weighted direction with a proper orthonormal frame
// (ops/sampling.py::cosine_direction_onb, math.go:94-131)
__device__ V cosine_direction_onb(V n, float u1, float u2) {
  float sp, cp;
  sincos_2pi(u1, sp, cp);
  float cos_t = sqrtf(u2);
  float sin_t = sqrtf(nmax(1.0f - u2, 0.0f));
  bool use_y = fabsf(n.x) > F(0.9);
  V axis = use_y ? mk(0.0f, 1.0f, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  V v = normalize(cross(n, axis));
  V u = cross(v, n);
  return add(add(muls(u, sin_t * cp), muls(v, sin_t * sp)), muls(n, cos_t));
}

// the closest dielectric backface along a refracted ray
// (integrator.py::_dielectric_exit_scan, renderer.go:316-371): analytic
// objects with a dielectric material, hit from behind, at squared distance
// in (1e-8, 1000), t_min 1e-4.  Writes the exit point where one is found.
__device__ bool exit_scan(const Scene& S, V o, V d, V& exit_p OPS_PARAM) {
  const float t_min = F(1e-4);
  float a = dot(d, d);
  float inv_a = 1.0f / a;
  float inv_dx = 1.0f / d.x, inv_dy = 1.0f / d.y, inv_dz = 1.0f / d.z;
  OPS(C_RAY_SETUP);
  float best_t = BIG_T;
  for (int m = 0; m < S.n_obj; ++m) {
    const float* ob = S.obj + m * OBJ_STRIDE;
    if ((int)S.mat[(int)ob[1] * MAT_STRIDE] != MAT_DIELECTRIC) continue;
    int typ = (int)ob[0];
    float t;
    OPS((typ == OBJ_SPHERE ? C_SPHERE : (typ == OBJ_PLANE ? C_PLANE : C_BOX)) + C_EXIT_CAND);
    bool ok = object_t(ob, typ, o, d, a, inv_a, inv_dx, inv_dy, inv_dz, t_min, t);
    float px = o.x + d.x * t, py = o.y + d.y * t, pz = o.z + d.z * t;
    bool front;
    if (typ == OBJ_SPHERE) {
      front = (d.x * (px - ob[4]) + d.y * (py - ob[5]) + d.z * (pz - ob[6])) < 0.0f;
    } else if (typ == OBJ_PLANE) {
      front = d.y < 0.0f;
    } else {  // box: the nearest-face normal chain (objects.go:186-219)
      float lx = px - ob[4], ly = py - ob[5], lz = pz - ob[6];
      bool on_x = fabsf(fabsf(lx) - ob[8] * 0.5f) < F(1e-4);
      bool on_y = fabsf(fabsf(ly) - ob[9] * 0.5f) < F(1e-4);
      float ndot = on_x ? d.x * signf(lx) : (on_y ? d.y * signf(ly) : d.z * signf(lz));
      front = ndot < 0.0f;
    }
    float ex = px - o.x, ey = py - o.y, ez = pz - o.z;
    float dist_sq = ex * ex + ey * ey + ez * ez;
    ok = ok && !front && dist_sq > F(1e-8) && dist_sq < 1000.0f;
    if (ok && t < best_t) best_t = t;
  }
  if (!(best_t < BIG_T)) return false;
  OPS(6);
  exit_p = add(o, muls(d, best_t));
  return true;
}

// one bounce of the cpu contract at path depth dep (integrator.py::_trace_cpu's
// loop body; renderer.go:286-404, materials.go:74-224).  Nine draws whatever
// the lane does.  Returns whether the path goes on; the ray then starts at
// the hit point itself, or at the exit point of the glass it refracted into.
template <bool PAGED>
__device__ bool cpu_bounce(const Scene& S, const Params& P, int dep, V& orig, V& dir, V& thr, V& col,
                           uint32_t& st OPS_PARAM) {
  STAGE_BEGIN(isect_t0);
  Hit h = intersect<PAGED>(S, orig, dir, -1, false, true OPS_ARG);
  STAGE_END(isect_t0, STAGE_ISECT);
  if (!h.hit) {
    OPS(C_NORMALIZE + C_BACKGROUND + 6);
    col = add(col, mul(thr, background(S, normalize(dir))));
    skip_u(st, CPU_DRAWS);
    RNG(CPU_DRAWS);
    return false;
  }
  const float* mt = S.mat + h.mat_idx * MAT_STRIDE;
  const int typ = h.mtyp;
  const bool is_lambert = typ == MAT_LAMBERT, is_metal = typ == MAT_METAL;
  const bool is_mirror = typ == MAT_MIRROR, is_diel = typ == MAT_DIELECTRIC;
  const bool is_emissive = typ == MAT_EMISSIVE;
  const V n = h.normal, p = h.p;
  const V view = normalize(dir);
  // roughness from smoothness for metals (materials.go:36-39); ior 0 means 1.5 (:42-45)
  const float rough = (is_metal && mt[3] > 0.0f) ? clampf(1.0f - mt[3], 0.0f, 1.0f) : clampf(mt[1], 0.0f, 1.0f);
  const float ior = mt[2] == 0.0f ? 1.5f : mt[2];
  OPS(C_NORMALIZE + 4 + (is_emissive ? 6 : 0) + 9 * C_DRAW);

  if (is_emissive) col = add(col, mul(thr, mk(mt[8], mt[9], mt[10])));

  const float lu1 = next_u(st), lu2 = next_u(st);
  const float bu1 = next_u(st), bu2 = next_u(st), bu3 = next_u(st);
  const float mu1 = next_u(st), mu2 = next_u(st);
  const float u_fr = next_u(st);
  RNG(8);

  V new_dir = n, new_orig = p;
  V att = is_diel ? mk(1.0f, 1.0f, 1.0f) : mk(mt[4], mt[5], mt[6]);
  if (is_lambert) {
    // cosine lobe plus a rough jitter (materials.go:76-97)
    new_dir = cosine_direction_onb(n, lu1, lu2);
    OPS(C_COSINE_ONB + 1);
    if (rough > F(1e-6)) {
      OPS(C_UNIT_BALL + 1 + 6 + C_NORMALIZE);
      new_dir = normalize(add(new_dir, muls(unit_ball(bu1, bu2, bu3), rough * F(0.1))));
    }
  } else if (is_metal || is_mirror) {
    // mirror blended toward a cosine lobe by rough^2 (materials.go:99-160)
    const V reflected = reflect(view, n);
    new_dir = reflected;
    OPS(C_REFLECT + 1);
    if (rough > F(1e-6)) {
      OPS(C_COSINE_ONB + 2 + 9 + C_DOT + C_NORMALIZE + C_DOT);
      const float alpha = rough * rough;
      V blended = add(muls(reflected, 1.0f - alpha), muls(cosine_direction_onb(reflected, mu1, mu2), alpha));
      blended = dot(blended, blended) < F(1e-8) ? reflected : normalize(blended);
      new_dir = dot(blended, n) <= 0.0f ? reflected : blended;
    }
  } else if (is_diel) {
    // Schlick on the refraction ratio (materials.go:162-200)
    OPS(C_DOT + 2 + 4 + 1 + 1 + C_SCHLICK + C_REFRACT);
    float cos_t = nmin(-dot(view, n), 1.0f);
    float sin_t = sqrtf(nmax(1.0f - cos_t * cos_t, 0.0f));
    const bool entering = h.front_face;
    float ratio = entering ? 1.0f / ior : ior;
    bool do_reflect = ratio * sin_t > 1.0f || schlick(cos_t, ratio) > u_fr;
    new_dir = do_reflect ? reflect(view, n) : refract(view, n, ratio);
    // Beer-Lambert through the exit scan (renderer.go:316-371)
    V exit_p;
    if ((P.flags & FLAG_DIELECTRIC) && entering && !do_reflect && exit_scan(S, p, new_dir, exit_p OPS_ARG)) {
      OPS(C_DOT + 4 + 3 * 3);
      V e = sub(exit_p, p);
      float dist = sqrtf(nmax(dot(e, e), 0.0f));
      if (any_positive(mk(mt[12], mt[13], mt[14])))
        att = mk(expf(-(mt[12] * dist)), expf(-(mt[13] * dist)), expf(-(mt[14] * dist)));
      new_orig = exit_p;
    }
  }

  // russian roulette on the remaining depth (renderer.go:373-393)
  const int remaining = P.max_depth - dep;
  float u_rr = next_u(st);
  RNG(1);
  float mc = max_comp(att);
  bool rr_active = remaining <= P.rr_threshold;
  float rr_prob = nmin(mc, F(0.95));
  bool rr_kill = rr_active && (mc < F(1e-6) || u_rr > rr_prob);
  if (rr_active && !rr_kill) att = muls(att, 1.0f / nmax(rr_prob, F(1e-6)));
  OPS(C_DRAW + 3 + (rr_active && !rr_kill ? 5 : 0));

  const bool alive = !is_emissive && !rr_kill;
  if (alive) {
    OPS(3);
    thr = mul(thr, att);
    orig = new_orig;
    dir = new_dir;
  }
  return alive;
}

// the fog march of faithful fog that starts a lane's trace, on the trace's
// own stream (integrator.py::_trace_gpu): its gated radiance, from which
// the bounces add on.  An inactive lane marches nothing but draws the
// march's quota all the same.
template <bool PAGED>
__device__ __forceinline__ V trace_march(const Scene& S, V orig, V dir, uint32_t& st, bool active OPS_PARAM) {
  V col = mk(0.0f, 0.0f, 0.0f);
  STAGE_BEGIN(fog_t0);
  if (active) {
    const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
    col = muls(fog_march<PAGED>(S, fog_params(S.fog), orig, dir, st OPS_ARG), gate);
  } else {
    skip_u(st, FOG_STEPS * 2 * S.n_lights);
    RNG(FOG_STEPS * 2 * S.n_lights);
  }
  STAGE_END(fog_t0, STAGE_FOG);
  return col;
}

// the bounces of one lane's trace, up to max_depth, adding into col; st
// advances one quota per own bounce, len receives the lane's bounces
template <bool PAGED, bool CPU, bool DROP = false>
__device__ __forceinline__ V trace_bounces(const Scene& S, const Params& P, const Shading& D, V orig, V dir, V col,
                                           uint32_t& st, bool active, int& len OPS_PARAM) {
  V thr = mk(1.0f, 1.0f, 1.0f);
  int glass_obj = -1;
  float glass_dist = 0.0f;
  bool alive = active;
  len = 0;
  STAGE_BEGIN(loop_t0);
  for (int dep = 0; alive && dep < P.max_depth; ++dep) {
    len += 1;
    if constexpr (CPU)
      alive = cpu_bounce<PAGED>(S, P, dep, orig, dir, thr, col, st OPS_ARG);
    else
      alive = gpu_bounce<PAGED, DROP>(S, P, D, dep, orig, dir, thr, col, st, glass_obj, glass_dist OPS_ARG);
    LANE_DONE();
  }
  STAGE_END(loop_t0, STAGE_LOOP);
  return col;
}

// kernel B3's rays, states and outputs for n lanes: the origin and direction
// components (o[k][lane * o_stride], d[k][lane * d_stride]), the uint32
// states in the low bits of st_in, an optional active mask, the radiance
// (out[k * out_comp + lane * out_lane]: component planes or [n][3] rows),
// the states (st: after the march, then after the lane's own bounces, then
// advanced by the call's other trips), each lane's path length and the
// call's trips
struct TraceIO {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  int o_stride, d_stride;
  const long long* st_in;
  const unsigned char* active;
  float* out;
  int out_comp, out_lane;
  long long* st;
  int* len;
  int* trips;
};

__device__ __forceinline__ V trace_origin(const TraceIO& io, size_t lane) {
  const size_t at = lane * io.o_stride;
  return mk(io.ox[at], io.oy[at], io.oz[at]);
}
__device__ __forceinline__ V trace_dir(const TraceIO& io, size_t lane) {
  const size_t at = lane * io.d_stride;
  return mk(io.dx[at], io.dy[at], io.dz[at]);
}
__device__ __forceinline__ bool trace_active(const TraceIO& io, size_t lane) {
  return io.active == nullptr || io.active[lane] != 0;
}

// kernel B3, first launch under the in-trace fog march (the gpu contract with
// FLAG_FOG_TRACE): one thread a ray marches it on the trace's own stream
// (integrator.py::_trace_gpu's fog_prepass_grid, an inactive lane drawing
// the march's quota all the same) and leaves the gated radiance in out and
// the state in st for the bounces.  The march is a fixed number of steps a
// ray, most of such a trace's work (PERF.md: 90% of the lane cycles), and
// runs here at the register budget that faithful fog's march kernel won.
template <bool PAGED>
__global__ void __launch_bounds__(BLOCK, PAGED ? 1 : MARCH_MIN_BLOCKS)
    trace_march_kernel(Tables T, Params P, TraceIO io, unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);
  OPS_DECL;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < (size_t)P.n_lanes) {
    uint32_t st = (uint32_t)io.st_in[lane];
    const V m = trace_march<PAGED>(S, trace_origin(io, lane), trace_dir(io, lane), st, trace_active(io, lane) OPS_ARG);
    io.out[lane * io.out_lane] = m.x;
    io.out[io.out_comp + lane * io.out_lane] = m.y;
    io.out[2 * (size_t)io.out_comp + lane * io.out_lane] = m.z;
    io.st[lane] = (long long)st;
  }
#ifdef PT_COUNT_OPS
  add_counters(0ull, &s_segs, counters OPS_ARG);
#else
  (void)counters;
#endif
}

// kernel B3's bounces (integrator.py::_trace_cpu / _trace_gpu's loop): one
// flat loop of one bounce an iteration.  With pages, persistent blocks whose
// thread takes the next ray from counters[CURSOR] (zero on entry) as soon as
// its path ends, so that no thread waits for its warp's longest path while
// rays are left (9% off bench_mesh's gpu trace, PERF.md); page-free, one
// thread a ray (persistent blocks lost 4% on the cpu contract's trace, which
// its longest path bounds, and moved the in-trace fog's by nothing).  A
// ray starts from the march's radiance and state where the call marched
// (marched), else from zero and st_in; it writes its radiance, its state
// after its own L bounces, and L, and raises trips[0] to the longest L (a
// shared maximum a block, one atomic a block).
template <bool PAGED, bool CPU, bool DROP = false>
__global__ void __launch_bounds__(BLOCK, PAGED ? TRACE_PAGED_MIN_BLOCKS : TRACE_MIN_BLOCKS)
    trace_bounce_kernel(Tables T, Params P, TraceIO io, int marched, unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  __shared__ int s_trips;
  if (threadIdx.x == 0) { s_segs = 0ull; s_trips = 0; }
  const Scene S = load_scene(T, P, smem);
  const Shading D = make_shading(S, P);
  unsigned long long segs = 0ull;
  OPS_DECL;
  const size_t oc = (size_t)io.out_comp;
  int lane = PAGED ? (int)atomicAdd(counters + CURSOR, 1ull) : (int)(blockIdx.x * blockDim.x + threadIdx.x);
  int dep = 0, most = 0, glass_obj = -1;
  float glass_dist = 0.0f;
  bool tracing = false, alive = false;
  uint32_t st = 0;
  V orig = mk(0.0f, 0.0f, 0.0f), dir = orig, thr = orig, col = orig;
  STAGE_BEGIN(loop_t0);
  while (lane < P.n_lanes) {
    const size_t at = (size_t)lane;
    if (!tracing) {
      orig = trace_origin(io, at);
      dir = trace_dir(io, at);
      alive = trace_active(io, at);
      if (marched) {
        st = (uint32_t)io.st[at];
        col = mk(io.out[at * io.out_lane], io.out[oc + at * io.out_lane], io.out[2 * oc + at * io.out_lane]);
      } else {
        st = (uint32_t)io.st_in[at];
        col = mk(0.0f, 0.0f, 0.0f);
      }
      thr = mk(1.0f, 1.0f, 1.0f);
      dep = 0;
      glass_obj = -1;
      glass_dist = 0.0f;
      tracing = true;
    }
    if (alive && dep < P.max_depth) {
      segs += 1;
      if constexpr (CPU)
        alive = cpu_bounce<PAGED>(S, P, dep, orig, dir, thr, col, st OPS_ARG);
      else
        alive = gpu_bounce<PAGED, DROP>(S, P, D, dep, orig, dir, thr, col, st, glass_obj, glass_dist OPS_ARG);
      dep += 1;
      LANE_DONE();
    }
    if (!(alive && dep < P.max_depth)) {  // the path ended: its results, then the next ray
      io.out[at * io.out_lane] = col.x;
      io.out[oc + at * io.out_lane] = col.y;
      io.out[2 * oc + at * io.out_lane] = col.z;
      io.st[at] = (long long)st;
      io.len[at] = dep;
      most = max(most, dep);
      tracing = false;
      lane = PAGED ? (int)atomicAdd(counters + CURSOR, 1ull) : P.n_lanes;
    }
  }
  STAGE_END(loop_t0, STAGE_LOOP);
  if (most) atomicMax(&s_trips, most);
  add_counters(segs, &s_segs, counters OPS_ARG);
  if (threadIdx.x == 0 && s_trips) atomicMax(io.trips, s_trips);
}

// the draws that the call's other trips take: (T - L) quotas for each lane
// (the counting build adds their hash rounds into counters[13] and, apart,
// into counters[ADVANCE_ROUNDS])
__global__ void __launch_bounds__(BLOCK) advance_kernel(TraceIO io, int n, int draws,
                                                        unsigned long long* __restrict__ counters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int skip = 0;
  if (lane < n) {
    uint32_t s = (uint32_t)io.st[lane];
    skip = (*io.trips - io.len[lane]) * draws;
    skip_u(s, skip);
    io.st[lane] = (long long)s;
  }
#ifdef PT_COUNT_OPS
  unsigned long long rounds = (unsigned long long)skip;
  for (int off = 16; off > 0; off >>= 1) rounds += __shfl_down_sync(0xffffffffu, rounds, off);
  if ((threadIdx.x & 31) == 0 && rounds) {
    atomicAdd(counters + 13, rounds);
    atomicAdd(counters + ADVANCE_ROUNDS, rounds);
  }
#else
  (void)counters;
#endif
}

// the camera ray of a classic sample (render.py:296-322): two jitter draws,
// the stratum, the camera ray (and the lens draws) from st
__device__ __forceinline__ void sample_ray(const Scene& S, const Params& P, uint32_t px, uint32_t py, int sample,
                                           uint32_t& st, V& o, V& d OPS_PARAM) {
  const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
  const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
  const float pxf = (float)(int)px;
  const float fy = (float)(P.height - 1) - (float)(int)py;
  float jx = next_u(st), jy = next_u(st);
  RNG(2);
  OPS(2 * C_DRAW + 10);
  float su = jx, sv = jy;
  if (P.n_strata > 1) {
    const float inv_strata = F(1.0 / P.n_strata);
    su = (jx + (float)(sample % P.n_strata)) * inv_strata;
    sv = (jy + (float)(sample / P.n_strata)) * inv_strata;
  }
  camera_ray(S, (pxf + su) * inv_w, (fy + sv) * inv_h, P.flags & FLAG_APERTURE, P.flags & FLAG_LENS_DISK, st, o, d
             OPS_ARG);
}

// the classic instance for one sample a pass (the cpu contract's bounce, no
// fog once a pass): a window of n_passes passes for pixel lanes, pass p
// seeded at frame_seed + p, its radiance added into accum[lane][3] in pass
// order.  Persistent blocks run one flat loop of one bounce an iteration;
// a thread whose path ends starts its lane's next pass in the next
// iteration, and after its lane's last pass takes the next lane from
// counters[CURSOR] (zero on entry), so that its warp waits on no other
// thread's path until the lanes run out (10% off the window against one
// thread a lane: PERF.md).
template <bool PAGED>
__global__ void __launch_bounds__(BLOCK)
    classic_window_kernel(Tables T, Params P, const int* __restrict__ g_px, const int* __restrict__ g_py,
                          float* __restrict__ accum, unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);
  unsigned long long segs = 0ull;
  OPS_DECL;
  int lane = (int)atomicAdd(counters + CURSOR, 1ull);
  uint32_t px = 0, py = 0, st = 0;
  int p = 0, dep = 0;
  bool fresh = true, tracing = false;
  V acc = mk(0.0f, 0.0f, 0.0f), col = acc, orig = acc, dir = acc, thr = acc;
  STAGE_BEGIN(loop_t0);
  while (lane < P.n_lanes) {
    if (!tracing) {
      STAGE_BEGIN(cam_t0);
      if (fresh) {
        px = (uint32_t)g_px[lane];
        py = (uint32_t)g_py[lane];
        acc = mk(accum[3 * (size_t)lane], accum[3 * (size_t)lane + 1], accum[3 * (size_t)lane + 2]);
        p = 0;
        fresh = false;
      }
      st = seed_lane(px, py, P.frame_seed + (uint32_t)p);
      RNG(1);
      sample_ray(S, P, px, py, 0, st, orig, dir OPS_ARG);
      thr = mk(1.0f, 1.0f, 1.0f);
      col = mk(0.0f, 0.0f, 0.0f);
      dep = 0;
      tracing = true;
      STAGE_END(cam_t0, STAGE_CAMERA);
    }
    bool done = true;
    if (dep < P.max_depth) {
      segs += 1;
      done = !cpu_bounce<PAGED>(S, P, dep, orig, dir, thr, col, st OPS_ARG);
      dep += 1;
      done = done || dep >= P.max_depth;
      LANE_DONE();
    }
    if (done) {  // the pass's radiance into the accumulator (pass_body_grid, then accum += col)
      tracing = false;
      if (P.flags & FLAG_NORMALIZE) col = muls(col, F(1.0 / P.samples));
      acc = add(acc, col);
      if (++p == P.n_passes) {
        accum[3 * (size_t)lane] = acc.x;
        accum[3 * (size_t)lane + 1] = acc.y;
        accum[3 * (size_t)lane + 2] = acc.z;
        lane = (int)atomicAdd(counters + CURSOR, 1ull);
        fresh = true;
      }
    }
  }
  STAGE_END(loop_t0, STAGE_LOOP);
#ifdef PT_COUNT_OPS
  ops.stage[STAGE_LOOP] -= ops.stage[STAGE_CAMERA];  // the loop's stage is its bounces (and the warp's wait)
#endif
  add_counters(segs, &s_segs, counters OPS_ARG);
}

// the classic instance, one sample of a pass for pixel lanes in chunks of
// ``chunk`` (render.py:296-322), as two launches a sample, the longest paths
// of each chunk's samples in trips[chunk][samples]: first the sample's ray
// (classic_march_kernel): sample 0 seeds the lane (and adds the fog-once
// estimate where the flags ask for it), a later sample advances the state
// that the last launch left by the previous sample's other trips of the
// lane's chunk; then the stratum's camera ray and, under faithful fog, the
// trace's fog march, whose gated radiance goes with the ray to ray_buf[9][n]
// (origin, direction, march) and the state to st_buf.  Then the bounces
// (classic_sample_kernel) from there; the running radiance, state and path
// length stay in col_buf[3][n], st_buf, len_buf for the next sample, and
// the last sample adds the pass into accum[lane][3].  The march holds most
// of faithful fog's time and runs in step on every lane (FOG_STEPS steps x
// every light) at its own register budget (PERF.md: 13% off the pass).
template <bool PAGED, bool CPU>
__global__ void __launch_bounds__(BLOCK, PAGED ? 1 : MARCH_MIN_BLOCKS)
    classic_march_kernel(Tables T, Params P, const int* __restrict__ g_px, const int* __restrict__ g_py, int sample,
                         int chunk, float* __restrict__ col_buf, float* __restrict__ ray_buf,
                         uint32_t* __restrict__ st_buf, const int* __restrict__ len_buf,
                         const int* __restrict__ trips, unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);
  OPS_DECL;
  const size_t n = (size_t)P.n_lanes;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n_lanes) {
    const uint32_t px = (uint32_t)g_px[lane], py = (uint32_t)g_py[lane];
    uint32_t st;
    STAGE_BEGIN(adv_t0);
    if (sample == 0) {
      st = seed_lane(px, py, P.frame_seed);
      RNG(1);
      V col = mk(0.0f, 0.0f, 0.0f);
      if (P.flags & FLAG_FOG_ONCE) {  // one pass: the fog estimate on its own stream (render.py:232-266)
        const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
        const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
        const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
        uint32_t fst = seed_lane(px, py, P.frame_seed ^ 0x9E3779B9u);
        float jx = next_u(fst), jy = next_u(fst);
        RNG(3);
        OPS(2 * C_DRAW + 4 + 2 + 9);
        V fo, fd;
        camera_ray(S, ((float)(int)px + jx) * inv_w, ((float)(P.height - 1) - (float)(int)py + jy) * inv_h,
                   P.flags & FLAG_APERTURE, P.flags & FLAG_LENS_DISK, fst, fo, fd OPS_ARG);
        col = muls(muls(fog_march<PAGED>(S, fog_params(S.fog), fo, fd, fst OPS_ARG), gate), (float)P.samples);
      }
      col_buf[lane] = col.x;
      col_buf[n + lane] = col.y;
      col_buf[2 * n + lane] = col.z;
    } else {
      const int c = lane / chunk;
      st = st_buf[lane];
      const int skip = (trips[c * P.samples + sample - 1] - len_buf[lane]) * trip_draws(P.flags, P.n_lights);
      skip_u(st, skip);
      RNG(skip);
    }
    STAGE_END(adv_t0, STAGE_ADVANCE);
    STAGE_BEGIN(cam_t0);
    V o, d;
    sample_ray(S, P, px, py, sample, st, o, d OPS_ARG);
    STAGE_END(cam_t0, STAGE_CAMERA);
    V m = mk(0.0f, 0.0f, 0.0f);
    if (!CPU && (P.flags & FLAG_FOG_TRACE)) m = trace_march<PAGED>(S, o, d, st, true OPS_ARG);
    const float v[9] = {o.x, o.y, o.z, d.x, d.y, d.z, m.x, m.y, m.z};
    for (int k = 0; k < 9; ++k) ray_buf[k * n + lane] = v[k];
    st_buf[lane] = st;
  }
#ifdef PT_COUNT_OPS
  add_counters(0ull, &s_segs, counters OPS_ARG);
#else
  (void)counters;
#endif
}

// the bounces of a classic sample from classic_march_kernel's ray, state and
// march (ray_buf, st_buf), adding into the running radiance
template <bool PAGED, bool CPU, bool DROP = false>
__global__ void __launch_bounds__(BLOCK, PAGED ? 1 : SAMPLE_MIN_BLOCKS)
    classic_sample_kernel(Tables T, Params P, int sample, int chunk, float* __restrict__ col_buf,
                          const float* __restrict__ ray_buf, uint32_t* __restrict__ st_buf, int* __restrict__ len_buf,
                          int* __restrict__ trips, float* __restrict__ accum,
                          unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);
  const Shading D = make_shading(S, P);
  const bool keep = sample + 1 < P.samples;  // a next sample reads the state
  unsigned long long segs = 0ull;
  OPS_DECL;
  const size_t n = (size_t)P.n_lanes;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = lane < P.n_lanes;
  int len = 0;
  if (valid) {
    uint32_t st = st_buf[lane];
    const V o = mk(ray_buf[lane], ray_buf[n + lane], ray_buf[2 * n + lane]);
    const V d = mk(ray_buf[3 * n + lane], ray_buf[4 * n + lane], ray_buf[5 * n + lane]);
    const V m = mk(ray_buf[6 * n + lane], ray_buf[7 * n + lane], ray_buf[8 * n + lane]);
    V col = mk(col_buf[lane], col_buf[n + lane], col_buf[2 * n + lane]);
    col = add(col, trace_bounces<PAGED, CPU, DROP>(S, P, D, o, d, m, st, true, len OPS_ARG));
    segs = (unsigned long long)len;
    if (keep) {
      st_buf[lane] = st;
      len_buf[lane] = len;
      col_buf[lane] = col.x;
      col_buf[n + lane] = col.y;
      col_buf[2 * n + lane] = col.z;
    } else {  // the pass into the accumulator (pass_body_grid, then accum += col)
      if (P.flags & FLAG_NORMALIZE) col = muls(col, F(1.0 / P.samples));
      float* a = accum + 3 * (size_t)lane;
      a[0] = a[0] + col.x;
      a[1] = a[1] + col.y;
      a[2] = a[2] + col.z;
    }
  }
  add_counters(segs, &s_segs, counters OPS_ARG);
  // the chunk's longest path: a warp's lanes of one chunk together, one atomic each
  const int key = valid && keep ? lane / chunk : -1;
  const unsigned same = __match_any_sync(0xffffffffu, key);
  const int most = __reduce_max_sync(same, len);
  if (key >= 0 && most > 0 && (int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicMax(trips + key * P.samples + sample, most);
}

// the launch plumbing of the classic instance: the Params of a call
inline Params classic_params(Params P, int n_lanes, unsigned int frame_seed, int width, int height, int n_strata,
                             int samples, int n_passes, int max_depth, int rr_threshold, int flags) {
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.n_strata = n_strata; P.samples = samples; P.n_passes = n_passes; P.max_depth = max_depth;
  P.rr_threshold = rr_threshold; P.flags = flags;
  return P;
}

template <bool PAGED, bool CPU, bool DROP = false>
cudaError_t launch_samples(const Tables& T, const Params& P, size_t smem, cudaStream_t stream, const int* px,
                           const int* py, int sample0, int sample1, int chunk, float* col, float* rays,
                           unsigned int* state, int* len, int* trips, float* accum, unsigned long long* march_counters,
                           unsigned long long* counters) {
  auto march = classic_march_kernel<PAGED, CPU>;
  auto bounce = classic_sample_kernel<PAGED, CPU, DROP>;
  cudaError_t e = prepare_launch(march, smem);
  if (e == cudaSuccess) e = prepare_launch(bounce, smem);
  if (e != cudaSuccess) return e;
  const int grid = (P.n_lanes + BLOCK - 1) / BLOCK;
  for (int s = sample0; s < sample1; ++s) {
    march<<<grid, BLOCK, smem, stream>>>(T, P, px, py, s, chunk, col, rays, state, len, trips, march_counters);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    bounce<<<grid, BLOCK, smem, stream>>>(T, P, s, chunk, col, rays, state, len, trips, accum, counters);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// B3 for n rays: under the in-trace fog march trace_march_kernel, then
// trace_bounce_kernel (with pages in persistent blocks, as many as fit), then
// advance_kernel once every block has raised trips[0] (one stream orders
// the three).  The call zeroes counters (and march_counters, which the
// march's launch tallies into where it is not counters) and trips[0].
// ``active`` may be null.
extern "C" int pt_trace_grid(PT_SCENE_PARAMS, const float* ox, const float* oy, const float* oz, int o_stride,
                             const float* dx, const float* dy, const float* dz, int d_stride, const long long* st_in,
                             const unsigned char* active, int n, int max_depth, int rr_threshold, int flags,
                             float* out, int out_comp, int out_lane, long long* st, int* len, int* trips,
                             unsigned long long* counters, unsigned long long* march_counters, void* stream) {
  if (n <= 0) return 0;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n; P.max_depth = max_depth; P.rr_threshold = rr_threshold; P.flags = flags;
  const TraceIO io = {ox, oy, oz, dx, dy, dz, o_stride, d_stride, st_in, active, out, out_comp, out_lane, st, len,
                      trips};
  const size_t smem = scene_smem_bytes(P);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool cpu = flags & FLAG_CPU, march = !cpu && (flags & FLAG_FOG_TRACE);
  const bool paged = n_pages > 0;
  const bool drop = paged && !cpu && (flags & FLAG_DROP_ANY);
  auto bounce = paged ? (cpu    ? trace_bounce_kernel<true, true>
                         : drop ? trace_bounce_kernel<true, false, true> : trace_bounce_kernel<true, false>)
                      : (cpu ? trace_bounce_kernel<false, true> : trace_bounce_kernel<false, false>);
  cudaError_t e = prepare_launch(bounce, smem);
  if (e == cudaSuccess) e = cudaMemsetAsync(counters, 0, sizeof(unsigned long long) * N_COUNTERS, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(trips, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (march) {
    auto kernel = paged ? trace_march_kernel<true> : trace_march_kernel<false>;
    if ((e = prepare_launch(kernel, smem)) != cudaSuccess) return (int)e;
    if (march_counters != counters &&
        (e = cudaMemsetAsync(march_counters, 0, sizeof(unsigned long long) * N_COUNTERS, s)) != cudaSuccess)
      return (int)e;
    kernel<<<grid, BLOCK, smem, s>>>(T, P, io, march_counters);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  int bounce_grid = grid;
  if (paged) {  // persistent: the blocks that fit on the card
    int per_sm = 0, dev = 0, sms = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bounce, BLOCK, smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    bounce_grid = std::min(grid, std::max(per_sm, 1) * sms);
  }
  bounce<<<bounce_grid, BLOCK, smem, s>>>(T, P, io, march ? 1 : 0, counters);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  advance_kernel<<<grid, BLOCK, 0, s>>>(io, n, trip_draws(flags, n_lights), counters);
  return (int)cudaGetLastError();
}

// a window of n_passes passes of the cpu contract (one sample a pass, no fog
// once a pass) for n_lanes pixel lanes, added into accum[n_lanes][3]:
// persistent blocks (as many as fit) whose threads take lanes from
// counters[CURSOR], which the call zeroes
extern "C" int pt_classic_window(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, unsigned int frame_seed,
                                 int width, int height, int n_strata, int n_passes, int max_depth, int rr_threshold,
                                 int flags, float* accum, unsigned long long* counters, void* stream) {
  if (n_lanes <= 0 || n_passes <= 0) return 0;
  if (!(flags & FLAG_CPU) || (flags & FLAG_FOG_ONCE)) return (int)cudaErrorInvalidValue;
  PT_SCENE_UNPACK(T, P0);
  const Params P = classic_params(P0, n_lanes, frame_seed, width, height, n_strata, 1, n_passes, max_depth,
                                  rr_threshold, flags);
  const size_t smem = scene_smem_bytes(P);
  auto kernel = n_pages > 0 ? classic_window_kernel<true> : classic_window_kernel<false>;
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  const int grid = std::min((n_lanes + BLOCK - 1) / BLOCK, std::max(per_sm, 1) * sms);
  e = cudaMemsetAsync(counters + CURSOR, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(T, P, px, py, accum, counters);
  return (int)cudaGetLastError();
}

// samples sample0 .. sample1 - 1 of one pass of the classic loop for n_lanes
// pixel lanes in chunks of ``chunk`` lanes (the last may be short), two
// launches a sample (its ray and march, then its bounces), the last sample
// adding the pass into accum[n_lanes][3]; launched in order on one stream.
// col f32[3][n], state and len [n] carry a lane from one sample to the
// next, rays f32[9][n] from a sample's first launch to its second, trips
// int[n_chunks][samples] the chunks' longest paths (zeroed by the call that
// starts at sample 0).  The march launches add their counts (counting build)
// into march_counters, the bounces' into counters.
extern "C" int pt_classic_samples(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, int chunk,
                                  unsigned int frame_seed, int width, int height, int n_strata, int samples,
                                  int sample0, int sample1, int max_depth, int rr_threshold, int flags, float* col,
                                  float* rays, unsigned int* state, int* len, int* trips, float* accum,
                                  unsigned long long* march_counters, unsigned long long* counters, void* stream) {
  if (n_lanes <= 0 || sample0 >= sample1) return 0;
  if (chunk <= 0 || sample0 < 0 || sample1 > samples) return (int)cudaErrorInvalidValue;
  PT_SCENE_UNPACK(T, P0);
  const Params P = classic_params(P0, n_lanes, frame_seed, width, height, n_strata, samples, 1, max_depth,
                                  rr_threshold, flags);
  const size_t smem = scene_smem_bytes(P);
  const cudaStream_t s = (cudaStream_t)stream;
  if (sample0 == 0) {
    const size_t n_chunks = ((size_t)n_lanes + chunk - 1) / chunk;
    cudaError_t e = cudaMemsetAsync(trips, 0, sizeof(int) * n_chunks * samples, s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool cpu = flags & FLAG_CPU;
  const bool drop = n_pages > 0 && !cpu && (flags & FLAG_DROP_ANY);
  auto run = n_pages > 0 ? (cpu    ? launch_samples<true, true>
                            : drop ? launch_samples<true, false, true> : launch_samples<true, false>)
                         : (cpu ? launch_samples<false, true> : launch_samples<false, false>);
  return (int)run(T, P, smem, s, px, py, sample0, sample1, chunk, col, rays, state, len, trips, accum,
                  march_counters, counters);
}
