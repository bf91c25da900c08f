// The classic per-sample loop, one thread per lane: kernel B3 (trace given
// rays) and the classic instance of the whole-pass kernel.
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
// TFLOP/s at 700 W), not bytes: B3 reads 28 bytes a ray and writes 20.
// One thread owns one lane's whole path in registers, the scene tables sit
// in shared memory, and meshes of any size go through intersect<PAGED> and
// occluded<PAGED> as in the regeneration kernel.
//
// What differs from the regeneration loop, and why the state needs care:
// the classic loop of the JAX package runs while any lane of the call is
// alive, and every lane, dead or alive, draws one bounce's quota on every
// trip (PHYSICS.md D7).  A lane's returned state is therefore its state
// after its own L bounces advanced by (T - L) more quotas, where T, the
// trips of the call, is the longest path among its lanes.  A thread stops
// at its own path's end, writes L and raises T with atomicMax; since T is
// known only when every block has finished, the rest is done by a second
// launch: for B3 pt_trace_grid's advance_kernel, for the whole-pass
// instance the next sample's launch, which begins with that advance (one
// sample a launch, the state kept in device memory between launches).
// Draws per trip: the gpu contract's shade draws + 1, the cpu contract's 9.
// The fog march of faithful fog draws 2 per light and step first.
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py like render_pass.cu
// (its own nvcc, its own library) and bound with ctypes through
// pt_trace_grid() and pt_classic_pass().

#include "common.cuh"

namespace {

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
  Hit h = intersect<PAGED>(S, orig, dir, -1, false OPS_ARG);
  if (!h.hit) {
    OPS(C_NORMALIZE + C_BACKGROUND + 6);
    col = add(col, mul(thr, background(S, normalize(dir))));
    skip_u(st, CPU_DRAWS);
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

// one lane of the classic loop for a given ray (integrator.py::_trace_gpu /
// _trace_cpu): the fog march first under faithful fog, then bounces up to
// max_depth.  Returns the radiance; st advances by the fog march's draws
// and one quota per own bounce, len receives the lane's bounces.  An
// inactive lane marches nothing and bounces never, but draws the march's
// quota all the same.
template <bool PAGED, bool CPU>
__device__ __forceinline__ V trace_lane(const Scene& S, const Params& P, const Shading& D, V orig, V dir,
                                        uint32_t& st, bool active, int& len OPS_PARAM) {
  V col = mk(0.0f, 0.0f, 0.0f);
  if (!CPU && (P.flags & FLAG_FOG_TRACE)) {
    if (active) {
      const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
      col = muls(fog_march<PAGED>(S, fog_params(S.fog), orig, dir, st OPS_ARG), gate);
    } else {
      skip_u(st, FOG_STEPS * 2 * S.n_lights);
    }
  }
  V thr = mk(1.0f, 1.0f, 1.0f);
  int glass_obj = -1;
  float glass_dist = 0.0f;
  bool alive = active;
  len = 0;
  for (int dep = 0; alive && dep < P.max_depth; ++dep) {
    len += 1;
    if constexpr (CPU)
      alive = cpu_bounce<PAGED>(S, P, dep, orig, dir, thr, col, st OPS_ARG);
    else
      alive = gpu_bounce<PAGED>(S, P, D, dep, orig, dir, thr, col, st, glass_obj, glass_dist OPS_ARG);
  }
  return col;
}

// kernel B3: rays[6][n] (origin, direction), states and an optional active
// mask in; radiance[3][n], the states after the lane's own path, its path
// length, and the call's trips (atomicMax) and segments out
template <bool PAGED, bool CPU>
__global__ void __launch_bounds__(BLOCK) trace_grid_kernel(Tables T, Params P, const float* __restrict__ rays,
                                                           const uint32_t* __restrict__ st_in,
                                                           const unsigned char* __restrict__ active,
                                                           float* __restrict__ out, uint32_t* __restrict__ st_out,
                                                           int* __restrict__ len_out, int* __restrict__ trips,
                                                           unsigned long long* __restrict__ segs_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  __shared__ int s_trips;
  if (threadIdx.x == 0) { s_segs = 0ull; s_trips = 0; }
  const Scene S = load_scene(T, P, smem);
  const Shading D = make_shading(S, P);
  unsigned long long segs = 0ull;
  OPS_DECL;
  const int n = P.n_lanes;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) {
    V o = mk(rays[lane], rays[n + lane], rays[2 * n + lane]);
    V d = mk(rays[3 * n + lane], rays[4 * n + lane], rays[5 * n + lane]);
    uint32_t st = st_in[lane];
    int len;
    V rad = trace_lane<PAGED, CPU>(S, P, D, o, d, st, active == nullptr || active[lane] != 0, len OPS_ARG);
    out[lane] = rad.x;
    out[n + lane] = rad.y;
    out[2 * n + lane] = rad.z;
    st_out[lane] = st;
    len_out[lane] = len;
    segs = (unsigned long long)len;
    if (len) atomicMax(&s_trips, len);
  }
  add_counters(segs, &s_segs, segs_out OPS_ARG);
  if (threadIdx.x == 0 && s_trips) atomicMax(trips, s_trips);
}

// the draws that the call's other trips take: (T - L) quotas for each lane
__global__ void __launch_bounds__(BLOCK) advance_kernel(uint32_t* __restrict__ st, const int* __restrict__ len,
                                                        const int* __restrict__ trips, int n, int draws) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) {
    uint32_t s = st[lane];
    skip_u(s, (*trips - len[lane]) * draws);
    st[lane] = s;
  }
}

// the classic instance of the whole-pass kernel: sample ``sample`` of a pass
// (render.py:296-322) for pixel lanes.  Sample 0 seeds the lane and adds the
// fog-once estimate where the flags ask for it; a later sample first
// advances the state that the previous launch left by the previous sample's
// other trips.  Then two jitter draws, the stratum, the camera ray, the
// trace; the radiance adds into out[3][n].  The state, path length and trips
// are kept for the next sample.
template <bool PAGED, bool CPU>
__global__ void __launch_bounds__(BLOCK) classic_pass_kernel(Tables T, Params P, const int* __restrict__ g_px,
                                                             const int* __restrict__ g_py, int sample,
                                                             float* __restrict__ out, uint32_t* __restrict__ st_buf,
                                                             int* __restrict__ len_buf, int* __restrict__ trips,
                                                             unsigned long long* __restrict__ segs_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  __shared__ int s_trips;
  if (threadIdx.x == 0) { s_segs = 0ull; s_trips = 0; }
  const Scene S = load_scene(T, P, smem);
  const Shading D = make_shading(S, P);
  const bool aperture = P.flags & FLAG_APERTURE, disk = P.flags & FLAG_LENS_DISK;
  const bool keep = sample + 1 < P.samples;  // a next sample reads the state
  unsigned long long segs = 0ull;
  OPS_DECL;
  const int n = P.n_lanes;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) {
    const uint32_t px = (uint32_t)g_px[lane], py = (uint32_t)g_py[lane];
    const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
    const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
    const float pxf = (float)(int)px;
    const float fy = (float)(P.height - 1) - (float)(int)py;
    uint32_t st;
    V col = mk(0.0f, 0.0f, 0.0f);
    if (sample == 0) {
      st = seed_lane(px, py, P.frame_seed);
      if (P.flags & FLAG_FOG_ONCE) {  // one pass: the fog estimate on its own stream (render.py:232-266)
        const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
        uint32_t fst = seed_lane(px, py, P.frame_seed ^ 0x9E3779B9u);
        float jx = next_u(fst), jy = next_u(fst);
        OPS(2 * C_DRAW + 4 + 2 + 9);
        V o, d;
        camera_ray(S, (pxf + jx) * inv_w, (fy + jy) * inv_h, aperture, disk, fst, o, d OPS_ARG);
        col = muls(muls(fog_march<PAGED>(S, fog_params(S.fog), o, d, fst OPS_ARG), gate), (float)P.samples);
      }
    } else {
      st = st_buf[lane];
      skip_u(st, (trips[sample - 1] - len_buf[lane]) * trip_draws(P.flags, P.n_lights));
      col = mk(out[lane], out[n + lane], out[2 * n + lane]);
    }
    float jx = next_u(st), jy = next_u(st);
    OPS(2 * C_DRAW + 10);
    float su = jx, sv = jy;
    if (P.n_strata > 1) {
      const float inv_strata = F(1.0 / P.n_strata);
      su = (jx + (float)(sample % P.n_strata)) * inv_strata;
      sv = (jy + (float)(sample / P.n_strata)) * inv_strata;
    }
    V o, d;
    camera_ray(S, (pxf + su) * inv_w, (fy + sv) * inv_h, aperture, disk, st, o, d OPS_ARG);
    int len;
    col = add(col, trace_lane<PAGED, CPU>(S, P, D, o, d, st, true, len OPS_ARG));
    segs = (unsigned long long)len;
    if (keep) {
      st_buf[lane] = st;
      len_buf[lane] = len;
      if (len) atomicMax(&s_trips, len);
    } else if (P.flags & FLAG_NORMALIZE) {
      col = muls(col, F(1.0 / P.samples));
    }
    out[lane] = col.x;
    out[n + lane] = col.y;
    out[2 * n + lane] = col.z;
  }
  add_counters(segs, &s_segs, segs_out OPS_ARG);
  if (threadIdx.x == 0 && keep && s_trips) atomicMax(trips + sample, s_trips);
}

}  // namespace

// B3 for n rays: trace_grid_kernel, then advance_kernel once every block has
// raised trips[0] (the same stream orders the two).  ``active`` may be null.
extern "C" int pt_trace_grid(PT_SCENE_PARAMS, const float* rays, const unsigned int* st_in,
                             const unsigned char* active, int n, int max_depth, int rr_threshold, int flags,
                             float* out, unsigned int* st_out, int* len, int* trips, unsigned long long* segs,
                             void* stream) {
  if (n <= 0) return 0;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n; P.max_depth = max_depth; P.rr_threshold = rr_threshold; P.flags = flags;
  const size_t smem = scene_smem_bytes(P);
  const bool cpu = flags & FLAG_CPU;
  auto kernel = n_pages > 0 ? (cpu ? trace_grid_kernel<true, true> : trace_grid_kernel<true, false>)
                            : (cpu ? trace_grid_kernel<false, true> : trace_grid_kernel<false, false>);
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(T, P, rays, st_in, active, out, st_out, len, trips, segs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  advance_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(st_out, len, trips, n, trip_draws(flags, n_lights));
  return (int)cudaGetLastError();
}

// sample ``sample`` of one pass of the classic loop for n pixel lanes;
// the caller launches samples 0 .. samples - 1 in order on one stream, with
// trips[samples] zeroed and out, state and len of n lanes each
extern "C" int pt_classic_pass(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, unsigned int frame_seed,
                               int width, int height, int n_strata, int samples, int sample, int max_depth,
                               int rr_threshold, int flags, float* out, unsigned int* state, int* len, int* trips,
                               unsigned long long* segs, void* stream) {
  if (n_lanes <= 0) return 0;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.n_strata = n_strata; P.samples = samples; P.n_passes = 1; P.max_depth = max_depth;
  P.rr_threshold = rr_threshold; P.flags = flags;
  const size_t smem = scene_smem_bytes(P);
  const bool cpu = flags & FLAG_CPU;
  auto kernel = n_pages > 0 ? (cpu ? classic_pass_kernel<true, true> : classic_pass_kernel<true, false>)
                            : (cpu ? classic_pass_kernel<false, true> : classic_pass_kernel<false, false>);
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(n_lanes + BLOCK - 1) / BLOCK, BLOCK, smem, (cudaStream_t)stream>>>(T, P, px, py, sample, out, state,
                                                                              len, trips, segs);
  return (int)cudaGetLastError();
}
