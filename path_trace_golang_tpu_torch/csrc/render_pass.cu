// Whole progressive pass of the gpu physics contract with path
// regeneration: the fog-once estimate in its own launch, then the merged
// sample + bounce loop over a whole pass window's lanes in one launch of
// persistent blocks.
//
// Replaces: path_trace_golang_tpu/ops/pallas_trace.py::render_pass_pallas
// (the Pallas kernel that runs render.pass_body_grid -> the fog-once march
// and integrator.pass_regen_gpu for a block of 32x128 lanes).  The classic
// per-sample loop that the same Pallas kernel runs for the cpu contract and
// faithful fog is the classic instance in classic.cu.
//
// What bounds it on an H100: f32 arithmetic outside the tensor cores
// (67 TFLOP/s at 700 W; half of that for multiply-adds built with
// --fmad=false), not bytes.  Each lane reads two int32 pixel coordinates
// and writes three floats, while it runs tens to hundreds of thousands of
// float operations and hash rounds: ray-object tests, the BVH walk over the
// mesh (the node walk up to 128 triangles, the paged walk of
// paged_walk.cuh above), shadow rays for NEE, the fog march with its hash
// noise.
//
// What the design does about that:
// - fog_pass_kernel marches the fog once for each (lane, pass), one thread
//   each: it holds no bounce state, so it runs at its own register budget,
//   and its lanes march in step (FOG_STEPS steps x every light).  Its terms
//   go to device memory (12 bytes a lane and pass), and the loop adds them
//   to a lane's color in pass order, the adds of the plain version.  Its
//   shadow tests held two thirds of its lanes' cycles, each visiting nearly
//   every primitive: the march's shadow cull (common.cuh, shadow_cull) has
//   the warp leave out of a light's tests the primitives that no ray of the
//   warp can reach (1.55 visits a test instead of 13.63 on the showcase).
// - one launch of render_pass_kernel covers a pass window's lanes: one
//   end-of-launch tail a window instead of one a chunk.  The paged instance
//   runs as many blocks as fit on the card, each thread taking the next
//   lane from a global counter when its lane's samples are done, in the same
//   loop, so its threads wait for their warp's slowest lane only when the
//   lanes run out; the page-free instance keeps one thread a lane, whose
//   warps hold neighbouring pixels for their whole life (the persistent form
//   lost 3% there and won 12% on the paged mesh frame: PERF.md).  A lane's
//   result does not depend on the thread or launch that runs it: it is
//   seeded per pixel and pass, and segments are summed exactly.
// - __launch_bounds__ trade registers for warps: the page-free loop runs at
//   48 registers (10 blocks an SM) with spills, which beat 128 registers
//   without them by 1.36x, the fog kernel at 64 (8 blocks; 3% faster than
//   48 with the cull); the paged loop keeps 128.
// - a lane keeps its loop state in registers; the scene tables (materials,
//   objects, lights, mesh rows, BVH nodes, camera basis) are copied once per
//   block into shared memory.  Work whose result a lane does not use is
//   skipped (NEE for lanes that neither are Lambert nor rough metal, shadow
//   rays whose cosine terms already rule them out, shading of missed rays),
//   but every lane still advances its RNG state by exactly the draws that
//   the JAX package and the plain PyTorch version make on that loop
//   iteration (PHYSICS.md D7), so lanes agree one for one with them.
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
//        -Xcompiler -fPIC -o render_pass.so render_pass.cu
// and bound with ctypes through the plain C functions pt_fog_pass(),
// pt_render_pass() and pt_paged_walk() (the paged walk alone, one thread per
// given ray).

#include <algorithm>

#include "common.cuh"

namespace {

// the blocks of 128 threads an SM that ptxas must leave room for (registers
// at most 65,536 / (128 x blocks)): the page-free loop gains from more warps
// to hide its latency despite the spills (10 blocks, 48 registers), the
// paged loop loses (4 blocks, 128 registers), the fog march runs best at 8
// (64 registers); PERF.md, the occupancy A/Bs.
constexpr int B1_MIN_BLOCKS = 10, B1_PAGED_MIN_BLOCKS = 4, FOG_MIN_BLOCKS = 8;

// the fog-once term of pass p for one lane on its own counter stream
// (render.py:232-266): jitter, camera ray and the march, times the gate and
// the pass's samples
template <bool PAGED>
__device__ __forceinline__ V fog_term(const Scene& S, const Params& P, uint32_t px, uint32_t py, int p OPS_PARAM) {
  const bool aperture = P.flags & FLAG_APERTURE, disk = P.flags & FLAG_LENS_DISK;
  const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
  const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
  const float pxf = (float)(int)px;
  const float fy = (float)(P.height - 1) - (float)(int)py;
  const Fog fp = fog_params(S.fog);
  const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
  uint32_t fst = seed_lane(px, py, (P.frame_seed + (uint32_t)p) ^ 0x9E3779B9u);
  float jx = next_u(fst), jy = next_u(fst);
  OPS(2 * C_DRAW + 4 + 2 + 9);
  RNG(3);
  V o, d;
  camera_ray(S, (pxf + jx) * inv_w, (fy + jy) * inv_h, aperture, disk, fst, o, d OPS_ARG);
  return muls(muls(fog_march<PAGED>(S, fp, o, d, fst OPS_ARG), gate), (float)P.samples);
}

// the fog-once terms of every (lane, pass): one thread each, lane fastest;
// terms[p][3][n]
template <bool PAGED>
__global__ void __launch_bounds__(BLOCK, FOG_MIN_BLOCKS)
    fog_pass_kernel(Tables T, Params P, const int* __restrict__ g_px, const int* __restrict__ g_py,
                    float* __restrict__ terms, unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
#ifdef PT_COUNT_OPS
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
#endif
  const Scene S = load_scene(T, P, smem);
  OPS_DECL;
  const long long n = P.n_lanes;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n * P.n_passes) {
    const int lane = (int)(i % n), p = (int)(i / n);
    STAGE_BEGIN(fog_t0);
    const V t = fog_term<PAGED>(S, P, (uint32_t)g_px[lane], (uint32_t)g_py[lane], p OPS_ARG);
    STAGE_END(fog_t0, STAGE_FOG);
    float* out = terms + 3 * (size_t)p * n + lane;
    out[0] = t.x;
    out[n] = t.y;
    out[2 * n] = t.z;
  }
#ifdef PT_COUNT_OPS
  // the counting build's tallies: the march's operations, hash rounds, lane
  // cycles (in all, and the terms' as the fog stage's), its split, the block
  // times
  add_counters(0ull, &s_segs, counters OPS_ARG);
#else
  (void)counters;
#endif
}

// B1's loop (integrator.py:523-744) over a pass window's lanes: one thread
// a lane (page-free), or persistent blocks whose threads take the next lane
// from counters[CURSOR] (zero on entry) when they have finished their last
// one (paged).  A lane starts from its fog terms added in pass order
// (fog_terms, when the flags ask for the fog once a pass); each iteration
// traces one segment: a new sample's camera ray where the path ended
// (reseeding at a pass boundary), else the ray goes on, then one bounce.
template <bool PAGED, bool DROP = false>
__global__ void __launch_bounds__(BLOCK, PAGED ? B1_PAGED_MIN_BLOCKS : B1_MIN_BLOCKS)
    render_pass_kernel(Tables T, Params P, const int* __restrict__ g_px, const int* __restrict__ g_py,
                       const float* __restrict__ fog_terms, float* __restrict__ out,
                       unsigned long long* __restrict__ counters) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);

  unsigned long long segs = 0ull;
  OPS_DECL;
  const bool aperture = P.flags & FLAG_APERTURE, disk = P.flags & FLAG_LENS_DISK;
  const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
  const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
  const float inv_strata = F(1.0 / P.n_strata);
  const int total = P.samples * P.n_passes;
  const size_t n = (size_t)P.n_lanes;
  const Shading D = make_shading(S, P);

  int lane = PAGED ? (int)atomicAdd(counters + CURSOR, 1ull) : (int)(blockIdx.x * blockDim.x + threadIdx.x);
  bool fresh = true;
  uint32_t px = 0, py = 0, st = 0;
  int s = 0, dep = 0, glass_obj = -1;
  float glass_dist = 0.0f;
  bool alive = false;
  V col = mk(0.0f, 0.0f, 0.0f), orig = col, dir = col, thr = col;
  STAGE_BEGIN(loop_t0);
  while (lane < P.n_lanes) {
    if (fresh) {
      px = (uint32_t)g_px[lane];
      py = (uint32_t)g_py[lane];
      col = mk(0.0f, 0.0f, 0.0f);
      if (P.flags & FLAG_FOG_ONCE) {
        for (int p = 0; p < P.n_passes; ++p) {
          const float* t = fog_terms + 3 * (size_t)p * n + lane;
          col = add(col, mk(t[0], t[n], t[2 * n]));
        }
      }
      st = seed_lane(px, py, P.frame_seed);
      RNG(1);
      s = 0;
      alive = false;
      fresh = false;
    }
    const bool regen = !alive;
    int stratum = s;
    if (P.n_passes > 1) {
      int pidx = s / P.samples;
      stratum = s - pidx * P.samples;
      if (regen && s > 0 && stratum == 0) {
        st = seed_lane(px, py, P.frame_seed + (uint32_t)pidx);
        RNG(1);
      }
    }
    float jx = next_u(st), jy = next_u(st);
    OPS(2 * C_DRAW);
    RNG(2);
    if (regen) {
      OPS(10);
      float su = jx, sv = jy;
      if (P.n_strata > 1) {
        su = ((float)(stratum % P.n_strata) + jx) * inv_strata;
        sv = ((float)(stratum / P.n_strata) + jy) * inv_strata;
      }
      const float pxf = (float)(int)px;
      const float fy = (float)(P.height - 1) - (float)(int)py;
      camera_ray(S, (pxf + su) * inv_w, (fy + sv) * inv_h, aperture, disk, st, orig, dir OPS_ARG);
      thr = mk(1.0f, 1.0f, 1.0f);
      dep = 0;
      glass_obj = -1;
      glass_dist = 0.0f;
      s += 1;
    } else if (aperture) {
      skip_u(st, 3);
      RNG(3);
    }
    segs += 1;
    alive = gpu_bounce<PAGED, DROP>(S, P, D, dep, orig, dir, thr, col, st, glass_obj, glass_dist OPS_ARG);
    dep += 1;
    LANE_DONE();
    if (!alive && s >= total) {
      if (P.flags & FLAG_NORMALIZE) col = muls(col, F(1.0 / P.samples));
      out[lane] = col.x;
      out[n + lane] = col.y;
      out[2 * n + lane] = col.z;
      lane = PAGED ? (int)atomicAdd(counters + CURSOR, 1ull) : P.n_lanes;
      fresh = true;
    }
  }
  STAGE_END(loop_t0, STAGE_LOOP);
  add_counters(segs, &s_segs, counters OPS_ARG);
}

}  // namespace

// the fog-once terms of a pass window: terms f32[n_passes][3][n_lanes]
extern "C" int pt_fog_pass(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, unsigned int frame_seed,
                           int width, int height, int samples, int n_passes, int flags, float* terms,
                           unsigned long long* counters, void* stream) {
  if (n_lanes <= 0 || n_passes <= 0) return 0;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.samples = samples; P.n_passes = n_passes; P.flags = flags;
  const size_t smem = scene_smem_bytes(P);
  auto kernel = n_pages > 0 ? fog_pass_kernel<true> : fog_pass_kernel<false>;
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long threads = (long long)n_lanes * n_passes;
  kernel<<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, smem, (cudaStream_t)stream>>>(T, P, px, py, terms,
                                                                                        counters);
  return (int)cudaGetLastError();
}

// B1: a pass window for n_lanes pixel lanes, the fog-once terms from
// pt_fog_pass in fog_terms (null when the flags march no fog once a pass);
// counters[CURSOR] must be zero.  The paged (persistent) instance's grid is
// the blocks that fit on the card.
extern "C" int pt_render_pass(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, unsigned int frame_seed,
                              int width, int height, int n_strata, int samples, int n_passes, int max_depth,
                              int rr_threshold, int flags, const float* fog_terms, float* out,
                              unsigned long long* counters, void* stream) {
  if (n_lanes <= 0) return 0;
  if ((flags & FLAG_FOG_ONCE) && fog_terms == nullptr) return (int)cudaErrorInvalidValue;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.n_strata = n_strata; P.samples = samples; P.n_passes = n_passes; P.max_depth = max_depth;
  P.rr_threshold = rr_threshold; P.flags = flags;
  const bool paged = n_pages > 0;
  const size_t smem = scene_smem_bytes(P);
  auto kernel = !paged ? render_pass_kernel<false>
                : (flags & FLAG_DROP_ANY) ? render_pass_kernel<true, true> : render_pass_kernel<true>;
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (n_lanes + BLOCK - 1) / BLOCK;
  if (paged) {
    int per_sm = 0, dev = 0, sms = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) != cudaSuccess) return (int)e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    grid = std::min(grid, std::max(per_sm, 1) * sms);
  }
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(T, P, px, py, fog_terms, out, counters);
  return (int)cudaGetLastError();
}

// The paged walk alone (paged_walk.cuh): any_hit = 0 writes the closest
// hit's key, page, t, normal, mat and obj, any_hit = 1 writes blocked.
extern "C" int pt_paged_walk(const float* tiles, const float* boxes, int n_pages, int n_sub, const float* rays,
                             const float* excl, const unsigned char* skip, int n, float t_min, int any_hit,
                             int* out_i, float* out_f, unsigned char* blocked, unsigned long long* counters,
                             void* stream) {
  if (n <= 0) return 0;
  paged_walk_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      tiles, boxes, n_pages, n_sub, rays, excl, skip, n, t_min, any_hit, out_i, out_f, blocked, counters);
  return (int)cudaGetLastError();
}
