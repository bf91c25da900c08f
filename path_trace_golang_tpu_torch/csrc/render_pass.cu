// Whole progressive pass of the gpu physics contract with path
// regeneration, one thread per pixel lane.
//
// Replaces: path_trace_golang_tpu/ops/pallas_trace.py::render_pass_pallas
// (the Pallas kernel that runs render.pass_body_grid -> the fog-once march
// and integrator.pass_regen_gpu for a block of 32x128 lanes).  The classic
// per-sample loop that the same Pallas kernel runs for the cpu contract and
// faithful fog is the classic instance in classic.cu.
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
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
//        -Xcompiler -fPIC -o render_pass.so render_pass.cu
// and bound with ctypes through the plain C functions pt_render_pass() and
// pt_paged_walk() (the paged walk alone, one thread per given ray).

#include "common.cuh"

namespace {

template <bool PAGED>
__global__ void __launch_bounds__(BLOCK) render_pass_kernel(Tables T, Params P, const int* __restrict__ g_px,
                                                            const int* __restrict__ g_py, float* __restrict__ out,
                                                            unsigned long long* __restrict__ segs_out) {
  extern __shared__ float smem[];
  __shared__ unsigned long long s_segs;
  if (threadIdx.x == 0) s_segs = 0ull;
  const Scene S = load_scene(T, P, smem);
  const bool aperture = P.flags & FLAG_APERTURE, disk = P.flags & FLAG_LENS_DISK;

  unsigned long long segs = 0ull;
  OPS_DECL;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < P.n_lanes) {
    const uint32_t px = (uint32_t)g_px[lane], py = (uint32_t)g_py[lane];
    const float inv_w = 1.0f / (float)(P.width > 1 ? P.width - 1 : 1);
    const float inv_h = 1.0f / (float)(P.height > 1 ? P.height - 1 : 1);
    const float pxf = (float)(int)px;
    const float fy = (float)(P.height - 1) - (float)(int)py;
    const float inv_strata = F(1.0 / P.n_strata);
    const int total = P.samples * P.n_passes;
    // built here and the Fog below where they are used: ptxas then gives the
    // page-free instance 123 registers; built at the kernel's top, 128
    const Shading D = make_shading(S, P);

    V col = mk(0.0f, 0.0f, 0.0f);

    // ---- fog once per pass on its own counter stream (render.py:232-266)
    if (P.flags & FLAG_FOG_ONCE) {
      const Fog fp = fog_params(S.fog);
      const float gate = S.fog[3] > 0.5f ? 1.0f : 0.0f;
      for (int p = 0; p < P.n_passes; ++p) {
        uint32_t fst = seed_lane(px, py, (P.frame_seed + (uint32_t)p) ^ 0x9E3779B9u);
        float jx = next_u(fst), jy = next_u(fst);
        OPS(2 * C_DRAW + 4 + 2 + 9);
        V o, d;
        camera_ray(S, (pxf + jx) * inv_w, (fy + jy) * inv_h, aperture, disk, fst, o, d OPS_ARG);
        V rad = fog_march<PAGED>(S, fp, o, d, fst OPS_ARG);
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
      segs += 1;
      alive = gpu_bounce<PAGED>(S, P, D, dep, orig, dir, thr, col, st, glass_obj, glass_dist OPS_ARG);
      dep += 1;
    }
    if (P.flags & FLAG_NORMALIZE) col = muls(col, F(1.0 / P.samples));
    out[lane] = col.x;
    out[P.n_lanes + lane] = col.y;
    out[2 * P.n_lanes + lane] = col.z;
  }
  add_counters(segs, &s_segs, segs_out OPS_ARG);
}

}  // namespace

extern "C" int pt_render_pass(PT_SCENE_PARAMS, const int* px, const int* py, int n_lanes, unsigned int frame_seed,
                              int width, int height, int n_strata, int samples, int n_passes, int max_depth,
                              int rr_threshold, int flags, float* out, unsigned long long* segs, void* stream) {
  if (n_lanes <= 0) return 0;
  PT_SCENE_UNPACK(T, P);
  P.n_lanes = n_lanes; P.frame_seed = frame_seed; P.width = width; P.height = height;
  P.n_strata = n_strata; P.samples = samples; P.n_passes = n_passes; P.max_depth = max_depth;
  P.rr_threshold = rr_threshold; P.flags = flags;
  const size_t smem = scene_smem_bytes(P);
  auto kernel = n_pages > 0 ? render_pass_kernel<true> : render_pass_kernel<false>;
  cudaError_t e = prepare_launch(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (n_lanes + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(T, P, px, py, out, segs);
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
