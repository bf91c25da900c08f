// The perf probes T1-T4 on Hopper: each a TPU probe of the JAX package's
// tools/perf/ redone as a CUDA kernel, with the plain PyTorch version of
// ops/probes.py beside it.  A probe's kernel is its measurement, so each is
// simple and says what it times.
//
// T1 op_chain_kernel      replaces tools/perf/microbench.py::_bench
// T2 paged_probe_kernel   replaces tools/perf/paged_probe.py::make_fn
// T3 tile_fetch_kernel    replaces tools/perf/fetch_probe.py::make_fn
// T4 fetch_attrib_kernel  replaces tools/perf/fetch_probe2.py::make_fn
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py like the renderer's
// kernels (nvcc for sm_90a, -O3 --fmad=false, no fast math), so that T1's
// multiply-add classes time what the renderer's own code compiles to, and
// bound with ctypes through the plain C functions at the end.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// T1: op throughput.  Replaces microbench.py::_bench, which runs ITERS
// iterations of 64 dependent ops of one class (the hash: 16 rounds) on one
// VMEM-resident f32[256,128] block and chains 20 calls.
//
// What bounds it: the op itself, the chain's latency at a few threads an SM
// and the issue rate of the op's unit on a full card.  One thread runs
// `ILP` independent chains (elements t, t + T, ... for T threads), each in
// registers for the whole launch; nothing leaves the chip but the result,
// which the wrapper's caller checks, so nvcc cannot drop the loop.  Under
// --fmad=false the `fma` class compiles to FMUL + FADD, as every multiply-
// add of the renderer's kernels does; `ffma` is one FFMA (__fmaf_rn), the
// slot that the 67 TFLOP/s f32 peak counts twice.
// ---------------------------------------------------------------------------

enum OpKind { K_FMA, K_FFMA, K_SQRT, K_RSQRT, K_DIVIDE, K_EXP, K_SIN, K_HASH, K_SELECT };

template <int KIND>
struct OpInner {
  static constexpr int value = 64;
};
template <>
struct OpInner<K_HASH> {
  static constexpr int value = 16;
};

__device__ __forceinline__ uint32_t probe_hash_round(uint32_t s) {
  s ^= s >> 17;
  s *= 0xED5AD4BBu;
  s ^= s >> 11;
  s *= 0xAC4C1B51u;
  s ^= s >> 15;
  s *= 0x31848BABu;
  s ^= s >> 14;
  return s;
}

// one iteration: OpInner<KIND> ops of the class (microbench.py:71-138)
template <int KIND>
__device__ __forceinline__ float op_iteration(float x) {
  if constexpr (KIND == K_HASH) {
    uint32_t s = __float_as_uint(x);
#pragma unroll
    for (int k = 0; k < OpInner<KIND>::value; ++k) s = probe_hash_round(s);
    return (float)(int)s * __int_as_float(0x2F800000) + 0.5f;  // * 2^-32
  } else {
#pragma unroll
    for (int k = 0; k < OpInner<KIND>::value; ++k) {
      if constexpr (KIND == K_FMA) x = x * F(1.000001) + F(1e-7);
      else if constexpr (KIND == K_FFMA) x = __fmaf_rn(x, F(1.000001), F(1e-7));
      else if constexpr (KIND == K_SQRT) x = sqrtf(x + F(0.31));
      else if constexpr (KIND == K_RSQRT) x = rsqrtf(x + F(0.77));
      else if constexpr (KIND == K_DIVIDE) x = F(1.37) / (x + F(1.11));
      else if constexpr (KIND == K_EXP) x = expf(-x) + F(0.1);
      else if constexpr (KIND == K_SIN) x = sinf(x) + F(0.7);
      else x = x > 0.5f ? x * F(0.731) : x + F(0.31);
    }
    return x;
  }
}

template <int KIND, int ILP>
__global__ void __launch_bounds__(256) op_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                       int threads, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  float v[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) v[j] = x[t + j * threads];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) v[j] = op_iteration<KIND>(v[j]);
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) out[t + j * threads] = v[j];
}

template <int KIND>
int launch_op_chain(const float* x, float* out, int n, int iters, int ilp, cudaStream_t stream) {
  const int threads = n / ilp, grid = (threads + 255) / 256;
  if (ilp == 1) op_chain_kernel<KIND, 1><<<grid, 256, 0, stream>>>(x, out, threads, iters);
  else op_chain_kernel<KIND, 4><<<grid, 256, 0, stream>>>(x, out, threads, iters);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T2: the paged sweep.  Replaces paged_probe.py::make_fn, whose Pallas
// kernel runs REPS traversals of one block of 32x128 rays over the paged
// table of a 10,240-triangle sphere and returns per-ray winner keys.
//
// On the tiles, boxes and device functions of kernel B2 (paged_walk.cuh:
// page_wanted, page_key_lane, paged_keys_lane, paged_traverse).
// What bounds it: f32 work of 32 operations per (row, ray) pair and 22 per
// box test, fed from the 1.3 MB table in L2; the variants take the walk
// apart, one thread per ray except in `real`:
//   fetch   one tile element a page (the load floor; the element's index
//           depends on the chained key, so nvcc cannot hoist the loop),
//   all     every page swept by every ray, no entry test,
//   dense   the TPU kernel's block cursor mapped to a warp: the warp visits
//           the union of its 32 rays' wanted pages in ascending order
//           (__reduce_min_sync over each ray's next wanted page) and every
//           thread sweeps each visited page,
//   gather  B2's per-thread walk, keys only (paged_keys_lane: a ray sweeps
//           the pages it enters),
//   real    B2 as the kernels run it (paged_traverse: the warp-cooperative
//           walk, then the winner's exact t and normal) and the merge of
//           its t into the ray's best distance, as intersect() in
//           common.cuh merges it; the result is the bits of that distance
//           (the merged normal, material and object are unused here, as in
//           the JAX probe, and compiled away).  Against `gather` it is the
//           A/B of the cooperative walk against the per-thread one.
// The traversals of one launch are chained through the key: a traversal
// starts 1e-6 further in x when the previous one returned PROBE_MAGIC.
// ---------------------------------------------------------------------------

enum PagedVariant { V_FETCH, V_ALL, V_DENSE, V_GATHER, V_REAL };
constexpr int PROBE_MAGIC = 0x12345678;

constexpr int PAGE_DONE = 0x7fffffff;  // a cursor past every page

// the first page at or after `from` that the ray enters, else PAGE_DONE
// (the `dense` variant's cursor)
__device__ __forceinline__ int next_page(const Pages& G, int from, V o, V inv, float t_min, float best_t,
                                         float t_max OPS_PARAM) {
  for (int p = from; p < G.n_pages; ++p)
    if (page_wanted(G, p, o, inv, t_min, best_t, t_max OPS_ARG)) return p;
  return PAGE_DONE;
}

__device__ __forceinline__ int sweep_page(const Pages& G, int p, V o, V d, float t_min, int best_key OPS_PARAM) {
  const int page_key = page_key_lane(G.tiles, p, o, d, t_min, __int_as_float(best_key | KEY_SLOT_MASK),
                                     __int_as_float(0x7f800000), -1.0f OPS_ARG);
  return page_key < best_key ? page_key : best_key;
}

template <int VARIANT>
__device__ __forceinline__ int probe_traversal(const Pages& G, V o, V d, V inv, float t_min, float best_t, int key,
                                               bool live OPS_PARAM) {
  const float inf = __int_as_float(0x7f800000);
  const int key0 = __float_as_int(best_t + o.x * 0.0f) | KEY_SLOT_MASK;
  if constexpr (VARIANT == V_FETCH) {
    const int sel = key == PROBE_MAGIC;
    unsigned acc = 0u;
    for (int p = 0; p < G.n_pages; ++p) acc += (unsigned)(int)G.tiles[(size_t)p * PAGE_TRIS * PAGE_ATTRS + sel];
    return (int)((unsigned)key0 + acc);
  } else if constexpr (VARIANT == V_ALL) {
    int best_key = key0;
    for (int p = 0; p < G.n_pages; ++p) best_key = sweep_page(G, p, o, d, t_min, best_key OPS_ARG);
    return best_key;
  } else if constexpr (VARIANT == V_GATHER) {
    int best_key = key0, best_page = -1;
    if (live) paged_keys_lane(G, o, d, inv, t_min, best_t, inf, -1.0f, best_key, best_page OPS_ARG);
    return best_key;
  } else if constexpr (VARIANT == V_DENSE) {
    // every thread of the warp runs this loop to the end: the vote needs all 32
    int best_key = key0;
    int cursor = live ? next_page(G, 0, o, inv, t_min, best_t, inf OPS_ARG) : PAGE_DONE;
    for (;;) {
      const int p = __reduce_min_sync(0xffffffffu, cursor);
      if (p == PAGE_DONE) break;
      best_key = sweep_page(G, p, o, d, t_min, best_key OPS_ARG);
      if (cursor == p) cursor = next_page(G, p + 1, o, inv, t_min, best_t, inf OPS_ARG);
    }
    return best_key;
  } else {
    if (!live) return key0;
    PagedWinner w = paged_traverse(G, o, d, inv, t_min, best_t, inf, -1.0f OPS_ARG);
    float t = best_t;
    if (w.hit && w.t < t) t = w.t;
    return __float_as_int(t);
  }
}

// rays f32[6, n]: ox oy oz dx dy dz; out i32[n]; ops: one uint64 (counting build)
template <int VARIANT>
__global__ void __launch_bounds__(128) paged_probe_kernel(Pages G, const float* __restrict__ rays, int n, int reps,
                                                          float t_min, float best_t, int* __restrict__ out,
                                                          unsigned long long* __restrict__ ops_out) {
  OPS_DECL;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int j = live ? i : n - 1;  // a tail thread stays in its warp (dense) and wants no page
  const V o0 = mk(rays[j], rays[n + j], rays[2 * n + j]);
  const V d = mk(rays[3 * n + j], rays[4 * n + j], rays[5 * n + j]);
  const V inv = mk(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  OPS(3);
  int key = 0;
  for (int r = 0; r < reps; ++r) {
    const float eps = key == PROBE_MAGIC ? F(1e-6) : 0.0f;
    const V o = mk(o0.x + eps, o0.y, o0.z);
    OPS(1);
    key = probe_traversal<VARIANT>(G, o, d, inv, t_min, best_t, key, live OPS_ARG);
  }
  if (live) out[i] = key;
#ifdef PT_COUNT_OPS
  unsigned long long all = live ? ops.all : 0ull;
  for (int off = 16; off > 0; off >>= 1) all += __shfl_down_sync(0xffffffffu, all, off);
  if ((threadIdx.x & 31) == 0 && all) atomicAdd(ops_out, all);
#else
  (void)ops_out;
#endif
}

// ---------------------------------------------------------------------------
// T3: one page tile's fetch, by layout.  Replaces fetch_probe.py::make_fn:
// a block of 32x128 outputs loops over the P page tiles of a VMEM table at
// a traced index and adds each tile's first and last element.
//
// Here a tile moves whole into shared memory, as a redesigned walk would
// stage it: layouts a (P,128,32), b (P,32,128) and c (P*32,128) are the same
// 16 KB of contiguous bytes, d (P*8,128) 4 KB.  What bounds it: every block
// stages every tile, so a block's P tiles pass through its SM's port from
// L2 (the 1.3 MB table stays in the 50 MB L2); on the TPU grid of 16 blocks
// each SM holds one block, and the block's P x 16 KB at the rate one SM
// takes bytes in (~145 GB/s, the slope of the full-card grid's time against
// P: PERF.md) is ~9 us beside the launch.  A first design waited on each
// tile's copy before it issued the next: P dependent round trips of ~0.4 us.
//
// Design: a ring of TILE_STAGES = 3 tiles in shared memory, each stage with
// its own mbarrier.  Thread 0 keeps three tiles in flight: it issues each
// whole tile as one bulk copy (cp.async.bulk, the TMA's one-dimensional
// form: the hardware moves the bytes and reports them to the stage's
// mbarrier), waits on the stages in page order, adds the tile's (first +
// last) to acc and issues the tile three pages on into the stage it has
// read.  The same ring serves all four layouts (one tile a stage, 16 KB or
// 4 KB).  acc runs over the pages in order from 0.0f, one rounding a page
// as in the plain version, so the result is bit-identical at every p (p = 0
// included: x + 0.0f).  The other threads wait at one barrier and then
// write x + acc, as before.
//
// What the 16-block grid reads: ~0.11 us a tile for every layout, 16 KB or
// 4 KB.  Layout a runs at the SM's ingest rate; d, whose 4 KB would take a
// quarter of that, reads how fast one block's bulk copies come back.  Thread
// 0's loop (split by clock64 in the counting build: the tile's reads, the
// fence, the issue and the wait) takes about that long a tile; with the loop
// split over a producer lane and a consumer thread (an "empty" mbarrier a
// stage beside the "full" one) both threads wait and the tiles still come
// one per ~0.11 us a block, at 3 or 4 stages; a ring of 12 tiles of d,
// 16-byte cp.async by every thread, and a warp issuing in rounds did no
// better or lost (PERF.md).  So on 16 blocks the comparison between layouts
// measures this issue loop, not the layouts' bytes; the full-card grid,
// several blocks an SM, still tells d from a.  At 3 stages a block of a
// takes 48 KB, so the full-card grid keeps 4 of its 8 blocks an SM
// resident, with 12 tiles in flight an SM where the first design had 8; at
// 4 stages (3 blocks) it ran slower.
// ---------------------------------------------------------------------------

// 16-byte cp.async (T4 stages its slabs so)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

constexpr int PROBE_ROWS = 32, PROBE_LANE = 128, PROBE_BLOCK = 256;
constexpr int TILE_STAGES = 3;  // T3's ring: whole tiles in flight a block (ops/probes.py mirrors it)

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// the stage's copy: one arrival that expects `bytes`, then the bulk copy that delivers them
__device__ __forceinline__ void stage_tile(unsigned long long* bar, float* dst, const float* src, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void stage_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

#ifdef PT_COUNT_OPS
// T3's split in the counting build (-DPT_COUNT_OPS): thread 0's clock
// cycles in the ring's loop by step (the wait for the tile, its two reads
// and the add, the proxy fence, the next tile's issue) and over the whole
// loop, each block's sums added here, then the blocks (ops/probes.py,
// tile_fetch_split, reads and resets them).
constexpr int T3_SLOTS = 5;
__device__ unsigned long long g_t3_clocks[T3_SLOTS + 1];
#define T3_CLOCK(v) const long long v = clock64()
#define T3_ADD(slot, a, b) t3_sum[slot] += (unsigned long long)((b) - (a))
#else
#define T3_CLOCK(v)
#define T3_ADD(slot, a, b)
#endif

template <int ELEMS>
__global__ void __launch_bounds__(PROBE_BLOCK) tile_fetch_kernel(const float* __restrict__ table,
                                                                 const float* __restrict__ x, float* __restrict__ out,
                                                                 int p) {
  extern __shared__ __align__(128) float s_ring[];  // TILE_STAGES x ELEMS
  __shared__ __align__(8) unsigned long long s_full[TILE_STAGES];
  __shared__ float s_acc;
  if (threadIdx.x == 0) {
#ifdef PT_COUNT_OPS
    unsigned long long t3_sum[T3_SLOTS] = {};
#endif
    T3_CLOCK(l0);
    constexpr unsigned bytes = ELEMS * 4u;
    const int first = min(p, TILE_STAGES);
    for (int k = 0; k < first; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&s_full[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < first; ++q) stage_tile(&s_full[q], s_ring + q * ELEMS, table + (size_t)q * ELEMS, bytes);
    float acc = 0.0f;
    unsigned parity = 0;
    for (int q = 0, k = 0; q < p; ++q) {
      T3_CLOCK(c0);
      stage_wait(&s_full[k], parity);
      T3_CLOCK(c1);
      const float* s = s_ring + k * ELEMS;
      acc = acc + (s[0] + s[ELEMS - 1]);
      T3_CLOCK(c2);
      T3_ADD(0, c0, c1);
      T3_ADD(1, c1, c2);
      if (q + TILE_STAGES < p) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reads above before the copy over them
        T3_CLOCK(c3);
        stage_tile(&s_full[k], s_ring + k * ELEMS, table + (size_t)(q + TILE_STAGES) * ELEMS, bytes);
        T3_CLOCK(c4);
        T3_ADD(2, c2, c3);
        T3_ADD(3, c3, c4);
      }
      if (++k == TILE_STAGES) k = 0, parity ^= 1u;
    }
    s_acc = acc;
#ifdef PT_COUNT_OPS
    T3_CLOCK(l1);
    T3_ADD(4, l0, l1);
    for (int k = 0; k < T3_SLOTS; ++k) atomicAdd(&g_t3_clocks[k], t3_sum[k]);
    atomicAdd(&g_t3_clocks[T3_SLOTS], 1ull);
#endif
  }
  __syncthreads();
  const float acc = s_acc;
  const size_t base = (size_t)blockIdx.x * PROBE_ROWS * PROBE_LANE;
  for (int k = threadIdx.x; k < PROBE_ROWS * PROBE_LANE; k += PROBE_BLOCK) out[base + k] = x[base + k] + acc;
}

// T3's launch for a tile of ELEMS floats: its ring of TILE_STAGES tiles is allowed once a device (a, b and c
// take 48 KB, above what a launch may take without asking)
template <int ELEMS>
int launch_tile_fetch(const float* table, const float* x, float* out, int p, int blocks, cudaStream_t s) {
  constexpr int RING = TILE_STAGES * ELEMS * (int)sizeof(float);
  constexpr int MAX_DEVICES = 64;
  static bool ring_allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ring_allowed[dev]) {
    e = cudaFuncSetAttribute(tile_fetch_kernel<ELEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
    if (e != cudaSuccess) return (int)e;
    ring_allowed[dev] = true;
  }
  tile_fetch_kernel<ELEMS><<<blocks, PROBE_BLOCK, RING, s>>>(table, x, out, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T4: the fetch's cost taken apart.  Replaces fetch_probe2.py::make_fn, five
// Pallas kernels over a f32[P*32,128] table read as P tiles of 32x128.
//   loop_only   x + sum of q: the loop alone, nothing read,
//   dyn_row     x + sum of each tile's first row: one 512-byte row a page,
//               a float per thread of the first 128,
//   dyn_vec     x + column sums of the elementwise sum of the tiles, summed
//               in page order, then over rows 0..31 in order,
//   static_vec  the same with the page count fixed at 80 and the page loop
//               unrolled,
//   dyn_scalar  x + sum of each tile's first element (one broadcast load).
// loop_only, dyn_row and dyn_scalar run one block per 32x128 output tile
// (fetch_attrib_kernel); with 16 blocks what bounds them is the latency of
// the dependent page loop.
//
// dyn_vec and static_vec (fetch_colsum_kernel) spread the 4,096 chains of
// the table's elements over the card.  Column c's output needs only column
// c of every tile, so a block owns a slice of 8 columns (one 32-byte sector
// a row) and all 32 rows of it: 16 blocks cover the table, each reading
// its 80 KB slab of the 1.3 MB once, where a block of the first design
// read the whole table (16 times over at 16 blocks).  The block stages the
// slab in shared memory with 16-byte cp.async, every thread issuing its
// share at once so that the whole slab is in flight; neighbouring threads
// copy neighbouring 16-byte pieces, 32-byte runs a row, so each sector the
// copy moves is used whole.  Then 64 threads sum their element's chain in
// page order from shared memory (a float4 of one row each), 8 threads sum
// the rows in order, and the block writes out[:, slice] = x[:, slice] + col
// itself: one launch, where a pass for col and a pass for out would pay the
// launch floor (~2.2 us, perf probe T7) twice.  The output rows are split
// over gridDim.y groups of at most 4,096 rows, and each group re-reads its
// 80 KB slab from L2: at the 16-block grid there is one group (each table
// byte read once); a full-card grid (1,056 blocks, 34 MB of x and out)
// takes 9 groups, 144 blocks, 11.8 MB of L2 reads beside the 34 MB that
// have to cross HBM.  What bounds it at 16 blocks: the launch, then one
// round trip of the staged slab over one SM's L2 port; on a full card,
// HBM bandwidth for x and out.
// ---------------------------------------------------------------------------

enum FetchVariant { F_LOOP_ONLY, F_DYN_ROW, F_DYN_VEC, F_STATIC_VEC, F_DYN_SCALAR };
constexpr int STATIC_PAGES = 80;
constexpr int TILE4 = PROBE_ROWS * PROBE_LANE / 4;    // float4 in one 32x128 tile
constexpr int ROW4 = PROBE_LANE / 4;                  // float4 in one row
constexpr int SLICE4 = 2;                             // float4 columns a block owns: 8 floats, 32 bytes a row
constexpr int SLICES = ROW4 / SLICE4;                 // 16 blocks cover the 128 columns
constexpr int SLAB4 = PROBE_ROWS * SLICE4;            // float4 of one tile's slice: 64, one chain each
constexpr int STAGE_PAGES = STATIC_PAGES;             // pages staged at a time: 80 KB of shared memory
constexpr int GROUP_ROWS = 128 * PROBE_ROWS;          // output rows a block writes at most

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x = a.x + b.x;
  a.y = a.y + b.y;
  a.z = a.z + b.z;
  a.w = a.w + b.w;
}

template <int VARIANT>
__global__ void __launch_bounds__(PROBE_BLOCK) fetch_attrib_kernel(const float* __restrict__ table,
                                                                   const float* __restrict__ x,
                                                                   float* __restrict__ out, int p) {
  __shared__ float s_col[PROBE_LANE];
  const int tid = threadIdx.x;
  float scalar = 0.0f;
  if constexpr (VARIANT == F_LOOP_ONLY) {
    for (int q = 0; q < p; ++q) scalar = scalar + (float)q;
  } else if constexpr (VARIANT == F_DYN_SCALAR) {
    for (int q = 0; q < p; ++q) scalar = scalar + table[(size_t)q * PROBE_ROWS * PROBE_LANE];
  } else {
    if (tid < PROBE_LANE) {
      float a = 0.0f;
      for (int q = 0; q < p; ++q) a = a + table[(size_t)q * PROBE_ROWS * PROBE_LANE + tid];
      s_col[tid] = a;
    }
    __syncthreads();
  }
  const size_t base = (size_t)blockIdx.x * PROBE_ROWS * PROBE_LANE;
  for (int k = tid; k < PROBE_ROWS * PROBE_LANE; k += PROBE_BLOCK) {
    const float add = VARIANT == F_DYN_ROW ? s_col[k % PROBE_LANE] : scalar;
    out[base + k] = x[base + k] + add;
  }
}

// grid (SLICES, groups); dynamic shared memory: min(p, STAGE_PAGES) * SLAB4 float4
template <bool STATIC>
__global__ void __launch_bounds__(PROBE_BLOCK) fetch_colsum_kernel(const float* __restrict__ table,
                                                                   const float* __restrict__ x,
                                                                   float* __restrict__ out, int p, int out_rows) {
  extern __shared__ float4 s_slab[];  // [page][row][float4 column of the slice]
  __shared__ float4 s_acc[SLAB4];
  __shared__ float4 s_col[SLICE4];
  const int tid = threadIdx.x, slice = blockIdx.x;
  const float4* t4 = reinterpret_cast<const float4*>(table) + slice * SLICE4;
  const int pages = STATIC ? STATIC_PAGES : p;
  // thread tid < SLAB4 carries the chain of row tid / SLICE4, float4 column tid % SLICE4
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q0 = 0; q0 < pages; q0 += STAGE_PAGES) {
    const int n = min(STAGE_PAGES, pages - q0);
    for (int i = tid; i < n * SLAB4; i += PROBE_BLOCK)
      cp_async16(&s_slab[i], t4 + (size_t)(q0 + i / SLAB4) * TILE4 + (i % SLAB4) / SLICE4 * ROW4 + i % SLICE4);
    cp_async_wait_all();
    __syncthreads();
    if (tid < SLAB4) {
      if constexpr (STATIC) {
#pragma unroll
        for (int q = 0; q < STAGE_PAGES; ++q) add4(a, s_slab[q * SLAB4 + tid]);
      } else {
#pragma unroll 16
        for (int q = 0; q < n; ++q) add4(a, s_slab[q * SLAB4 + tid]);
      }
    }
    __syncthreads();
  }
  if (tid < SLAB4) s_acc[tid] = a;
  __syncthreads();
  if (tid < 4 * SLICE4) {  // column tid of the slice: rows 0..31 in order
    const float* acc = reinterpret_cast<const float*>(s_acc);
    float c = 0.0f;
#pragma unroll
    for (int r = 0; r < PROBE_ROWS; ++r) c = c + acc[r * 4 * SLICE4 + tid];
    reinterpret_cast<float*>(s_col)[tid] = c;
  }
  __syncthreads();
  const int row0 = blockIdx.y * GROUP_ROWS, rows = min(GROUP_ROWS, out_rows - row0);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = tid; i < rows * SLICE4; i += PROBE_BLOCK) {
    const size_t at = (size_t)(row0 + i / SLICE4) * ROW4 + slice * SLICE4 + i % SLICE4;
    float4 v = x4[at];
    add4(v, s_col[i % SLICE4]);
    o4[at] = v;
  }
}

template <bool STATIC>
int launch_colsum(const float* table, const float* x, float* out, int p, int blocks, cudaStream_t s) {
  const int smem = (STATIC ? STAGE_PAGES : max(1, min(p, STAGE_PAGES))) * SLAB4 * (int)sizeof(float4);
  const cudaError_t e = cudaFuncSetAttribute(fetch_colsum_kernel<STATIC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             STAGE_PAGES * SLAB4 * (int)sizeof(float4));
  if (e != cudaSuccess) return (int)e;
  const int out_rows = blocks * PROBE_ROWS;
  const dim3 grid(SLICES, (out_rows + GROUP_ROWS - 1) / GROUP_ROWS);
  fetch_colsum_kernel<STATIC><<<grid, PROBE_BLOCK, smem, s>>>(table, x, out, p, out_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// T1: kind indexes OpKind; inner must be the class's ops per iteration
// (64, the hash 16); ilp 1 or 4 divides n.
extern "C" int pt_op_chain(int kind, const float* x, float* out, int n, int iters, int inner, int ilp, void* stream) {
  if (n <= 0) return 0;
  if (kind < K_FMA || kind > K_SELECT || inner != (kind == K_HASH ? 16 : 64) || (ilp != 1 && ilp != 4) || n % ilp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case K_FMA: return launch_op_chain<K_FMA>(x, out, n, iters, ilp, s);
    case K_FFMA: return launch_op_chain<K_FFMA>(x, out, n, iters, ilp, s);
    case K_SQRT: return launch_op_chain<K_SQRT>(x, out, n, iters, ilp, s);
    case K_RSQRT: return launch_op_chain<K_RSQRT>(x, out, n, iters, ilp, s);
    case K_DIVIDE: return launch_op_chain<K_DIVIDE>(x, out, n, iters, ilp, s);
    case K_EXP: return launch_op_chain<K_EXP>(x, out, n, iters, ilp, s);
    case K_SIN: return launch_op_chain<K_SIN>(x, out, n, iters, ilp, s);
    case K_HASH: return launch_op_chain<K_HASH>(x, out, n, iters, ilp, s);
    default: return launch_op_chain<K_SELECT>(x, out, n, iters, ilp, s);
  }
}

// T2: variant indexes PagedVariant; tiles f32[n_pages,128,32], boxes
// f32[n_pages,n_sub,6], rays f32[6,n]; out i32[n]; ops one uint64, written
// by the counting build only.
extern "C" int pt_paged_probe(int variant, const float* tiles, const float* boxes, int n_pages, int n_sub,
                              const float* rays, int n, int reps, float t_min, float best_t, int* out,
                              unsigned long long* ops, void* stream) {
  if (n <= 0) return 0;
  if (variant < V_FETCH || variant > V_REAL || n_pages < 0 || n_sub < 1) return (int)cudaErrorInvalidValue;
  Pages G;
  G.tiles = tiles; G.boxes = boxes; G.n_pages = n_pages; G.n_sub = n_sub;
  const int grid = (n + 127) / 128;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case V_FETCH: paged_probe_kernel<V_FETCH><<<grid, 128, 0, s>>>(G, rays, n, reps, t_min, best_t, out, ops); break;
    case V_ALL: paged_probe_kernel<V_ALL><<<grid, 128, 0, s>>>(G, rays, n, reps, t_min, best_t, out, ops); break;
    case V_DENSE: paged_probe_kernel<V_DENSE><<<grid, 128, 0, s>>>(G, rays, n, reps, t_min, best_t, out, ops); break;
    case V_GATHER: paged_probe_kernel<V_GATHER><<<grid, 128, 0, s>>>(G, rays, n, reps, t_min, best_t, out, ops); break;
    default: paged_probe_kernel<V_REAL><<<grid, 128, 0, s>>>(G, rays, n, reps, t_min, best_t, out, ops); break;
  }
  return (int)cudaGetLastError();
}

// T3: layout 0-3 = a, b, c (16 KB tiles), d (4 KB); x and out
// f32[32*blocks, 128]; the table holds at least p tiles and is 16-byte
// aligned (the bulk copies need it).
extern "C" int pt_tile_fetch(int layout, const float* table, const float* x, float* out, int p, int blocks,
                             void* stream) {
  if (blocks <= 0) return 0;
  if (layout < 0 || layout > 3 || p < 0 || (uintptr_t)table % 16) return (int)cudaErrorInvalidValue;
  if (layout == 3) return launch_tile_fetch<8 * PROBE_LANE>(table, x, out, p, blocks, (cudaStream_t)stream);
  return launch_tile_fetch<PROBE_ROWS * PROBE_LANE>(table, x, out, p, blocks, (cudaStream_t)stream);
}

#ifdef PT_COUNT_OPS
// T3's split of the launches since the last call (counting build): out[T3_SLOTS + 1] as g_t3_clocks; reset
extern "C" int pt_t3_clocks(unsigned long long* out) {
  const unsigned long long zero[T3_SLOTS + 1] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_t3_clocks, sizeof(g_t3_clocks));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_t3_clocks, zero, sizeof(zero));
  return (int)e;
}
#endif

// T4: variant indexes FetchVariant (static_vec needs p == 80); table
// f32[>=32*p, 128]; x and out f32[32*blocks, 128].
extern "C" int pt_fetch_attrib(int variant, const float* table, const float* x, float* out, int p, int blocks,
                               void* stream) {
  if (blocks <= 0) return 0;
  if (variant < F_LOOP_ONLY || variant > F_DYN_SCALAR || p < 0 || (variant == F_STATIC_VEC && p != STATIC_PAGES))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case F_LOOP_ONLY: fetch_attrib_kernel<F_LOOP_ONLY><<<blocks, PROBE_BLOCK, 0, s>>>(table, x, out, p); break;
    case F_DYN_ROW: fetch_attrib_kernel<F_DYN_ROW><<<blocks, PROBE_BLOCK, 0, s>>>(table, x, out, p); break;
    case F_DYN_VEC: return launch_colsum<false>(table, x, out, p, blocks, s);
    case F_STATIC_VEC: return launch_colsum<true>(table, x, out, p, blocks, s);
    default: fetch_attrib_kernel<F_DYN_SCALAR><<<blocks, PROBE_BLOCK, 0, s>>>(table, x, out, p); break;
  }
  return (int)cudaGetLastError();
}
