// The Mosaic repros T5-T8 on Hopper: each a small TPU kernel of the JAX
// package's tools/repro/ redone as a CUDA kernel, with the plain PyTorch
// version of ops/repro.py beside it.  On the TPU each repro checked that
// Mosaic compiles one pattern right; here each is also a small probe of a
// Hopper mechanism that the redesigns of B1/B2 need priced.
//
// T5 window_slice_kernel<layout>  replaces tools/repro/window_slice_probe.py::_kernel_a / _kernel_b
// T6 cond_chain_kernel,           replaces tools/repro/mosaic_cond_skip.py::cond_kernel
//    ctrl_chain_kernel                     and ::ctrl_kernel
// T7 reshape_stage_kernel<stage>  replaces tools/repro/mosaic_reshape_repro.py::run_stage (_body)
// T8 group_rows_kernel            replaces tools/repro/group_rows_relayout.py::main (body)
//
// Built by path_trace_golang_tpu_torch/ops/cuda_trace.py like the renderer's
// kernels (nvcc for sm_90a, -O3 --fmad=false, no fast math): every product
// and every sum is rounded on its own, as in the plain versions' separate
// tensor ops; min propagates NaN like torch.amin and XLA's min.  Bound with
// ctypes through the plain C functions at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int TRIPS = 3;               // T7's and T8's loop trips
constexpr int STAGE45_WORDS = 0b10110;  // T7 stages 4/5: each lane's mask word before the first pop
constexpr int STAGE5_THREADS = 1024;   // T7 stage 5: threads (and lanes) a block, 32 warps of 4 rows of w each

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ bool not_finite(float v) { return !(fabsf(v) <= 3.402823466e38f); }

// the block-wide minimum of v over all threads (blockDim a multiple of 32);
// every thread gets it.  `scratch` holds 33 floats of shared memory.
__device__ float block_min(float v, float* scratch) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warps = (blockDim.x * blockDim.y) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    float m = tid < warps ? scratch[tid] : __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (tid == 0) scratch[32] = m;
  }
  __syncthreads();
  const float m = scratch[32];
  __syncthreads();  // scratch may be written again by the next call
  return m;
}

// ---------------------------------------------------------------------------
// T5: the windowed one-hot gather.  Replaces window_slice_probe.py's
// _kernel_a (lane-dim dynamic slice of the table bf16[R, P]) and _kernel_b
// (sublane slice of its transpose bf16[P, R]), which gather one table column
// per lane through a one-hot MXU product over a W-page window at a
// data-dependent base.
//
// The probe asks what staging the window costs in layout A (R strided runs
// of W*2 bytes, one per table row) against layout B (one run of W*R*2
// bytes).  Design: block b owns table rows 8b .. 8b + 7 and stages only
// those rows of the window, 8 x W bf16 (4 KB at W 256), so the grid's copies
// are the whole window, each byte read once.  Every block first finds the
// base itself (a block minimum over the live lanes, floored to 128 and
// clamped: n int32 of reading).  The copy is one scheme for both layouts:
// each thread moves 16-byte chunks, chunk k of the block's rows into
// shared-memory chunk k; in A a chunk is 8 pages of one row (the rows' runs
// of W*2 bytes), in B the block's 8 rows at one page (16 bytes out of each
// 192-byte table row: how that slice reads is layout B's finding, PERF.md).
// Then warp j counts row j's non-finite entries in the window, and thread i
// writes lane i's outputs in the block's 8 rows (its page read once, for the
// base), each the contraction's closed form below: a shared read, a compare
// and a select.  What bounds it: the launch, the base's read of the pages
// and the copy, three dependent steps; a few hundred operations a block.
//
// Why the closed form gives the contraction's bits.  The plain version sums
// out[r, i] = sum over w < W of t(r, w) * onehot(w, i) in f32 from +0, where
// t(r, w) = bf16 table[r, base + w] (exact in f32) and onehot(w, i) is 1
// where base + w == page_i, else 0: at most one w, `sel`, has weight 1.
//   - A term with weight 0 is t * 0: +-0 where t is finite, NaN where t is
//     +-inf or NaN.  The term at sel is t(r, sel) * 1 = t(r, sel) exactly.
//   - So if row r holds a non-finite t at any w other than sel, a term is
//     NaN and the sum is NaN (a NaN stays NaN through every add).
//   - Else every term but sel's is +-0, and the sum starts at +0:
//     +0 + (+-0) = +0 in round-to-nearest, and x + (+-0) = x for x != 0, so
//     in any order the sum is t(r, sel) + 0.0f where sel exists (a nonzero
//     value or +-inf itself, +0 for either zero, NaN for NaN), and +0 where
//     it does not (a dead lane, page < 0, or a page outside the window).
// With bad(r) the row's non-finite entries in the window and
// others = bad(r) - [sel exists and t(r, sel) is not finite], the kernel
// writes exactly this: others > 0 ? NaN : (sel exists ? t(r, sel) + 0.0f :
// 0.0f).  A NaN's payload may differ from the plain version's sum.
// ---------------------------------------------------------------------------

constexpr int T5_ROWS = 8;                // table rows a block: one 16-byte chunk of a layout B row
constexpr int T5_THREADS = 32 * T5_ROWS;  // warp j counts row j
constexpr int T5_SMEM_MAX = 48 * 1024;    // the window's rows stay within what a launch takes without asking

#ifdef PT_COUNT_OPS
// T5's split in the counting build (-DPT_COUNT_OPS), each block timed by its
// thread 0 and summed over blocks: [0] the base (block minimum), [1] the
// window's copy, [2] the rows' non-finite counts (the contraction's work),
// [3] the outputs' selects and stores, [4] the wait for the block's last
// thread, [5] the blocks; [6] the earliest block start, [7] the earliest and
// [8] the latest block end, in ns of %globaltimer.  Read and reset by
// pt_t5_clocks()
__device__ unsigned long long g_t5_clocks[9] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, ~0ull, ~0ull, 0ull};
__device__ __forceinline__ unsigned long long t5_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define T5_CLOCK(v) const long long v = clock64()
#else
#define T5_CLOCK(v)
#endif

template <int LAYOUT>  // 0: A, table[R][P]; 1: B, table[P][R]
__global__ void __launch_bounds__(T5_THREADS) window_slice_kernel(const __nv_bfloat16* __restrict__ table, int R,
                                                                  int P, int W, const int* __restrict__ p_l, int n,
                                                                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);  // A: [T5_ROWS][W], B: [W][T5_ROWS]
  __shared__ int s_min[T5_THREADS / 32 + 1];
  __shared__ int s_bad[T5_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * T5_ROWS;
#ifdef PT_COUNT_OPS
  const unsigned long long ns0 = t5_ns();
#endif
  T5_CLOCK(c0);

  const int my_page = tid < n ? p_l[tid] : -1;  // lane tid's page, kept for its outputs
  int m = my_page >= 0 ? my_page : P;          // a dead lane (page < 0) counts as P
  for (int i = tid + T5_THREADS; i < n; i += T5_THREADS) {
    const int v = p_l[i];
    m = min(m, v >= 0 ? v : P);
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) s_min[warp] = m;
  __syncthreads();
  if (tid < 32) {
    int v = tid < T5_THREADS / 32 ? s_min[tid] : P;
    v = __reduce_min_sync(0xffffffffu, v);
    if (tid == 0) s_min[T5_THREADS / 32] = v;
  }
  __syncthreads();
  const int base = max(min((s_min[T5_THREADS / 32] / 128) * 128, P - W), 0);
  T5_CLOCK(c1);

  const int row_chunks = W / 8;  // 16-byte chunks of one row's window (layout A)
  for (int k = tid; k < T5_ROWS * row_chunks; k += T5_THREADS) {
    const __nv_bfloat16* src = LAYOUT == 0 ? table + (size_t)(r0 + k / row_chunks) * P + base + (k % row_chunks) * 8
                                           : table + (size_t)(base + k) * R + r0;
    reinterpret_cast<uint4*>(win)[k] = *reinterpret_cast<const uint4*>(src);
  }
  __syncthreads();
  T5_CLOCK(c2);

  auto at = [&](int r, int w) { return __bfloat162float(LAYOUT == 0 ? win[r * W + w] : win[w * T5_ROWS + r]); };
  int bad = 0;
  for (int w = lane; w < W; w += 32) bad += not_finite(at(warp, w));
  bad = __reduce_add_sync(0xffffffffu, bad);
  if (lane == 0) s_bad[warp] = bad;
  __syncthreads();
  T5_CLOCK(c3);

  for (int i = tid; i < n; i += T5_THREADS) {  // lane i's outputs in the block's rows
    const int page = i == tid ? my_page : p_l[i];
    const bool sel = page >= base && page - base < W;  // a dead lane's page < 0 <= base lies below the window
#pragma unroll
    for (int r = 0; r < T5_ROWS; ++r) {
      const float t = sel ? at(r, page - base) : 0.0f;
      const int others = s_bad[r] - (sel && not_finite(t) ? 1 : 0);
      out[(size_t)(r0 + r) * n + i] = others > 0 ? __int_as_float(0x7fffffff) : (sel ? t + 0.0f : 0.0f);
    }
  }
#ifdef PT_COUNT_OPS
  T5_CLOCK(c4);
  __syncthreads();
  T5_CLOCK(c5);
  if (tid == 0) {
    atomicAdd(&g_t5_clocks[0], (unsigned long long)(c1 - c0));
    atomicAdd(&g_t5_clocks[1], (unsigned long long)(c2 - c1));
    atomicAdd(&g_t5_clocks[2], (unsigned long long)(c3 - c2));
    atomicAdd(&g_t5_clocks[3], (unsigned long long)(c4 - c3));
    atomicAdd(&g_t5_clocks[4], (unsigned long long)(c5 - c4));
    atomicAdd(&g_t5_clocks[5], 1ull);
    const unsigned long long ns1 = t5_ns();
    atomicMin(&g_t5_clocks[6], ns0);
    atomicMin(&g_t5_clocks[7], ns1);
    atomicMax(&g_t5_clocks[8], ns1);
  }
#endif
}

// ---------------------------------------------------------------------------
// T6: a guarded chain of matrix products.  Replaces mosaic_cond_skip.py's
// cond_kernel (rounds x lax.cond(flag, 32 serial dots c <- a @ c)) and
// ctrl_kernel (the same without the cond), which ask whether a uniform
// branch skips its work or executes it predicated.
//
// Design: column j of a @ c depends only on column j of c, so the chain
// splits into N independent matrix-vector chains, one block each (N = 128
// blocks, no grid-wide sync), the column in shared memory, double buffered.
// A step is 2*N^2 operations, 256 issue cycles of each of the block's 4
// schedulers at best.  The shared reads bound it: a warp whose lanes each
// hold a row of `a` must read (broadcast) all N entries of the column a
// step, one shared-memory wavefront an entry (a 16-byte read of 4 entries
// takes 4), 4 x 128 = 512 wavefronts a step with one thread a row (PERF.md:
// the step took 513 cycles, and four threads a row, four warps a
// scheduler, took longer still).  So a thread holds T6_ROWS rows and uses
// each entry it reads for all of them: 512 / T6_ROWS wavefronts a step, and
// T6_PARTS threads share those rows' entries (T6_PARTS * 128 / T6_ROWS
// threads).  Two rows and two parts (128 threads, 64 entries of each row a
// thread) won the A/B of the layouts (PERF.md): more parts add the
// shuffles and warps that hide latency no better than they cost.  Thread
// (g, p), lanes of one warp for one row group, keeps the p-th part of rows
// g * T6_ROWS .. + T6_ROWS - 1 of `a` in registers for the whole launch; a
// step is 16-byte reads of that part of the column (each part padded by 16
// bytes, so that the parts a warp reads lie in other banks), each row's
// products and sums in four interleaved partial sums, the parts' sums
// joined in a fixed order ((q0 + q1) + (q2 + q3) for four parts) by
// shuffles, one write a row and one barrier.  The flag is read from device
// memory, so nvcc cannot fold the branch; the loop over rounds tests it
// every round (not unswitched: PERF.md).
//
// Bit-identity: the kernel sums a row's 128 products in another order than
// the plain version's (a[:, :, None] * c[None]).sum(1).  Each row of T6's
// own `a` (mosaic_cond_skip.py's _mk_a) has at most two nonzero entries, so
// each sum holds at most two nonzero terms beside exact zeros, and every
// order gives the same float: x + (+-0) = x for x != 0, and a sum of zeros
// is -0 only where every term is -0.  The kernel equals the plain version
// bit for bit there; for a general `a` within the rounding of the order.
// No fused multiply-add (--fmad=false): each product is rounded on its own,
// as in the plain version.
//
// What bounds it: the f32 instruction rate of one SM a column, 2*N^2
// operations a step (a multiply and an add each, unfused: 128 a cycle and
// SM); the chain of steps serialises the blocks' barriers.
// ---------------------------------------------------------------------------

constexpr int T6_ROWS = 2;   // rows of `a` a thread
constexpr int T6_PARTS = 2;  // threads a row
constexpr int T6_K = LANE / T6_PARTS;        // entries of a row a thread holds
constexpr int T6_THREADS = LANE * T6_PARTS / T6_ROWS;
constexpr int T6_PAD = LANE + 4 * T6_PARTS;  // the column's floats in shared memory, each part padded by 16 bytes
static_assert(T6_PARTS == 1 || T6_PARTS == 2 || T6_PARTS == 4 || T6_PARTS == 8, "T6_PARTS must divide a warp");
static_assert(T6_ROWS >= 1 && T6_ROWS <= T6_PARTS && LANE % T6_ROWS == 0, "T6_ROWS: 1 to T6_PARTS");

#ifdef PT_COUNT_OPS
// T6's step split in the counting build (-DPT_COUNT_OPS): clock cycles of a
// step's products, of its write and barrier wait, of the whole chain, and
// the steps, summed over threads; read and zeroed by pt_t6_clocks()
__device__ unsigned long long g_t6_clocks[4];
#define T6_CLOCK(v) const long long v = clock64()
#define T6_ADD(k, n) (t6_sum[k] += (unsigned long long)(n))
#else
#define T6_CLOCK(v)
#define T6_ADD(k, n) ((void)0)
#endif

__device__ __forceinline__ void chain_column(bool active, const float* __restrict__ a, const float* __restrict__ b,
                                             float* __restrict__ out, int rounds, int inner) {
  __shared__ __align__(16) float v[2][T6_PAD];
  const int g = threadIdx.x / T6_PARTS, p = threadIdx.x % T6_PARTS, j = blockIdx.x;
  const int at = p * (T6_K + 4);  // the first float of this part of the column
#ifdef PT_COUNT_OPS
  unsigned long long t6_sum[4] = {0ull, 0ull, 0ull, 0ull};
#endif
  T6_CLOCK(c_start);
  float ar[T6_ROWS][T6_K];
#pragma unroll
  for (int k = 0; k < T6_ROWS; ++k)
#pragma unroll
    for (int q = 0; q < T6_K / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(a + (size_t)(g * T6_ROWS + k) * LANE + p * T6_K)[q];
      ar[k][4 * q] = t.x, ar[k][4 * q + 1] = t.y, ar[k][4 * q + 2] = t.z, ar[k][4 * q + 3] = t.w;
    }
  // the row that this thread writes, where its part's index names one of its group's rows
  const bool writes = p < T6_ROWS;
  const int mine = g * T6_ROWS + (writes ? p : 0);
  const int mine_at = mine + 4 * (mine / T6_K);  // its place in the padded column
  if (writes) v[0][mine_at] = b[(size_t)mine * LANE + j];
  __syncthreads();
  int cur = 0;
  for (int rr = 0; rr < rounds; ++rr) {
    if (!active) continue;
    for (int s = 0; s < inner; ++s) {
      T6_CLOCK(c0);
      const float4* c4 = reinterpret_cast<const float4*>(v[cur] + at);
      float acc[T6_ROWS][4];
#pragma unroll
      for (int k = 0; k < T6_ROWS; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
#pragma unroll
      for (int q = 0; q < T6_K / 4; ++q) {
        const float4 c = c4[q];
#pragma unroll
        for (int k = 0; k < T6_ROWS; ++k) {
          acc[k][0] = acc[k][0] + ar[k][4 * q] * c.x;
          acc[k][1] = acc[k][1] + ar[k][4 * q + 1] * c.y;
          acc[k][2] = acc[k][2] + ar[k][4 * q + 2] * c.z;
          acc[k][3] = acc[k][3] + ar[k][4 * q + 3] * c.w;
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < T6_ROWS; ++k) {
        float r = (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
#pragma unroll
        for (int o = 1; o < T6_PARTS; o <<= 1) r = r + __shfl_xor_sync(0xffffffffu, r, o);
        if (p == k) sum = r;
      }
      T6_CLOCK(c1);
      cur ^= 1;
      if (writes) v[cur][mine_at] = sum;
      __syncthreads();
      T6_CLOCK(c2);
      T6_ADD(0, c1 - c0);
      T6_ADD(1, c2 - c1);
      T6_ADD(3, 1);
    }
  }
  if (writes) out[(size_t)mine * LANE + j] = v[cur][mine_at];
  T6_CLOCK(c_end);
  T6_ADD(2, c_end - c_start);
#ifdef PT_COUNT_OPS
  for (int q = 0; q < 4; ++q) atomicAdd(&g_t6_clocks[q], t6_sum[q]);
#endif
}

__global__ void __launch_bounds__(T6_THREADS)
    cond_chain_kernel(const int* __restrict__ flag, const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int rounds, int inner) {
  chain_column(flag[0] > 0, a, b, out, rounds, inner);
}

__global__ void __launch_bounds__(T6_THREADS)
    ctrl_chain_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int rounds,
                      int inner) {
  chain_column(true, a, b, out, rounds, inner);
}

// ---------------------------------------------------------------------------
// T7: the staged relayout repro.  Replaces mosaic_reshape_repro.py's
// run_stage, whose kernels regroup x f32[rows, 128] to (rows/G, G*128)
// inside the kernel and run _body's stage on each wide row: 1 the identity,
// 2 x*2 + 1, 3 a 3-trip carry acc <- acc*0.5 + row, 4 acc <- acc + p*row
// over 3 pops p of a mask word, 5 as 4 with p replaced by the minimum over
// the rows of bf16(w) @ onehot(p).
//
// Design: the regrouping is an index map.  Thread e of the grid owns lane
// j = e mod G*128 of wide row s = e div G*128, which is element s*G*128 + j
// of x and of the output, so the reshape and its inverse cost nothing.
// Stages 1-4: 128 lanes a block; what bounds them is the launch.  Stage 5
// (reshape_stage5_kernel): 1,024 lanes a block.  The contraction's result
// for a pop p depends on p alone, so each block first builds the 129
// answers, table[p] for p = 0..128, from one coalesced read of w (each warp
// four rows, a 16-byte load a lane and row), and every lane then runs its 3
// pops and reads contrib = table[p].  What bounds it: the 73,728 bytes of
// x, w and the output (every entry of w can change the answer), and the
// launch.
//
// Why the table gives the contraction's bits for every w.  Write b(r,q) for
// bf16(w[r,q]) (RNE; a finite w past bf16's range becomes inf) and
// gth(r,p) = sum over q of b(r,q) * onehot_p(q), the sum begun at +0 and
// taken term by term (the plain version's sum begins at +0 too).  The terms
// with q != p are b(r,q) * 0: +-0 where b(r,q) is finite, NaN where it is
// inf or NaN.  The term q = p (p < 128) is b(r,p) * 1 = b(r,p).  So
//   - gth(r,p) is NaN where b(r,q) is not finite for some q != p, or where
//     b(r,p) is NaN;
//   - else gth(r,p) = +0 + b(r,p) added to +-0 terms: b(r,p) itself where
//     it is not zero (inf included), and +0 where it is +-0 (+0 + -0 is
//     +0 in round-to-nearest);
//   - p = 128 (an empty word) matches no column: gth(r,128) is NaN where
//     row r holds a non-finite b, else +0.
// With `others` the non-finite entries of row r other than column p, the
// kernel forms exactly this: others > 0 ? NaN : 0.0f + b(r,p).  No gth is
// -0, and the minimum propagates NaN, so the minimum over the rows is the
// same value whatever order takes it: NaN if any gth(., p) is NaN, else the
// least, with no +0/-0 pair to choose between.  A NaN's payload may differ
// from the contraction's; acc + contrib * row then gives the card's one
// canonical NaN either way.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int pop_lane(int& words) {
  const uint32_t u = (uint32_t)words;
  const uint32_t low = u & (0u - u);
  const int idx = (__float_as_int((float)(int)low) >> 23) - 127;  // the float exponent of the lowest set bit
  const int p = words > 0 ? idx : LANE;
  words = (int)(u & ~low);
  return p;
}

template <int STAGE>
__global__ void __launch_bounds__(1024) reshape_stage_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                             int g) {
  static_assert(STAGE >= 1 && STAGE <= 4, "stage 5 is reshape_stage5_kernel");
  const int gl = g * LANE;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = e / gl, j = e - s * gl;  // wide row, lane of it
  const size_t at = (size_t)s * gl + j;  // the regrouping's index map: x's and the output's element
  const float row = x[at];
  if constexpr (STAGE == 1) {
    out[at] = row;
  } else if constexpr (STAGE == 2) {
    out[at] = row * 2.0f + 1.0f;
  } else if constexpr (STAGE == 3) {
    float acc = row * 0.0f;
    for (int i = 0; i < TRIPS; ++i) acc = acc * 0.5f + row;
    out[at] = acc;
  } else {
    float acc = row * 0.0f;
    int words = (int)(row * 0.0f) | STAGE45_WORDS;
    for (int i = 0; i < TRIPS; ++i) {
      const int p = pop_lane(words);
      acc = acc + (float)p * row;
    }
    out[at] = acc;
  }
}

// stage 5 for `lanes` lanes (a multiple of 128), STAGE5_THREADS a block
__global__ void __launch_bounds__(STAGE5_THREADS) reshape_stage5_kernel(const float* __restrict__ x,
                                                                        const float* __restrict__ w,
                                                                        float* __restrict__ out, int g, int lanes) {
  constexpr int WARPS = STAGE5_THREADS / 32, ROWS = LANE / WARPS;
  __shared__ float part[WARPS][LANE];  // each warp's column minima over its rows
  __shared__ float table[LANE + 1];    // the contraction's minimum for each pop p = 0..128
  const int t = threadIdx.x, warp = t >> 5, l = t & 31;
  float4 v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)  // row warp + WARPS*i, columns 4l..4l+3: one row a warp's load
    v[i] = reinterpret_cast<const float4*>(w)[(warp + WARPS * i) * (LANE / 4) + l];
  float m[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  bool row_bad = false;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float b[4] = {__bfloat162float(__float2bfloat16_rn(v[i].x)), __bfloat162float(__float2bfloat16_rn(v[i].y)),
                        __bfloat162float(__float2bfloat16_rn(v[i].z)), __bfloat162float(__float2bfloat16_rn(v[i].w))};
    int mine = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) mine += not_finite(b[k]);
    const int bad = __reduce_add_sync(0xffffffffu, mine);  // the row's non-finite entries
    row_bad = row_bad || bad > 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int others = bad - (not_finite(b[k]) ? 1 : 0);
      m[k] = nan_min(m[k], others > 0 ? __int_as_float(0x7fffffff) : 0.0f + b[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) part[warp][4 * l + k] = m[k];
  const int any_bad = __syncthreads_or(row_bad);
  if (t < LANE) {
    float c = part[0][t];
    for (int k = 1; k < WARPS; ++k) c = nan_min(c, part[k][t]);
    table[t] = c;
  } else if (t == LANE) {
    table[LANE] = any_bad ? __int_as_float(0x7fffffff) : 0.0f;
  }
  __syncthreads();
  const int e = blockIdx.x * STAGE5_THREADS + t;
  if (e >= lanes) return;
  const int gl = g * LANE;
  const int s = e / gl, j = e - s * gl;
  const size_t at = (size_t)s * gl + j;
  const float row = x[at];
  float acc = row * 0.0f;
  int words = (int)(row * 0.0f) | STAGE45_WORDS;
  for (int i = 0; i < TRIPS; ++i) acc = acc + table[pop_lane(words)] * row;
  out[at] = acc;
}

// ---------------------------------------------------------------------------
// T8: the grouped-rows relayout repro.  Replaces group_rows_relayout.py's
// kernel, which regroups x f32[rows, 128] to (rows/G, G*128), runs per wide
// row a 3-trip loop acc <- acc + (acc > min(acc)) from 2*row, and regroups
// back.
//
// Design: one block a wide row, one thread a lane (G*128 <= 1024 threads);
// the regrouping is the index map s*G*128 + t.  Each trip is one block
// minimum (warp shuffles, then one warp over the warps' minima,
// NaN-propagating) and one compare and add a lane.  What bounds it: launch;
// three block-wide barriers a trip.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) group_rows_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float scratch[33];
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = x[e] * 2.0f;
  for (int i = 0; i < TRIPS; ++i) {
    const float m = block_min(acc, scratch);
    acc = acc + (acc > m ? 1.0f : 0.0f);
  }
  out[e] = acc;
}

template <int LAYOUT>
int launch_window_slice(const __nv_bfloat16* table, int R, int P, int W, const int* p_l, int n, float* out,
                        cudaStream_t s) {
  window_slice_kernel<LAYOUT><<<R / T5_ROWS, T5_THREADS, (size_t)T5_ROWS * W * sizeof(__nv_bfloat16), s>>>(
      table, R, P, W, p_l, n, out);
  return (int)cudaGetLastError();
}

template <int STAGE>
int launch_reshape_stage(const float* x, const float* w, float* out, int grows, int g, cudaStream_t s) {
  const int lanes = grows * g * LANE;
  if constexpr (STAGE == 5)
    reshape_stage5_kernel<<<(lanes + STAGE5_THREADS - 1) / STAGE5_THREADS, STAGE5_THREADS, 0, s>>>(x, w, out, g,
                                                                                                  lanes);
  else
    reshape_stage_kernel<STAGE><<<lanes / LANE, LANE, 0, s>>>(x, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// T5: layout 0 (A: table bf16[R, P]) or 1 (B: bf16[P, R]); p_l i32[n]; out
// f32[R, n].  W <= P; 8*W*2 bytes of shared memory a block (at most 48 KB);
// the 16-byte copies need P, W and R multiples of 8 and a 16-byte aligned
// table.
extern "C" int pt_window_slice(int layout, const void* table, int R, int P, int W, const int* p_l, int n, float* out,
                               void* stream) {
  if (n <= 0 || R <= 0) return 0;
  if ((layout != 0 && layout != 1) || W <= 0 || W > P || P % 8 || W % 8 || R % T5_ROWS || (uintptr_t)table % 16 ||
      (size_t)T5_ROWS * W * 2 > T5_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  return layout == 0 ? launch_window_slice<0>(t, R, P, W, p_l, n, out, s)
                     : launch_window_slice<1>(t, R, P, W, p_l, n, out, s);
}

// T6: control 0 runs cond_chain_kernel (flag i32[1] read on the device),
// 1 ctrl_chain_kernel; a, b, out f32[128, 128]; inner products a round.
extern "C" int pt_cond_chain(int control, const int* flag, const float* a, const float* b, float* out, int rounds,
                             int inner, void* stream) {
  if (rounds < 0 || inner <= 0 || (uintptr_t)a % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (control)
    ctrl_chain_kernel<<<LANE, T6_THREADS, 0, s>>>(a, b, out, rounds, inner);
  else
    cond_chain_kernel<<<LANE, T6_THREADS, 0, s>>>(flag, a, b, out, rounds, inner);
  return (int)cudaGetLastError();
}

// T7: stage 1-5; x and out f32[grows*g, 128]; w f32[128, 128], 16-byte aligned.
extern "C" int pt_reshape_stage(int stage, const float* x, const float* w, float* out, int grows, int g,
                                void* stream) {
  if (grows <= 0) return 0;
  if (g < 1 || stage < 1 || stage > 5 || (uintptr_t)w % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 1: return launch_reshape_stage<1>(x, w, out, grows, g, s);
    case 2: return launch_reshape_stage<2>(x, w, out, grows, g, s);
    case 3: return launch_reshape_stage<3>(x, w, out, grows, g, s);
    case 4: return launch_reshape_stage<4>(x, w, out, grows, g, s);
    default: return launch_reshape_stage<5>(x, w, out, grows, g, s);
  }
}

// T8: x and out f32[grows*g, 128]; g*128 <= 1024.
extern "C" int pt_group_rows(const float* x, float* out, int grows, int g, void* stream) {
  if (grows <= 0) return 0;
  if (g < 1 || g * LANE > 1024) return (int)cudaErrorInvalidValue;
  group_rows_kernel<<<grows, g * LANE, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

#ifdef PT_COUNT_OPS
// T6's step split of the launches since the last call (counting build):
// out[4] = the products' cycles, the write and barrier's, the chain's, the
// steps, each summed over threads; the sums are zeroed
extern "C" int pt_t6_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_t6_clocks, sizeof(g_t6_clocks));
  const unsigned long long zero[4] = {0ull, 0ull, 0ull, 0ull};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_t6_clocks, zero, sizeof(zero));
  return (int)e;
}

// T5's split of the launches since the last call (counting build): out[9] as
// g_t5_clocks; the sums are reset
extern "C" int pt_t5_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_t5_clocks, sizeof(g_t5_clocks));
  const unsigned long long reset[9] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, ~0ull, ~0ull, 0ull};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_t5_clocks, reset, sizeof(reset));
  return (int)e;
}
#endif

extern "C" const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
