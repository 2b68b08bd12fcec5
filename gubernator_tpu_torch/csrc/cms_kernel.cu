// K2: the count-min-sketch merge kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_cms_kernel` / `cms_step_pallas_impl`
// (gubernator_tpu/ops/pallas/cms_kernel.py:44-166).  One dispatch applies a
// whole merge of k chunks of B lanes to the sliding-window sketch, in order:
//
//     cur, prev, window_start (in place), packed[k, 2, B] (over, estimate)
//
// Chunk c decides every lane against the sketch as it stood after chunks
// 0..c-1, then adds its active lanes' hits.  Its plain PyTorch version is
// gubernator_tpu_torch/ops/sketch.py `multi_step` (the JAX package's
// `make_multi_step(cms_step_scatter_impl)`); the two agree bit for bit.
//
// What bounds it.  Bytes are few: a lane reads its fingerprint, hits and
// limit (16 B) and writes over and estimate (8 B); each distinct (row,
// column) cell it touches is read in cur and prev and written in cur
// (12 B).  A merge that rolls the window also reads cur and writes both
// tables (12 B a cell, 48 MB at D = 4, W = 2^20).  There is almost no
// arithmetic.  What sets the time is the chain of chunks: each must read
// its cells after the previous chunk's adds, so a merge is k steps in
// sequence, and each step is 3D scattered requests a lane (D reads of cur,
// D of prev, D atomic adds: 12K for 1024 lanes at D = 4).  Walked by one
// block, a chunk took about 7 us on the H100, as long as the first
// design's chunk with its two grid-wide barriers: about what one SM
// issuing one such request a cycle would take.  So the step is spread over
// several SMs and ordered by a barrier cheaper than the grid's.
//
// Design.  The TPU ran the batch as a sequential grid of one-hot MXU
// matmuls over a VMEM-resident sketch.  Here it is a gather, a min and a
// scatter-add, as in `cms_step_scatter_impl`, in two launches on one
// stream:
//
// - k2_roll_kernel: every chunk shares `now`, so only the first can roll the
//   window (ops/sketch.py _rotate_cond).  Every block reads the two window
//   words; only a merge that rolls sweeps the tables, with the whole grid.
//   The stream order to the next launch is the merge's one device-wide
//   barrier; a merge that does not roll sweeps nothing.  It leaves
//   window_start as it found it.
// - k2_walk_kernel, for chunks of at most 1024 lanes (the tier's chunks,
//   SketchTierConfig.batch_size = 1024): ONE thread block cluster of 16
//   blocks (8 where the card refuses clusters that large), 1024 threads in
//   all, walks the chunks, a thread per lane.  Two cluster barriers a chunk
//   order the steps: one between the chunk's reads and its adds, one
//   between its adds and the next chunk's reads.  They are hardware
//   barriers among the cluster's SMs, not the grid's, and the first is
//   relaxed: it orders reads that have already returned their values, so
//   it waits for no memory operation.  While a chunk's barriers and adds
//   run, each thread loads its next lane's prev values (prev does not
//   change during the walk), brings its next cur cells into L2, and loads
//   the lane after that: only the read of cur, at L2, stays on the chain.
// - k2_grid_walk_kernel, for wider chunks (a warm-up's 32768): a cooperative
//   grid walks each chunk with a grid-stride loop and grid barriers in the
//   same two places.
// Either walk takes the roll decision again from the unchanged window
// words and writes the new window_start at its end.
//
// Each lane: the D columns (a wrapping 64-bit multiply and a logical shift,
// in unsigned long long), eff = f32(cur) + f32(prev) * overlap with explicit
// _rn intrinsics (and -fmad=false, so nothing is contracted), the min over
// rows, over = hits > 0 && est + f32(hits) > f32(limit) on the float
// estimate, and the estimate converted toward zero with saturation
// (__float2int_rz), as XLA does.  Then atomicAdd of its hits (negative ones
// too) into its D cells: integer adds commute and wrap, so duplicate keys
// sum to the same bits as the scatter form, in any order.
//
// The adds are atomics performed at L2, by other SMs of the cluster too,
// so cur is read with __ldcg (at L2): a load through the SM's L1 could be
// served a line that an earlier chunk's add has made stale.  prev changes
// only in the roll, a launch before, so it takes the read-only path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 1024;        // lanes a walk pass covers (the cluster's threads)
constexpr int kSweepThreads = 1024;
constexpr int kGridThreads = 256;
constexpr int kMaxDepth = 8;

// ops/sketch.py _ROW_MULTIPLIERS.
__constant__ unsigned long long kRowMult[kMaxDepth] = {
    0x9E3779B97F4A7C15ull, 0xBF58476D1CE4E5B9ull, 0x94D049BB133111EBull,
    0xD6E8FEB86659FD93ull, 0xA5A3564DDF522B81ull, 0xC2B2AE3D27D4EB4Full,
    0x27D4EB2F165667C5ull, 0x165667B19E3779F9ull,
};

struct Args {
  int32_t* cur;             // [D, W]
  int32_t* prev;            // [D, W]
  int64_t* window_start;    // [1]
  const int64_t* window_ms; // [1]
  const int64_t* kh;        // [k, B]; 0 = inactive lane
  const int32_t* hits;      // [k, B]
  const int32_t* lim;       // [k, B]
  int32_t* packed;          // [k, 2, B]
  int64_t now;
  int depth;
  int log2w;
  int k;
  int B;
};

// One lane's request.
struct Lane {
  int64_t h;
  int32_t hits;
  int32_t lim;
};

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}

// Python/JAX `a % b` for b > 0: the result takes the divisor's sign.
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Cell index of fingerprint u in row d (ops/sketch.py row_columns).
__device__ __forceinline__ int64_t cell_of(uint64_t u, int d, int log2w) {
  const int64_t col = log2w == 0 ? 0 : (int64_t)((u * kRowMult[d]) >> (64 - log2w));
  return ((int64_t)d << log2w) + col;
}

__device__ __forceinline__ Lane load_lane(const Args& a, int c, int i) {
  const int64_t off = (int64_t)c * a.B + i;
  return Lane{__ldg(a.kh + off), __ldg(a.hits + off), __ldg(a.lim + off)};
}

// prev at lane l's D cells.  prev does not change during a walk (the roll
// rewrote it in the launch before), so it may be read early.
__device__ __forceinline__ void load_prev(const Args& a, const Lane& l,
                                          int32_t (&pv)[kMaxDepth]) {
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    if (d < a.depth && l.h != 0) pv[d] = __ldg(a.prev + cell_of((uint64_t)l.h, d, a.log2w));
  }
}

// Bring lane l's cells of cur into L2 ahead of their read.
__device__ __forceinline__ void prefetch_cur(const Args& a, const Lane& l) {
  if (l.h == 0) return;
  for (int d = 0; d < a.depth; ++d) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a.cur + cell_of((uint64_t)l.h, d, a.log2w)));
  }
}

// Decide lane i of chunk c against the sketch as it stands (prev at its
// cells in pv), and write its packed outputs.
__device__ __forceinline__ void decide(const Args& a, int c, int i, const Lane& l,
                                       const int32_t (&pv)[kMaxDepth], float overlap) {
  int32_t over = 0, est_i = 0;
  if (l.h != 0) {
    int32_t cv[kMaxDepth];
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < a.depth) cv[d] = __ldcg(a.cur + cell_of((uint64_t)l.h, d, a.log2w));
    }
    float est = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < a.depth) {
        const float eff = __fadd_rn(__int2float_rn(cv[d]),
                                    __fmul_rn(__int2float_rn(pv[d]), overlap));
        est = d == 0 ? eff : fminf(est, eff);
      }
    }
    over = (l.hits > 0 && __fadd_rn(est, __int2float_rn(l.hits)) >
                              __int2float_rn(l.lim)) ? 1 : 0;
    est_i = __float2int_rz(est);
  }
  int32_t* out = a.packed + (int64_t)c * 2 * a.B;
  out[i] = over;
  out[a.B + i] = est_i;
}

__device__ __forceinline__ void add(const Args& a, const Lane& l) {
  if (l.h == 0 || l.hits == 0) return;  // adding 0 changes no cell
  for (int d = 0; d < a.depth; ++d) {
    atomicAdd(a.cur + cell_of((uint64_t)l.h, d, a.log2w), l.hits);
  }
}

// Whether the merge rolls, and the window start it leaves.
__device__ __forceinline__ bool rolls(const Args& a, int64_t* start) {
  const int64_t w = a.window_ms[0];
  const int64_t elapsed = wsub(a.now, a.window_start[0]);
  *start = a.window_start[0];
  if (elapsed < w) return false;
  *start = wsub(a.now, floor_mod(elapsed, w));
  return true;
}

// Launch 1: the roll's table sweep (ops/sketch.py _rotate_cond).
__global__ void __launch_bounds__(kSweepThreads) k2_roll_kernel(Args a) {
  int64_t unused;
  if (!rolls(a, &unused)) return;
  const bool one_behind =
      wsub(a.now, a.window_start[0]) < (int64_t)((uint64_t)a.window_ms[0] * 2);
  const int64_t cells = (int64_t)a.depth << a.log2w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * blockDim.x + threadIdx.x; i < cells; i += stride) {
    a.prev[i] = one_behind ? a.cur[i] : 0;
    a.cur[i] = 0;
  }
}

// clip(1 - f32(now - start) / f32(w), 0, 1) in float32.
__device__ __forceinline__ float overlap_of(const Args& a, int64_t start) {
  const float frac = __fsub_rn(
      1.0f, __fdiv_rn(__ll2float_rn(wsub(a.now, start)),
                      __ll2float_rn(a.window_ms[0])));
  return fminf(fmaxf(frac, 0.0f), 1.0f);
}

// Launch 2, B <= kLanes: one cluster walks the chunks, lane i on thread i
// of the cluster.  Chunk c + 1's prev values and lane inputs, and chunk
// c + 2's lane inputs, are loaded (and c + 1's cur cells brought into L2)
// while chunk c's barriers and adds run.
__global__ void __launch_bounds__(kLanes / 8) k2_walk_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  int64_t start;
  const bool rolled = rolls(a, &start);
  const float overlap = overlap_of(a, start);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = i < a.B;
  const Lane none{0, 0, 0};
  Lane l = mine ? load_lane(a, 0, i) : none;
  Lane l1 = (mine && a.k > 1) ? load_lane(a, 1, i) : none;
  int32_t pv[kMaxDepth], pv1[kMaxDepth];
  load_prev(a, l, pv);
  for (int c = 0; c < a.k; ++c) {
    if (mine) decide(a, c, i, l, pv, overlap);
    load_prev(a, l1, pv1);
    prefetch_cur(a, l1);
    const Lane l2 = (mine && c + 2 < a.k) ? load_lane(a, c + 2, i) : none;
    // Every read of this chunk precedes its adds.  The reads have returned
    // their values (the outputs were computed from them), so this barrier
    // needs no memory ordering.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                 "barrier.cluster.wait.aligned;" ::: "memory");
    add(a, l);
    cluster.sync();  // the next chunk reads after this chunk's adds
    l = l1;
    l1 = l2;
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) pv[d] = pv1[d];
  }
  // Every thread read the window words before the first barrier.
  if (rolled && i == 0) a.window_start[0] = start;
}

// Launch 2, B > kLanes (wider chunks, such as a warm-up's): a cooperative
// grid walks each chunk with a grid-stride loop, grid barriers in the same
// two places.
__global__ void __launch_bounds__(kGridThreads) k2_grid_walk_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  int64_t start;
  const bool rolled = rolls(a, &start);
  const float overlap = overlap_of(a, start);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int32_t pv[kMaxDepth];
  for (int c = 0; c < a.k; ++c) {
    if (c > 0) grid.sync();  // chunk c reads after chunk c-1's adds
    for (int i = tid; i < a.B; i += stride) {
      const Lane l = load_lane(a, c, i);
      load_prev(a, l, pv);
      decide(a, c, i, l, pv, overlap);
    }
    grid.sync();  // every read of this chunk precedes its adds
    for (int i = tid; i < a.B; i += stride) add(a, load_lane(a, c, i));
  }
  if (rolled && tid == 0) a.window_start[0] = start;
}

// Restores the calling thread's current device when it leaves scope.  An
// entry point selects `device` to query or launch on it; without the guard
// the caller would stay on that card, and PyTorch's next allocation or
// stream lookup without an index would land there.
struct DeviceGuard {
  int prev = -1;
  DeviceGuard() {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

struct Device {
  int sms = 0;
  int cluster = 0;  // blocks of the walk's cluster
  int grid_cap = 0; // co-resident blocks of k2_grid_walk_kernel
};

// Sweep grid and walk cluster size of `device`.  Returns a cudaError_t.
int device_shape(int device, Device* out) {
  static Device of[64];
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Device& d = of[device];
  if (d.cluster == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    // 16 blocks a cluster is beyond the portable 8: take it where it fits.
    err = cudaFuncSetAttribute(k2_walk_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int fits = 0;
    if (err == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 16;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(16);
      cfg.blockDim = dim3(kLanes / 16);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&fits, k2_walk_kernel, &cfg) != cudaSuccess)
        fits = 0;
    }
    cudaGetLastError();  // a refused probe is not this launch's error
    d.cluster = fits > 0 ? 16 : 8;
    int coop = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k2_grid_walk_kernel, kGridThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    d.grid_cap = d.sms * per_sm;
  }
  *out = d;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Dispatch K2 on `stream`: k2_roll_kernel, then k2_walk_kernel
// (k2_grid_walk_kernel for chunks wider than kLanes).  Returns a cudaError_t.
int gub_cms_launch(int device, void* stream, int32_t* cur, int32_t* prev,
                   int64_t* window_start, const int64_t* window_ms,
                   const int64_t* kh, const int32_t* hits, const int32_t* lim,
                   int32_t* packed, long long now, int depth, int log2w, int k,
                   int B) {
  DeviceGuard guard;
  if (depth < 1 || depth > kMaxDepth || log2w < 0 || log2w > 30 || k < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  Device d;
  int err = device_shape(device, &d);
  if (err != (int)cudaSuccess) return err;
  Args a;
  a.cur = cur;
  a.prev = prev;
  a.window_start = window_start;
  a.window_ms = window_ms;
  a.kh = kh;
  a.hits = hits;
  a.lim = lim;
  a.packed = packed;
  a.now = (int64_t)now;
  a.depth = depth;
  a.log2w = log2w;
  a.k = k;
  a.B = B;
  cudaStream_t st = (cudaStream_t)stream;
  k2_roll_kernel<<<d.sms, kSweepThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (B > kLanes) {
    int grid = (B + kGridThreads - 1) / kGridThreads;
    if (grid > d.grid_cap) grid = d.grid_cap;
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)k2_grid_walk_kernel, dim3(grid),
                                    dim3(kGridThreads), params, 0, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(d.cluster);
  cfg.blockDim = dim3(kLanes / d.cluster);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k2_walk_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"

// Blocks in the cluster that walks K2's chunks on `device` (16 or 8), or a
// negated cudaError_t.
extern "C" int gub_cms_cluster(int device) {
  DeviceGuard guard;
  Device d;
  const int err = device_shape(device, &d);
  return err != (int)cudaSuccess ? -err : d.cluster;
}
