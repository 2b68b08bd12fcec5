// K2: the count-min-sketch merge kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_cms_kernel` / `cms_step_pallas_impl`
// (gubernator_tpu/ops/pallas/cms_kernel.py:44-166).  One launch applies a
// whole merge of k chunks of B lanes to the sliding-window sketch, in order:
//
//     cur, prev, window_start (in place), packed[k, 2, B] (over, estimate)
//
// Chunk c decides every lane against the sketch as it stood after chunks
// 0..c-1, then adds its active lanes' hits.  Its plain PyTorch version is
// gubernator_tpu_torch/ops/sketch.py `multi_step` (the JAX package's
// `make_multi_step(cms_step_scatter_impl)`); the two agree bit for bit.
//
// What bounds it: bytes, and few of them.  A lane reads its fingerprint,
// hits and limit (16 B) and writes over and estimate (8 B); each distinct
// (row, column) cell it touches is read in cur and prev and written in cur
// (12 B).  A merge that rolls the window also reads cur and writes both
// tables (12 B a cell, 48 MB at D = 4, W = 2^20).  There is almost no
// arithmetic.  At the tier's shapes (B = 1024, D = 4) the gathers are
// random 4-byte reads, so latency and the phase barriers, not bandwidth,
// set the time.
//
// Design.  The TPU ran the batch as a sequential grid of one-hot MXU
// matmuls over a VMEM-resident sketch.  Here it is a gather, a min and a
// scatter-add, as in `cms_step_scatter_impl`: one COOPERATIVE launch (grid
// no larger than the co-resident limit) walks lanes with a grid-stride loop,
// and grid-wide barriers order the phases:
//
//   [roll] | read/decide chunk 0 | add chunk 0 | read/decide chunk 1 | ...
//
// - roll: every k chunk shares `now`, so only chunk 0 can roll the window
//   (ops/sketch.py _rotate_cond).  Every thread reads the same two window
//   words and takes the same branch; only a merge that rolls rewrites the
//   tables and pays its barrier.
// - read/decide: per active lane, the D columns (a wrapping 64-bit multiply
//   and a logical shift, in unsigned long long), eff = f32(cur) +
//   f32(prev) * overlap with explicit _rn intrinsics (and -fmad=false, so
//   nothing is contracted), the min over rows, over = hits > 0 &&
//   est + f32(hits) > f32(limit) on the float estimate, and the estimate
//   converted toward zero with saturation (__float2int_rz), as XLA does.
// - add: atomicAdd of each active lane's hits (negative ones too) into its
//   D cells.  Integer adds commute and wrap, so duplicate keys sum to the
//   same bits as the scatter form, in any order.  A barrier separates every
//   read of a chunk from its adds, and the adds from the next chunk's reads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads) cms_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;

  // Roll (ops/sketch.py _rotate_cond).  Every thread reads the window words
  // before the barrier; the new start is written only after it.
  const int64_t w = a.window_ms[0];
  const int64_t elapsed = wsub(a.now, a.window_start[0]);
  int64_t start = a.window_start[0];
  if (!(elapsed < w)) {
    const bool one_behind = elapsed < (int64_t)((uint64_t)w * 2);
    const int64_t cells = (int64_t)a.depth << a.log2w;
    for (int64_t i = tid; i < cells; i += stride) {
      a.prev[i] = one_behind ? a.cur[i] : 0;
      a.cur[i] = 0;
    }
    start = wsub(a.now, floor_mod(elapsed, w));
    grid.sync();
    if (tid == 0) a.window_start[0] = start;
  }
  // clip(1 - f32(now - start) / f32(w), 0, 1) in float32.
  const float frac = __fsub_rn(
      1.0f, __fdiv_rn(__ll2float_rn(wsub(a.now, start)), __ll2float_rn(w)));
  const float overlap = fminf(fmaxf(frac, 0.0f), 1.0f);

  for (int c = 0; c < a.k; ++c) {
    const int64_t* kh = a.kh + (int64_t)c * a.B;
    const int32_t* hits = a.hits + (int64_t)c * a.B;
    const int32_t* lim = a.lim + (int64_t)c * a.B;
    int32_t* out = a.packed + (int64_t)c * 2 * a.B;
    if (c > 0) grid.sync();  // chunk c reads after chunk c-1's adds

    // Read/decide against the sketch as it stands before this chunk.
    for (int i = tid; i < a.B; i += stride) {
      const int64_t h = __ldg(kh + i);
      int32_t over = 0, est_i = 0;
      if (h != 0) {
        float est = 0.0f;
        for (int d = 0; d < a.depth; ++d) {
          const int64_t cell = cell_of((uint64_t)h, d, a.log2w);
          const float eff = __fadd_rn(__int2float_rn(a.cur[cell]),
                                      __fmul_rn(__int2float_rn(a.prev[cell]), overlap));
          est = d == 0 ? eff : fminf(est, eff);
        }
        const int32_t hv = __ldg(hits + i);
        over = (hv > 0 && __fadd_rn(est, __int2float_rn(hv)) >
                              __int2float_rn(__ldg(lim + i))) ? 1 : 0;
        est_i = __float2int_rz(est);
      }
      out[i] = over;
      out[a.B + i] = est_i;
    }
    grid.sync();  // every read of this chunk precedes its adds

    for (int i = tid; i < a.B; i += stride) {
      const int64_t h = __ldg(kh + i);
      const int32_t hv = __ldg(hits + i);
      if (h == 0 || hv == 0) continue;  // adding 0 changes no cell
      for (int d = 0; d < a.depth; ++d) {
        atomicAdd(a.cur + cell_of((uint64_t)h, d, a.log2w), hv);
      }
    }
  }
}

// Grid of the cooperative launch: a thread per lane, and at least one block
// per SM (a roll sweeps the whole tables), capped at the co-resident limit.
// Returns a cudaError_t.
int cms_grid(int device, int B, int* grid_out) {
  static int cap_of[64] = {0};  // co-resident block limit per device
  static int sms_of[64] = {0};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cap_of[device] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cms_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cap_of[device] = sms * per_sm;
    sms_of[device] = sms;
  }
  int want = (B + kThreads - 1) / kThreads;
  if (want < sms_of[device]) want = sms_of[device];
  *grid_out = want < cap_of[device] ? want : cap_of[device];
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Launch K2 on `stream`.  Returns a cudaError_t.
int gub_cms_launch(int device, void* stream, int32_t* cur, int32_t* prev,
                   int64_t* window_start, const int64_t* window_ms,
                   const int64_t* kh, const int32_t* hits, const int32_t* lim,
                   int32_t* packed, long long now, int depth, int log2w, int k,
                   int B) {
  if (depth < 1 || depth > kMaxDepth || log2w < 0 || log2w > 30 || k < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  int err = cms_grid(device, B, &grid);
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
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)cms_kernel, dim3(grid), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
