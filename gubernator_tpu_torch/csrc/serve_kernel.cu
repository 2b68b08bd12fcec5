// K1: the persistent decision kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_serve_kernel` / `persistent_serve_step_impl`
// (gubernator_tpu/ops/pallas/serve_kernel.py:57-143).  One launch drains k
// packed request rounds against the slot table, in order:
//
//     table (in place), resps[k, 9, B], seq_out = seq_in + k
//
// Round b applies the decision step of gubernator_tpu/ops/step.py
// (`apply_batch_packed_q_impl`: W-way probe, 3 lowest-lane-wins insert
// claim rounds, token/leaky algebra, write-back) at nows[b] and sees the
// effects of rounds 0..b-1.  Its plain PyTorch version is
// gubernator_tpu_torch/ops/ring.py `ring_step`; the two agree bit for bit.
//
// What bounds it: bytes.  Each active lane reads its request (96 B), the
// key/expire_at/touched words of its bucket (3 x 8 ways x 8 B), the rest of
// its own row, writes its row (84 B) and its response (72 B): about 0.5 KB
// of useful traffic, scattered over the 1.4 GB table at 2^24 slots, and
// almost no arithmetic.  An inactive (padding) lane reads only its active
// word and writes a zero response: 80 B.
//
// Design.  The TPU ran the k rounds as a sequential grid over one core.
// Here one COOPERATIVE launch (grid no larger than the co-resident limit)
// walks the lanes with a grid-stride loop, and grid-wide barriers
// (cooperative_groups::this_grid().sync()) separate the phases that
// depend on every lane of the phase before:
//
//   probe  | claim r=0: choose, atomicMin | r=1 ... | r=2 ... | decide+write
//
// The claim word buffer `claim` (int32[S], all INT32_MAX between launches)
// replaces the TPU's sort-based "lowest lane wins": a found lane marks its
// slot reserved (-1); an inserting lane picks its best unblocked way (lowest
// score, lowest way on ties) from the words as they stood at the round's
// start, then atomicMin's its lane id into the word; the word's final value
// names the winner, which keeps the slot blocked for the next rounds.  In
// the last phase every found lane and every winner restores its word, and
// every attempted word has a winner, so the buffer is all INT32_MAX again.
//
// Gather, algebra and write-back share the last phase: a lane whose output
// depends on a row reads only its own found slot, and only that lane writes
// it (found slots are blocked from victims); transient and inactive lanes
// read and write nothing.  Arithmetic that wraps in the JAX form goes
// through uint64_t; the saturating helpers clamp, then add; float64 math
// keeps the JAX evaluation order with explicit _rn intrinsics (and the
// build passes -fmad=false), so no multiply-add is contracted.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kInsertRounds = 3;
constexpr int kQRows = 12;
constexpr int kRespRows = 9;
constexpr int32_t kFree = INT32_MAX;   // claim word: nobody claimed
constexpr int32_t kReserved = -1;      // claim word: a found lane's slot
constexpr int64_t kInf = int64_t(1) << 62;

// Lane state flags (scratch `lflag`).
constexpr int32_t kActive = 1;
constexpr int32_t kFound = 2;
constexpr int32_t kNeed = 4;
constexpr int32_t kWon = 8;

struct Table {
  int64_t* key;
  int32_t* algo;
  int32_t* kind;
  int64_t* limit;
  int64_t* duration;
  int64_t* remaining;
  double* remaining_f;
  int64_t* t0;
  int32_t* status;
  int64_t* burst;
  int64_t* expire_at;
  int64_t* touched;
};

struct Args {
  Table t;
  const int64_t* qs;     // [k, 12, B]
  const int64_t* nows;   // [k]
  const int64_t* seq_in; // [1]
  int64_t* seq_out;      // [1]
  int64_t* resps;        // [k, 9, B]
  int32_t* claim;        // [S]
  int32_t* lflag;        // [B]
  int32_t* lslot;        // [B]
  int32_t* lvslot;       // [B]
  int64_t S;
  int ways;
  int k;
  int B;
};

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// ops/step.py _sat_add_i64: clamp b into the room a leaves, then add.
__device__ __forceinline__ int64_t sat_add(int64_t a, int64_t b) {
  const int64_t room_hi = INT64_MAX - imax(a, 0);
  const int64_t room_lo = INT64_MIN - imin(a, 0);
  return a + imin(imax(b, room_lo), room_hi);
}

// ops/step.py _sat_sub_i64.
__device__ __forceinline__ int64_t sat_sub(int64_t a, int64_t b) {
  const int64_t b_lo = imax(a, -1) - INT64_MAX;
  const int64_t b_hi = imin(a, -1) - INT64_MIN;
  return a - imin(imax(b, b_lo), b_hi);
}

// ops/step.py _trunc_i64: toward zero, saturating, NaN -> 0.
__device__ __forceinline__ int64_t trunc_i64(double x) {
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return INT64_MAX;
  if (x <= -9223372036854775808.0) return INT64_MIN;
  return (int64_t)x;
}

__device__ __forceinline__ double f64(int64_t x) { return (double)x; }

// f_now + (f_lim - f_rem) * f_rate, in that order, no contraction.
__device__ __forceinline__ double reset_expr(double f_now, double f_lim,
                                             double f_rem, double f_rate) {
  return __dadd_rn(f_now, __dmul_rn(__dsub_rn(f_lim, f_rem), f_rate));
}

// Victim score of one candidate way (ops/step.py:214-220).
__device__ __forceinline__ int64_t victim_score(const Table& t, int64_t s,
                                                int64_t h, int64_t now) {
  const int64_t key = t.key[s];
  const bool keymatch = key == h;
  const bool live = t.expire_at[s] > now;
  const int64_t klass = (keymatch && !live) ? 0 : (key == 0) ? 1 : (!live) ? 2 : 3;
  return (int64_t)(((uint64_t)klass << 48) + (uint64_t)t.touched[s]);
}

// Phase "probe": find each active lane's live match; mark it reserved.
__device__ void probe_phase(const Args& a, const int64_t* q, int64_t now,
                            int64_t nbm) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.B; i += stride) {
    int32_t flag = 0;
    int32_t slot = -1;
    if (__ldg(q + 10 * (int64_t)a.B + i) != 0) {
      flag = kActive;
      const int64_t h = __ldg(q + i);
      const int64_t base = (h & nbm) * a.ways;
      for (int w = 0; w < a.ways; ++w) {
        const int64_t s = base + w;
        if (a.t.key[s] == h && a.t.expire_at[s] > now) {
          flag |= kFound;
          slot = (int32_t)s;
          break;
        }
      }
      if (flag & kFound) {
        a.claim[slot] = kReserved;
      } else {
        flag |= kNeed;
      }
    }
    a.lflag[i] = flag;
    a.lslot[i] = slot;
    a.lvslot[i] = -1;
  }
}

// Settle the previous claim attempt of lane i: it won if the word names it.
__device__ __forceinline__ bool settle(const Args& a, int i, int32_t& flag) {
  const int32_t v = a.lvslot[i];
  if ((flag & kNeed) && v >= 0 &&
      *((volatile int32_t*)(a.claim + v)) == i) {
    flag = (flag & ~kNeed) | kWon;
    a.lflag[i] = flag;
    a.lslot[i] = v;
    a.lvslot[i] = -1;
    return true;
  }
  return false;
}

// Phase "choose": settle the last attempt, then pick the best unblocked way.
__device__ void choose_phase(const Args& a, const int64_t* q, int64_t now,
                             int64_t nbm) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.B; i += stride) {
    int32_t flag = a.lflag[i];
    if (!(flag & kNeed)) continue;
    if (settle(a, i, flag)) continue;
    const int64_t h = __ldg(q + i);
    const int64_t base = (h & nbm) * a.ways;
    int64_t vmin = 0;
    int best = 0;
    for (int w = 0; w < a.ways; ++w) {
      const int64_t s = base + w;
      const bool blocked = a.claim[s] != kFree;
      const int64_t vs = blocked ? kInf : victim_score(a.t, s, h, now);
      if (w == 0 || vs < vmin) {
        vmin = vs;
        best = w;
      }
    }
    a.lvslot[i] = vmin < kInf ? (int32_t)(base + best) : -1;
  }
}

// Phase "claim": the lowest attempting lane wins each word.
__device__ void claim_phase(const Args& a) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.B; i += stride) {
    const int32_t v = a.lvslot[i];
    if ((a.lflag[i] & kNeed) && v >= 0) atomicMin(a.claim + v, i);
  }
}

// Phase "decide": settle the last claim, then gather, decide, write back,
// respond, and restore the claim word.  One lane of apply_batch_impl
// (gubernator_tpu/ops/step.py:252-486).
__device__ void decide_phase(const Args& a, const int64_t* q, int64_t now,
                             int64_t* resp) {
  const int stride = gridDim.x * blockDim.x;
  const int64_t B = a.B;
  const Table& t = a.t;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.B; i += stride) {
    int32_t flag = a.lflag[i];
    if (!(flag & kActive)) {
      // An inactive lane reads nothing but its active word; it answers zero.
      for (int r = 0; r < kRespRows; ++r) resp[r * B + i] = 0;
      continue;
    }
    settle(a, i, flag);
    const bool found = flag & kFound;
    const bool persist = found || (flag & kWon);
    const int64_t slot = persist ? a.lslot[i] : 0;

    const int64_t h = __ldg(q + i);
    const int64_t r_hits = __ldg(q + 1 * B + i);
    const int64_t r_lim = __ldg(q + 2 * B + i);
    const int64_t r_dur = __ldg(q + 3 * B + i);
    const int32_t algo = (int32_t)__ldg(q + 4 * B + i);
    const int64_t r_burst = __ldg(q + 5 * B + i);
    const bool reset = __ldg(q + 6 * B + i) != 0;
    const bool is_greg = __ldg(q + 7 * B + i) != 0;
    const int64_t greg_exp = __ldg(q + 8 * B + i);
    const int64_t greg_dur = __ldg(q + 9 * B + i);
    const bool use_cached = __ldg(q + 11 * B + i) != 0;

    // Row gather: only found lanes' outputs depend on it.
    int32_t s_algo = 0, s_kind = 0, s_status = 0;
    int64_t s_limit = 0, s_dur = 0, s_rem = 0, s_t0 = 0, s_burst = 0,
            s_expire = 0;
    double s_rem_f = 0.0;
    if (found) {
      s_algo = t.algo[slot];
      s_kind = t.kind[slot];
      s_limit = t.limit[slot];
      s_dur = t.duration[slot];
      s_rem = t.remaining[slot];
      s_rem_f = t.remaining_f[slot];
      s_t0 = t.t0[slot];
      s_status = t.status[slot];
      s_burst = t.burst[slot];
      s_expire = t.expire_at[slot];
    }

    const bool req_token = algo == 0;
    const bool req_leaky = algo == 1;
    const bool is_bucket_row = found && s_kind == 0;
    const bool cached_hit = found && s_kind == 1 && use_cached;
    const bool tok_clear = req_token && reset && found;
    const bool tok_exist = req_token && !reset && is_bucket_row && s_algo == 0;
    const bool lky_exist = req_leaky && is_bucket_row && s_algo == 1;
    const bool is_new = !tok_clear && !tok_exist && !lky_exist;
    const bool tok_new = is_new && req_token;
    const bool lky_new = is_new && req_leaky;

    // Outputs of the selected path; all-zero for a path-less lane (an
    // algorithm id that is neither bucket).
    int64_t o_status = 0, o_rem = 0, o_reset = 0, o_stored = 0;
    int32_t o_stored_status = 0;
    int64_t n_limit = 0, n_dur = 0, n_rem = 0, n_t0 = 0, n_burst = 0,
            n_expire = 0;
    double n_rem_f = 0.0;
    int32_t n_status = 0;

    const double f_now = f64(now);
    const double f_lim = f64(r_lim);
    const int64_t safe_lim = r_lim == 0 ? 1 : r_lim;

    if (tok_clear) {
      // algorithms.go:78-90: the row is cleared, remaining = limit.
      o_rem = r_lim;
      o_stored = r_lim;
    } else if (tok_exist) {
      // ==== token bucket, existing item (algorithms.go:112-195) ====
      const int64_t rem0 = s_limit != r_lim
          ? imax(sat_sub(sat_add(s_rem, r_lim), s_limit), 0) : s_rem;
      const bool dur_changed = s_dur != r_dur;
      const int64_t expire1 = is_greg ? greg_exp : sat_add(s_t0, r_dur);
      const bool renew = dur_changed && expire1 <= now;
      const int64_t te_expire = dur_changed
          ? (renew ? sat_add(now, r_dur) : expire1) : s_expire;
      const int64_t te_t0 = renew ? now : s_t0;
      const int64_t rem1 = renew ? r_lim : rem0;
      const bool h0 = r_hits == 0;
      const bool over_zero = !h0 && rem0 == 0 && r_hits > 0;
      const bool exact = !h0 && !over_zero && rem1 == r_hits;
      const bool over_more = !h0 && !over_zero && !exact && r_hits > rem1;
      const bool under = !h0 && !over_zero && !exact && !over_more;
      const int64_t te_rem = exact ? 0 : (under ? wsub(rem1, r_hits) : rem1);
      const int32_t te_status = over_zero ? 1 : s_status;
      o_status = (over_zero || over_more) ? 1 : s_status;
      o_rem = (exact || under) ? te_rem : rem0;
      o_reset = te_expire;
      o_stored = te_rem;
      o_stored_status = te_status;
      n_limit = r_lim;
      n_dur = r_dur;
      n_rem = te_rem;
      n_t0 = te_t0;
      n_status = te_status;
      n_burst = s_burst;
      n_expire = te_expire;
    } else if (tok_new) {
      // ==== token bucket, new item (algorithms.go:203-258) ====
      const bool tn_over = r_hits > r_lim;
      const int64_t tn_rem = tn_over ? r_lim : wsub(r_lim, r_hits);
      const int64_t tn_expire = is_greg ? greg_exp : sat_add(now, r_dur);
      o_status = tn_over ? 1 : 0;
      o_rem = tn_rem;
      o_reset = tn_expire;
      o_stored = tn_rem;
      n_limit = r_lim;
      n_dur = r_dur;
      n_rem = tn_rem;
      n_t0 = now;
      n_expire = tn_expire;
    } else if (lky_exist) {
      // ==== leaky bucket, existing item (algorithms.go:327-426) ====
      const double lb0 = reset ? f64(r_burst) : s_rem_f;
      const bool grow = s_burst != r_burst && r_burst > trunc_i64(lb0);
      const double lb1 = grow ? f64(r_burst) : lb0;
      const int64_t l_dur_c = is_greg ? wsub(greg_exp, now) : r_dur;
      const double l_rate = r_lim == 0
          ? 0.0 : __ddiv_rn(is_greg ? f64(greg_dur) : f64(r_dur), f64(safe_lim));
      const int64_t le_expire = r_hits != 0 ? sat_add(now, l_dur_c) : s_expire;
      const double elapsed = f64(wsub(now, s_t0));
      const double leak = l_rate != 0.0 ? __ddiv_rn(elapsed, l_rate) : 0.0;
      const bool leaked = trunc_i64(leak) > 0;
      const double lb2 = leaked ? __dadd_rn(lb1, leak) : lb1;
      const int64_t le_t0 = leaked ? now : s_t0;
      const double lb3 = trunc_i64(lb2) > r_burst ? f64(r_burst) : lb2;
      const int64_t lrem_i = trunc_i64(lb3);
      const int64_t lrate_i = trunc_i64(l_rate);
      const bool l_over_zero = lrem_i == 0 && r_hits > 0;
      const bool l_exact = !l_over_zero && lrem_i == r_hits;
      const bool l_over_more = !l_over_zero && !l_exact && r_hits > lrem_i;
      const bool l_take = l_exact ||
          (!l_over_zero && !l_exact && !l_over_more && r_hits != 0);
      const double lb4 = l_take ? __dsub_rn(lb3, f64(r_hits)) : lb3;
      const int64_t le_resp_rem = l_exact ? 0 : (l_take ? trunc_i64(lb4) : lrem_i);
      const double f_lrate = f64(lrate_i);
      o_status = (l_over_zero || l_over_more) ? 1 : 0;
      o_rem = le_resp_rem;
      o_reset = trunc_i64(l_take
          ? reset_expr(f_now, f_lim, f64(le_resp_rem), f_lrate)
          : reset_expr(f_now, f_lim, f64(lrem_i), f_lrate));
      o_stored = trunc_i64(lb4);
      n_limit = r_lim;
      n_dur = r_dur;
      n_rem_f = lb4;
      n_t0 = le_t0;
      n_burst = r_burst;
      n_expire = le_expire;
    } else if (lky_new) {
      // ==== leaky bucket, new item (algorithms.go:433-492) ====
      // The rate uses the RAW duration even under Gregorian (:441).
      const int64_t ln_rate_i = trunc_i64(
          r_lim == 0 ? 0.0 : __ddiv_rn(f64(r_dur), f64(safe_lim)));
      const int64_t ln_dur = is_greg ? wsub(greg_exp, now) : r_dur;
      const bool ln_over = r_hits > r_burst;
      const double ln_rem_f = ln_over ? 0.0 : f64(wsub(r_burst, r_hits));
      const int64_t ln_resp_rem = ln_over ? 0 : wsub(r_burst, r_hits);
      o_status = ln_over ? 1 : 0;
      o_rem = ln_resp_rem;
      o_reset = trunc_i64(reset_expr(f_now, f_lim, f64(ln_resp_rem),
                                     f64(ln_rate_i)));
      o_stored = trunc_i64(ln_rem_f);
      n_limit = r_lim;
      n_dur = ln_dur;
      n_rem_f = ln_rem_f;
      n_t0 = now;
      n_burst = r_burst;
      n_expire = sat_add(now, ln_dur);
    }

    int64_t o_limit = r_lim;
    if (cached_hit) {
      // GLOBAL non-owner read (gubernator.go:434-447): verbatim, no write.
      o_status = s_status;
      o_limit = s_limit;
      o_rem = s_rem;
      o_reset = s_expire;
      o_stored = s_rem;
      o_stored_status = s_status;
    }

    resp[0 * B + i] = (int64_t)(int32_t)o_status;
    resp[1 * B + i] = o_limit;
    resp[2 * B + i] = o_rem;
    resp[3 * B + i] = o_reset;
    resp[4 * B + i] = persist ? 1 : 0;
    resp[5 * B + i] = found ? 1 : 0;
    resp[6 * B + i] = o_stored;
    resp[7 * B + i] = cached_hit ? 1 : 0;
    resp[8 * B + i] = (int64_t)o_stored_status;

    if (persist && !cached_hit) {
      t.key[slot] = tok_clear ? 0 : h;
      t.algo[slot] = tok_clear ? 0 : algo;
      t.kind[slot] = 0;
      t.limit[slot] = n_limit;
      t.duration[slot] = n_dur;
      t.remaining[slot] = n_rem;
      t.remaining_f[slot] = n_rem_f;
      t.t0[slot] = n_t0;
      t.status[slot] = n_status;
      t.burst[slot] = n_burst;
      t.expire_at[slot] = n_expire;
      t.touched[slot] = tok_clear ? 0 : now;
    }
    if (persist) a.claim[slot] = kFree;
  }
}

__global__ void __launch_bounds__(kThreads) serve_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) a.seq_out[0] = a.seq_in[0] + a.k;
  const int64_t nbm = a.S / a.ways - 1;
  for (int b = 0; b < a.k; ++b) {
    const int64_t* q = a.qs + (int64_t)b * kQRows * a.B;
    int64_t* resp = a.resps + (int64_t)b * kRespRows * a.B;
    const int64_t now = __ldg(a.nows + b);
    if (b > 0) grid.sync();  // round b sees round b-1's writes
    probe_phase(a, q, now, nbm);
    for (int r = 0; r < kInsertRounds; ++r) {
      grid.sync();
      choose_phase(a, q, now, nbm);
      grid.sync();
      claim_phase(a);
    }
    grid.sync();
    decide_phase(a, q, now, resp);
  }
}

// Grid of the cooperative launch for B lanes: enough blocks to give each
// lane a thread, capped at the co-resident limit.  Returns a cudaError_t.
int serve_grid(int device, int B, int* grid_out) {
  static int cap_of[64] = {0};  // co-resident block limit per device
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, serve_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cap_of[device] = sms * per_sm;
  }
  int want = (B + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  *grid_out = want < cap_of[device] ? want : cap_of[device];
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  cols: the 12 table column pointers in SlotTable
// field order.  scratch: int32[3 * B].  Returns a cudaError_t.
int gub_serve_launch(int device, void* stream, void** cols, long long S,
                     int ways, const int64_t* qs, const int64_t* nows,
                     const int64_t* seq_in, int64_t* seq_out, int64_t* resps,
                     int32_t* claim, int32_t* scratch, int k, int B) {
  int grid = 0;
  int err = serve_grid(device, B, &grid);
  if (err != (int)cudaSuccess) return err;
  Args a;
  a.t.key = (int64_t*)cols[0];
  a.t.algo = (int32_t*)cols[1];
  a.t.kind = (int32_t*)cols[2];
  a.t.limit = (int64_t*)cols[3];
  a.t.duration = (int64_t*)cols[4];
  a.t.remaining = (int64_t*)cols[5];
  a.t.remaining_f = (double*)cols[6];
  a.t.t0 = (int64_t*)cols[7];
  a.t.status = (int32_t*)cols[8];
  a.t.burst = (int64_t*)cols[9];
  a.t.expire_at = (int64_t*)cols[10];
  a.t.touched = (int64_t*)cols[11];
  a.qs = qs;
  a.nows = nows;
  a.seq_in = seq_in;
  a.seq_out = seq_out;
  a.resps = resps;
  a.claim = claim;
  a.lflag = scratch;
  a.lslot = scratch + B;
  a.lvslot = scratch + 2 * (int64_t)B;
  a.S = S;
  a.ways = ways;
  a.k = k;
  a.B = B;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)serve_kernel, dim3(grid), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
