// K1: the persistent decision kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_serve_kernel` / `persistent_serve_step_impl`
// (gubernator_tpu/ops/pallas/serve_kernel.py:57-143).  One dispatch drains k
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
// What bounds it.  Bytes are few: each active lane reads its request
// (96 B), the key/expire_at/touched words of its bucket (3 x 8 ways x 8 B),
// the rest of its own row, writes its row (84 B) and its response (72 B),
// about 0.5 KB scattered over the 1.4 GB table at 2^24 slots, with almost no
// arithmetic.  But the table is twelve column arrays, so a lane touches
// some 25 separate sectors of device memory.  A full round (32768 lanes)
// takes about 60 us on the H100 in either design, most likely set by that
// scattered traffic and its latency under load.  Most rounds of a check()
// are small (the duplicates of the first round's keys), and a small round
// is set by its chain of dependent steps: probe, up to three (choose,
// claim) pairs and decide, each needing the one before.  The first design
// put a grid-wide barrier between the steps, 8 a round; here they are
// ordered inside a block.
//
// Design: bucket-owner blocks.  Every dependency inside a round is local to
// a bucket: the probe, the victim score and the claims index only the W
// slots of bucket = h & (nb - 1), "lowest lane wins" compares lanes that
// attempt the same slot, and a lane writes back only its own slot.  Round
// b + 1 depends on round b only through the slots of the same bucket.  So
// a block that owns a fixed set of buckets (owner = bucket % G) and handles
// every lane of every round whose bucket it owns can drain all k rounds
// with __syncthreads() alone.  The dispatch is two launches on one stream:
//
// 1. k1_bin_kernel, a block per (part of 1024 lanes, round): inactive lanes
//    answer zero here (resps is not zeroed beforehand).  Each active lane
//    takes a rank in its owner's count (shared-memory atomics; the counts
//    are zeroed inside the launch), the block scans the counts into
//    offsets, writes each owner's (offset, count) in this part, and
//    scatters the lane ids into its part of `list`, grouped by owner.  The
//    lists hold every active lane exactly once, in room of exactly B a
//    round.
// 2. k1_walk_kernel, G blocks: block g drains rounds 0..k-1 over its own
//    lanes only, the concatenation of its sub-lists of the round's parts:
//
//      probe | (choose | claim) x <= 3 | decide     (__syncthreads between)
//
//    The claim rounds stop as soon as no lane of the block attempts a
//    slot (__syncthreads_or).  Owners never wait on each other; one with no
//    bucket (G > nb) finds every list empty.
//
// The stream order between the two launches is the dispatch's one
// device-wide barrier, whatever k is.
//
// The claim word buffer `claim` (int32[S], all INT32_MAX between dispatches)
// replaces the TPU's sort-based "lowest lane wins": a found lane marks its
// slot reserved (-1); an inserting lane picks its best unblocked way (lowest
// score, lowest way on ties) from the words as they stood at the claim
// round's start, then atomicMin's its lane id i (its index in the round,
// never its place in a list) into the word; the word's final value names
// the winner, which keeps the slot blocked for the next claim rounds.
// Decide restores every found lane's and winner's word, and every attempted
// word has a winner, so the buffer is all INT32_MAX again.  Claim words and
// rows are touched by their owner block only, so __syncthreads() orders
// them; claim words are read at L2 (__ldcg), where the atomics land.
// Per-lane scratch (flag, slot, attempted slot) is kept per list entry.
//
// Gather, algebra and write-back share the decide step: a lane whose output
// depends on a row reads only its own found slot, and only that lane writes
// it (found slots are blocked from victims); transient lanes read and write
// no row.  Arithmetic that wraps in the JAX form goes through uint64_t; the
// saturating helpers clamp, then add; float64 math keeps the JAX evaluation
// order with explicit _rn intrinsics (and the build passes -fmad=false), so
// no multiply-add is contracted.
//
// The store: the GLOBAL replica upsert.  gub_store_launch writes one block
// of owner-broadcast rows (int64[6, L]: key hash, algo, limit, remaining,
// status, reset time; key 0 = inactive) into a replica as KIND_CACHED_RESP
// rows, the plain form being ops/step.py `store_cached_rows`.  It replaces
// no Pallas kernel: the JAX form, gubernator_tpu/ops/step.py:634
// `store_cached_rows_impl`, is plain XLA, and its torch port's three
// sort-based claim rounds and host sync (the nonzero() of its scatter)
// set the GLOBAL sync's broadcast stage.  It is K1's dispatch with a
// write in place of the algebra: k1_bin_kernel<true> bins the lanes by
// owner (a lane is active where its key is nonzero), then k1_store_kernel
// runs the same probe and (choose | claim) x <= 3 on the same claim words
// and stores each found or winning lane's row; a lane that wins no slot
// writes nothing, as the plain form drops it.  What bounds it on this
// card: a probe of W ways (3 x 8 B a way) and a 12-column row write a
// lane, a few KB at L = 1024, so it is set by its chain of dependent
// steps and its two launches, like a small K1 round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPartLanes = 1024;   // lanes per bin block (a thread each)
constexpr int kWalkThreads = 256;
constexpr int kMaxOwners = 2048;   // G: walk blocks, capped
constexpr int kMaxParts = 2048;    // parts per round: B <= 2^21
constexpr int kInsertRounds = 3;
constexpr int kQRows = 12;
constexpr int kRespRows = 9;
constexpr int32_t kFree = INT32_MAX;   // claim word: nobody claimed
constexpr int32_t kReserved = -1;      // claim word: a found lane's slot
constexpr int64_t kInf = int64_t(1) << 62;
constexpr int32_t kKindCachedResp = 1;  // ops/state.py KIND_CACHED_RESP

// Lane state flags (scratch `lflag`).
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
  int32_t* list;         // [k, B]: lane ids, per part grouped by owner
  int32_t* lflag;        // [k, B], per list entry
  int32_t* lslot;        // [k, B], per list entry
  int32_t* lvslot;       // [k, B], per list entry
  int32_t* sub;          // [k, P, G, 2]: (offset in the part, count)
  int64_t S;
  int ways;
  int k;
  int B;
  int G;
  int P;
  int64_t now;           // the store's clock (K1 reads nows[b])
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

// Inclusive sum of x over the block's threads, in thread order.  Every
// thread of the block must call it; `warp_sums` holds 32 ints of shared
// memory.
__device__ int block_inclusive_sum(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // warp_sums may still be read from an earlier call
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  return warp > 0 ? x + warp_sums[warp - 1] : x;
}

__device__ __forceinline__ int owner_of(int64_t h, int64_t nbm, int G) {
  return (int)((uint64_t)(h & nbm) % (uint64_t)G);
}

// Launch 1: bin part blockIdx.x of round blockIdx.y by owner.  K1's lanes
// are active by their active word (row 10); the store's (kStore) by a
// nonzero key (row 0), and it has no responses or sequence word.
template <bool kStore>
__global__ void __launch_bounds__(kPartLanes) k1_bin_kernel(Args a) {
  __shared__ int cnt[kMaxOwners];
  __shared__ int off[kMaxOwners];
  __shared__ int warp_sums[32];
  const int p = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  if constexpr (!kStore) {
    if (p == 0 && b == 0 && t == 0) a.seq_out[0] = a.seq_in[0] + a.k;
  }
  for (int g = t; g < a.G; g += blockDim.x) cnt[g] = 0;
  __syncthreads();

  const int64_t B = a.B;
  const int64_t* q = a.qs + (int64_t)b * kQRows * B;
  const int i = p * kPartLanes + t;
  const int64_t nbm = a.S / a.ways - 1;
  int owner = -1, rank = 0;
  if (i < a.B) {
    if (__ldg(q + (kStore ? 0 : 10) * B + i) != 0) {
      owner = owner_of(__ldg(q + i), nbm, a.G);
      rank = atomicAdd(&cnt[owner], 1);
    } else if constexpr (!kStore) {
      // An inactive lane reads nothing but its active word; it answers zero.
      int64_t* resp = a.resps + (int64_t)b * kRespRows * B;
      for (int r = 0; r < kRespRows; ++r) resp[r * B + i] = 0;
    }
  }
  __syncthreads();

  // Exclusive scan of the counts; thread t takes owners [t*E, t*E + E).
  const int E = (a.G + blockDim.x - 1) / blockDim.x;
  int local = 0;
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    if (g < a.G) local += cnt[g];
  }
  int run = block_inclusive_sum(local, warp_sums) - local;
  int32_t* sub = a.sub + ((int64_t)b * a.P + p) * a.G * 2;
  for (int e = 0; e < E; ++e) {
    const int g = t * E + e;
    if (g < a.G) {
      off[g] = run;
      sub[2 * g] = run;
      sub[2 * g + 1] = cnt[g];
      run += cnt[g];
    }
  }
  __syncthreads();
  if (owner >= 0) a.list[b * B + (int64_t)p * kPartLanes + off[owner] + rank] = i;
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

// Probe: find lane i's live match and mark it reserved.  Returns whether
// the lane needs an insert slot.
__device__ bool probe(const Args& a, const int64_t* q, int64_t now,
                      int64_t nbm, int i, int64_t e) {
  const int64_t h = __ldg(q + i);
  const int64_t base = (h & nbm) * a.ways;
  int32_t flag = 0, slot = -1;
  for (int w = 0; w < a.ways; ++w) {
    const int64_t s = base + w;
    if (a.t.key[s] == h && a.t.expire_at[s] > now) {
      flag = kFound;
      slot = (int32_t)s;
      break;
    }
  }
  if (flag & kFound) {
    a.claim[slot] = kReserved;
  } else {
    flag = kNeed;
  }
  a.lflag[e] = flag;
  a.lslot[e] = slot;
  a.lvslot[e] = -1;
  return flag & kNeed;
}

// Settle list entry e's (lane i's) last claim attempt: it won if the word
// names it.
__device__ __forceinline__ bool settle(const Args& a, int i, int64_t e,
                                       int32_t& flag) {
  const int32_t v = a.lvslot[e];
  if ((flag & kNeed) && v >= 0 && __ldcg(a.claim + v) == i) {
    flag = (flag & ~kNeed) | kWon;
    a.lflag[e] = flag;
    a.lslot[e] = v;
    a.lvslot[e] = -1;
    return true;
  }
  return false;
}

// Choose: settle the last attempt, then pick the best unblocked way.
// Returns whether the lane attempts a slot in this claim round.
__device__ bool choose(const Args& a, const int64_t* q, int64_t now,
                       int64_t nbm, int i, int64_t e) {
  int32_t flag = a.lflag[e];
  if (!(flag & kNeed)) return false;
  if (settle(a, i, e, flag)) return false;
  const int64_t h = __ldg(q + i);
  const int64_t base = (h & nbm) * a.ways;
  int64_t vmin = 0;
  int best = 0;
  for (int w = 0; w < a.ways; ++w) {
    const int64_t s = base + w;
    const bool blocked = __ldcg(a.claim + s) != kFree;
    const int64_t vs = blocked ? kInf : victim_score(a.t, s, h, now);
    if (w == 0 || vs < vmin) {
      vmin = vs;
      best = w;
    }
  }
  const bool attempt = vmin < kInf;
  a.lvslot[e] = attempt ? (int32_t)(base + best) : -1;
  return attempt;
}

// Claim: the lowest attempting lane wins each word.
__device__ __forceinline__ void claim(const Args& a, int i, int64_t e) {
  const int32_t v = a.lvslot[e];
  if ((a.lflag[e] & kNeed) && v >= 0) atomicMin(a.claim + v, i);
}

// Decide: settle the last claim, then gather, decide, write back, respond,
// and restore the claim word.  One lane of apply_batch_impl
// (gubernator_tpu/ops/step.py:252-486).
__device__ void decide(const Args& a, const int64_t* q, int64_t now,
                       int64_t* resp, int i, int64_t e) {
  const int64_t B = a.B;
  const Table& t = a.t;
  int32_t flag = a.lflag[e];
  settle(a, i, e, flag);
  const bool found = flag & kFound;
  const bool persist = found || (flag & kWon);
  const int64_t slot = persist ? a.lslot[e] : 0;

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

// Store: settle the last claim, then write lane i's cached row into its
// found or won slot and restore the claim word; a lane with no slot writes
// nothing.  One lane of ops/step.py store_cached_rows.
__device__ void store_row(const Args& a, const int64_t* q, int64_t now,
                          int i, int64_t e) {
  int32_t flag = a.lflag[e];
  settle(a, i, e, flag);
  if (!(flag & (kFound | kWon))) return;
  const int64_t B = a.B;
  const Table& t = a.t;
  const int64_t slot = a.lslot[e];
  t.key[slot] = __ldg(q + i);
  t.algo[slot] = (int32_t)__ldg(q + 1 * B + i);
  t.kind[slot] = kKindCachedResp;
  t.limit[slot] = __ldg(q + 2 * B + i);
  t.duration[slot] = 0;
  t.remaining[slot] = __ldg(q + 3 * B + i);
  t.remaining_f[slot] = 0.0;
  t.t0[slot] = 0;
  t.status[slot] = (int32_t)__ldg(q + 4 * B + i);
  t.burst[slot] = 0;
  t.expire_at[slot] = __ldg(q + 5 * B + i);
  t.touched[slot] = now;
  a.claim[slot] = kFree;
}

// The block's round-b list, the concatenation of its sub-lists of the
// round's P parts: entry j lies at pos[p] + (j - pre[p]) of `list` (and of
// the per-entry scratch) for the largest p with pre[p] <= j.
struct OwnList {
  int pre[kMaxParts];   // exclusive prefix of the sub-list counts
  int64_t pos[kMaxParts];
  int n;
};

__device__ __forceinline__ int64_t entry_of(const OwnList& l, int P, int j) {
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (l.pre[mid] <= j) lo = mid; else hi = mid - 1;
  }
  return l.pos[lo] + (j - l.pre[lo]);
}

// Block g drains every round over the lanes whose bucket it owns: K1's
// walk, or with kStore the store's (its one round, a store in place of
// decide).
template <bool kStore>
__device__ __forceinline__ void walk(const Args& a) {
  __shared__ OwnList l;
  __shared__ int warp_sums[32];
  const int g = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int64_t B = a.B;
  const int64_t nbm = a.S / a.ways - 1;
  const int E = (a.P + nt - 1) / nt;  // parts per thread in the scan
  for (int b = 0; b < a.k; ++b) {
    const int64_t* q = a.qs + (int64_t)b * kQRows * B;
    int64_t* resp = kStore ? nullptr : a.resps + (int64_t)b * kRespRows * B;
    const int64_t now = kStore ? a.now : __ldg(a.nows + b);

    // This round's list: each part's sub-list (offset, count); the counts
    // sit in pre[] until the scan turns them into its exclusive prefix.
    int local = 0;
    for (int e = 0; e < E; ++e) {
      const int p = t * E + e;
      if (p < a.P) {
        const int32_t* s = a.sub + (((int64_t)b * a.P + p) * a.G + g) * 2;
        l.pos[p] = b * B + (int64_t)p * kPartLanes + __ldg(s);
        l.pre[p] = __ldg(s + 1);
        local += l.pre[p];
      }
    }
    const int incl = block_inclusive_sum(local, warp_sums);
    int run = incl - local;
    for (int e = 0; e < E; ++e) {
      const int p = t * E + e;
      if (p < a.P) {
        const int c = l.pre[p];
        l.pre[p] = run;
        run += c;
      }
    }
    if (t == nt - 1) l.n = incl;
    __syncthreads();  // pre[], pos[] and n are complete
    const int n = l.n;
    if (n == 0) continue;

    bool need = false;
    for (int j = t; j < n; j += nt) {
      const int64_t e = entry_of(l, a.P, j);
      need |= probe(a, q, now, nbm, __ldg(a.list + e), e);
    }
    bool go = __syncthreads_or(need);
    for (int r = 0; go && r < kInsertRounds; ++r) {
      bool attempt = false;
      for (int j = t; j < n; j += nt) {
        const int64_t e = entry_of(l, a.P, j);
        attempt |= choose(a, q, now, nbm, __ldg(a.list + e), e);
      }
      if (!__syncthreads_or(attempt)) break;
      for (int j = t; j < n; j += nt) {
        const int64_t e = entry_of(l, a.P, j);
        claim(a, __ldg(a.list + e), e);
      }
      __syncthreads();
    }
    for (int j = t; j < n; j += nt) {
      const int64_t e = entry_of(l, a.P, j);
      if constexpr (kStore) {
        store_row(a, q, now, __ldg(a.list + e), e);
      } else {
        decide(a, q, now, resp, __ldg(a.list + e), e);
      }
    }
    __syncthreads();  // round b + 1 sees round b's rows and claim words
  }
}

// Launch 2: K1's walk.
__global__ void __launch_bounds__(kWalkThreads) k1_walk_kernel(Args a) {
  walk<false>(a);
}

// The store's launch 2: the walk over its one round of rows.
__global__ void __launch_bounds__(kWalkThreads) k1_store_kernel(Args a) {
  walk<true>(a);
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

// Owners (walk blocks) of `device`: as many as fit on the card at once.
// Returns a cudaError_t.
int device_owners(int device, int* G) {
  static int owners_of[64] = {0};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (owners_of[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k1_walk_kernel, kWalkThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int g = sms * (per_sm < 1 ? 1 : per_sm);
    owners_of[device] = g < kMaxOwners ? g : kMaxOwners;
  }
  *G = owners_of[device];
  return (int)cudaSuccess;
}

int parts_of(int B) { return B <= 0 ? 1 : (B + kPartLanes - 1) / kPartLanes; }

// int32 words of scratch a dispatch of k rounds of B lanes needs on
// `device` (the caller selects and restores the device), or a negated
// cudaError_t.
long long scratch_words_of(int device, int k, int B) {
  int G = 0;
  const int err = device_owners(device, &G);
  if (err != (int)cudaSuccess) return -(long long)err;
  if (k < 0 || B < 0 || parts_of(B) > kMaxParts) return -(long long)cudaErrorInvalidValue;
  return 4LL * k * B + 2LL * k * parts_of(B) * G;
}

// Args of a dispatch of k rounds of B lanes on `device`: the 12 table
// columns (SlotTable field order), the claim words and the scratch (checked
// against what the dispatch needs).  Returns a cudaError_t.
int dispatch_args(Args& a, int device, void** cols, long long S, int ways,
                  int32_t* claim, int32_t* scratch, long long scratch_words,
                  int k, int B) {
  const long long need = scratch_words_of(device, k, B);
  if (need < 0) return (int)-need;
  if (k < 1 || ways < 1 || scratch_words < need) return (int)cudaErrorInvalidValue;
  int G = 0;
  device_owners(device, &G);
  a = Args{};
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
  a.claim = claim;
  const int64_t kB = (int64_t)k * B;
  a.list = scratch;
  a.lflag = scratch + kB;
  a.lslot = scratch + 2 * kB;
  a.lvslot = scratch + 3 * kB;
  a.sub = scratch + 4 * kB;
  a.S = S;
  a.ways = ways;
  a.k = k;
  a.B = B;
  a.G = G;
  a.P = parts_of(B);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Number of owner blocks K1 uses on `device` (owner = bucket % G), or a
// negated cudaError_t.
int gub_serve_owners(int device) {
  DeviceGuard guard;
  int G = 0;
  const int err = device_owners(device, &G);
  return err != (int)cudaSuccess ? -err : G;
}

// int32 words of scratch a dispatch of k rounds of B lanes needs on
// `device`, or a negated cudaError_t.
long long gub_serve_scratch_words(int device, int k, int B) {
  DeviceGuard guard;
  return scratch_words_of(device, k, B);
}

// Dispatch K1 on `stream`: k1_bin_kernel, then k1_walk_kernel.  cols: the 12
// table column pointers in SlotTable field order.  scratch: int32 words,
// gub_serve_scratch_words(device, k, B) of them.  Returns a cudaError_t.
int gub_serve_launch(int device, void* stream, void** cols, long long S,
                     int ways, const int64_t* qs, const int64_t* nows,
                     const int64_t* seq_in, int64_t* seq_out, int64_t* resps,
                     int32_t* claim, int32_t* scratch, long long scratch_words,
                     int k, int B) {
  DeviceGuard guard;
  Args a;
  const int err = dispatch_args(a, device, cols, S, ways, claim, scratch,
                                scratch_words, k, B);
  if (err != (int)cudaSuccess) return err;
  a.qs = qs;
  a.nows = nows;
  a.seq_in = seq_in;
  a.seq_out = seq_out;
  a.resps = resps;
  cudaStream_t st = (cudaStream_t)stream;
  k1_bin_kernel<false><<<dim3(a.P, k), kPartLanes, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k1_walk_kernel<<<a.G, kWalkThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Dispatch the store on `stream`: k1_bin_kernel<true>, then k1_store_kernel.
// rows: int64[6, B] (key hash, algo, limit, remaining, status, reset time;
// key 0 = inactive), keys unique; they become KIND_CACHED_RESP rows touched
// at `now`.  scratch: gub_serve_scratch_words(device, 1, B) words.  Returns
// a cudaError_t.
int gub_store_launch(int device, void* stream, void** cols, long long S,
                     int ways, const int64_t* rows, long long now,
                     int32_t* claim, int32_t* scratch,
                     long long scratch_words, int B) {
  DeviceGuard guard;
  Args a;
  const int err = dispatch_args(a, device, cols, S, ways, claim, scratch,
                                scratch_words, 1, B);
  if (err != (int)cudaSuccess) return err;
  a.qs = rows;
  a.now = now;
  cudaStream_t st = (cudaStream_t)stream;
  k1_bin_kernel<true><<<dim3(a.P, 1), kPartLanes, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k1_store_kernel<<<a.G, kWalkThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
