// Batched quantum admission for Hopper (sm_90a), CUDA C++, plain C entry
// points bound from Python with ctypes.
//
// Replaces src/repro/core/vectorized.py::admit_quantum.  That function is
// not a Pallas kernel: it is a jitted lax.fori_loop that XLA fuses into one
// device loop, the exact sequential replay of the paper's §4.3 admission
// pipeline (bound → concurrency → token budget / KV → priority) over one
// scheduling quantum of M requests against a pool of N entitlement rows.
// Request i sees every state change made by requests 0..i-1.
//
// What bounds it on the H100.  Not bytes (each input read once is ~1.6 MB
// at N = 4,096 rows and M = 65,536 requests, under a microsecond at
// 3.35 TB/s) and not arithmetic (a few dozen operations a request), but
// the dependent chain.  Read as M dependent steps it is 65,536 steps long
// (the first port's serial kernel walked it with one thread at ~170
// cycles a step).  It is much shorter than that: the state
// a request reads is its row's bucket and KV, which only its own row's
// requests change, and two pool scalars that move one way each —
//   * the admitted count only grows, so "contended" (f32(count) > cap;
//     the int-to-float rounding is monotone) turns on at most once;
//   * the running minimum only falls, on an admit below it, and is read
//     only while the pool is contended.
// So the quantum is N independent per-row chains (16 requests a row on
// average at the draw, 31 at most) joined at the few points where a pool
// scalar changes.
//
// Design: speculate and commit, by rounds, in one cluster of 8 CTAs of
// 1,024 threads (the `rounds` route, admit_rounds_kernel).  Every step
// below is scattered reads and writes of a few bytes, and what bounds a
// scattered access is the SM's path to L2 (32-byte sectors): one CTA
// moved ~14 sectors a request and took 0.63 ms at the draw, 64 % of it in
// the grouping.  So the work is spread over a cluster's SMs, joined by
// cluster barriers and distributed shared memory, and each request costs
// a few sectors: a 16-byte entry (index, tokens, KV, row << 1 | live)
// that carries everything through the sort, and one decision byte.
//   1. Grouping, once per launch: a stable LSD radix sort of the entries
//      by row, 8 bits a pass (two passes for N <= 65,536), by hand: each
//      warp of the cluster owns a contiguous slice of arrival order and
//      counts its digits into its own 256-bin histogram in shared memory;
//      the (digit, warp) offsets come from the CTAs' digit totals read
//      over distributed shared memory and one block scan; each warp then
//      scatters its slice 32 entries at a time, ranking the lanes of equal
//      digit (eight ballots) in lane order.  Both orders that make the
//      sort stable — warps by slice, lanes within a group — are arrival
//      order, so each row's requests come out in arrival order
//      (shared-memory atomics alone would lose it).
//   2. Speculative pass: thread t of the cluster walks rows t, t + 8192,
//      ... from the first uncommitted request with the pool scalars
//      frozen; rows longer than LONG_ROW go to a warp each, whose lanes
//      load 32 entries at a time and shuffle them through the chain.  The
//      row's checks that depend only on the row and the frozen scalars are
//      hoisted out of the walk and the bucket and KV are registers, so no
//      memory access lies on the chain.  Each request's packed decision
//      (admit | reason << 1) goes to a byte array.
//   3. Commit point c: contended, one past the first admit whose weight is
//      below the running minimum (an atomicMin in CTA 0's shared memory
//      during the pass; such a row stops at that admit); uncontended, one
//      past the admit that makes the pool contended (a cluster-wide scan
//      of the admit counts of 8,192 slices of arrival order); else M.
//      Everything before c saw the true pool state, so it is final.
//   4. Commit: each row replays its admits before c (a binary search
//      finds them) into its bucket and KV; the pool scalars are set at c
//      (after an uncontended round the running minimum is min-reduced over
//      the admits before c).  The committed decisions are unpacked in
//      arrival order at the end.
//   5. After MAX_ROUNDS rounds, or a round that committed fewer than
//      MIN_COMMIT requests (every admit lowering the minimum, say), a
//      second launch of one warp (admit_walk_kernel) finishes the quantum
//      with the serial walk below; it ends at once when nothing is left.
// A quantum of fewer than WALK_BELOW requests (the simulators' few
// requests a pool) takes that walk directly (the `walk` route,
// admit_walk_kernel, one warp): the grouping would cost more than it
// saves.  The walk's 32 lanes hold 32 requests and each keeps its own
// request's row bucket and KV in registers (read once per group, written
// back once); at step j every lane computes request j's decision from
// lane j's state by shuffles and the lanes of j's row apply an admit, so
// no memory access lies on the chain, and the contention test is an
// integer compare against a count found once.  The inputs are staged in
// two steps ahead of the chain.
//
// MAX_ROUNDS = 32, MIN_COMMIT = 512 and WALK_BELOW = 256 are passed by
// the wrapper (kernels/admit_quantum/admit_quantum.py), chosen from
// chip_smoke.py's timings on an H100 SXM (PERF.md): a round costs from
// ~9 us (4,097 rounds of 16 requests each in 37.6 ms) to ~34 us (a full
// round at the draw) and the walk ~110 cycles (~56 ns) a request, so a
// round pays only when it commits a few hundred requests or more; 32
// rounds of at least 512 bound the rounds at ~1 ms before the walk takes
// over, which keeps the worst case under that serial kernel's ~5.4 ms; and
// the walk beats the rounds' fixed cost below ~250 requests (0.0085 ms
// against 0.0204 at 32 requests, 0.0248 against 0.0219 at 256).
//
// Exactness against the XLA loop, decision for decision:
//   * int32 against f32 compares promote the int to f32 first
//     (__int2float_rn), as JAX does;
//   * the bucket and KV updates and the threshold product are single
//     rounded f32 operations (__fadd_rn, __fmul_rn), never contracted;
//     the slack factor 1 - slack is rounded to f32 by the caller;
//   * a padding request (live = 0) gets the reason of its row and state,
//     is never admitted, and changes nothing.
// The inputs are never written: the rounds route keeps the row state in
// the caller's global scratch (each row is touched once a round); the walk
// route in shared memory up to 24,576 rows, else in that scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SPOT = 3;                      // CLASS_CODES[SPOT]
// class-code bit masks (codes 0..4: dedicated, guaranteed, elastic,
// spot, preemptible)
constexpr unsigned PROTECTED_CODES = 0x03u;  // dedicated, guaranteed
constexpr unsigned BURSTOK_CODES = 0x1Du;    // all but guaranteed
// flag bits of a request's row
constexpr int F_BOUND = 1, F_LIVE = 2, F_BURSTOK = 4, F_PROT = 8,
              F_CONC = 16;
// the walk route keeps bucket and kv in shared memory when 8·N bytes fit
constexpr int MAX_SMEM_STATE_ROWS = 24576;
constexpr unsigned FULL = 0xffffffffu;

constexpr int RT = 1024;                     // threads of the rounds route
constexpr int WARPS = RT / 32;
constexpr int DIGITS = 256;                  // radix-sort bins (8 bits)

struct Args {
  const int* __restrict__ class_code;
  const uint8_t* __restrict__ bound;
  const float* __restrict__ baseline_kv;
  const float* __restrict__ baseline_conc;
  const float* __restrict__ weights;
  const float* __restrict__ bucket_in;
  const int* __restrict__ in_flight;
  const float* __restrict__ kv_in;
  const int* __restrict__ req_ent;
  const float* __restrict__ req_tokens;
  const float* __restrict__ req_kv;
  const uint8_t* __restrict__ req_live;
  uint8_t* admitted;
  int* reason;
  float* prio;
  int n_rows, m, pool_in_flight;
  float pool_resident, cap, running_min, slack_factor;
};

// Global scratch (bytes from the start of the caller's buffer, each part
// 128-byte aligned): the radix sort's two buffers of packed entries (the
// second pass's output is the grouped order), each row's first request
// and first uncommitted request, the rows' bucket and KV, each
// request's packed decision (admit bit | reason << 1), and where the
// serial walk resumes (request, contended, running minimum).
struct Layout {
  size_t ent0, ent1, start, ptr, bucket, kv, dec, resume, bytes;
};

__host__ __device__ inline size_t up128(size_t x) {
  return (x + 127) & ~size_t(127);
}

__host__ __device__ inline Layout layout(int n, int m) {
  Layout l;
  size_t at = 0;
  l.ent0 = at;   at = up128(at + 16 * size_t(m));
  l.ent1 = at;   at = up128(at + 16 * size_t(m));
  l.start = at;  at = up128(at + 4 * size_t(n + 1));
  l.ptr = at;    at = up128(at + 4 * size_t(n));
  l.bucket = at; at = up128(at + 4 * size_t(n));
  l.kv = at;     at = up128(at + 4 * size_t(n));
  l.dec = at;    at = up128(at + size_t(m));
  l.resume = at; at = up128(at + 16);
  l.bytes = at;
  return l;
}

__device__ __forceinline__ int clamp_row(int e, int n) {
  return e < 0 ? 0 : (e >= n ? n - 1 : e);
}

// The row-static flags of row e: bound, burst-capable, protected, and the
// row-static half of the concurrency check (resident counts are frozen
// within a quantum).
__device__ __forceinline__ int row_flags(const Args& a, int e) {
  const int cc = a.class_code[e];
  const float r_lim = a.baseline_conc[e];
  const float r_eff = (r_lim <= 0.0f && cc == SPOT) ? a.cap : r_lim;
  const bool conc = (r_eff <= 0.0f) ||
                    (__int2float_rn(a.in_flight[e]) < r_eff);
  const unsigned bit = (cc >= 0 && cc < 32) ? (1u << cc) : 0u;
  int f = 0;
  f |= a.bound[e] ? F_BOUND : 0;
  f |= (BURSTOK_CODES & bit) ? F_BURSTOK : 0;
  f |= (PROTECTED_CODES & bit) ? F_PROT : 0;
  f |= conc ? F_CONC : 0;
  return f;
}

// Admits after which a pool holding p0 requests is contended: the least
// k >= 1 with f32(p0 + k) > cap (the rounding is monotone), or INT_MAX.
// Called when f32(p0) <= cap.
__device__ __forceinline__ int admits_to_contend(int p0, float cap) {
  if (!(__int2float_rn(INT_MAX) > cap)) return INT_MAX;   // NaN cap too
  int lo = 1, hi = INT_MAX - p0;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__int2float_rn(p0 + mid) > cap) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The raw row gathers of one request, loaded a group ahead of their use.
struct Staged {
  int e, live, cc, infl;
  float tok, kvn, w, chi, r_lim;
  uint8_t bound;
};

__device__ __forceinline__ void stage_request(const Args& a, int i,
                                              Staged& q) {
  q.e = clamp_row(a.req_ent[i], a.n_rows);
  q.tok = a.req_tokens[i];
  q.kvn = a.req_kv[i];
  q.live = a.req_live[i];
}

__device__ __forceinline__ void stage_row(const Args& a, Staged& q) {
  q.cc = a.class_code[q.e];
  q.r_lim = a.baseline_conc[q.e];
  q.infl = a.in_flight[q.e];
  q.bound = a.bound[q.e];
  q.w = a.weights[q.e];
  q.chi = a.baseline_kv[q.e];
}

__device__ __forceinline__ int staged_flags(const Args& a, const Staged& q) {
  const float r_eff = (q.r_lim <= 0.0f && q.cc == SPOT) ? a.cap : q.r_lim;
  const bool conc = (r_eff <= 0.0f) || (__int2float_rn(q.infl) < r_eff);
  const unsigned bit = (q.cc >= 0 && q.cc < 32) ? (1u << q.cc) : 0u;
  return (q.bound ? F_BOUND : 0) | (q.live ? F_LIVE : 0) |
         ((BURSTOK_CODES & bit) ? F_BURSTOK : 0) |
         ((PROTECTED_CODES & bit) ? F_PROT : 0) | (conc ? F_CONC : 0);
}

// The serial walk of requests s..M-1 in arrival order by one warp, from
// the row state in bucket / kv and the pool state given.  `contended` is
// sticky (the admitted count only grows), so a caller that has seen the
// pool contended passes true and the count no longer matters.
//
// The 32 lanes hold 32 requests.  Each lane keeps the bucket and KV of its
// own request's row in registers, read once per group and written back
// once; at step j every lane computes request j's decision and the lanes
// of j's row apply an admit.  Request j + 1's state is fetched from its
// lane before step j and patched after it when the two share a row, so
// the chain from one decision to the next holds a few compares and
// selects and no memory access or shuffle; the 32 steps are unrolled and
// branch-free (a lane past the quantum's end holds an inert request), and
// the contention test is an integer compare against a count found once.
// The inputs are staged in two steps ahead (the request arrays two groups
// ahead, the rows they name one group ahead).
__device__ void warp_walk(const Args& a, float* bucket, float* kv, int s,
                          bool contended, float run_min) {
  const int lane = threadIdx.x & 31;
  const bool free_slots = a.pool_resident < a.cap;
  const int to_contend =
      contended ? 0 : admits_to_contend(a.pool_in_flight, a.cap);
  int admits = 0;
  float thresh = __fmul_rn(run_min, a.slack_factor);
  Staged cur = {}, nxt = {}, far = {};
  if (s + lane < a.m) {
    stage_request(a, s + lane, cur);
    stage_row(a, cur);
  }
  if (s + 32 + lane < a.m) stage_request(a, s + 32 + lane, nxt);
  for (int g = s; g < a.m; g += 32) {
    const bool valid = g + lane < a.m;
    if (g + 32 + lane < a.m) stage_row(a, nxt);
    if (g + 64 + lane < a.m) stage_request(a, g + 64 + lane, far);
    const int f = valid ? staged_flags(a, cur) : 0;   // 0: inert
    const int e = valid ? cur.e : -1 - lane;          // a row of its own
    const int fe = e * 32 + f;                        // flags < 32
    float b = valid ? bucket[e] : 0.0f;
    float k = valid ? kv[e] : 0.0f;
    int my_d = 0;
    float pb = __shfl_sync(FULL, b, 0), pk = __shfl_sync(FULL, k, 0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float tj = __shfl_sync(FULL, cur.tok, j);
      const float nj = __shfl_sync(FULL, cur.kvn, j);
      const float wj = __shfl_sync(FULL, cur.w, j);
      const float cj = __shfl_sync(FULL, cur.chi, j);
      const int fej = __shfl_sync(FULL, fe, j);
      const int fj = fej & 31, ej = fej >> 5;
      const int en = __shfl_sync(FULL, fe, (j + 1) & 31) >> 5;
      // request j + 1's state before this step
      const float nb = __shfl_sync(FULL, b, (j + 1) & 31);
      const float nk = __shfl_sync(FULL, k, (j + 1) & 31);
      const bool cont = admits >= to_contend;
      const float kv_new = __fadd_rn(pk, nj);
      const float b_new = __fadd_rn(pb, -tj);
      const bool ok_conc = (fj & F_CONC) ||
                           ((fj & F_BURSTOK) && free_slots && !cont);
      const bool fits = (pb >= tj) && ((cj <= 0.0f) || (kv_new <= cj));
      const bool ok_prio = (fj & F_PROT) || !cont || (wj > thresh);
      const int why = !(fj & F_BOUND) ? 1 : !ok_conc ? 2 : !fits ? 3
                      : !ok_prio ? 4 : 0;
      const bool admit = why == 0 && (fj & F_LIVE);
      admits += admit ? 1 : 0;
      const bool lower = admit && (wj < run_min);
      run_min = lower ? wj : run_min;
      thresh = lower ? __fmul_rn(wj, a.slack_factor) : thresh;
      if (lane == j) my_d = (why << 1) | (admit ? 1 : 0);
      const bool mine = admit && (e == ej);
      b = mine ? b_new : b;
      k = mine ? kv_new : k;
      const bool same = admit && (en == ej);
      pb = same ? b_new : nb;
      pk = same ? kv_new : nk;
    }
    if (valid) {
      bucket[e] = b;          // lanes of one row hold the same state
      kv[e] = k;
      a.admitted[g + lane] = static_cast<uint8_t>(my_d & 1);
      a.reason[g + lane] = my_d >> 1;
      a.prio[g + lane] = cur.w;
    }
    __syncwarp();
    cur = nxt;
    nxt = far;
  }
}

// The walk route (resume = 0): the whole quantum, the row state copied
// from the inputs for the rows the quantum names.  After the rounds
// (resume = 1): the requests from where the rounds stopped, if any, from
// the committed row state.  Row state in shared memory when 8·N bytes fit.
__global__ void __launch_bounds__(32, 1) admit_walk_kernel(
    Args a, unsigned char* scratch, int* stats, int state_in_smem,
    int resume) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t0 = clock64();
  const Layout l = layout(a.n_rows, a.m);
  const int4 at = resume ? *reinterpret_cast<const int4*>(scratch + l.resume)
                         : make_int4(0, 0, 0, 0);
  if (at.x >= a.m) return;
  float* gb = reinterpret_cast<float*>(scratch + l.bucket);
  float* gk = reinterpret_cast<float*>(scratch + l.kv);
  float* bucket = state_in_smem ? reinterpret_cast<float*>(smem) : gb;
  float* kv = state_in_smem ? bucket + a.n_rows : gk;
  if (resume) {
    if (state_in_smem)
      for (int r = threadIdx.x; r < a.n_rows; r += 32) {
        bucket[r] = gb[r];
        kv[r] = gk[r];
      }
  } else {
    for (int i = threadIdx.x; i < a.m; i += 32) {
      const int e = clamp_row(a.req_ent[i], a.n_rows);
      bucket[e] = a.bucket_in[e];
      kv[e] = a.kv_in[e];
    }
  }
  __syncwarp();
  warp_walk(a, bucket, kv, at.x,
            resume ? at.y != 0 : __int2float_rn(a.pool_in_flight) > a.cap,
            resume ? __int_as_float(at.z) : a.running_min);
  if (threadIdx.x == 0) {
    if (!resume) {
      stats[0] = 0;
      stats[1] = 0;
      stats[2] = 0;
      stats[3] = 0;
    }
    stats[4] = static_cast<int>(clock64() - t0);
  }
}

// Rows longer than this are walked by a warp in the speculative pass (a
// thread's walk of a long row is one load latency per four requests).
constexpr int LONG_ROW = 64;
constexpr int MAX_LONG = 1024;

// The rounds route runs as one cluster of CLUSTER CTAs on as many SMs:
// the grouping and the walks are scattered reads and writes of a few bytes
// each, and one SM's path to L2 is what bounds them (one CTA took ~14
// scattered 32-byte sectors a request).
constexpr int CLUSTER = 8;
constexpr int G = CLUSTER * RT;              // threads of the cluster
constexpr int GWARPS = CLUSTER * WARPS;

struct RoundShared {
  int hist[WARPS * DIGITS];   // radix: each warp's digit counts, then offsets
  int dtot[DIGITS];           // radix: this CTA's count of each digit
  int c[3];                   // rank 0: the commit point, by round % 3
  int ints[WARPS];            // block-scan partials
  float floats[WARPS];        // block-min partials
  int ctot;                   // this CTA's sum in a cluster scan
  float cmin;                 // this CTA's least value in a cluster min
  int n_long;                 // long rows of this CTA this round
  int long_rows[MAX_LONG];
};

// Exclusive prefix sum of v over the 1,024 threads; `total` gets the sum.
__device__ int block_excl_scan(int v, int* part, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = part[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    part[lane] = t;
  }
  __syncthreads();
  const int excl = (warp ? part[warp - 1] : 0) + x - v;
  total = part[WARPS - 1];
  __syncthreads();
  return excl;
}

// Exclusive prefix sum of v over the cluster's threads, in (CTA, thread)
// order; `total` gets the sum.
__device__ int cluster_excl_scan(cg::cluster_group& cl, RoundShared& sh,
                                 int v, int& total) {
  int mine;
  const int excl = block_excl_scan(v, sh.ints, mine);
  if (threadIdx.x == 0) sh.ctot = mine;
  cl.sync();
  const int me = cl.block_rank();
  int before = 0;
  total = 0;
  for (int k = 0; k < CLUSTER; ++k) {
    const int t = *cl.map_shared_rank(&sh.ctot, k);
    before += k < me ? t : 0;
    total += t;
  }
  cl.sync();
  return before + excl;
}

// The least of v over the cluster's threads, by the serial walk's own
// compare (a < b ? a : b).
__device__ float cluster_min(cg::cluster_group& cl, RoundShared& sh,
                             float v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float y = __shfl_xor_sync(FULL, v, o);
    v = y < v ? y : v;
  }
  if (lane == 0) sh.floats[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = sh.floats[0];
    for (int k = 1; k < WARPS; ++k) r = sh.floats[k] < r ? sh.floats[k] : r;
    sh.cmin = r;
  }
  cl.sync();
  float r = *cl.map_shared_rank(&sh.cmin, 0);
  for (int k = 1; k < CLUSTER; ++k) {
    const float x = *cl.map_shared_rank(&sh.cmin, k);
    r = x < r ? x : r;
  }
  cl.sync();
  return r;
}

// The pool state a round freezes.
struct Frozen {
  bool free_slots, contended;
  float run_min, thresh;      // thresh = run_min · slack factor
};

// What a row's requests face in a round: the reason when the request fits
// the bucket and KV ceiling and when it does not (the row-static checks
// under the frozen pool state), the ceiling, and whether an admit lowers
// the running minimum (and so ends the round).
struct RowRule {
  int pass_why, fail_why;
  float chi;
  bool lowers;
};

__device__ __forceinline__ RowRule row_rule(const Args& a, const Frozen& fz,
                                            int r) {
  const int f = row_flags(a, r);
  const float w = a.weights[r];
  const bool ok_conc = (f & F_CONC) ||
                       ((f & F_BURSTOK) && fz.free_slots && !fz.contended);
  const bool ok_prio = (f & F_PROT) || !fz.contended || (w > fz.thresh);
  const int row_why = !(f & F_BOUND) ? 1 : !ok_conc ? 2 : 0;
  RowRule rr;
  rr.fail_why = row_why ? row_why : 3;
  rr.pass_why = row_why ? row_why : ok_prio ? 0 : 4;
  rr.chi = a.baseline_kv[r];
  rr.lowers = fz.contended && (w < fz.run_min);
  return rr;
}

// A packed entry: request index, tokens, KV bytes, row << 1 | live.
// One request of a row's walk: its packed decision (admit | reason << 1),
// and the row's bucket and KV after it.
__device__ __forceinline__ int row_step(const RowRule& rr, int4 q, float& b,
                                        float& k) {
  const float tok = __int_as_float(q.y);
  const float kv_new = __fadd_rn(k, __int_as_float(q.z));
  const bool fits = (b >= tok) && ((rr.chi <= 0.0f) || (kv_new <= rr.chi));
  const int why = fits ? rr.pass_why : rr.fail_why;
  const bool admit = why == 0 && (q.w & 1);
  if (admit) {
    b = __fadd_rn(b, -tok);
    k = kv_new;
  }
  return (why << 1) | (admit ? 1 : 0);
}

// A row's requests q..stop-1 walked by one thread, four entries loaded
// ahead of their compares.  LOWERS: an admit of this row lowers the
// minimum, so it ends the walk and bids for the commit point (a separate
// instance, so that the common walk has no branch on its chain).
template <bool LOWERS>
__device__ void thread_walk(const RowRule& rr, int q, int stop,
                            const int4* ent, uint8_t* dec, float b, float k,
                            int* c_min) {
  bool done = false;
  for (; q < stop && !done; q += 4) {
    int4 e4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (q + u < stop) e4[u] = __ldcg(ent + q + u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u < stop && !done) {
        const int d = row_step(rr, e4[u], b, k);
        dec[e4[u].x] = static_cast<uint8_t>(d);
        if (LOWERS && (d & 1)) {
          atomicMin(c_min, e4[u].x + 1);
          done = true;
        }
      }
    }
  }
}

// A long row's requests walked by a warp: the lanes load 32 entries at a
// time (the next 32 while these are walked), every lane runs the chain
// over the 32 shuffled entries, unrolled (a lane past the row's end holds
// an inert entry), and lane j keeps request j's decision.  LOWERS as for
// thread_walk.
template <bool LOWERS>
__device__ void row_warp_walk(const RowRule& rr, int q0, int stop,
                              const int4* ent, uint8_t* dec, float b,
                              float k, int* c_min) {
  const int lane = threadIdx.x & 31;
  int4 nxt = make_int4(0, 0, 0, 0);
  if (q0 + lane < stop) nxt = __ldcg(ent + q0 + lane);
  bool done = false;
  for (int q = q0; q < stop && !done; q += 32) {
    const int4 mine = q + lane < stop ? nxt : make_int4(0, 0, 0, 0);
    if (q + 32 + lane < stop) nxt = __ldcg(ent + q + 32 + lane);
    int mine_d = 0, steps = 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int4 qj;
      qj.x = __shfl_sync(FULL, mine.x, j);
      qj.y = __shfl_sync(FULL, mine.y, j);
      qj.z = __shfl_sync(FULL, mine.z, j);
      qj.w = __shfl_sync(FULL, mine.w, j);
      const int d = row_step(rr, qj, b, k);
      if (lane == j) mine_d = d;
      // the first admit ends the walk; what follows it is past the
      // commit point and not kept
      if (LOWERS && (d & 1) && !done) {
        if (lane == 0) atomicMin(c_min, qj.x + 1);
        done = true;
        steps = j + 1;
      }
    }
    if (lane < steps && q + lane < stop)
      dec[mine.x] = static_cast<uint8_t>(mine_d);
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(RT, 1)
    admit_rounds_kernel(Args a, unsigned char* scratch, int* stats,
                        int max_rounds, int min_commit) {
  extern __shared__ __align__(16) unsigned char smem[];
  RoundShared& sh = *reinterpret_cast<RoundShared*>(smem);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gt = rank * RT + tid, gw = rank * WARPS + warp;
  const int n = a.n_rows, m = a.m;
  const long long t0 = clock64();
  const Layout l = layout(n, m);
  int4* ents[2] = {reinterpret_cast<int4*>(scratch + l.ent0),
                   reinterpret_cast<int4*>(scratch + l.ent1)};
  int* start = reinterpret_cast<int*>(scratch + l.start);
  int* ptr = reinterpret_cast<int*>(scratch + l.ptr);
  float* bucket = reinterpret_cast<float*>(scratch + l.bucket);
  float* kv = reinterpret_cast<float*>(scratch + l.kv);
  uint8_t* dec = scratch + l.dec;

  // -- 1. grouping: stable LSD radix sort of the packed entries by row ---
  // (data another CTA wrote is read with __ldcg, from L2)
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;
  const int passes = max(1, (bits + 7) / 8);
  const int seg = (m + GWARPS - 1) / GWARPS;
  const int beg = min(gw * seg, m), end = min(beg + seg, m);
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    const int4* in = ents[(p + 1) & 1];      // the previous pass's output
    int4* out = ents[p & 1];
    for (int k = tid; k < WARPS * DIGITS; k += RT) sh.hist[k] = 0;
    __syncthreads();
    for (int i = beg + lane; i < end; i += 32) {
      int key;
      if (p == 0) {
        key = clamp_row(a.req_ent[i], n);
        a.prio[i] = a.weights[key];
      } else {
        key = __ldcg(&in[i].w) >> 1;
      }
      atomicAdd(&sh.hist[warp * DIGITS + ((key >> shift) & (DIGITS - 1))],
                1);
    }
    __syncthreads();
    if (tid < DIGITS) {
      int t = 0;
      for (int w = 0; w < WARPS; ++w) t += sh.hist[w * DIGITS + tid];
      sh.dtot[tid] = t;
    }
    cl.sync();
    // offsets in (digit, cluster warp) order: digit tid's count in the
    // cluster and in the CTAs before this one, a scan over digits, then
    // this CTA's warps in order
    {
      int all = 0, before = 0;
      if (tid < DIGITS) {
        for (int k = 0; k < CLUSTER; ++k) {
          const int x = *cl.map_shared_rank(&sh.dtot[tid], k);
          all += x;
          before += k < rank ? x : 0;
        }
      }
      int total;
      const int base = block_excl_scan(tid < DIGITS ? all : 0, sh.ints,
                                       total);
      if (tid < DIGITS) {
        int run = base + before;
        for (int w = 0; w < WARPS; ++w) {
          const int x = sh.hist[w * DIGITS + tid];
          sh.hist[w * DIGITS + tid] = run;
          run += x;
        }
      }
    }
    __syncthreads();
    // scatter, 32 entries at a time in arrival order within the warp's
    // slice; each group's entries are loaded while the group before is
    // ranked
    int4 nxt = make_int4(0, 0, 0, 0);
    auto load = [&](int i) {
      if (p) return __ldcg(in + i);
      const int e = clamp_row(a.req_ent[i], n);
      return make_int4(i, __float_as_int(a.req_tokens[i]),
                       __float_as_int(a.req_kv[i]),
                       (e << 1) | (a.req_live[i] ? 1 : 0));
    };
    if (beg + lane < end) nxt = load(beg + lane);
    for (int g = beg; g < end; g += 32) {
      const bool valid = g + lane < end;
      const int4 e4 = nxt;
      if (g + 32 + lane < end) nxt = load(g + 32 + lane);
      // the lanes of equal digit, from one ballot per digit bit
      const int digit = ((e4.w >> 1) >> shift) & (DIGITS - 1);
      unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const unsigned ones = __ballot_sync(FULL, (digit >> bit) & 1);
        peers &= ((digit >> bit) & 1) ? ones : ~ones;
      }
      const int rank_in = __popc(peers & ((1u << lane) - 1));
      int* slot = &sh.hist[warp * DIGITS + digit];
      const int base = valid ? *slot : 0;
      __syncwarp();
      if (valid && rank_in == 0) *slot = base + __popc(peers);
      __syncwarp();
      if (valid) out[base + rank_in] = e4;
    }
    cl.sync();      // the pass's output is complete in every CTA
  }
  const int4* ent = ents[(passes - 1) & 1];
  // each row's first request
  for (int q = gt; q < m; q += G) {
    const int key = __ldcg(&ent[q].w) >> 1;
    const int prev = q ? __ldcg(&ent[q - 1].w) >> 1 : -1;
    for (int r = prev + 1; r <= key; ++r) start[r] = q;
    if (q == m - 1)
      for (int r = key + 1; r <= n; ++r) start[r] = m;
  }
  if (rank == 0 && tid < 3) sh.c[tid] = m;
  cl.sync();
  // thread gt owns rows gt, gt + G, ...: their committed state
  for (int r = gt; r < n; r += G) {
    bucket[r] = a.bucket_in[r];
    kv[r] = a.kv_in[r];
    ptr[r] = __ldcg(&start[r]);
  }
  if (gt == 0) stats[2] = static_cast<int>(clock64() - t0);

  // -- 2-4. rounds -------------------------------------------------------
  int* c_home = cl.map_shared_rank(&sh.c[0], 0);
  const bool free_slots = a.pool_resident < a.cap;
  int s = 0, rounds = 0, last_s = 0;
  bool contended = __int2float_rn(a.pool_in_flight) > a.cap;
  float run_min = a.running_min;
  while (s < m) {
    if (rounds == max_rounds || (rounds && s - last_s < min_commit)) break;
    // round r bids in slot r % 3 and clears the next round's slot, which
    // nobody reads or bids in until this round's cluster barrier
    const int par = rounds % 3;
    ++rounds;
    last_s = s;
    if (rank == 0 && tid == 0) sh.c[(par + 1) % 3] = m;
    if (tid == 0) sh.n_long = 0;
    __syncthreads();
    // 2. speculative pass, the pool scalars frozen: rows of up to
    // LONG_ROW requests left by one thread each, longer ones by a warp
    const Frozen fz = {free_slots, contended, run_min,
                       __fmul_rn(run_min, a.slack_factor)};
    for (int r = gt; r < n; r += G) {
      const int q = ptr[r], stop = __ldcg(&start[r + 1]);
      if (q >= stop) continue;
      if (stop - q > LONG_ROW) {
        const int at = atomicAdd(&sh.n_long, 1);
        if (at < MAX_LONG) {
          sh.long_rows[at] = r;
          continue;
        }
      }
      const RowRule rr = row_rule(a, fz, r);
      if (rr.lowers)
        thread_walk<true>(rr, q, stop, ent, dec, bucket[r], kv[r],
                          c_home + par);
      else
        thread_walk<false>(rr, q, stop, ent, dec, bucket[r], kv[r],
                           c_home + par);
    }
    __syncthreads();
    for (int k = warp; k < min(sh.n_long, MAX_LONG); k += WARPS) {
      const int r = sh.long_rows[k];
      const RowRule rr = row_rule(a, fz, r);
      const int q = ptr[r], stop = __ldcg(&start[r + 1]);
      if (rr.lowers)
        row_warp_walk<true>(rr, q, stop, ent, dec, bucket[r], kv[r],
                            c_home + par);
      else
        row_warp_walk<false>(rr, q, stop, ent, dec, bucket[r], kv[r],
                             c_home + par);
    }
    cl.sync();
    // 3. the commit point
    int c = c_home[par];
    if (!contended) {
      // the admit that makes the pool contended, over the cluster's
      // threads' slices of arrival order [s, m)
      const int per = (m - s + G - 1) / G;
      const int lo = min(s + gt * per, m), hi = min(lo + per, m);
      int mine = 0;
      for (int i = lo; i < hi; ++i) mine += __ldcg(&dec[i]) & 1;
      int total;
      int cnt = cluster_excl_scan(cl, sh, mine, total);
      for (int i = lo; i < hi; ++i) {
        if (!(__ldcg(&dec[i]) & 1)) continue;
        ++cnt;
        if (__int2float_rn(a.pool_in_flight + cnt) > a.cap) {
          atomicMin(c_home + par, i + 1);
          break;
        }
      }
      cl.sync();
      c = c_home[par];
      if (c < m) {
        // the running minimum over the admits before c
        float v = run_min;
        for (int i = lo; i < min(hi, c); ++i)
          if (__ldcg(&dec[i]) & 1) {
            const float w = __ldcg(&a.prio[i]);
            v = w < v ? w : v;
          }
        run_min = cluster_min(cl, sh, v);
        contended = true;
      }
    } else if (c < m) {
      run_min = __ldcg(&a.prio[c - 1]);
    }
    if (c >= m) {            // every decision of the round is final
      s = m;
      break;
    }
    // 4. commit: each row's state after its last request before c,
    // replayed from the decisions (a row's request indices rise)
    for (int r = gt; r < n; r += G) {
      const int q0 = ptr[r];
      int q = q0, hi = __ldcg(&start[r + 1]);
      while (q < hi) {
        const int mid = (q + hi) / 2;
        if (__ldcg(&ent[mid].x) < c) q = mid + 1;
        else hi = mid;
      }
      if (q == q0) continue;
      float b = bucket[r], k = kv[r];
      for (int j = q0; j < q; ++j) {
        const int4 e4 = __ldcg(ent + j);
        if (__ldcg(&dec[e4.x]) & 1) {
          b = __fadd_rn(b, -__int_as_float(e4.y));
          k = __fadd_rn(k, __int_as_float(e4.z));
        }
      }
      bucket[r] = b;
      kv[r] = k;
      ptr[r] = q;
    }
    s = c;
  }
  // the committed decisions, in arrival order
  for (int i = gt; i < s; i += G) {
    const int d = __ldcg(&dec[i]);
    a.admitted[i] = static_cast<uint8_t>(d & 1);
    a.reason[i] = d >> 1;
  }
  // -- 5. the rest, serially, by admit_walk_kernel (resume = 1) -----------
  if (gt == 0) {
    stats[0] = rounds;
    stats[1] = s < m ? s : -1;
    stats[3] = static_cast<int>(clock64() - t0);
    stats[4] = 0;
    *reinterpret_cast<int4*>(scratch + l.resume) =
        make_int4(s, contended ? 1 : 0, __float_as_int(run_min), 0);
  }
  cl.sync();        // no CTA leaves while another may read its shared memory
}

}  // namespace

extern "C" {

// Bytes of global scratch a launch of either route needs.
long long admit_quantum_scratch_bytes(int n_rows, int m) {
  return static_cast<long long>(layout(n_rows, m).bytes);
}

// Whether bucket and kv of n_rows rows live in shared memory.
int admit_quantum_state_in_smem(int n_rows) {
  return n_rows <= MAX_SMEM_STATE_ROWS ? 1 : 0;
}

// route 0: the rounds (one cluster), then the serial walk of whatever they
// left (one warp, a second launch that ends at once when nothing is left);
// route 1: the serial walk alone.  stats[0] gets the rounds run, stats[1]
// the request the serial walk started at (-1 if it did not run),
// stats[2..3] the SM clock cycles from the rounds kernel's start to the
// end of the grouping and of the rounds, stats[4] the walk kernel's
// cycles (0 for a phase the route does not have).
int admit_quantum_launch(
    const void* class_code, const void* bound, const void* baseline_kv,
    const void* baseline_conc, const void* weights, const void* bucket,
    const void* in_flight, const void* kv_in_use, const void* req_ent,
    const void* req_tokens, const void* req_kv, const void* req_live,
    void* admitted, void* reason, void* prio, void* scratch, void* stats,
    int n_rows, int m, int pool_in_flight, float pool_resident,
    float pool_conc_cap, float running_min, float slack_factor, int route,
    int max_rounds, int min_commit, void* stream) {
  Args a;
  a.class_code = static_cast<const int*>(class_code);
  a.bound = static_cast<const uint8_t*>(bound);
  a.baseline_kv = static_cast<const float*>(baseline_kv);
  a.baseline_conc = static_cast<const float*>(baseline_conc);
  a.weights = static_cast<const float*>(weights);
  a.bucket_in = static_cast<const float*>(bucket);
  a.in_flight = static_cast<const int*>(in_flight);
  a.kv_in = static_cast<const float*>(kv_in_use);
  a.req_ent = static_cast<const int*>(req_ent);
  a.req_tokens = static_cast<const float*>(req_tokens);
  a.req_kv = static_cast<const float*>(req_kv);
  a.req_live = static_cast<const uint8_t*>(req_live);
  a.admitted = static_cast<uint8_t*>(admitted);
  a.reason = static_cast<int*>(reason);
  a.prio = static_cast<float*>(prio);
  a.n_rows = n_rows;
  a.m = m;
  a.pool_in_flight = pool_in_flight;
  a.pool_resident = pool_resident;
  a.cap = pool_conc_cap;
  a.running_min = running_min;
  a.slack_factor = slack_factor;
  const int in_smem = admit_quantum_state_in_smem(n_rows);
  const int state = in_smem ? 8 * n_rows : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  int* stt = static_cast<int*>(stats);
  cudaError_t err;
  err = cudaFuncSetAttribute(admit_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (route == 0) {
    const int bytes = sizeof(RoundShared);
    err = cudaFuncSetAttribute(admit_rounds_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    admit_rounds_kernel<<<CLUSTER, RT, bytes, st>>>(a, sc, stt, max_rounds,
                                                    min_commit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  admit_walk_kernel<<<1, 32, state, st>>>(a, sc, stt, in_smem,
                                          route == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
