// Batched quantum admission for Hopper (sm_90a), CUDA C++, plain C entry
// point bound from Python with ctypes.
//
// Replaces src/repro/core/vectorized.py::admit_quantum.  That function is
// not a Pallas kernel: it is a jitted lax.fori_loop that XLA fuses into one
// device loop, the exact sequential replay of the paper's §4.3 admission
// pipeline (bound → concurrency → token budget / KV → priority) over one
// scheduling quantum of M requests against a pool of N entitlement rows.
// Request i sees every state change made by requests 0..i-1: its
// entitlement's bucket level and KV in use, the pool's admitted count
// (which decides contention) and the running minimum priority of what
// the pool holds.  Eager PyTorch would issue ~20 launches per request.
//
// What bounds it on the H100: not bytes (each input read once is ~1.6 MB
// at N = 4,096 rows and M = 65,536 requests, under a microsecond at
// 3.35 TB/s) and not arithmetic (a few dozen operations a request), but
// the serial chain of M dependent steps: request i's
// decision needs the bucket, KV, pool count and threshold that request
// i-1 left behind.  The latency of one step (shared-memory reads of the
// row's bucket and KV, a handful of compares, the conditional writes)
// times M is the floor of this design.
//
// Design: one CTA of 256 threads per dispatch.  The requests go in
// chunks of CHUNK:
//   (a) all threads gather each request's row-static inputs in parallel —
//       its row, tokens, KV bytes, Eq. 1 weight (also written out as the
//       request's priority), the KV ceiling chi, and one flag byte with
//       the bound bit, the live bit, the burst-capable and protected class
//       bits and the row-static half of the concurrency check
//       (r_eff <= 0 or in_flight[e] < r_eff; resident counts are frozen
//       within a quantum) — into shared memory;
//   (b) thread 0 walks the chunk in arrival order, with the bucket and KV
//       columns in shared memory when 8·N bytes fit (else in a global
//       scratch copy; the inputs are never written) and the pool's
//       admitted count and running minimum in registers.
// The gather of the next chunk waits for the walk of this one; the two
// are not overlapped.
//
// Exactness against the XLA loop, decision for decision:
//   * int32 against f32 compares promote the int to f32 first
//     (__int2float_rn), as JAX does;
//   * the bucket and KV updates and the threshold product are single
//     rounded f32 operations (__fadd_rn, __fmul_rn), never contracted;
//     the slack factor 1 - slack is rounded to f32 by the caller;
//   * a padding row (live = 0) gets the reason of its row and state, is
//     never admitted, and changes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;
constexpr int SPOT = 3;                      // CLASS_CODES[SPOT]
// class-code bit masks (codes 0..4: dedicated, guaranteed, elastic,
// spot, preemptible)
constexpr unsigned PROTECTED_CODES = 0x03u;  // dedicated, guaranteed
constexpr unsigned BURSTOK_CODES = 0x1Du;    // all but guaranteed
// flag bits of a staged request
constexpr uint8_t F_BOUND = 1, F_LIVE = 2, F_BURSTOK = 4, F_PROT = 8,
                  F_CONC = 16;
// staged bytes per request: row, tokens, kv, weight, chi, flags
constexpr int STAGE_BYTES = 4 * 5 + 1;
// bucket and kv live in shared memory when 8·N bytes fit beside the stage
constexpr int MAX_SMEM_STATE_ROWS = 24576;

struct Stage {
  int* e;
  float* tok;
  float* kvn;
  float* w;
  float* chi;
  uint8_t* flags;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base) {
  Stage s;
  s.e = reinterpret_cast<int*>(base);
  s.tok = reinterpret_cast<float*>(base + 4 * CHUNK);
  s.kvn = reinterpret_cast<float*>(base + 8 * CHUNK);
  s.w = reinterpret_cast<float*>(base + 12 * CHUNK);
  s.chi = reinterpret_cast<float*>(base + 16 * CHUNK);
  s.flags = base + 20 * CHUNK;
  return s;
}

__global__ void __launch_bounds__(THREADS, 1) admit_quantum_kernel(
    const int* __restrict__ class_code, const uint8_t* __restrict__ bound,
    const float* __restrict__ baseline_kv,
    const float* __restrict__ baseline_conc,
    const float* __restrict__ weights, const float* __restrict__ bucket_in,
    const int* __restrict__ in_flight, const float* __restrict__ kv_in,
    const int* __restrict__ req_ent, const float* __restrict__ req_tokens,
    const float* __restrict__ req_kv, const uint8_t* __restrict__ req_live,
    uint8_t* __restrict__ admitted, int* __restrict__ reason,
    float* __restrict__ prio, float* scratch, int n_rows, int m,
    int pool_in_flight, float pool_resident, float pool_conc_cap,
    float running_min, float slack_factor, int state_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  Stage st = stage_at(smem);
  float* bucket;
  float* kv;
  if (state_in_smem) {
    // past the stage, 16-byte aligned (STAGE_BYTES · CHUNK is a multiple
    // of 16)
    bucket = reinterpret_cast<float*>(smem + STAGE_BYTES * CHUNK);
  } else {
    bucket = scratch;
  }
  kv = bucket + n_rows;
  for (int r = tid; r < n_rows; r += THREADS) {
    bucket[r] = bucket_in[r];
    kv[r] = kv_in[r];
  }

  // walker registers (thread 0 only)
  int pool_infl = pool_in_flight;
  float run_min = running_min;
  const bool free_slots = pool_resident < pool_conc_cap;

  for (int base = 0; base < m; base += CHUNK) {
    const int n = min(CHUNK, m - base);
    __syncthreads();  // the walk of the previous chunk is done
    for (int j = tid; j < n; j += THREADS) {
      const int g = base + j;
      int e = req_ent[g];
      e = e < 0 ? 0 : (e >= n_rows ? n_rows - 1 : e);
      const int cc = class_code[e];
      const float r_lim = baseline_conc[e];
      const float r_eff = (r_lim <= 0.0f && cc == SPOT) ? pool_conc_cap
                                                         : r_lim;
      const bool conc = (r_eff <= 0.0f) ||
                        (__int2float_rn(in_flight[e]) < r_eff);
      const unsigned bit = (cc >= 0 && cc < 32) ? (1u << cc) : 0u;
      uint8_t f = 0;
      f |= bound[e] ? F_BOUND : 0;
      f |= req_live[g] ? F_LIVE : 0;
      f |= (BURSTOK_CODES & bit) ? F_BURSTOK : 0;
      f |= (PROTECTED_CODES & bit) ? F_PROT : 0;
      f |= conc ? F_CONC : 0;
      const float w = weights[e];
      st.e[j] = e;
      st.tok[j] = req_tokens[g];
      st.kvn[j] = req_kv[g];
      st.w[j] = w;
      st.chi[j] = baseline_kv[e];
      st.flags[j] = f;
      prio[g] = w;
    }
    __syncthreads();
    if (tid != 0) continue;
    for (int j = 0; j < n; ++j) {
      const int e = st.e[j];
      const uint8_t f = st.flags[j];
      const float tok = st.tok[j];
      const float kvn = st.kvn[j];
      const float w = st.w[j];
      const float chi = st.chi[j];
      const float b = bucket[e];
      const float kv_new = __fadd_rn(kv[e], kvn);
      const bool contended = __int2float_rn(pool_infl) > pool_conc_cap;
      const bool ok_bound = f & F_BOUND;
      const bool ok_conc =
          (f & F_CONC) || ((f & F_BURSTOK) && free_slots && !contended);
      const bool ok_budget = b >= tok;
      const bool ok_kv = (chi <= 0.0f) || (kv_new <= chi);
      const bool ok_prio = (f & F_PROT) || !contended ||
                           (w > __fmul_rn(run_min, slack_factor));
      const bool admit = (f & F_LIVE) && ok_bound && ok_conc && ok_budget &&
                         ok_kv && ok_prio;
      const int why = !ok_bound ? 1
                      : !ok_conc ? 2
                      : !(ok_budget && ok_kv) ? 3
                      : !ok_prio ? 4 : 0;
      if (admit) {
        bucket[e] = __fadd_rn(b, -tok);
        kv[e] = kv_new;
        pool_infl += 1;
        run_min = w < run_min ? w : run_min;
      }
      admitted[base + j] = admit ? 1 : 0;
      reason[base + j] = why;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one launch (exported for the wrapper's checks).
int admit_quantum_smem_bytes(int n_rows) {
  int bytes = STAGE_BYTES * CHUNK;
  if (n_rows <= MAX_SMEM_STATE_ROWS) bytes += 8 * n_rows;
  return bytes;
}

// Whether bucket and kv of n_rows rows live in shared memory (else the
// caller passes a scratch buffer of 2·n_rows floats).
int admit_quantum_state_in_smem(int n_rows) {
  return n_rows <= MAX_SMEM_STATE_ROWS ? 1 : 0;
}

int admit_quantum_launch(
    const void* class_code, const void* bound, const void* baseline_kv,
    const void* baseline_conc, const void* weights, const void* bucket,
    const void* in_flight, const void* kv_in_use, const void* req_ent,
    const void* req_tokens, const void* req_kv, const void* req_live,
    void* admitted, void* reason, void* prio, void* scratch, int n_rows,
    int m, int pool_in_flight, float pool_resident, float pool_conc_cap,
    float running_min, float slack_factor, void* stream) {
  const int in_smem = admit_quantum_state_in_smem(n_rows);
  const int bytes = admit_quantum_smem_bytes(n_rows);
  cudaError_t err = cudaFuncSetAttribute(
      admit_quantum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  admit_quantum_kernel<<<1, THREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(class_code),
      static_cast<const uint8_t*>(bound),
      static_cast<const float*>(baseline_kv),
      static_cast<const float*>(baseline_conc),
      static_cast<const float*>(weights), static_cast<const float*>(bucket),
      static_cast<const int*>(in_flight),
      static_cast<const float*>(kv_in_use),
      static_cast<const int*>(req_ent),
      static_cast<const float*>(req_tokens),
      static_cast<const float*>(req_kv),
      static_cast<const uint8_t*>(req_live),
      static_cast<uint8_t*>(admitted), static_cast<int*>(reason),
      static_cast<float*>(prio), static_cast<float*>(scratch), n_rows, m,
      pool_in_flight, pool_resident, pool_conc_cap, running_min,
      slack_factor, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
