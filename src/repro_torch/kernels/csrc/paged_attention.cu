// Paged decode attention for Hopper (sm_90a), CUDA C++, plain C entry
// points bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py::paged_attention
//   (body _paged_kernel): one decode token per sequence attends over a
//   paged KV pool through a block table; online softmax across pages,
//   one page fetch serves the whole GQA group, optional logit softcap,
//   tokens at or beyond the context length are masked and pages
//   numbered -1 are skipped.  A sequence with context length 0 gets a
//   zero output, as the TPU kernel gives.
//
// On the TPU the block table rides in scalar memory and drives the
// BlockSpec index maps, and the grid's page axis walks the pages in
// order with (m, l, acc) in VMEM.  On Hopper the pages of a sequence are
// split over CTAs instead (flash-decoding), because one CTA per
// (sequence, kv head) — 64 at batch 8 on Qwen3-8B — leaves half the 132
// SMs idle and walks its pages in series.
//
// What bounds it on the H100: every K/V element of the live context is
// read once and used for G multiply-adds (one per query head of the
// group), ~G FLOP per bf16 byte — far below the ~295 FLOP/byte ridge of
// the tensor cores, so the work is bound by memory bandwidth (3.35
// TB/s).  Two routes, picked by the wrapper's route(dtype, dh, G):
//
// Split route (paged_split_kernel, any dtype, dh 16-256, any G), grid
// (H_kv * n_tiles, B, n_split): each CTA of 4 warps takes one chunk of
// 64 tokens (pps = 64 / T pages; one page when T > 64) of one (sequence,
// kv head) for one tile of the group's query heads.  n_split comes from
// the block table's width, so the host never reads context_lens; a CTA
// whose chunk starts at or past the context, or ends at or before the
// window's first live token, exits at once.  The CTA reads its pps
// table entries once, then each warp issues all the 16-byte K and V row
// loads of its 16 tokens before any math (for bf16 at dh = 128 one
// warp-load covers two token rows, 16 lanes each; at dh = 256 one row
// is a whole warp).  The tile's GT query heads sit in f32 registers and
// each K row is used for all of them; a score is reduced over the row's
// lanes with shuffles.  The chunk's partial (m, l, acc[GT][dh]) goes to
// f32 scratch.  The group G = H / H_kv is taken at run time in tiles of
// GT heads, GT the largest of 8, 4, 2, 1 that divides G, so q and acc
// never hold more than 8 heads a lane.  Its products run on the CUDA
// cores in f32, 2 FLOP an FMA: at G ~20 FLOP/byte they, and not the
// bytes, set the pace (67 TFLOP/s ÷ 3.35 TB/s), and from G 10 up each
// tile re-reads its chunk's K/V.  It stays the route of f32 queries or
// pages (whose 2e-5 tolerance a bf16 product would break), of dh 16/32
// and of small groups, where it is as fast.
//
// Group route (paged_group_kernel, bf16 queries and pages, dh 64/128/
// 256, G up to 16), grid (H_kv, B, n_split), n_split = ceil(max_pages·T
// / 64): one CTA of 4 warps for each (kv head, sequence, 64-token chunk)
// serves all G query heads, so each chunk's K/V is read from device
// memory once.  The products run on the tensor cores, mma.sync
// m16n8k16 bf16 → f32, with the group in the 16 rows of M (zero rows
// past G): the work is memory-bound, so mma.sync serves, and wgmma's 64
// rows would waste most of its tile at G ≤ 16.  The CTA copies Q, and
// each warp its 16 tokens' K rows then V rows, into shared memory with
// 16-byte cp.async (zero-filled for tokens that are not live: past the
// context, behind the window, on −1 pages), page by page from its
// block-table entries, so V is still arriving while Q·Kᵀ and the
// softmax run.  Each warp computes S for its own 16 keys (ldmatrix from
// Q and K), the CTA takes the softmax of the 64 scores of each head
// through shared memory, and each warp computes its dh/4 columns of
// P·V over all 64 keys, so O is at most 32 f32 registers a thread
// (dh 256) and nothing spills.  The reference computes P·V in f32, and
// one bf16 rounding of P misses the families' tolerance (as it did in
// flash at dh 256): P enters P·V as hi = bf16(p) and lo = bf16(p − hi),
// each through its own product, which costs nothing at this intensity.
// The chunk's partial (m, l, acc) goes to the same scratch layout as the
// split route's.  At the served shapes its grid is one wave or less, so
// a call is held by latency (block table, then copies, then products,
// then the merge's launch) more than by bytes: a chunk's copies are all
// in flight at once, the products are off the CUDA cores, and the merge
// is one CTA per query head.
//
// Window: with window w > 0 a token at position k_pos of a sequence of
// context ctx is live when ctx − w ≤ k_pos < ctx (the reference's
// decode mask cur − k_pos < w, cur = ctx − 1).  Pages stay allocated
// behind the window (every layer shares one block table); the kernels
// only skip them.
//
// Pass 2 (paged_merge_kernel, both routes), grid (H, B): one CTA for
// each query head of each sequence reads the partials of the chunks
// pass 1 wrote, from the window's first chunk to ceil(ctx / chunk),
// computes each chunk's weight e^(m_c − M) and Σ weight·l once into
// shared memory, then sums the weighted acc rows and divides, and
// writes q's dtype; context 0 gives zeros.
//
// Partial route (paged_partial_*, and paged_group_bf16 with a
// key_offset): the same two passes over one rank's block of a
// sequence-sharded cache.  Its pages hold global positions [off, off +
// max_pages·T) of the sequence (off = key_offset[b]) and context_lens
// holds the global context, so the local context is clamp(ctx − off, 0,
// max_pages·T) and the window's first live token ctx − w is taken in
// global positions.  Pass 2 writes the rank's partial in f32 — o = Σ
// p·v / Σ p and lse = ln Σ e^s over its live tokens (o = 0, lse = −inf
// where it has none) — for the ranks' partials to be merged
// (flash-decoding across ranks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The local context of sequence b and its first live token: its pages
// hold positions [off, off + span) (off = 0 without key_offset) of a
// sequence of global context context_lens[b].
__device__ __forceinline__ void local_span(const int* context_lens,
                                           const int* key_offset, int b,
                                           int span, int window, int& ctx,
                                           int& lo) {
  const int ctx_g = context_lens[b];
  const int off = key_offset ? key_offset[b] : 0;
  ctx = min(max(ctx_g - off, 0), span);
  lo = window > 0 ? max(0, ctx_g - window - off) : 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 2 of both routes.  Partials: acc (B, H_kv, n_split, G, dh) and
// ml (B, H_kv, n_split, G, 2) f32, m in log2 units, written by pass 1
// for the chunks [lo / chunk, ceil(ctx / chunk)).  One CTA for each
// (query head, sequence): out (B, H, dh) in q's type, or with lse the
// partial route's f32 o and lse (B, H).  Dynamic shared memory: n_split
// floats, the chunks' weights.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ context_lens,
                   const int* __restrict__ key_offset, TQ* __restrict__ o,
                   float* __restrict__ lse, int Hkv, int G, int dh,
                   int chunk, int n_split, int window) {
  extern __shared__ float sw[];               // e^(m_c − M), by chunk
  __shared__ float red[THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / G, g = h % G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int ctx, lo;
  local_span(context_lens, key_offset, b, n_split * chunk, window, ctx, lo);
  const int s0 = lo / chunk;
  const int ns = min(n_split, (ctx + chunk - 1) / chunk);
  const long long p0 = ((long long)b * Hkv + hk) * n_split;

  // M, the chunks' largest m
  float mx = -INFINITY;
  for (int s = s0 + tid; s < ns; s += THREADS)
    mx = fmaxf(mx, part_ml[((p0 + s) * G + g) * 2]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  const float base = mx == -INFINITY ? 0.f : mx;
  __syncthreads();                            // red is reused

  // each chunk's weight once, and Σ weight·l
  float ls = 0.f;
  for (int s = s0 + tid; s < ns; s += THREADS) {
    const float* ml = part_ml + ((p0 + s) * G + g) * 2;
    const float w = exp2f(ml[0] - base);
    sw[s - s0] = w;
    ls = fmaf(w, ml[1], ls);
  }
  ls = warp_sum(ls);
  if (lane == 0) red[warp] = ls;
  __syncthreads();                            // sw and red ready
  ls = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) ls += red[w];

  // the weighted rows: a thread's column tid and, at dh 256 (the widest),
  // tid + THREADS too, in one pass over the chunks so that their loads
  // are in flight together
  const float* acc = part_acc + (p0 * G + g) * dh + tid;
  const long long step = (long long)G * dh;   // one chunk's rows
  TQ* ob = o + ((long long)b * Hkv * G + h) * dh + tid;
  if (dh > THREADS) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int s = s0; s < ns; ++s) {
      const float w = sw[s - s0];
      a0 = fmaf(w, acc[s * step], a0);
      a1 = fmaf(w, acc[s * step + THREADS], a1);
    }
    ob[0] = from_f32<TQ>(ls > 0.f ? a0 / ls : 0.f);
    ob[THREADS] = from_f32<TQ>(ls > 0.f ? a1 / ls : 0.f);
  } else if (tid < dh) {
    float a0 = 0.f;
#pragma unroll 8
    for (int s = s0; s < ns; ++s) a0 = fmaf(sw[s - s0], acc[s * step], a0);
    ob[0] = from_f32<TQ>(ls > 0.f ? a0 / ls : 0.f);
  }
  if (lse && tid == 0)
    lse[(long long)b * Hkv * G + h] =
        ls > 0.f ? mx / LOG2E + logf(ls) : -INFINITY;
}

// Pass 2's launch for either route: f32 (o, lse) when lse is given,
// else q's type.
template <typename TQ>
cudaError_t launch_merge(const float* part, const float* part_ml,
                         const int* cl, const int* off, void* o, float* lse,
                         int B, int Hkv, int G, int dh, int chunk,
                         int n_split, int window, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * n_split;
  const dim3 grid(Hkv * G, B);
  if (lse) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_merge_kernel<float>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    paged_merge_kernel<float><<<grid, THREADS, smem, stream>>>(
        part, part_ml, cl, off, static_cast<float*>(o), lse, Hkv, G, dh,
        chunk, n_split, window);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          paged_merge_kernel<TQ>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    paged_merge_kernel<TQ><<<grid, THREADS, smem, stream>>>(
        part, part_ml, cl, nullptr, static_cast<TQ*>(o), nullptr, Hkv, G,
        dh, chunk, n_split, window);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-K route
// ---------------------------------------------------------------------------
namespace split {

constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;                  // tokens per CTA for pages <= 64
constexpr int MAX_GROUP = 16;              // query heads per kv head

// 16 bytes of a K or V row as f32
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// q (B, H, dh); pages (P, T, H_kv, dh); block_tables (B, max_pages) int32
// padded with -1; context_lens (B,) int32.  Partials: acc
// (B, H_kv, n_split, G, DH) and ml (B, H_kv, n_split, G, 2) f32, m in
// log2 units.  This CTA serves query heads [tile·GT, tile·GT + GT) of
// its kv head's group.
template <typename TQ, typename TKV, int DH, int GT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const TKV* __restrict__ vp,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   const int* __restrict__ key_offset,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int Hkv, int G, int T, int max_pages, int pps, int window,
                   float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(TKV);       // elements per 16-byte load
  constexpr int LOADS = DH / VEC;             // 16-byte loads per row
  constexpr int L = LOADS < 32 ? LOADS : 32;  // lanes per row
  constexpr int NV = LOADS / L;               // loads per lane per row
  constexpr int RPL = 32 / L;                 // rows per warp-load
  constexpr int STEPS = (GT >= 8 ? 4 : 8) / NV;  // warp-loads in flight
  constexpr int BT = STEPS * RPL;             // tokens per warp batch
  constexpr int NE = NV * VEC;                // elements per lane per row
  static_assert(DH % VEC == 0 && 32 % L == 0, "head width");

  __shared__ int spage[CHUNK];
  __shared__ float wml[WARPS][GT][2];
  __shared__ float wacc[WARPS][GT][DH];

  const int n_tiles = G / GT;
  const int hk = blockIdx.x / n_tiles, g0 = blockIdx.x % n_tiles * GT;
  const int b = blockIdx.y, sp = blockIdx.z;
  int ctx, lo;                                // local context, first live
  local_span(context_lens, key_offset, b, max_pages * T, window, ctx, lo);
  const int chunk = pps * T;
  const int t0 = sp * chunk;
  // uniform: nothing to read (past the context, or behind the window)
  if (t0 >= ctx || t0 + chunk <= lo) return;
  const int t1 = min(ctx, t0 + chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % L;                   // position along the row
  const int rsel = lane / L;                  // row of the warp-load

  if (tid < pps) {
    const int ip = sp * pps + tid;
    spage[tid] = ip < max_pages ? block_tables[b * max_pages + ip] : -1;
  }

  const int H = Hkv * G;
  float qr[GT][NE];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][n * VEC + e] = to_f32(
            q[((long long)b * H + hk * G + g0 + g) * DH + (n * L + sub) * VEC +
              e]);
  __syncthreads();                            // spage ready

  float m[GT], l[GT], acc[GT][NE];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[g][e] = 0.f;
  }

  const long long tok_stride = (long long)Hkv * DH;   // one token row
  const int ts = max(t0, lo);                 // the chunk's first live token
  for (int base = ts + warp * BT; base < t1; base += WARPS * BT) {
    // every K and V load of the batch first
    uint4 kr[STEPS][NV], vr[STEPS][NV];
    bool ok[STEPS];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int t = base + st * RPL + rsel;
      const int page = t < t1 ? spage[(t - t0) / T] : -1;
      ok[st] = page >= 0;
      const long long row =
          ((long long)(ok[st] ? page : 0) * T + t % T) * tok_stride +
          (long long)hk * DH;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const long long off = row + (n * L + sub) * VEC;
        kr[st][n] = ok[st] ? __ldg(reinterpret_cast<const uint4*>(kp + off))
                           : make_uint4(0, 0, 0, 0);
        vr[st][n] = ok[st] ? __ldg(reinterpret_cast<const uint4*>(vp + off))
                           : make_uint4(0, 0, 0, 0);
      }
    }

    // scores, in log2 units, reduced over the L lanes of each row
    float s[STEPS][GT];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      float kf[NE];
#pragma unroll
      for (int n = 0; n < NV; ++n) unpack(kr[st][n], kf + n * VEC, TKV());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) part = fmaf(qr[g][e], kf[e], part);
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float x = part * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[st][g] = ok[st] ? x * LOG2E : -INFINITY;
      }
    }

    // online update with the warp's max over the batch
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) mx = fmaxf(mx, s[st][g]);
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx);
      const float base_g = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[g] - base_g);
      m[g] = mn;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const float p = exp2f(s[st][g] - base_g);
        psum += p;
        float vf[NE];
#pragma unroll
        for (int n = 0; n < NV; ++n) unpack(vr[st][n], vf + n * VEC, TKV());
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
      // every lane of a row holds the same p: sum over the rows only
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[g] = l[g] * alpha + psum;
    }
  }

  // the warp's acc: sum the rows of the warp-load, lanes 0..L-1 hold it
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < NE; ++e)
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wacc[warp][g][(n * L + sub) * VEC + e] = acc[g][n * VEC + e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      wml[warp][g][0] = m[g];
      wml[warp][g][1] = l[g];
    }
  }
  __syncthreads();

  // the CTA's partial: the warps rescaled to their common max
  const long long pidx = ((long long)b * Hkv + hk) * gridDim.z + sp;
  for (int i = tid; i < GT * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wml[w][g][0]);
    const float base_g = mx == -INFINITY ? 0.f : mx;
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(wml[w][g][0] - base_g);
      a = fmaf(f, wacc[w][g][d], a);
      ls = fmaf(f, wml[w][g][1], ls);
    }
    part_acc[(pidx * G + g0) * DH + i] = a;
    if (d == 0) {
      part_ml[(pidx * G + g0 + g) * 2 + 0] = mx;
      part_ml[(pidx * G + g0 + g) * 2 + 1] = ls;
    }
  }
}

// pages per CTA: 64 tokens, or one page when pages are longer
inline int pages_per_split(int T) { return T < CHUNK ? CHUNK / T : 1; }

template <typename TQ, typename TKV, int DH, int GT>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* cl, const int* off, void* o,
                     float* lse, float* part, int B, int Hkv, int G, int T,
                     int max_pages, int window, float softcap, float scale,
                     cudaStream_t stream) {
  const int pps = pages_per_split(T);
  const int n_split = (max_pages + pps - 1) / pps;
  float* part_ml = part + (size_t)B * Hkv * n_split * G * DH;
  paged_split_kernel<TQ, TKV, DH, GT>
      <<<dim3(Hkv * (G / GT), B, n_split), THREADS, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), static_cast<const int*>(bt),
          static_cast<const int*>(cl), off, part, part_ml, Hkv, G, T,
          max_pages, pps, window, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<TQ>(part, part_ml, static_cast<const int*>(cl), off,
                          o, lse, B, Hkv, G, DH, pps * T, n_split, window,
                          stream);
}

// heads per tile: the largest of 8, 4, 2, 1 that divides the group
inline int group_tile(int G) {
  return G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch_dh(const void* q, const void* kp, const void* vp,
                      const void* bt, const void* cl, const int* off, void* o,
                      float* lse, float* part, int B, int Hkv, int G, int T,
                      int max_pages, int window, float softcap, float scale,
                      cudaStream_t stream) {
  switch (group_tile(G)) {
    case 1: return launch_g<TQ, TKV, DH, 1>(q, kp, vp, bt, cl, off, o,
                                            lse, part, B, Hkv, G, T,
                                            max_pages, window, softcap,
                                            scale, stream);
    case 2: return launch_g<TQ, TKV, DH, 2>(q, kp, vp, bt, cl, off, o,
                                            lse, part, B, Hkv, G, T,
                                            max_pages, window, softcap,
                                            scale, stream);
    case 4: return launch_g<TQ, TKV, DH, 4>(q, kp, vp, bt, cl, off, o,
                                            lse, part, B, Hkv, G, T,
                                            max_pages, window, softcap,
                                            scale, stream);
    default: return launch_g<TQ, TKV, DH, 8>(q, kp, vp, bt, cl, off, o,
                                             lse, part, B, Hkv, G, T,
                                             max_pages, window, softcap,
                                             scale, stream);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp,
           const void* bt, const void* cl, const void* key_offset, void* o,
           void* lse, void* part, int B, int H, int Hkv, int T, int dh,
           int max_pages, int window, float softcap, float scale,
           void* stream) {
  if (B == 0 || max_pages == 0) return cudaSuccess;
  const int G = H / Hkv;
  if (G < 1 || G > MAX_GROUP || G * Hkv != H)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  const int* off = static_cast<const int*>(key_offset);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16: err = launch_dh<TQ, TKV, 16>(q, kp, vp, bt, cl, off, o, ls, p,
                                          B, Hkv, G, T, max_pages, window,
                                          softcap, scale, s); break;
    case 32: err = launch_dh<TQ, TKV, 32>(q, kp, vp, bt, cl, off, o, ls, p,
                                          B, Hkv, G, T, max_pages, window,
                                          softcap, scale, s); break;
    case 64: err = launch_dh<TQ, TKV, 64>(q, kp, vp, bt, cl, off, o, ls, p,
                                          B, Hkv, G, T, max_pages, window,
                                          softcap, scale, s); break;
    case 128: err = launch_dh<TQ, TKV, 128>(q, kp, vp, bt, cl, off, o, ls,
                                            p, B, Hkv, G, T, max_pages,
                                            window, softcap, scale, s);
      break;
    case 256: err = launch_dh<TQ, TKV, 256>(q, kp, vp, bt, cl, off, o, ls,
                                            p, B, Hkv, G, T, max_pages,
                                            window, softcap, scale, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace split

// ---------------------------------------------------------------------------
// Group route: all G query heads of a chunk on the tensor cores
// ---------------------------------------------------------------------------
namespace group {

constexpr int KEYS = 64;                   // tokens of one CTA
constexpr int ROWS = 16;                   // query heads, zero-padded: mma M
constexpr int SP = KEYS + 8;               // row stride of S (f32) and P

// Shared memory of one CTA.  Rows of Q, K and V are padded by 16 bytes
// (and those of P to 144 bytes), so the 8 rows of an ldmatrix fall on
// distinct banks.
template <int DH> struct Smem {
  static constexpr int KS = DH + 8;        // row stride of Q, K, V
  __nv_bfloat16 q[ROWS * KS];
  __nv_bfloat16 k[KEYS * KS];
  __nv_bfloat16 v[KEYS * KS];
  float s[ROWS * SP];                      // scores, log2 units
  __nv_bfloat16 ph[ROWS * SP];             // bf16(p)
  __nv_bfloat16 pl[ROWS * SP];             // bf16(p − bf16(p))
  float m[ROWS], l[ROWS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global → shared; zero-filled (nothing read) unless `ok`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16 x 16, row) · b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// q (B, H, DH) bf16; pages (P, T, H_kv, DH) bf16; block_tables (B,
// max_pages) int32 padded with -1; context_lens (B,) int32.  Partials as
// the split route's: acc (B, H_kv, n_split, G, DH) and ml (B, H_kv,
// n_split, G, 2) f32, m in log2 units, chunk sp holding tokens [64·sp,
// 64·sp + 64).
template <int DH>
__global__ void __launch_bounds__(THREADS)
paged_group_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   const int* __restrict__ key_offset,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int Hkv, int G, int T, int max_pages, int window,
                   float softcap, float scale) {
  constexpr int KS = Smem<DH>::KS;
  constexpr int CPR = DH / 8;              // 16-byte pieces of a row
  constexpr int NT = DH / 32;              // n-tiles of 8 of a warp's O
  static_assert(DH % 64 == 0, "head width");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);

  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  int ctx, lo;                              // local context, first live
  local_span(context_lens, key_offset, b, max_pages * T, window, ctx, lo);
  const int t0 = sp * KEYS;
  // uniform: nothing to read (past the context, or behind the window)
  if (t0 >= ctx || t0 + KEYS <= lo) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long tok_stride = (long long)Hkv * DH;  // one token row

  // lane j < 16 of warp w: the page of token t0 + 16w + j, −1 where the
  // token is not live
  int pg = -1;
  if (lane < 16) {
    const int t = t0 + warp * 16 + lane;
    if (t < ctx && t >= lo) pg = block_tables[(long long)b * max_pages + t / T];
  }

  // Q (rows past G zero), then this warp's 16 K rows: group 1; its 16 V
  // rows: group 2
  const __nv_bfloat16* qb = q + ((long long)b * Hkv + hk) * G * DH;
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(smem_u32(&sm.q[r * KS + c * 8]),
               qb + (r < G ? r : 0) * DH + c * 8, r < G);
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* src = pass ? vp : kp;
    __nv_bfloat16* dst = pass ? sm.v : sm.k;
#pragma unroll 4
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR, c = i % CPR;
      const int page = __shfl_sync(0xffffffffu, pg, r);
      const int t = t0 + warp * 16 + r;
      cp_async16(smem_u32(&dst[(warp * 16 + r) * KS + c * 8]),
                 src + ((long long)(page >= 0 ? page : 0) * T + t % T) *
                           tok_stride + (long long)hk * DH + c * 8,
                 page >= 0);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();                       // Q and K
  __syncthreads();

  // S = Q·Kᵀ for this warp's 16 keys (two n-tiles of 8)
  const int gr = lane / 4, c2 = 2 * (lane % 4);   // fragment row, column
  const int arow = (lane % 8) + 8 * ((lane / 8) % 2), acol = 8 * (lane / 16);
  float s[2][4] = {};
  {
    const uint32_t qa = smem_u32(&sm.q[arow * KS + acol]);
    const uint32_t kb = smem_u32(
        &sm.k[(warp * 16 + (lane % 8) + 8 * (lane / 16)) * KS +
              8 * ((lane / 8) % 2)]);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, qa + kk * 2);
      ldsm_x4(bk, kb + kk * 2);
      mma(s[0], a, bk[0], bk[1]);
      mma(s[1], a, bk[2], bk[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + c2 + (e % 2);     // of this warp's 16
      const bool live = __shfl_sync(0xffffffffu, pg, key) >= 0;
      float x = s[nt][e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sm.s[(gr + 8 * (e / 2)) * SP + warp * 16 + key] =
          live ? x * LOG2E : -INFINITY;
    }
  __syncthreads();

  // softmax of each row's 64 scores: 8 threads a row, 8 keys each
  {
    const int r = tid / 8, j0 = tid % 8;
    float x[KEYS / 8], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
      x[i] = sm.s[r * SP + j0 + 8 * i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float base = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
      const float p = exp2f(x[i] - base);
      const __nv_bfloat16 hi = __float2bfloat16(p);
      sum += p;
      sm.ph[r * SP + j0 + 8 * i] = hi;
      sm.pl[r * SP + j0 + 8 * i] = __float2bfloat16(p - __bfloat162float(hi));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (j0 == 0) {
      sm.m[r] = mx;
      sm.l[r] = sum;
    }
  }
  cp_async_wait<0>();                       // V
  __syncthreads();

  // O[:, d0 : d0 + DH/4] = P·V over the 64 keys, P as hi + lo
  const int d0 = warp * (DH / 4);
  float o[NT][4] = {};
  {
    const uint32_t pha = smem_u32(&sm.ph[arow * SP + acol]);
    const uint32_t pla = smem_u32(&sm.pl[arow * SP + acol]);
    const uint32_t vb = smem_u32(&sm.v[arow * KS + d0 + acol]);
#pragma unroll
    for (int kk = 0; kk < KEYS; kk += 16) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, pha + kk * 2);
      ldsm_x4(al, pla + kk * 2);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (kk * KS + nt * 8) * 2);
        mma(o[nt], ah, bv[0], bv[1]);
        mma(o[nt], al, bv[0], bv[1]);
        mma(o[nt + 1], ah, bv[2], bv[3]);
        mma(o[nt + 1], al, bv[2], bv[3]);
      }
    }
  }

  // the chunk's partial: rows past G are padding
  const long long pidx = ((long long)b * Hkv + hk) * gridDim.z + sp;
  float* pa = part_acc + pidx * G * DH;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gr + 8 * h;
      if (row < G)
        *reinterpret_cast<float2*>(&pa[row * DH + d0 + nt * 8 + c2]) =
            make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
    }
  if (tid < G) {
    part_ml[(pidx * G + tid) * 2 + 0] = sm.m[tid];
    part_ml[(pidx * G + tid) * 2 + 1] = sm.l[tid];
  }
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* kp, const void* vp,
                      const void* bt, const void* cl, const int* off,
                      void* o, float* lse, float* part, int B, int Hkv,
                      int G, int T, int max_pages, int window,
                      float softcap, float scale, cudaStream_t stream) {
  const int n_split = (int)(((long long)max_pages * T + KEYS - 1) / KEYS);
  float* part_ml = part + (size_t)B * Hkv * n_split * G * DH;
  const int smem = (int)sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(
      paged_group_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  paged_group_kernel<DH><<<dim3(Hkv, B, n_split), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(cl), off, part, part_ml, Hkv, G, T, max_pages,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<__nv_bfloat16>(part, part_ml,
                                     static_cast<const int*>(cl), off, o,
                                     lse, B, Hkv, G, DH, KEYS, n_split,
                                     window, stream);
}

int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* cl, const void* key_offset, void* o, void* lse,
           void* part, int B, int H, int Hkv, int T, int dh, int max_pages,
           int window, float softcap, float scale, void* stream) {
  if (B == 0 || max_pages == 0) return cudaSuccess;
  const int G = H / Hkv;
  if (G < 1 || G > ROWS || G * Hkv != H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* off = static_cast<const int*>(key_offset);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 64: err = launch_dh<64>(q, kp, vp, bt, cl, off, o, ls, p, B, Hkv, G,
                                 T, max_pages, window, softcap, scale, s);
      break;
    case 128: err = launch_dh<128>(q, kp, vp, bt, cl, off, o, ls, p, B, Hkv,
                                   G, T, max_pages, window, softcap, scale,
                                   s);
      break;
    case 256: err = launch_dh<256>(q, kp, vp, bt, cl, off, o, ls, p, B, Hkv,
                                   G, T, max_pages, window, softcap, scale,
                                   s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace group

}  // namespace

// The split-K entries.  `part` is f32 scratch of
// B * H_kv * n_split * G * (dh + 2) floats, n_split = ceil(max_pages /
// pps), pps = 64 / T for T < 64 else 1.  dh in {16, 32, 64, 128, 256},
// G = H / H_kv in 1..16.  window <= 0 means no window; softcap <= 0
// means no cap.  Both passes launch on `stream`; returns
// cudaGetLastError() after them.
extern "C" int paged_decode_f32(const void* q, const void* kp,
                                const void* vp, const void* block_tables,
                                const void* context_lens, void* o,
                                void* part, int B, int H, int Hkv, int T,
                                int dh, int max_pages, int window,
                                float softcap, float scale, void* stream) {
  return split::launch<float, float>(q, kp, vp, block_tables, context_lens,
                                     nullptr, o, nullptr, part, B, H, Hkv, T,
                                     dh, max_pages, window, softcap, scale,
                                     stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* block_tables,
                                 const void* context_lens, void* o,
                                 void* part, int B, int H, int Hkv, int T,
                                 int dh, int max_pages, int window,
                                 float softcap, float scale, void* stream) {
  return split::launch<__nv_bfloat16, __nv_bfloat16>(
      q, kp, vp, block_tables, context_lens, nullptr, o, nullptr, part, B, H,
      Hkv, T, dh, max_pages, window, softcap, scale, stream);
}

// f32 query (and output) over bf16 pages.
extern "C" int paged_decode_f32_bf16(const void* q, const void* kp,
                                     const void* vp,
                                     const void* block_tables,
                                     const void* context_lens, void* o,
                                     void* part, int B, int H, int Hkv,
                                     int T, int dh, int max_pages,
                                     int window, float softcap, float scale,
                                     void* stream) {
  return split::launch<float, __nv_bfloat16>(
      q, kp, vp, block_tables, context_lens, nullptr, o, nullptr, part, B, H,
      Hkv, T, dh, max_pages, window, softcap, scale, stream);
}

// The partial route: as the split-K entries, over one rank's block of a
// sequence-sharded cache whose pages hold global positions
// [key_offset[b], key_offset[b] + max_pages·T); context_lens is the
// global context.  o (B, H, dh) and lse (B, H) are f32 whatever q's type.
#define PAGED_PARTIAL(NAME, TQ, TKV)                                         \
  extern "C" int NAME(const void* q, const void* kp, const void* vp,        \
                      const void* block_tables, const void* context_lens,   \
                      const void* key_offset, void* o, void* lse,           \
                      void* part, int B, int H, int Hkv, int T, int dh,     \
                      int max_pages, int window, float softcap,             \
                      float scale, void* stream) {                          \
    return split::launch<TQ, TKV>(q, kp, vp, block_tables, context_lens,    \
                                  key_offset, o, lse, part, B, H, Hkv, T,   \
                                  dh, max_pages, window, softcap, scale,    \
                                  stream);                                  \
  }
PAGED_PARTIAL(paged_partial_f32, float, float)
PAGED_PARTIAL(paged_partial_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_PARTIAL(paged_partial_f32_bf16, float, __nv_bfloat16)
#undef PAGED_PARTIAL

// The group route, bf16 queries and pages, dh in {64, 128, 256}, G = H /
// H_kv in 1..16.  `part` is f32 scratch of B * H_kv * n_split * G *
// (dh + 2) floats, n_split = ceil(max_pages * T / 64).  Without a
// key_offset (null) it writes out (B, H, dh) bf16 to o and ignores lse;
// with one it is the partial route, o (B, H, dh) and lse (B, H) f32.
extern "C" int paged_group_bf16(const void* q, const void* kp,
                                const void* vp, const void* block_tables,
                                const void* context_lens,
                                const void* key_offset, void* o, void* lse,
                                void* part, int B, int H, int Hkv, int T,
                                int dh, int max_pages, int window,
                                float softcap, float scale, void* stream) {
  return group::launch(q, kp, vp, block_tables, context_lens, key_offset, o,
                       key_offset ? lse : nullptr, part, B, H, Hkv, T, dh,
                       max_pages, window, softcap, scale, stream);
}
