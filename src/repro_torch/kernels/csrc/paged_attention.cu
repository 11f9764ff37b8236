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
// BlockSpec index maps, so the grid's page axis DMAs one page per step.
// Here one CTA owns one (sequence, kv head) and reads its own block
// table: it walks pages 0 .. ceil(ctx / T) - 1, skips -1 entries, and
// reads each page's K and V rows for its kv head straight from device
// memory (each row is dh contiguous elements, so a warp's loads are
// coalesced).  Scores for the G query heads of the group land in
// shared memory, one warp per head runs the online-softmax update, and
// every thread keeps its (head, column) accumulators in shared memory.
//
// What bounds it on the H100: every K/V element of the live context is
// read once and used for G multiply-adds (one per query head of the
// group), ~G FLOP per bf16 byte (4 at Qwen3-8B) — far below the ~295
// FLOP/byte ridge, so it is bound by memory bandwidth (3.35 TB/s).  The weakness of this first version is
// parallelism: B x H_kv CTAs (64 at batch 8 on Qwen3-8B) leave half of
// the 132 SMs idle and each CTA walks its pages serially.  The next step
// is flash-decoding: split the pages of a sequence over several CTAs and
// merge the partial (m, l, acc) in a second pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -2.38e38f;

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

// q (B, H, dh); pages (P, T, H_kv, dh); block_tables (B, max_pages)
// int32 padded with -1; context_lens (B,) int32; out (B, H, dh) in q's
// type.  The query may be wider than the pages (f32 q over a bf16
// cache), as the TPU kernel allows: both are read into f32.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens,
                    TQ* __restrict__ o, int H, int Hkv, int T_, int dh,
                    int max_pages, float softcap, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* Qs = smem;                 // G x dh
  float* Ss = Qs + G * dh;          // G x T   scores, then probabilities
  float* acc = Ss + G * T_;         // G x dh
  float* ml = acc + G * dh;         // G x 3   (m, l, alpha)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = THREADS / 32;

  const TQ* qb = q + ((long long)b * H + (long long)hk * G) * dh;
  for (int i = tid; i < G * dh; i += THREADS) {
    Qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ml[g * 3 + 0] = NEG_INF;
    ml[g * 3 + 1] = 0.f;
  }

  const int ctx = context_lens[b];
  const int n_pages = min(max_pages, (ctx + T_ - 1) / T_);
  const long long tok_stride = (long long)Hkv * dh;      // one token row
  const long long page_stride = (long long)T_ * tok_stride;

  for (int ip = 0; ip < n_pages; ++ip) {
    const int page = block_tables[(long long)b * max_pages + ip];
    if (page < 0) continue;                             // uniform per CTA
    const TKV* kpage = kp + page * page_stride + (long long)hk * dh;
    const TKV* vpage = vp + page * page_stride + (long long)hk * dh;
    __syncthreads();                  // Qs / ml ready; last page consumed

    // scores: warp w takes tokens w, w + nwarps, ...; lanes split dh
    for (int t = warp; t < T_; t += nwarps) {
      const TKV* krow = kpage + t * tok_stride;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
        for (int d = lane; d < dh; d += 32)
          part = fmaf(Qs[g * dh + d], to_f32(krow[d]), part);
        part = warp_sum(part);
        if (lane == 0) Ss[g * T_ + t] = part;
      }
    }
    __syncthreads();

    // online-softmax update: warp w takes heads w, w + nwarps, ...
    for (int g = warp; g < G; g += nwarps) {
      const float m_prev = ml[g * 3 + 0];
      float mx = NEG_INF;
      for (int t = lane; t < T_; t += 32) {
        float x = Ss[g * T_ + t] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = ip * T_ + t < ctx;
        x = ok ? x : NEG_INF;
        Ss[g * T_ + t] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < T_; t += 32) {
        const bool ok = ip * T_ + t < ctx;
        const float p = ok ? expf(Ss[g * T_ + t] - m_new) : 0.f;
        Ss[g * T_ + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
      if (lane == 0) {
        ml[g * 3 + 0] = m_new;
        ml[g * 3 + 1] = alpha * ml[g * 3 + 1] + sum;
        ml[g * 3 + 2] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = alpha_g * acc[g, d] + sum_t p[g, t] * v[t, d]
    for (int i = tid; i < G * dh; i += THREADS) {
      const int g = i / dh, d = i % dh;
      float a = acc[i] * ml[g * 3 + 2];
      for (int t = 0; t < T_; ++t)
        a = fmaf(Ss[g * T_ + t], to_f32(vpage[t * tok_stride + d]), a);
      acc[i] = a;
    }
  }
  __syncthreads();

  TQ* ob = o + ((long long)b * H + (long long)hk * G) * dh;
  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh;
    ob[i] = from_f32<TQ>(acc[i] / fmaxf(ml[g * 3 + 1], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp,
           const void* block_tables, const void* context_lens, void* o,
           int B, int H, int Hkv, int T_, int dh, int max_pages,
           float softcap, float scale, void* stream) {
  if (B == 0) return cudaSuccess;
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * (2 * G * dh + G * T_ + 3 * G);
  auto kern = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<TQ*>(o), H, Hkv, T_,
      dh, max_pages, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// softcap <= 0 means no cap.  Returns cudaGetLastError() of the launch.
extern "C" int paged_decode_f32(const void* q, const void* kp,
                                const void* vp, const void* block_tables,
                                const void* context_lens, void* o, int B,
                                int H, int Hkv, int T, int dh, int max_pages,
                                float softcap, float scale, void* stream) {
  return launch<float, float>(q, kp, vp, block_tables, context_lens, o, B,
                              H, Hkv, T, dh, max_pages, softcap, scale,
                              stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* block_tables,
                                 const void* context_lens, void* o, int B,
                                 int H, int Hkv, int T, int dh,
                                 int max_pages, float softcap, float scale,
                                 void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      q, kp, vp, block_tables, context_lens, o, B, H, Hkv, T, dh, max_pages,
      softcap, scale, stream);
}

// f32 query (and output) over bf16 pages.
extern "C" int paged_decode_f32_bf16(const void* q, const void* kp,
                                     const void* vp,
                                     const void* block_tables,
                                     const void* context_lens, void* o,
                                     int B, int H, int Hkv, int T, int dh,
                                     int max_pages, float softcap,
                                     float scale, void* stream) {
  return launch<float, __nv_bfloat16>(
      q, kp, vp, block_tables, context_lens, o, B, H, Hkv, T, dh, max_pages,
      softcap, scale, stream);
}
