// Flash-attention prefill for Hopper (sm_90a), CUDA C++, plain C entry
// points bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (body _flash_kernel): prefill attention with an online softmax over
//   K blocks, causal mask, sliding window, logit softcap and GQA; rows
//   whose keys are all masked output 0.
//
// On the TPU the grid's K-block axis runs in order and (m, l, acc) ride
// in VMEM scratch between grid steps.  Here one CTA owns one
// (batch, head, 64-row query tile) and walks the K/V tiles itself: the
// tiles are staged in shared memory and (m, l, acc) stay in registers
// for the whole loop.  The loop stops at the causal limit of the tile
// and starts at its window limit, so masked tiles cost nothing.  Ragged
// sequence lengths are masked here (the TPU kernel needs S % block ==
// 0).
//
// What bounds it on the H100: causal prefill does 2·S²·H·dh FLOPs
// against 2·(2·H + 2·H_kv)·S·dh bytes of bf16 traffic, about 0.4·S
// FLOP per byte at 32/8 heads.  Below ~740 tokens that is under the
// card's ~295 FLOP/byte ridge, so the least time is set by bytes
// (prompts on the serve path are 32-512 tokens); above it by the
// tensor cores.  This first version is bound by neither: it does its
// products as scalar f32 FMAs out of shared memory, about one shared
// load per FMA, on the CUDA cores.  The next step is wgmma on bf16
// tiles fed by TMA, with one CTA per (batch, kv head) so a K/V tile
// serves the whole GQA group; the data layout (64-row query tiles, K/V
// tiles in shared memory) is the one that needs.
//
// Layout: every tensor is addressed as base + b*sb + s*ss + h*sh + d
// (element strides, d contiguous), so (B,S,H,dh) and (B,H,S,dh) views
// are read in place.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 32;        // keys per tile: one per lane
constexpr int WARPS = 8;      // 8 warps x 8 rows = BQ
constexpr int ROWS = BQ / WARPS;
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

struct Strides {
  long long b, s, h;
};

// NC = output columns per lane = ceil(dh / 32)
template <typename T, int NC>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int S, int Sk, int H, int group, int dh,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;                       // padded: no bank conflicts
  float* Qs = smem;                             // BQ x dh
  float* Ks = Qs + BQ * dh;                     // BK x (dh + 1)
  float* Vs = Ks + BK * ldk;                    // BK x dh
  float* Ps = Vs + BK * dh;                     // BQ x BK

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * dh; i += WARPS * 32) {
    const int r = i / dh, d = i % dh;
    const int qi = q0 + r;
    Qs[i] = qi < S ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // keys this tile can see: [k_begin, k_end)
  const int q_last = min(S, q0 + BQ) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();                            // previous tile consumed
    for (int i = tid; i < BK * dh; i += WARPS * 32) {
      const int j = i / dh, d = i % dh;
      const int kj = kt + j;
      const bool in = kj < Sk;
      Ks[j * ldk + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[j * dh + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's ROWS query rows against key kt + lane
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * ldk;
    const float* qrow = Qs + warp * ROWS * dh;
    for (int d = 0; d < dh; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qrow[r * dh + d], kd, s[r]);
    }

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos < window);
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float alpha = m[r] > NEG_INF / 2 ? expf(m[r] - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      Ps[(warp * ROWS + r) * BK + lane] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < dh ? Vs[j * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Ps[(warp * ROWS + r) * BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vj[c], acc[r][c]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) ob[qi * os.s + d] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Hkv, int S, int Sk, int dh,
                      Strides qs, Strides ks, Strides vs, Strides os,
                      int causal, int window, float softcap, float scale,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * dh + BK * (dh + 1) + BK * dh + BQ * BK);
  auto kern = flash_prefill_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, H, H / Hkv, dh,
      qs, ks, vs, os, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int S, int Sk, int dh, const long long* st,
           int causal, int window, float softcap, float scale,
           void* stream) {
  if (S == 0 || B == 0) return cudaSuccess;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (dh + 31) / 32;
  cudaError_t err;
  if (nc == 1)
    err = launch_nc<T, 1>(q, k, v, o, B, H, Hkv, S, Sk, dh, qs, ks, vs, os,
                          causal, window, softcap, scale, s);
  else if (nc == 2)
    err = launch_nc<T, 2>(q, k, v, o, B, H, Hkv, S, Sk, dh, qs, ks, vs, os,
                          causal, window, softcap, scale, s);
  else if (nc <= 4)
    err = launch_nc<T, 4>(q, k, v, o, B, H, Hkv, S, Sk, dh, qs, ks, vs, os,
                          causal, window, softcap, scale, s);
  else
    err = launch_nc<T, 8>(q, k, v, o, B, H, Hkv, S, Sk, dh, qs, ks, vs, os,
                          causal, window, softcap, scale, s);
  return static_cast<int>(err);
}

}  // namespace

// strides: 12 int64 — (batch, seq, head) element strides of q, k, v, o.
// window <= 0 means no window; softcap <= 0 means no cap.
// Returns cudaGetLastError() of the launch (0 = cudaSuccess).
extern "C" int flash_prefill_f32(const void* q, const void* k,
                                 const void* v, void* o, int B, int H,
                                 int Hkv, int S, int Sk, int dh,
                                 const long long* strides, int causal,
                                 int window, float softcap, float scale,
                                 void* stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, S, Sk, dh, strides, causal,
                       window, softcap, scale, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* o, int B, int H,
                                  int Hkv, int S, int Sk, int dh,
                                  const long long* strides, int causal,
                                  int window, float softcap, float scale,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Sk, dh, strides,
                               causal, window, softcap, scale, stream);
}
