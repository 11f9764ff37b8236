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
// (batch, head, 64-row query tile) and walks the K/V tiles itself with
// (m, l, acc) in registers.  The loop stops at the causal limit of the
// tile and starts at its window limit, so masked tiles cost nothing.
// Ragged sequence lengths are masked here (the TPU kernel needs
// S % block == 0).  Every tensor is addressed as base + b*sb + s*ss +
// h*sh + d (element strides, d contiguous), so the model's (B,S,H,dh)
// tensors are read in place as (B,H,S,dh) views.
//
// What bounds it on the H100: causal prefill does 2·S²·H·dh FLOPs
// against 2·(2·H + 2·H_kv)·S·dh bytes of bf16 traffic, about 0.4·S
// FLOP per byte at 32/8 heads.  Below ~740 tokens that is under the
// card's ~295 FLOP/byte ridge, so the least time is set by bytes
// (prompts on the serve path are 32-512 tokens); above it by the
// tensor cores.
//
// Two routes, chosen by the wrapper on dtype and head width:
//
// * flash_prefill_bf16_wgmma — bf16 with dh in {64, 128, 256}, the
//   serve path's route.  One warpgroup (128 threads) per CTA.  Both
//   products run on the tensor cores with wgmma: S = Q·Kᵀ as m64n64k16
//   with Q and K read from shared memory, O += P·V with P rounded to
//   bf16 in registers (the accumulator fragment of S is already the A
//   fragment of the second product) and V read through the transpose
//   bit of its descriptor.  The softmax runs on the f32 accumulator
//   fragment: each thread holds two query rows, whose max and sum are
//   taken across the thread's quad with shuffles.  Q (64 x dh) is copied
//   once; K and V tiles of 64 keys sit in a two-stage ring, filled with
//   16-byte cp.async copies in the 128-byte-swizzle layout the wgmma
//   descriptors read, the next tile's copies issued before the current
//   tile's math.  The K/V bytes are read once per query head (GQA does
//   not share them across the group) and from L2 after the first.
//   By width:
//   - dh 64 and 128: P·V as one m64n{dh}k16 a k-step; 41 / 81 KB of
//     shared memory, so two or more CTAs fit on an SM.
//   - dh 256 (gemma2, recurrentgemma): O is 64 x 256 f32, 128 registers
//     a thread, and no m64n256 product is issued: each P·V k-step is two
//     m64n128k16 products into the two 64-register halves of O, the
//     second reading V two swizzle blocks (128 columns) further on.  P
//     enters P·V as two bf16 parts, hi = bf16(p) and lo = bf16(p − hi),
//     each through its own product: one rounding of P (2^-9 relative)
//     puts the output up to 1.5x past the families' limit (2e-3 +
//     2e-2·|ref|), the two parts keep it at ~0.3 of it, for half again
//     the tensor-core work.  Q·Kᵀ runs 16 k-steps over four 128-byte
//     swizzle blocks.  O, S (32) and P (16 + 16) leave little of the
//     255 registers a thread may hold: each thread copies one 16-byte
//     column of a tile and steps a single source address down its rows
//     (per-row addresses, hoisted out of the tile loop as at dh 64/128,
//     spilled); the build's `-Xptxas -v` line for this instance gives
//     the count and its spill bytes, which must be 0.  Q 32 KB + two K
//     and two V stages of 32 KB = 161 KB of shared memory with the
//     alignment slack, so one CTA (one warpgroup) sits on an SM and its
//     softmax does not overlap its own products (two consumer
//     warpgroups sharing each K/V tile, each branching past the tiles
//     its rows do not see, measured slower at the models' shapes).
// * flash_prefill_f32 / flash_prefill_bf16 — the first, scalar kernel:
//   both products as f32 FMAs out of shared memory, no tensor cores.  It
//   is the route for float32 (tensor cores would mean TF32, beyond the
//   2e-5 tolerance) and for bf16 head widths outside {64, 128, 256}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// Scalar route
// ---------------------------------------------------------------------------
namespace scalar {

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

}  // namespace scalar

// ---------------------------------------------------------------------------
// Tensor-core route (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 64;          // query rows per CTA: one wgmma M
constexpr int BN = 64;          // keys per K/V tile
constexpr int THREADS = 128;    // one warpgroup
constexpr int ATOM = BN * 128;  // bytes of one 64-row x 128-byte swizzle block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor with the 128-byte swizzle.  Address
// and offsets in bytes (the descriptor holds them in 16-byte units).
// K-major operands (Q, K): rows of 128 bytes, 8-row groups `sbo` apart,
// `lbo` unused.  MN-major operand (V): `lbo` is the distance between
// 64-column blocks, `sbo` between 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the
// async proxy: each writer fences before the barrier that publishes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// S (64 x 64, f32) += Q (64 x 16, smem, K-major) · K (64 x 16, smem,
// K-major)ᵀ; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x dh, f32) += P (64 x 16, bf16 registers) · V (16 x dh, smem,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t bits) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
}

// Issues the copies of rows [row0, row0 + 64) of a (rows x DH) bf16
// matrix with row stride `ld` into a 64 x DH shared tile at `dst`: DH/64
// blocks of 64 rows x 128 bytes, the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8) (the 128-byte swizzle).  Rows at or past `rows`
// are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int rows,
                                          int tid) {
  constexpr int CPR = DH / 8;                   // 16-byte chunks per row
  if constexpr (DH <= 128) {
#pragma unroll
    for (int i = 0; i < BN * CPR / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / CPR, c = idx % CPR;
      const bool in = row0 + r < rows;
      const __nv_bfloat16* g = src + (in ? row0 + r : 0) * ld + c * 8;
      cp_async16(dst + (c / 8) * ATOM + r * 128 +
                     (((c % 8) ^ (r % 8)) << 4), g, in);
    }
  } else {
    // Each thread keeps one column chunk and walks the rows RPI apart
    // with one source address: the 16 per-row addresses a tile, which
    // the compiler hoists out of the caller's loop at dh 64/128, spill
    // beside the 128 registers of O.
    constexpr int RPI = THREADS / CPR;          // rows per pass: 4
    static_assert(RPI == 4, "tile shape");
    const int c = tid % CPR, r = tid / CPR;
    // row r + 4i has the swizzle phase of r, flipped by 4 on odd i
    const uint32_t d = dst + (c / 8) * ATOM + r * 128 +
                       (((c % 8) ^ (r % 8)) << 4);
    const int left = rows - row0 - r;           // rows of this thread in
    unsigned long long g = reinterpret_cast<unsigned long long>(
        src + (row0 + r) * ld + c * 8);
    const unsigned long long step = RPI * ld * 2;   // bytes
#pragma unroll
    for (int i = 0; i < BN / RPI; ++i) {
      const bool in = i * RPI < left;
      cp_async16((d + i * RPI * 128) ^ (((i * RPI) % 8) << 4),
                 in ? reinterpret_cast<const void*>(g) : src, in);
      g += step;
      asm volatile("" : "+l"(g));               // one address, stepped
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int Sk,
                           int group, Strides qs, Strides ks, Strides vs,
                           Strides os, int causal, int window, float softcap,
                           float scale) {
  constexpr int TILE = BN * DH * 2;             // bytes of a 64-row tile
  // O in NH column halves of at most 128 (one wgmma N each), NACC f32
  // registers a thread in each
  constexpr int NH = DH > 128 ? DH / 128 : 1;
  constexpr int NACC = DH / 2 / NH;
  // at dh 256 P goes into P·V as two bf16 parts, hi = bf16(p) and lo =
  // bf16(p − hi): one bf16 rounding of P (2^-9) exceeds the families'
  // tolerance over gemma2's 4,096-key rows
  constexpr bool SPLIT = DH == 256;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle's phase follows address bits 7-9: 1024-byte alignment
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + TILE;                // two stages
  const uint32_t sV = sK + 2 * TILE;            // two stages

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  // keys this tile can see: [k_begin, k_end), k_begin on a tile boundary
  const int q_last = min(S, q0 + BM) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  const int n_tiles = max(0, (k_end - k_begin + BN - 1) / BN);

  // the accumulator fragment: this thread holds rows r0 and r0 + 8, and
  // in each 8-column block the columns cq and cq + 1
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);

  float acc[NH][NACC];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) zero(acc[hf]);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // the scale, the softcap and the change to log2 units as products
  // (within an ulp or two of dividing by the softcap)
  const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2e = softcap * LOG2E, scale_log2e = scale * LOG2E;

  if (n_tiles > 0) {
    load_tile<DH>(sQ, qb, qs.s, q0, S, tid);
    load_tile<DH>(sK, kb, ks.s, k_begin, Sk, tid);
    cp_async_commit();
    load_tile<DH>(sV, vb, vs.s, k_begin, Sk, tid);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int kt = k_begin + it * BN;
    const bool more = it + 1 < n_tiles;
    // groups in flight, oldest first: K[it], V[it], K[it+1], V[it+1]
    if (more) {
      load_tile<DH>(sK + (st ^ 1) * TILE, kb, ks.s, kt + BN, Sk, tid);
      cp_async_commit();
      load_tile<DH>(sV + (st ^ 1) * TILE, vb, vs.s, kt + BN, Sk, tid);
      cp_async_commit();
      cp_async_wait<3>();
    } else {
      cp_async_wait<1>();
    }
    fence_proxy_async();
    __syncthreads();                            // Q and K[it] in place

    float s[32];
    zero(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // k16 step kk: 64-column block kk / 4, 32 bytes per step inside it
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_qk(s, sw128_desc(sQ + off, 16, 1024),
               sw128_desc(sK + st * TILE + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // softmax on the fragment, in log2 units
    const bool edge = (causal && kt + BN - 1 > q0) || kt + BN > Sk ||
                      (window > 0 && q0 + BM - 1 - kt >= window);
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = cap_log2e * tanhf(s[i] * scale_cap);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2e;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (edge) {
          const int kp = kt + 8 * j + cq + (e & 1);
          const int qp = e < 2 ? r0 : r1;
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          x = ok ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {       // across the quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps p = 0 (exp2(-inf - 0))
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - base0), al1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;

    // P in bf16 as the A fragment of P·V: for keys 16kk..16kk+15 the
    // registers hold (r0, cq), (r1, cq), (r0, cq + 8), (r1, cq + 8);
    // pl the low parts at dh 256
    uint32_t pa[4][4], pl[SPLIT ? 4 : 1][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[4 * j + 0] - base0);
      const float p1 = exp2f(s[4 * j + 1] - base0);
      const float p2 = exp2f(s[4 * j + 2] - base1);
      const float p3 = exp2f(s[4 * j + 3] - base1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      uint32_t& h01 = pa[j / 2][(j % 2) * 2 + 0];
      uint32_t& h23 = pa[j / 2][(j % 2) * 2 + 1];
      h01 = pack_bf16(p0, p1);
      h23 = pack_bf16(p2, p3);
      if constexpr (SPLIT) {
        const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
        pl[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0 - f01.x, p1 - f01.y);
        pl[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2 - f23.x, p3 - f23.y);
      }
    }
    // l stays a per-thread partial sum until the end: alpha is the same
    // across the quad
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        acc[hf][4 * j + 0] *= al0;
        acc[hf][4 * j + 1] *= al0;
        acc[hf][4 * j + 2] *= al1;
        acc[hf][4 * j + 3] *= al1;
      }

    if (more) cp_async_wait<2>();
    else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                            // V[it] in place

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {  // columns 128·hf on: 2 blocks each
        const uint64_t dv = sw128_desc(
            sV + st * TILE + hf * 2 * ATOM + kk * 16 * 128, ATOM, 1024);
        wgmma_pv(acc[hf], pa[kk], dv);
        if constexpr (SPLIT) wgmma_pv(acc[hf], pl[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(acc[hf]);
    __syncthreads();                            // stage st free for it + 2
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j) {
      const int col = 128 * hf + 8 * j + cq;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + col) =
            __floats2bfloat162_rn(acc[hf][4 * j] * inv0,
                                  acc[hf][4 * j + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os.s + col) =
            __floats2bfloat162_rn(acc[hf][4 * j + 2] * inv1,
                                  acc[hf][4 * j + 3] * inv1);
    }
}

template <int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int Hkv, int S, int Sk, Strides qs,
                      Strides ks, Strides vs, Strides os, int causal,
                      int window, float softcap, float scale,
                      cudaStream_t stream) {
  // Q, two K stages, two V stages, and room to align to 1024 bytes
  constexpr int SMEM = 5 * BN * DH * 2 + 1024;
  static bool configured = false;
  auto kern = flash_prefill_wgmma_kernel<DH>;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((S + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Sk, H / Hkv, qs, ks, vs, os, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
  return scalar::launch<float>(q, k, v, o, B, H, Hkv, S, Sk, dh, strides,
                               causal, window, softcap, scale, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* o, int B, int H,
                                  int Hkv, int S, int Sk, int dh,
                                  const long long* strides, int causal,
                                  int window, float softcap, float scale,
                                  void* stream) {
  return scalar::launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Sk, dh,
                                       strides, causal, window, softcap,
                                       scale, stream);
}

// The tensor-core route: bf16, dh 64, 128 or 256, every pointer and every
// (batch, seq, head) stride 16-byte aligned (the wrapper checks).
extern "C" int flash_prefill_bf16_wgmma(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int H, int Hkv, int S, int Sk,
                                        int dh, const long long* st,
                                        int causal, int window,
                                        float softcap, float scale,
                                        void* stream) {
  if (S == 0 || B == 0) return cudaSuccess;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh == 64)
    err = tc::launch_dh<64>(q, k, v, o, B, H, Hkv, S, Sk, qs, ks, vs, os,
                            causal, window, softcap, scale, s);
  else if (dh == 128)
    err = tc::launch_dh<128>(q, k, v, o, B, H, Hkv, S, Sk, qs, ks, vs, os,
                             causal, window, softcap, scale, s);
  else if (dh == 256)
    err = tc::launch_dh<256>(q, k, v, o, B, H, Hkv, S, Sk, qs, ks, vs, os,
                             causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
