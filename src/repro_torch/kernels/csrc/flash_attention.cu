// Forward flash attention on Hopper (sm_90a): online softmax over kv tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (entry flash_attention, wrapper kernels/ops.py).  For q
// (B,Sq,H,hd) and k/v (B,Sk,KV,hd) it computes, per query row,
//   s = (q . k) * scale;  s = tanh(s / cap) * cap when cap > 0;
//   live keys: kpos < kv_len, and kpos <= qpos when causal, and
//              qpos - kpos < window when window > 0;
//   out = sum_live exp(s - m) v / max(sum_live exp(s - m), 1e-30)
// with the kv head of query head h being h / (H / KV) (GQA, MQA).  A row
// with no live key gives 0, as the Pallas kernel does (kernels/ref.py's
// materialised softmax would give the mean of v there instead).
//
// Numerics: float32 throughout, whatever the input type (bf16 inputs are
// widened exactly on load, the output is rounded once).  The products are
// explicit __fmaf_rn on the CUDA cores: no tensor cores, so no TF32, and the
// build's -fmad=false leaves the rest of the arithmetic uncontracted.
// expf/tanhf/division are the IEEE versions (no fast math).
//
// Bound on this card.  At the serving prefill shape (B 4, S 1024, H 8,
// KV 1, hd 256, causal, bf16) the function does ~17.2 GFLOP of QK^T and PV
// and moves ~37.7 MB, so the least time is 17.4 us at the 989 TFLOP/s bf16
// tensor-core rate (operations bound; the bytes alone take 11.3 us).  This
// kernel does its products in float32 on the CUDA cores, whose peak is
// 67 TFLOP/s, so it cannot come nearer than ~257 us at that shape; reaching
// the bound needs wgmma on bf16 tiles, which is later work.
//
// Design.  The TPU kernel walks a sequential (b*h, q-block, kv-block) grid
// and keeps (m, l, acc) in VMEM scratch between kv steps; on Hopper the kv
// axis becomes a loop inside one CTA:
//   * one CTA of 256 threads per (b*H + h, 64-row q tile); q tiles are
//     issued longest-first, so the causal tail does not straggle;
//   * the Q tile and each 64-row K and V tile are staged in shared memory
//     as float32, row stride hd + 4 so that the column reads of K are free
//     of bank conflicts (217 KB at hd 256: one CTA per SM);
//   * thread (ty, tx) of a 16 x 16 layout owns query rows 4*ty .. 4*ty+3:
//     it computes their scores against keys tx + 16 j (j < 4), reduces the
//     row max and sum over the 16 lanes of its half-warp with shuffles, and
//     keeps the rows' m, l and its 4 x hd/16 slice of acc in registers;
//   * P goes through shared memory once per tile for the PV product;
//   * kv tiles wholly outside the causal, window or kv_len band are never
//     visited (the TPU kernel's pl.when skip), and ragged Sq/Sk edges are
//     masked here, so no input needs padding to a tile multiple.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per kv tile
constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kLDP = kBK + 4;  // row stride of the P tile, floats
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <int HD>
constexpr int smem_bytes() {
  return 4 * (kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * kLDP);
}

// Four consecutive elements as float4, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<unsigned*>(&lo) = u.x;
  *reinterpret_cast<unsigned*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = __fmaf_rn(a.x, b.x, s);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// Reductions over the 16 lanes of a half-warp (the threads sharing ty).
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int KV, int causal, int window,
    float cap, float scale, int kv_len) {
  constexpr int LD = HD + 4;  // row stride of the Q, K and V tiles, floats
  constexpr int NC = HD / 64;  // float4 output columns per thread: tx*4 + 64*c
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal rows first
  const long long q_stride = static_cast<long long>(H) * HD;  // between positions
  const long long k_stride = static_cast<long long>(KV) * HD;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * Sk * KV + kvh) * HD;
  const T* vb = v + (static_cast<long long>(b) * Sk * KV + kvh) * HD;
  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * HD;

  for (int idx = tid; idx < kBQ * HD / 4; idx += kThreads) {
    const int r = idx / (HD / 4);
    const int c = (idx - r * (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = load4(qb + (q0 + r) * q_stride + c);
    store4(Qs + r * LD + c, x);
  }

  // The kv range these rows can see: [k_begin, k_end).
  const int k_live = min(kv_len, Sk);
  int k_end = k_live;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * HD / 4; idx += kThreads) {
      const int r = idx / (HD / 4);
      const int c = (idx - r * (HD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Sk) {
        kx = load4(kb + (k0 + r) * k_stride + c);
        vx = load4(vb + (k0 + r) * k_stride + c);
      }
      store4(Ks + r * LD + c, kx);
      store4(Vs + r * LD + c, vx);
    }
    __syncthreads();

    // Scores of rows 4*ty + i against keys tx + 16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = load4(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], kk[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      unsigned live = 0;
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if (cap > 0.f) x = __fmul_rn(tanhf(__fdiv_rn(x, cap)), cap);
        bool ok = kpos < k_live;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? x : kNeg;
        live |= static_cast<unsigned>(ok) << j;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float r = expf(__fsub_rn(m[i], m_new));
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (live >> j) & 1u ? expf(__fsub_rn(s[i][j], m_new)) : 0.f;
        Ps[(4 * ty + i) * kLDP + tx + 16 * j] = p;
        p_sum = __fadd_rn(p_sum, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], r), half_warp_sum(p_sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], r);
    }
    __syncthreads();

    // acc += P V over this tile's keys.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = load4(Ps + (4 * ty + i) * kLDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vx = load4(Vs + (kk + e) * LD + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
            acc[i][4 * c + 0] = __fmaf_rn(pe, vx.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = __fmaf_rn(pe, vx.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = __fmaf_rn(pe, vx.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = __fmaf_rn(pe, vx.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x = make_float4(
          __fdiv_rn(acc[i][4 * c + 0], den), __fdiv_rn(acc[i][4 * c + 1], den),
          __fdiv_rn(acc[i][4 * c + 2], den), __fdiv_rn(acc[i][4 * c + 3], den));
      store4(ob + qpos * q_stride + 64 * c + 4 * tx, x);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KV, int causal, int window, float cap, float scale,
           int kv_len, cudaStream_t stream) {
  static bool configured[kMaxDevices];  // one per instance: the smem attribute is set
  constexpr int smem = smem_bytes<HD>();
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, window, cap, scale, kv_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(int head_dim, const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Sk, int H, int KV, int causal, int window,
                 float cap, float scale, int kv_len, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream`; returns a CUDA error code (0 = launched).
// q (B,Sq,H,hd), k and v (B,Sk,KV,hd), o (B,Sq,H,hd): contiguous device
// tensors of one type, float32 (dtype 0) or bfloat16 (dtype 1), aligned to
// 16 bytes, with hd in {64, 128, 256} and H a multiple of KV.  The caller
// checks all of this; B*H and Sq must be positive.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Sq, int Sk, int H, int KV,
                                      int head_dim, int dtype, int causal, int window,
                                      float cap, float scale, int kv_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(head_dim, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                               cap, scale, kv_len, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(head_dim, q, k, v, o, B, Sq, Sk, H, KV, causal,
                                       window, cap, scale, kv_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
