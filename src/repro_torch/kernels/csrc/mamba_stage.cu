// Mamba-1 scan elements on Hopper (sm_90a): the decay a = exp(dt*A) and the
// drive b = (dt*x)*B of every state element, in one pass.
//
// Replaces no Pallas kernel: the JAX package builds a and b op by op
// (src/repro/models/mamba.py) and hands them to _scan_kernel.  The port built
// them the same way, in three PyTorch passes over (B,S,di,st) float32 (a
// broadcast multiply, an in-place exp, a second broadcast multiply), which
// took longer than the scan that reads them; this kernel writes each once.
// Entry mamba_stage_launch, wrapper kernels/mamba_stage.py, plain version
// kernels/ref.py:mamba_stage_ref.  For dt and x (B,S,di) and Bm (B,S,st) in
// the compute dtype T (bf16 or float32) and A (di,st) float32, it writes
//   a[b,s,d,n] = expf(float(dt[b,s,d]) * A[d,n])
//   b[b,s,d,n] = float(T(dt[b,s,d] * x[b,s,d])) * float(Bm[b,s,n])
// (B,S,di,st) float32 and contiguous.
//
// Numerics: every product is one IEEE round to nearest (__fmul_rn, never
// contracted); dt*x is rounded to T first (bf16: the float product of two
// bf16 values is exact, then one round to nearest even), as PyTorch and JAX
// round it; exp is CUDA's accurate expf (no fast math in the build).  So a and
// b equal the plain version's on the card bit for bit.
//
// Bound on this card: bytes.  Each output element costs 8 bytes written and
// one exp and two products.  At falcon-mamba-7b's serving wave (B 32, S 1024,
// di 8192, st 16) the pass writes 34.36 GB and reads 1.07 GB (dt and x bf16,
// Bm, A): 10.58 ms at 3.35 TB/s, while its 4.3e9 exps take about 1-2 ms on
// the MUFU and FMA pipes (a variant with no exp ran no faster).
//
// Design.  The (di, st) slab of one token is contiguous in a, b and A, so
// one thread owns one chunk of V consecutive elements of the slab (V = 4 where
// st % 4 == 0, else 1), whose row d and lanes n..n+V-1 it computes once, and
// walks a group of kTokens tokens:
//   * A's chunk stays in registers;
//   * the CTA first stages the group's dt and dt*x (rounded) for its rows and
//     the group's Bm in shared memory, with coalesced loads that read each
//     value once (the 4 threads of one row would each load it otherwise);
//   * then each thread writes a and b with one V-wide streaming store each
//     (__stcs: 34 GB cannot stay in the 50 MB L2), so a warp's store is one
//     contiguous run of 32 * V floats;
//   * the grid is (slab chunks / kThreads, token groups); offsets are 64-bit
//     (a falcon-mamba wave has 4.29e9 elements), and ragged di, any st and
//     any token count are masked here.
// Measured on an H100 (700 W) at that wave: 12.21 ms, 86.6 % of the bound.
// The loads hold it back: the same stores with no loads take 10.67 ms, while
// loading a token group ahead (double-buffered shared memory), 16 or 32
// tokens a CTA, 128 or 256 threads, or the loads in registers with no shared
// memory all ran at 79-84 %.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTokens = 8;  // tokens of one group, staged in shared memory
constexpr int kMaxState = 32;
// Rows of dt and x a CTA reads: kThreads * V / st + 1 at most, and V <= st
constexpr int kRows = kThreads + 1;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// dt * x in the compute dtype, widened to float32.
__device__ __forceinline__ float drive(float dt, float x) { return __fmul_rn(dt, x); }
__device__ __forceinline__ float drive(__nv_bfloat16 dt, __nv_bfloat16 x) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(widen(dt), widen(x))));
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) __stcs(p + k, v[k]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) mamba_stage_ab(
    const T* __restrict__ dt, const T* __restrict__ x, const T* __restrict__ Bm,
    const float* __restrict__ A, float* __restrict__ a, float* __restrict__ b,
    long long tokens, int di, int st) {
  // A token group's dt and rounded dt*x for the CTA's rows, and its Bm rows
  __shared__ float s_dt[kTokens][kRows], s_p[kTokens][kRows], s_B[kTokens][kMaxState];
  const int slab = di * st;  // elements of one token
  const int f0 = blockIdx.x * kThreads * V;  // the CTA's first element of the slab
  const int d0 = f0 / st;
  const int rows = (min(f0 + kThreads * V, slab) - 1) / st + 1 - d0;
  const int f = f0 + threadIdx.x * V;  // this thread's chunk
  const bool live = f < slab;
  const int d = f / st, n = f - d * st;  // V divides st: the chunk is in one row
  float Ad[V];
#pragma unroll
  for (int k = 0; k < V; ++k) Ad[k] = live ? __ldg(A + f + k) : 0.f;

  for (long long t0 = static_cast<long long>(blockIdx.y) * kTokens; t0 < tokens;
       t0 += static_cast<long long>(gridDim.y) * kTokens) {
    const int nt = static_cast<int>(min(static_cast<long long>(kTokens), tokens - t0));
    __syncthreads();  // the previous group's tile is read
#pragma unroll 4
    for (int i = threadIdx.x; i < nt * rows; i += kThreads) {
      const int u = i / rows, r = i - u * rows;
      const long long o = (t0 + u) * di + d0 + r;
      const T dtt = dt[o];
      s_dt[u][r] = widen(dtt);
      s_p[u][r] = drive(dtt, x[o]);
    }
    for (int i = threadIdx.x; i < nt * st; i += kThreads)  // one contiguous run of Bm
      s_B[i / st][i % st] = widen(Bm[t0 * st + i]);
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int u = 0; u < nt; ++u) {
      const float dtv = s_dt[u][d - d0], pv = s_p[u][d - d0];
      float av[V], bv[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        av[k] = expf(__fmul_rn(dtv, Ad[k]));
        bv[k] = __fmul_rn(pv, s_B[u][n + k]);
      }
      const long long o = (t0 + u) * slab + f;
      store_lanes<V>(a + o, av);
      store_lanes<V>(b + o, bv);
    }
  }
}

template <typename T, int V>
int launch(const void* dt, const void* x, const void* Bm, const void* A, void* a, void* b,
           long long tokens, int di, int st, cudaStream_t stream) {
  const int chunks = di * st / V;
  const long long groups = (tokens + kTokens - 1) / kTokens;
  const dim3 grid((chunks + kThreads - 1) / kThreads,
                  static_cast<unsigned>(groups < kMaxGridY ? groups : kMaxGridY));
  mamba_stage_ab<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const float*>(A), static_cast<float*>(a), static_cast<float*>(b), tokens,
      di, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* dt, const void* x, const void* Bm, const void* A, void* a, void* b,
             long long tokens, int di, int st, cudaStream_t stream) {
  return st % 4 == 0 ? launch<T, 4>(dt, x, Bm, A, a, b, tokens, di, st, stream)
                     : launch<T, 1>(dt, x, Bm, A, a, b, tokens, di, st, stream);
}

}  // namespace

// Launches the kernel on `stream`; returns a CUDA error code (0 = launched).
// dt, x (B,S,di) and Bm (B,S,st) contiguous in bf16 (`bf16` != 0) or float32,
// A (di,st) float32, a and b (B,S,di,st) float32 and 16-byte aligned, all
// contiguous device tensors; tokens = B*S >= 1, di >= 1, 1 <= st <= 32,
// di*st <= 2^30.  The caller checks all of this.
extern "C" int mamba_stage_launch(const void* dt, const void* x, const void* Bm, const void* A,
                                  void* a, void* b, long long tokens, int di, int st, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(dt, x, Bm, A, a, b, tokens, di, st, s)
              : dispatch<float>(dt, x, Bm, A, a, b, tokens, di, st, s);
}
