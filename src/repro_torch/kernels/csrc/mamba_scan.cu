// Mamba-1 selective scan on Hopper (sm_90a): the time recurrence with the
// state in registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py:_scan_kernel
// (entry mamba_scan, wrapper kernels/ops.py).  For a, b (B,S,di,st) and
// C (B,S,st), all float32 and contiguous, it computes from h_0 = 0
//   h_t = a_t * h_{t-1} + b_t            (elementwise over (di, st))
//   y_t[d] = sum_s h_t[d, s] * C_t[s]
// and writes y (B,S,di) and h_last = h_S (B,di,st), float32.
//
// Numerics: the product and the sum of the update round apart (__fmul_rn
// and __fadd_rn are never contracted into an FMA, whatever the flags), as
// the plain PyTorch version rounds them, so the two carry bitwise-equal
// states.  y's sum over st is a fixed xor butterfly over the state lanes,
// so two launches on the same input give bitwise-equal outputs.  No atomics.
//
// Bound on this card: bytes.  Each element of a and b is read once and feeds
// about 4 float operations.  At the serving prefill shape (B 4, S 1024,
// di 8192, st 16) the function moves 4.43 GB (a and b 4.29 GB, y 134 MB,
// h_last 2 MB, C 0.3 MB): 1.323 ms at 3.35 TB/s, while its 2.1 GFLOP take
// 32 us at the 67 TFLOP/s float32 rate.
//
// Design.  The TPU kernel keeps a (bd, st) state tile in VMEM across a
// sequential (B, di/bd, S/Lc) grid.  Here the time loop runs inside the
// thread:
//   * one thread owns one state element h[b, d, s] in a register for the
//     whole sequence.  A CTA of 256 threads covers 256/G channels x G state
//     lanes, G = st rounded up to a power of two (lanes s >= st are masked
//     and hold 0), and the grid is (ceil(di / (256/G)), B);
//   * for fixed (b, t) the CTA's loads of a and b are one contiguous run of
//     (256/G) * st floats, so a warp's loads coalesce; they are streamed
//     (__ldcs: each element is read once), C through the read-only path;
//   * the loads of the next kUnroll steps are issued before the current
//     kUnroll steps are computed (the registers are double-buffered), so the
//     dependent chain is the multiply-add, not the memory latency;
//   * y_t reduces over the G lanes with __shfl_xor_sync, and lane 0 writes it;
//   * ragged di and any S are masked here: no input needs padding.
// Against the byte bound this design still pays one strided 4-byte store of
// y per channel per step and the shuffles of the readout.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int G>
__global__ void __launch_bounds__(kThreads) mamba_scan_fwd(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ C, float* __restrict__ y, float* __restrict__ h_last,
    int S, int di, int st) {
  constexpr int kChannels = kThreads / G;
  const int lane = threadIdx.x % G;
  const int d = blockIdx.x * kChannels + threadIdx.x / G;
  const long long bb = blockIdx.y;
  const bool live = d < di && lane < st;  // this thread's state element exists
  const bool c_live = lane < st;
  const long long step = static_cast<long long>(di) * st;  // stride of t in a, b
  // Offsets of (bb, t = 0, d, lane) in a and b, (bb, 0, lane) in C, (bb, 0, d) in y.
  const long long ab0 = bb * S * step + static_cast<long long>(d) * st + lane;
  const long long c0 = bb * S * st + lane;
  const long long y0 = bb * S * di + d;

  float ra[kUnroll], rb[kUnroll], rc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = u < S;
    ra[u] = ok && live ? __ldcs(a + ab0 + u * step) : 0.f;
    rb[u] = ok && live ? __ldcs(b + ab0 + u * step) : 0.f;
    rc[u] = ok && c_live ? __ldg(C + c0 + static_cast<long long>(u) * st) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float na[kUnroll], nb[kUnroll], nc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next kUnroll steps, in flight
      const int t = t0 + kUnroll + u;
      const bool ok = t < S;
      na[u] = ok && live ? __ldcs(a + ab0 + t * step) : 0.f;
      nb[u] = ok && live ? __ldcs(b + ab0 + t * step) : 0.f;
      nc[u] = ok && c_live ? __ldg(C + c0 + static_cast<long long>(t) * st) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {  // uniform over the CTA: every lane reaches the shuffles
        h = __fadd_rn(__fmul_rn(ra[u], h), rb[u]);
        float v = __fmul_rn(h, rc[u]);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
        if (lane == 0 && d < di) y[y0 + static_cast<long long>(t) * di] = v;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = na[u];
      rb[u] = nb[u];
      rc[u] = nc[u];
    }
  }
  if (live) h_last[(bb * di + d) * st + lane] = h;
}

template <int G>
int launch(const void* a, const void* b, const void* C, void* y, void* h_last, int B,
           int S, int di, int st, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  mamba_scan_fwd<G><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(h_last),
      S, di, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns a CUDA error code (0 = launched).
// a and b (B,S,di,st), C (B,S,st), y (B,S,di), h_last (B,di,st): contiguous
// float32 device tensors, with 1 <= st <= 32, 1 <= B <= 65535, di >= 1 and
// S >= 0.  The caller checks all of this.
extern "C" int mamba_scan_launch(const void* a, const void* b, const void* C, void* y,
                                 void* h_last, int B, int S, int di, int st,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (st <= 1) return launch<1>(a, b, C, y, h_last, B, S, di, st, s);
  if (st <= 2) return launch<2>(a, b, C, y, h_last, B, S, di, st, s);
  if (st <= 4) return launch<4>(a, b, C, y, h_last, B, S, di, st, s);
  if (st <= 8) return launch<8>(a, b, C, y, h_last, B, S, di, st, s);
  if (st <= 16) return launch<16>(a, b, C, y, h_last, B, S, di, st, s);
  if (st <= 32) return launch<32>(a, b, C, y, h_last, B, S, di, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
