// Chimbuko's AD hot loop on Hopper (sm_90a): per-function moments + labels.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moments.py:_moments_kernel
// (entry moments_and_labels).  For every event (fid, x) of one stream it
//   * labels the event against the PREVIOUS raw-sums table: 1 when the row
//     has n >= min_count and x lies outside mu +- alpha*sd, all in float32
//     with the reference's own formula (mu = s/n, var = q/n - mu*mu);
//   * folds the event into a per-function delta (n, sum x, sum x^2, min, max).
// Events whose fid - fid_offset lies outside [0, F) drop out like padding
// (fid -1); rows no event reached keep the +-1e30 sentinels.
//
// Bound on this card: bytes.  The function reads fids and durations
// (8 B/event), writes one int8 label per event, and reads and writes an
// (F,5) float32 table: about N*9 + 2*F*20 bytes over 3.35 TB/s, plus the
// launch floor of two kernels.  Its arithmetic (~20 float32 operations per
// event) is far below the 67 TFLOP/s float32 rate.
//
// Design.  The TPU kernel carries its (F,5) accumulator across a sequential
// grid and reduces with one-hot matmuls; neither carries over.  Here:
//   pass 1: num_partials CTAs each walk chunks c = blockIdx.x, +gridDim.x, ...
//     of block_events events, in 32-event slots, one warp per slot.  Each
//     lane labels its event (the table row gathered directly, no one-hot)
//     and __match_any_sync groups the slot's lanes by fid; the lowest lane
//     of a group sums the group in lane order.  Then one warp folds the
//     chunk's group sums into the CTA's shared (5,F) table slot by slot:
//     the groups of one slot have distinct fids, so no float atomics are
//     needed.  The CTA writes its table to partials[blockIdx.x].
//   pass 2: 32 fids x 16 slices of the partials per CTA; slice y folds
//     partials y, y+16, ... and the 16 slice sums fold in slice order.
// Every float sum is taken in a fixed order that depends only on N, F and
// block_events, so two launches on the same input give bitwise-equal deltas.
// Against the byte bound this design still pays the partials
// (num_partials*F*20 B written, then read) and one warp's serial fold per
// chunk; the bytes that must move are the events and two small tables.
#include <cuda_runtime.h>

namespace {

constexpr float kPos = 1e30f;
constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFoldFids = 32;    // pass 2: fids per CTA (threadIdx.x)
constexpr int kFoldSlices = 16;  // pass 2: partial slices per CTA (threadIdx.y)
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of pass 1, F*20 + block_events*24 + kWarps*128 bytes:
//   acc [5][F]       float  this CTA's (n, sum x, sum x^2, min, max)
//   gv  [5][eb]      float  group sums, at the group's lowest event
//   wx  [kWarps][32] float  each warp's staged slot durations
//   gl  [eb]         int    the fid of the group led by this event, or -1
__global__ void __launch_bounds__(kThreads) moments_pass1(
    const int* __restrict__ fids, const float* __restrict__ durs,
    const float* __restrict__ table_sums, signed char* __restrict__ labels,
    float* __restrict__ partials, long long n, int F, int fid_offset, int eb,
    int num_chunks, float alpha, float min_count) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* gv = acc + 5 * F;
  float* wx = gv + 5 * eb;
  int* gl = reinterpret_cast<int*>(wx + kWarps * 32);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slots = (eb + 31) / 32;

  for (int f = threadIdx.x; f < F; f += kThreads) {
    acc[f] = 0.f;
    acc[F + f] = 0.f;
    acc[2 * F + f] = 0.f;
    acc[3 * F + f] = kPos;
    acc[4 * F + f] = kNeg;
  }
  __syncthreads();

  for (int c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const long long base = static_cast<long long>(c) * eb;

    // Label each event against the previous table; sum each fid's group.
    for (int slot = warp; slot < slots; slot += kWarps) {  // warp-uniform
      const int i = slot * 32 + lane;
      const long long e = base + i;
      int f = -1;
      float x = 0.f;
      if (i < eb && e < n) {
        f = fids[e] - fid_offset;
        x = durs[e];
        if (f < 0 || f >= F) f = -1;
        signed char lab = 0;
        if (f >= 0) {
          const float* row = table_sums + static_cast<long long>(f) * 5;
          const float np = row[0];
          const float n_safe = fmaxf(np, 1.f);
          const float mu = np > 0.f ? __fdiv_rn(row[1], n_safe) : 0.f;
          float var = np > 1.f ? __fsub_rn(__fdiv_rn(row[2], n_safe), __fmul_rn(mu, mu)) : 0.f;
          var = fmaxf(var, 0.f);
          const float a_sd = __fmul_rn(alpha, __fsqrt_rn(var));
          const bool out = x > __fadd_rn(mu, a_sd) || x < __fsub_rn(mu, a_sd);
          lab = (out && np >= min_count) ? 1 : 0;
        }
        labels[e] = lab;
      }
      const unsigned same = __match_any_sync(kFull, f);
      wx[warp * 32 + lane] = x;
      __syncwarp();
      if (i < eb) {
        int lead = -1;
        if (f >= 0 && __ffs(same) - 1 == lane) {
          float s = 0.f, q = 0.f, mn = kPos, mx = kNeg;
          for (unsigned m = same; m; m &= m - 1) {
            const float xj = wx[warp * 32 + __ffs(m) - 1];
            s = __fadd_rn(s, xj);
            q = __fadd_rn(q, __fmul_rn(xj, xj));
            mn = fminf(mn, xj);
            mx = fmaxf(mx, xj);
          }
          gv[i] = static_cast<float>(__popc(same));
          gv[eb + i] = s;
          gv[2 * eb + i] = q;
          gv[3 * eb + i] = mn;
          gv[4 * eb + i] = mx;
          lead = f;
        }
        gl[i] = lead;
      }
      __syncwarp();  // wx is restaged by this warp's next slot
    }
    __syncthreads();

    // Fold the group sums into the CTA table, slot by slot.
    if (warp == 0) {
      for (int t = 0; t < slots; ++t) {
        const int i = t * 32 + lane;
        const int f = i < eb ? gl[i] : -1;
        if (f >= 0) {
          acc[f] = __fadd_rn(acc[f], gv[i]);
          acc[F + f] = __fadd_rn(acc[F + f], gv[eb + i]);
          acc[2 * F + f] = __fadd_rn(acc[2 * F + f], gv[2 * eb + i]);
          acc[3 * F + f] = fminf(acc[3 * F + f], gv[3 * eb + i]);
          acc[4 * F + f] = fmaxf(acc[4 * F + f], gv[4 * eb + i]);
        }
        __syncwarp();  // the next slot may update the same rows
      }
    }
    __syncthreads();
  }

  float* out = partials + static_cast<long long>(blockIdx.x) * 5 * F;
  for (int k = threadIdx.x; k < 5 * F; k += kThreads) out[k] = acc[k];
}

__global__ void __launch_bounds__(kFoldFids * kFoldSlices) moments_pass2(
    const float* __restrict__ partials, float* __restrict__ delta, int F,
    int num_partials) {
  __shared__ float red[5][kFoldSlices][kFoldFids];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int f = blockIdx.x * kFoldFids + tx;
  float v[5] = {0.f, 0.f, 0.f, kPos, kNeg};
  if (f < F) {
    for (int g = ty; g < num_partials; g += kFoldSlices) {
      const float* p = partials + static_cast<long long>(g) * 5 * F + f;
      v[0] = __fadd_rn(v[0], p[0]);
      v[1] = __fadd_rn(v[1], p[F]);
      v[2] = __fadd_rn(v[2], p[2 * F]);
      v[3] = fminf(v[3], p[3 * F]);
      v[4] = fmaxf(v[4], p[4 * F]);
    }
  }
  for (int k = 0; k < 5; ++k) red[k][ty][tx] = v[k];
  __syncthreads();
  if (ty != 0 || f >= F) return;
  for (int y = 1; y < kFoldSlices; ++y) {
    v[0] = __fadd_rn(v[0], red[0][y][tx]);
    v[1] = __fadd_rn(v[1], red[1][y][tx]);
    v[2] = __fadd_rn(v[2], red[2][y][tx]);
    v[3] = fminf(v[3], red[3][y][tx]);
    v[4] = fmaxf(v[4], red[4][y][tx]);
  }
  float* row = delta + static_cast<long long>(f) * 5;
  for (int k = 0; k < 5; ++k) row[k] = v[k];
}

constexpr int kMaxDevices = 64;
int configured_smem[kMaxDevices];  // pass 1's dynamic shared memory limit, per device

}  // namespace

// Launches both passes on `stream`; returns a CUDA error code (0 = launched).
// Pointers are device pointers: fids (n,) int32, durs (n,) float32,
// table_sums (F,5) float32, delta (F,5) float32 out, labels (n,) int8 out,
// partials (num_partials,5,F) float32 scratch.  The caller checks shapes and
// that F*20 + block_events*24 + 1024 bytes fit in a block's shared memory.
extern "C" int moments_and_labels_launch(
    const void* fids, const void* durs, const void* table_sums, void* delta,
    void* labels, void* partials, long long n, int num_funcs, int fid_offset,
    int block_events, int num_chunks, int num_partials, float alpha,
    float min_count, void* stream) {
  const int F = num_funcs;
  const int smem = F * 20 + block_events * 24 + kWarps * 32 * 4;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > configured_smem[device]) {
    err = cudaFuncSetAttribute(moments_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem[device] = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  moments_pass1<<<num_partials, kThreads, smem, s>>>(
      static_cast<const int*>(fids), static_cast<const float*>(durs),
      static_cast<const float*>(table_sums), static_cast<signed char*>(labels),
      static_cast<float*>(partials), n, F, fid_offset, block_events,
      num_chunks, alpha, min_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_pass2<<<(F + kFoldFids - 1) / kFoldFids, dim3(kFoldFids, kFoldSlices), 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(delta), F,
      num_partials);
  return static_cast<int>(cudaGetLastError());
}
