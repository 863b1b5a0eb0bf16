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
// (F,5) float32 table: about N*9 + 2*F*20 bytes over 3.35 TB/s, plus one
// kernel's launch floor.  Its arithmetic (~20 float32 operations per event)
// is far below the 67 TFLOP/s float32 rate.
//
// Design: one launch.  The TPU kernel carries its (F,5) accumulator across a
// sequential grid and reduces with one-hot matmuls; neither carries over.
// The grid is fixed: C CTAs of 256 threads, C a multiple of the cluster size
// 8 and at most 128, set by N and block_events alone (moments.py:grid), never
// by the card's SM count.  Each CTA holds a whole (5,F) table in shared
// memory, so F is limited as before.
//   1. CTA b walks chunks c = b, b + C, ... of block_events events, in steps
//      of at most 512 events, two per lane.  The next step's table rows are
//      gathered, and the events of the step after are fetched, while a step
//      runs.  Each lane labels its events (the row read directly, no
//      one-hot) and ranks each among the step's events of its owner warp:
//      warp w owns rows [w << shift, (w + 1) << shift).
//   2. The 8 warps scan the per-(slot, owner) counts, and each event goes to
//      its owner's list in event order.  Each warp then folds its own list
//      into the CTA's table 32 events at a time: the events of one row in a
//      batch (found by ballots over the row's bits) are summed in list
//      order by the earliest, which alone writes the row; a batch of a
//      single row is summed by a fixed shuffle tree.  No two lanes write one
//      row, and no float atomics are used.
//   3. After a cluster barrier, CTA r of a cluster folds rows
//      [r*F/8, (r+1)*F/8) of the 8 peers' tables in rank order, reading them
//      through distributed shared memory, into the cluster's partial: C/8
//      partials (16 at F 2048, 655 KB) instead of one per CTA.  It arrives
//      on the cluster barrier after its reads and waits on it only before it
//      exits, so its peers' tables outlive their readers.
//   4. An integer ticket per rank (atom.add.acq_rel.gpu, after the CTA's
//      partial rows) finds the last CTA of rank r over all clusters.  It
//      folds those rows of the C/8 partials in cluster order into delta and
//      returns the ticket to 0.  So the final fold is spread over 8 CTAs,
//      and no CTA waits on another cluster.
// The tickets only choose who folds.  Each row's sums are taken in an order
// fixed by the input and N, F and block_events, so two launches on the same
// input give bitwise-equal deltas.
//
// What holds it back on the H100 (PERF.md): with one CTA of 8 warps per
// SM a 512-event step is bound by latency and instruction rate, not bytes;
// the cluster fold reads 40 KB per CTA through distributed shared memory;
// the ticket is a round trip to L2; and a few SMs hold two CTAs, because at
// one CTA per SM the card's GPCs hold fewer clusters of 8 than the largest
// grid has.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kPos = 1e30f;
constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;  // CTAs per cluster: the portable maximum
constexpr int kMaxCtas = 128;
constexpr int kMaxClusters = kMaxCtas / kCluster;
constexpr int kSlots = 2 * kWarps;  // 32-event slots per step: two a warp, 512 events
// Rows lie in [0, F) and F*20 bytes fit in a block's shared memory, so
// F < 11600 < 2^14.
constexpr int kRowBits = 14;
constexpr int kPeerBatch = 4;  // elements per thread whose 8 peer values are in flight at once
constexpr int kPartBatch = 2;  // elements per thread whose partials are in flight at once
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* fids;
  const float* durs;
  const float* table_sums;  // (F,5) previous raw sums
  signed char* labels;      // (n,)
  float* delta;             // (F,5) out
  float* partials;          // (C/8,5,F) one per cluster
  int* tickets;             // (8,) one per cluster rank, 0 between launches
  long long n;
  int F;
  int fid_offset;
  int eb;  // events per chunk
  int num_chunks;
  int steps;  // 512-event steps per chunk
  float alpha;
  float min_count;
};

// Column k of (n, sum x, sum x^2, min, max) folds b into a.
__device__ __forceinline__ float fold(int k, float a, float b) {
  return k < 3 ? __fadd_rn(a, b) : (k == 3 ? fminf(a, b) : fmaxf(a, b));
}

// v[0] folded with v[1], ..., v[n-1] along column k, with the column's
// operation chosen once for the run.
template <int kN>
__device__ __forceinline__ float fold_run(int k, const float (&v)[kN], int n) {
  float s = v[0];
  if (k < 3) {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n) s = __fadd_rn(s, v[g]);
  } else if (k == 3) {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n) s = fminf(s, v[g]);
  } else {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n) s = fmaxf(s, v[g]);
  }
  return s;
}

template <int kN>
__device__ __forceinline__ float4 fold_run(int k, const float4 (&v)[kN], int n) {
  float4 s = v[0];
  if (k < 3) {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n)
        s = make_float4(__fadd_rn(s.x, v[g].x), __fadd_rn(s.y, v[g].y), __fadd_rn(s.z, v[g].z),
                        __fadd_rn(s.w, v[g].w));
  } else if (k == 3) {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n)
        s = make_float4(fminf(s.x, v[g].x), fminf(s.y, v[g].y), fminf(s.z, v[g].z),
                        fminf(s.w, v[g].w));
  } else {
#pragma unroll
    for (int g = 1; g < kN; ++g)
      if (g < n)
        s = make_float4(fmaxf(s.x, v[g].x), fmaxf(s.y, v[g].y), fmaxf(s.z, v[g].z),
                        fmaxf(s.w, v[g].w));
  }
  return s;
}

// Relaxed: it only says that this CTA reads its peers' tables no more (the
// values it loaded are already used), so it orders no memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Takes a ticket: the count before this one.  Release orders the CTA's
// partial (written before the __syncthreads that precedes it) before the
// ticket; acquire lets the last taker read every other CTA's partial.
__device__ __forceinline__ int take_ticket(int* ticket) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(ticket) : "memory");
  return before;
}

// The lanes whose value equals this lane's (values below 2^kBits), as
// __match_any_sync gives them, from one ballot per bit, all in flight at once
// (a bit no lane sets costs one ballot and changes nothing): MATCH.ANY
// takes a pass per distinct value, which is most of 32 at F 2048.
template <int kBits>
__device__ __forceinline__ unsigned same_value(unsigned u) {
  unsigned ones[kBits];
#pragma unroll
  for (int b = 0; b < kBits; ++b) ones[b] = __ballot_sync(kFull, (u >> b) & 1);
  unsigned same = kFull;
#pragma unroll
  for (int b = 0; b < kBits; ++b) same &= ((u >> b) & 1) ? ones[b] : ~ones[b];
  return same;
}

// The address in CTA `rank` of this cluster of a shared-memory location of
// this CTA, and loads through it (distributed shared memory).
__device__ __forceinline__ unsigned peer_addr(const void* own, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(own))), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_peer(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_peer4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Event j (0, 1) of this lane in step s of a chunk: its index in the chunk.
__device__ __forceinline__ int event_in_chunk(int s, int warp, int j, int lane) {
  return s * kSlots * 32 + (warp + j * kWarps) * 32 + lane;
}

// Whether event i of chunk c exists.
__device__ __forceinline__ bool live(const Args& a, int c, int i) {
  return c < a.num_chunks && i < a.eb && static_cast<long long>(c) * a.eb + i < a.n;
}

// The step after (c, s) in this CTA's order: the chunk's next 512 events, or
// the first of its next chunk.
__device__ __forceinline__ void next_step(const Args& a, int c, int s, int& c2, int& s2) {
  c2 = s + 1 < a.steps ? c : c + static_cast<int>(gridDim.x);
  s2 = s + 1 < a.steps ? s + 1 : 0;
}

// This lane's two events of step s of chunk c, -1/0 where none.
__device__ __forceinline__ void fetch(const Args& a, int c, int s, int warp, int lane,
                                      int (&f)[2], float (&x)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = event_in_chunk(s, warp, j, lane);
    f[j] = -1;
    x[j] = 0.f;
    if (live(a, c, i)) {
      const long long e = static_cast<long long>(c) * a.eb + i;
      f[j] = __ldg(a.fids + e);
      x[j] = __ldg(a.durs + e);
    }
  }
}

// A lane's two events of one step in registers: each one's shard-local row
// (-1 where it has none: padding, outside the block, or no event), its
// duration, and the row's previous (n, sum x, sum x^2).
struct Held {
  int row[2];
  float x[2], np[2], rs[2], rq[2];
};

// The rows of step s's fetched events (f, x), with their table gathers
// started: in flight until the step is labelled.
__device__ __forceinline__ void gather(const Args& a, int c, int s, int warp, int lane,
                                       const int (&f)[2], const float (&x)[2], Held& h) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool is = live(a, c, event_in_chunk(s, warp, j, lane));
    const int r = f[j] - a.fid_offset;
    h.row[j] = is && r >= 0 && r < a.F ? r : -1;
    h.x[j] = is ? x[j] : 0.f;
    h.np[j] = h.rs[j] = h.rq[j] = 0.f;
    if (h.row[j] >= 0) {
      const float* t = a.table_sums + static_cast<long long>(h.row[j]) * 5;
      h.np[j] = __ldg(t);
      h.rs[j] = __ldg(t + 1);
      h.rq[j] = __ldg(t + 2);
    }
  }
}

// The label of x against a previous row (np, s, q) = (n, sum x, sum x^2).
__device__ __forceinline__ signed char label_of(const Args& a, float np, float s, float q,
                                                float x) {
  const float n_safe = fmaxf(np, 1.f);
  const float mu = np > 0.f ? __fdiv_rn(s, n_safe) : 0.f;
  float var = np > 1.f ? __fsub_rn(__fdiv_rn(q, n_safe), __fmul_rn(mu, mu)) : 0.f;
  var = fmaxf(var, 0.f);
  const float a_sd = __fmul_rn(a.alpha, __fsqrt_rn(var));
  const bool out = x > __fadd_rn(mu, a_sd) || x < __fsub_rn(mu, a_sd);
  return (out && np >= a.min_count) ? 1 : 0;
}

// The owner warp (0-7, or kWarps for none) of each lane: the lanes of this
// lane's owner, and in lanes 0-7 how many lanes owner `lane` has.
__device__ __forceinline__ unsigned owner_lanes(int owner, int lane, int& count) {
  const unsigned b0 = __ballot_sync(kFull, owner & 1), b1 = __ballot_sync(kFull, owner & 2),
                 b2 = __ballot_sync(kFull, owner & 4), b3 = __ballot_sync(kFull, owner & 8);
  count = __popc((lane & 1 ? b0 : ~b0) & (lane & 2 ? b1 : ~b1) & (lane & 4 ? b2 : ~b2) & ~b3);
  return (owner & 1 ? b0 : ~b0) & (owner & 2 ? b1 : ~b1) & (owner & 4 ? b2 : ~b2) &
         (owner & 8 ? b3 : ~b3);
}

// Dynamic shared memory, F*20 + eb*24 + kWarps*128 bytes (the layout of the
// earlier two-pass kernel, so the F limit is unchanged):
//   acc [5][F]       float  this CTA's (n, sum x, sum x^2, min, max)
//   gv  [5][eb]      float  a step's durations listed by owner warp (the
//                           first min(eb, 512) floats are used)
//   wx  [kWarps][32] int    each warp's slots' counts by owner, then a flag
//   gl  [eb]         int    the row of each listed event
// At most 128 registers a thread, so that two CTAs fit an SM: at one CTA
// per SM the H100's GPCs hold fewer than the 16 clusters of the largest
// grid (cudaOccupancyMaxActiveClusters), which then runs in two waves.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
    moments_cluster(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int F = a.F, eb = a.eb;
  float* acc = smem;
  float* gv = acc + 5 * F;
  float* wx = gv + 5 * eb;
  int* gl = reinterpret_cast<int*>(wx + kWarps * 32);
  int* counts = reinterpret_cast<int*>(wx);  // [warp][j][owner]: slot warp + 8j
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* wxi = counts + warp * 32;  // this warp's part of wx
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int shift = 0;  // warp w owns rows [w << shift, (w + 1) << shift)
  while ((F - 1) >> shift >= kWarps) ++shift;

  // Steps (c, s), (c1, s1), (c2, s2) in this CTA's order: the rows of the
  // next step are gathered, and the events of the one after are fetched,
  // while this one runs.
  int c = blockIdx.x, s = 0, c1, s1;
  next_step(a, c, s, c1, s1);
  int nf[2];
  float nx[2];
  Held h, hn;
  fetch(a, c, s, warp, lane, nf, nx);  // in flight while the table is set
  for (int f = threadIdx.x; f < F; f += kThreads) {
    acc[f] = 0.f;
    acc[F + f] = 0.f;
    acc[2 * F + f] = 0.f;
    acc[3 * F + f] = kPos;
    acc[4 * F + f] = kNeg;
  }
  gather(a, c, s, warp, lane, nf, nx, h);
  fetch(a, c1, s1, warp, lane, nf, nx);
  __syncthreads();

  while (c < a.num_chunks) {
    const long long base = static_cast<long long>(c) * eb;
    int c2, s2;
    next_step(a, c1, s1, c2, s2);
    gather(a, c1, s1, warp, lane, nf, nx, hn);
    fetch(a, c2, s2, warp, lane, nf, nx);

    // Label each event against the previous table, and rank it among the
    // step's events of its owner warp, the warp whose rows hold it.
    int owner[2], ranked[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = event_in_chunk(s, warp, j, lane);
      if (live(a, c, i))
        a.labels[base + i] = h.row[j] >= 0 ? label_of(a, h.np[j], h.rs[j], h.rq[j], h.x[j]) : 0;
      owner[j] = h.row[j] >= 0 ? h.row[j] >> shift : kWarps;
      int count;
      ranked[j] = __popc(owner_lanes(owner[j], lane, count) & ((1u << lane) - 1));
      if (lane < kWarps) wxi[j * kWarps + lane] = count;
    }
    __syncthreads();

    // Every warp scans the step's counts, owner-major then slot order (entry
    // o*16 + t, t = w + 8j at counts[w*32 + j*8 + o]): lane L holds entries
    // 4L..4L+3.  Each event then goes to its owner's list, in event order.
    int pre[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * lane + e, o = idx / kSlots, t = idx % kSlots;
      pre[e] = sum;
      sum += counts[(t % kWarps) * 32 + (t / kWarps) * kWarps + o];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    const int excl = incl - sum;
#pragma unroll
    for (int e = 0; e < 4; ++e) pre[e] += excl;
    const int total = __shfl_sync(kFull, incl, 31);
    const int start = __shfl_sync(kFull, pre[0], 4 * warp);  // entry warp*16 + 0
    const int end = warp + 1 < kWarps ? __shfl_sync(kFull, pre[0], (4 * warp + 4) & 31) : total;
    const int q = warp & 3;  // entries o*16 + t of this warp's slots t sit at t % 4 == warp % 4
    const int mine = q == 0 ? pre[0] : q == 1 ? pre[1] : q == 2 ? pre[2] : pre[3];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = warp + j * kWarps;
      const int o = owner[j] < kWarps ? owner[j] : 0;
      const int at = __shfl_sync(kFull, mine, o * 4 + t / 4) + ranked[j];
      if (owner[j] < kWarps) {
        gl[at] = h.row[j];
        gv[at] = h.x[j];
      }
    }
    __syncthreads();

    // Each warp folds its list into its own rows, 32 events at a time, in
    // list order.  A batch of one row is summed by a fixed shuffle tree;
    // otherwise the events of one row are summed in list order by the
    // earliest (the leader), which alone writes the row.
    for (int b0 = start; b0 < end; b0 += 32) {  // warp-uniform
      const int e = b0 + lane;
      const bool in = e < end;
      const int f = in ? gl[e] : 0;
      const float x = in ? gv[e] : 0.f;
      const unsigned active = __ballot_sync(kFull, in);
      const unsigned low = (1u << shift) - 1;  // the bits that tell a warp's rows apart
      const unsigned same = same_value<kRowBits>(static_cast<unsigned>(f) & low) & active;
      if (__all_sync(kFull, !in || same == active)) {
        float v[5] = {in ? 1.f : 0.f, x, __fmul_rn(x, x), in ? x : kPos, in ? x : kNeg};
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
          for (int k = 0; k < 5; ++k) v[k] = fold(k, v[k], __shfl_down_sync(kFull, v[k], d));
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 5; ++k) acc[k * F + f] = fold(k, acc[k * F + f], v[k]);
        }
      } else if (in && __ffs(same) - 1 == lane) {
        float sx = x, sq = __fmul_rn(x, x), mn = x, mx = x;
        for (unsigned m = same & (same - 1); m; m &= m - 1) {
          const float xs = gv[b0 + __ffs(m) - 1];
          sx = __fadd_rn(sx, xs);
          sq = __fadd_rn(sq, __fmul_rn(xs, xs));
          mn = fminf(mn, xs);
          mx = fmaxf(mx, xs);
        }
        const float r0 = acc[f], r1 = acc[F + f], r2 = acc[2 * F + f], r3 = acc[3 * F + f],
                    r4 = acc[4 * F + f];
        acc[f] = __fadd_rn(r0, static_cast<float>(__popc(same)));
        acc[F + f] = __fadd_rn(r1, sx);
        acc[2 * F + f] = __fadd_rn(r2, sq);
        acc[3 * F + f] = fminf(r3, mn);
        acc[4 * F + f] = fmaxf(r4, mx);
      }
      __syncwarp();  // the next batch may update a row of this one
    }
    __syncthreads();
    h = hn;
    c = c1;
    s = s1;
    c1 = c2;
    s1 = s2;
  }

  // Fold this CTA's rows of the cluster's 8 tables, in rank order, into the
  // cluster's partial.  Where F is a multiple of 32, every rank's rows start
  // and end on a multiple of 4, so the loads are 16 bytes wide.
  cluster.sync();  // every peer's table is complete
  const int r0 = rank * F / kCluster;
  const int rows = (rank + 1) * F / kCluster - r0;
  const int total = 5 * rows;
  const int num_clusters = gridDim.x / kCluster;
  const bool wide = (F & 31) == 0;
  float* part = a.partials + static_cast<long long>(blockIdx.x / kCluster) * 5 * F;
  unsigned peer[kCluster];  // acc in each CTA of the cluster
#pragma unroll
  for (int q = 0; q < kCluster; ++q) peer[q] = peer_addr(acc, q);
  if (wide) {
    for (int j = 4 * threadIdx.x; j < total; j += 4 * kThreads) {
      const int k = j / rows;
      const int at = k * F + r0 + (j - k * rows);
      float4 v[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) v[q] = ld_peer4(peer[q] + 4 * at);
      *reinterpret_cast<float4*>(part + at) = fold_run(k, v, kCluster);
    }
  } else {
    for (int j0 = threadIdx.x; j0 < total; j0 += kPeerBatch * kThreads) {
      float v[kPeerBatch][kCluster];
#pragma unroll
      for (int b = 0; b < kPeerBatch; ++b) {
        const int j = j0 + b * kThreads;
        if (j < total) {
          const int k = j / rows;
          const int at = k * F + r0 + (j - k * rows);
#pragma unroll
          for (int q = 0; q < kCluster; ++q) v[b][q] = ld_peer(peer[q] + 4 * at);
        }
      }
#pragma unroll
      for (int b = 0; b < kPeerBatch; ++b) {
        const int j = j0 + b * kThreads;
        if (j < total) {
          const int k = j / rows;
          part[k * F + r0 + (j - k * rows)] = fold_run(k, v[b], kCluster);
        }
      }
    }
  }
  cluster_arrive();  // done with the peers' tables; each waits for this before it exits

  // The last CTA of this rank, over all clusters, folds the partials of its
  // rows in cluster order into delta.  Thread 0's acquire, passed on by the
  // __syncthreads, lets every thread's plain loads see the other CTAs'
  // partials (the acquire also drops this SM's L1 lines).
  int* last = reinterpret_cast<int*>(wx);  // wx is free once the chunks are done
  __syncthreads();  // this CTA's rows of the partial are written
  if (threadIdx.x == 0) {
    int* ticket = a.tickets + rank;
    *last = take_ticket(ticket) == num_clusters - 1;
    if (*last) *ticket = 0;  // every CTA of this rank has taken its ticket
  }
  __syncthreads();
  if (*last && wide) {
    for (int j = 4 * threadIdx.x; j < total; j += 4 * kThreads) {
      const int k = j / rows;
      const int f = r0 + (j - k * rows);
      const float4* p = reinterpret_cast<const float4*>(a.partials + k * F + f);
      float4 v[kMaxClusters];
#pragma unroll
      for (int g = 0; g < kMaxClusters; ++g)
        v[g] = g < num_clusters ? p[static_cast<long long>(g) * 5 * F / 4]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 s = fold_run(k, v, num_clusters);
      float* d = a.delta + static_cast<long long>(f) * 5 + k;
      d[0] = s.x;
      d[5] = s.y;
      d[10] = s.z;
      d[15] = s.w;
    }
  } else if (*last) {
    for (int j0 = threadIdx.x; j0 < total; j0 += kPartBatch * kThreads) {
      float v[kPartBatch][kMaxClusters];
#pragma unroll
      for (int b = 0; b < kPartBatch; ++b) {
        const int j = j0 + b * kThreads;
        if (j < total) {
          const int k = j / rows;
          const float* p = a.partials + k * F + r0 + (j - k * rows);
#pragma unroll
          for (int g = 0; g < kMaxClusters; ++g)
            v[b][g] = g < num_clusters ? p[static_cast<long long>(g) * 5 * F] : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < kPartBatch; ++b) {
        const int j = j0 + b * kThreads;
        if (j < total) {
          const int k = j / rows;
          const int f = r0 + (j - k * rows);
          a.delta[static_cast<long long>(f) * 5 + k] = fold_run(k, v[b], num_clusters);
        }
      }
    }
  }
  cluster_wait();  // the peers are done with this CTA's table
}

// The launch floor of moments_cluster's geometry: the same clusters and
// threads, no work.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    moments_launch_floor() {}

constexpr int kMaxDevices = 64;
int configured_smem[kMaxDevices];  // dynamic shared memory limit set, per device

}  // namespace

// Launches moments_cluster once on `stream`; returns a CUDA error code
// (0 = launched).  Pointers are device pointers: fids (n,) int32, durs (n,)
// float32, table_sums (F,5) float32, delta (F,5) float32 out, labels (n,) int8
// out, partials (num_ctas/8,5,F) float32 scratch, tickets 8 int32 that are
// 0 and are left 0.  num_ctas is a multiple of 8 of at most 128.  The caller
// checks shapes and that F*20 + block_events*24 + 1024 bytes fit in a block's
// shared memory, and gives each stream its own partials and tickets.
extern "C" int moments_and_labels_launch(
    const void* fids, const void* durs, const void* table_sums, void* delta,
    void* labels, void* partials, void* tickets, long long n, int num_funcs, int fid_offset,
    int block_events, int num_chunks, int num_ctas, float alpha, float min_count,
    void* stream) {
  if (num_ctas < kCluster || num_ctas > kMaxCtas || num_ctas % kCluster ||
      num_funcs >= (1 << kRowBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = num_funcs * 20 + block_events * 24 + kWarps * 32 * 4;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > configured_smem[device]) {
    err = cudaFuncSetAttribute(moments_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem[device] = smem;
  }
  const Args a{static_cast<const int*>(fids), static_cast<const float*>(durs),
               static_cast<const float*>(table_sums), static_cast<signed char*>(labels),
               static_cast<float*>(delta), static_cast<float*>(partials),
               static_cast<int*>(tickets), n, num_funcs, fid_offset, block_events,
               num_chunks, (block_events + kSlots * 32 - 1) / (kSlots * 32), alpha, min_count};
  moments_cluster<<<num_ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches the empty moments_launch_floor on `stream` with num_ctas CTAs (a
// multiple of 8): what any launch of this geometry costs.
extern "C" int moments_launch_floor_launch(int num_ctas, void* stream) {
  if (num_ctas < kCluster || num_ctas % kCluster) return static_cast<int>(cudaErrorInvalidValue);
  moments_launch_floor<<<num_ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
