// Forward flash attention on Hopper (sm_90a): online softmax over kv tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _flash_kernel (entry flash_attention, wrapper kernels/ops.py).  For q
// (B,Sq,H,hd) and k/v (B,Sk,KV,hd) it computes, per query row,
//   s = (q . k) * scale;  s = tanh(s / cap) * cap when cap > 0;
//   live keys: kpos < kv_len, and kpos <= qpos when causal, and
//              qpos - kpos < window when window > 0;
//   out = sum_live exp(s - m) v / max(sum_live exp(s - m), 1e-30)
// with the kv head of query head h being h / (H / KV) (GQA, MQA), running
// (m, l, acc) in float32 and the output in the input type.  A row with no
// live key gives 0, as the Pallas kernel does (kernels/ref.py's
// materialised softmax would give the mean of v there instead).  kv tiles
// wholly outside the causal, window or kv_len band are never loaded (the
// TPU kernel's pl.when skip); ragged Sq and Sk are masked here, so no input
// needs padding to a tile multiple.  Two instances, each for hd 64, 128
// and 256, both wgmma fed by TMA:
//
// bfloat16: flash_fwd_wgmma_bf16, on the tensor cores.
//   Bound.  At the serving prefill shape (B 4, S 1024, H 8, KV 1, hd 256,
//   causal) the function does 17.20 GFLOP of QK^T and PV and moves 37.7 MB,
//   so the least time is 17.39 us at the 989 TFLOP/s bf16 tensor-core rate
//   (operations bound; the bytes alone take 11.27 us).
//   Design.  One CTA of three warpgroups per (b*H + h, 128-row q tile), q
//   tiles issued longest-first:
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg 24)
//     and one thread issues TMA loads, which complete on mbarriers: the Q
//     tile once, then each 64-row K and V tile into a ring of stages (2 at
//     hd 256, 4 at 128, 8 at 64: shared memory enough that one CTA holds
//     an SM, as setmaxnreg's register budget needs) with full and empty
//     barriers, so loads run ahead of the math.  The tensor maps are 4-D over (hd, heads, S, B): the GQA kv
//     head is a coordinate, nothing is copied, and TMA fills rows past Sq
//     or Sk with zeros.  Tiles land in shared memory as bf16 with the
//     128-byte swizzle, in boxes of 64 columns (128 B).
//   * warpgroups 1 and 2 are consumers of 64 query rows each (setmaxnreg
//     240).  S = Q K^T is wgmma m64n64k16 with both operands in shared
//     memory (K-major); O += P V is wgmma m64n{hd}k16 with P in registers
//     and V read from shared memory transposed (MN-major), so nothing is
//     staged by hand.  The S accumulator fragment of a 16-bit wgmma has the
//     layout of its register A operand, so P is a pairwise cast.
//   * The softmax stays in registers: the 4 threads that share a row
//     reduce its max with two shuffles, l is summed per thread and reduced
//     once at the end, exp is ex2.approx with log2(e) folded into the
//     scale, and masks are applied only on tiles that cross the causal,
//     window, kv_len or ragged edge.
//   * The two consumers run independently, so one's softmax overlaps the
//     other's products.  No atomics and no split over kv: two launches on
//     the same input give the same bits.
//   What it does about the limits of the first, CUDA-core design: the products
//   run on the tensor cores, not the CUDA cores; tiles are bf16 fed by TMA
//   while the consumers compute, not float32 stored by every thread between
//   barriers; neither product reads its operands through the CUDA cores' shared
//   memory loads, and P never leaves registers; exp is one ex2.approx, not
//   the IEEE expf.
//   Numerics.  P is rounded to bf16 before the PV product, as in every
//   tensor-core flash kernel; the Pallas kernel multiplies float32 p by v
//   widened to float32.  l is summed from the float32 p.  The products
//   accumulate in float32.  This holds the 2e-2 bf16 tolerance of
//   tests/test_kernels.py:88 per call; through a small bf16 model, which
//   turns any one-ulp difference into larger logit moves, it moves more
//   logits past 2e-2 than the plain version run on the card does
//   (chip_smoke.py:smoke_card_vs_cpu).  tanh (softcap only) and the final
//   division by l are IEEE; the exponent is ex2.approx (2 ulp).
//
// float32: flash_fwd_wgmma_f32, split TF32 on the tensor cores.
//   Bound.  The same 17.20 GFLOP at the serving shape take 256.67 us on the
//   CUDA cores' 67 TFLOP/s.  wgmma's float32 product is TF32 (10 mantissa
//   bits, ~2^-11 relative per product), which alone cannot hold the 2e-5 of
//   tests/test_kernels.py:88.  Split TF32 (3xTF32) can: x = hi + lo with
//   hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact), and
//   a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in float32, leaves ~2^-21
//   relative per product, float32's order.  Three TF32 products at
//   495 TFLOP/s bound it at 3 x 17.20e9 / 495e12 = 104.2 us; the 75.4 MB of
//   float32 q, k, v and output take 22.5 us.  tf32 rounds to nearest, ties
//   away from zero (cvt.rna.tf32.f32), so every operand the tensor cores see
//   is exactly a TF32 value.
//   Design.  Two kernels on the caller's stream, no atomics, no split over
//   kv: two launches on the same input give the same bits.
//   * flash_kv_split_tf32, the prologue, writes K_hi, K_lo (B, Sk, KV, hd)
//     and V^T_hi, V^T_lo (B, KV, hd, Sk rounded up to 8) into scratch the
//     wrapper allocates.  tf32 wgmma takes no transposed operand, so both
//     shared-memory operands are K-major: for O += P V the keys are V's K
//     dimension, hence V^T.  Each group of 8 keys is stored as 0, 2, 4, 6,
//     1, 3, 5, 7: a thread's f32 score fragment holds columns 2t and 2t + 1
//     of each 8, the tf32 A fragment wants t and t + 4, and this order makes
//     the one the other (a0..a3 = d0, d2, d1, d3) with no shuffle.
//   * flash_fwd_wgmma_f32 is the bf16 instance's skeleton: one CTA per
//     (b*H + h, q tile), tiles issued longest-first, a producer warpgroup
//     whose one thread issues TMA loads (float32 boxes of 32 columns, 128 B,
//     the 128-byte swizzle) completing on mbarriers, and consumer
//     warpgroups of 64 query rows.  Q arrives once; each consumer splits its
//     rows in shared memory (Q_hi in place, Q_lo beside it), fences the
//     async proxy and syncs its warpgroup.  K and V^T stream through a ring
//     of 32 KB slots, each one chunk of a 64-key tile: 64 head-dim columns
//     of K (or rows of V^T), hi then lo; per tile hd/64 K chunks, then hd/64
//     V^T chunks.  Shared memory sets the shape: Q_hi + Q_lo take 512 B a
//     row per 64 head dims, so hd 64 and 128 run two consumers (128 rows)
//     with 5 and 3 slots, hd 256 one consumer (64 rows; 128 rows would need
//     256 KB for Q alone) with 3 slots; 225 KB in all.  With one consumer
//     no register budget has to move, so only two consumers use setmaxnreg.
//     hd 256's one consumer was chosen by measurement: two consumers there,
//     with Q_hi of 128 rows in shared memory and Q_lo's A fragments made in
//     registers from q read from L2 two k8 steps at a time
//     (benchmarks/flash_f32_hd256_two_consumers.patch), need more than the
//     240 registers setmaxnreg leaves a consumer (O alone takes 128, P's
//     split 64): ptxas spills and serialises the wgmmas (C7512), and a call
//     at the serving shape took 292-295 us of device time against this
//     layout's 206-209 us (benchmarks/bench_flash_f32.py, H100).
//   * S = Q K^T is wgmma m64n64k8 with both operands in shared memory,
//     three per k8 step (Q_lo K_hi, Q_hi K_lo, then Q_hi K_hi: the small
//     terms first, as CUTLASS's 3xTF32 takes them); O += P V is m64n64k8 per
//     64 output columns with P_hi and P_lo split in registers as the A
//     operand.  A chunk's slot is freed (one arrival per consumer warp) once
//     the next chunk's products are issued and its own have completed, so
//     the tensor pipe does not drain between chunks.
//   * The softmax is the bf16 instance's: registers only, ex2.approx with
//     log2(e) folded into the scale, masks only on edge tiles, l summed from
//     the float32 p, tanh and the final division IEEE.
//   Against the CUDA-core design it replaces (flash_fwd_simt_f32):
//   the products run on the tensor cores; tiles arrive by TMA while the
//   consumers compute instead of through every thread's loads between two
//   barriers; neither product reads operands with the CUDA cores' shared
//   memory loads; P stays in registers; exp is one ex2.approx.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// ------------------------------------------- bfloat16, tensor cores
namespace tc {

constexpr int kBQ = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 64;        // key rows per kv tile
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBox = 64;       // bf16 columns per TMA box: 128 B, the swizzle span
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 10000;  // + the CUresult of cuTensorMapEncodeTiled

template <int HD>
struct Layout {  // byte offsets from the 1024-aligned base of dynamic smem
  // K and V stages in the ring: enough to keep loads ahead of the products,
  // and enough shared memory in all that one CTA holds an SM, as setmaxnreg's
  // register budget needs (kernels/flash_attention.py:plan mirrors this).
  static constexpr int stages = HD == 256 ? 2 : HD == 128 ? 4 : 8;
  static constexpr int q_bytes = kBQ * HD * 2;
  static constexpr int kv_bytes = kBK * HD * 2;  // one K or V tile
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + stages * kv_bytes;
  static constexpr int bar_off = v_off + stages * kv_bytes;
  static constexpr int n_bars = 1 + 3 * stages;  // Q, full K, full V, empty
  static constexpr int bytes = 1024 + bar_off + 8 * n_bars;  // 1024: aligning the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = +0
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mbarriers in shared memory.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D (hd, heads, S, B) tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: start address, leading and stride byte offsets (in 16 B
// units, 14 bits each), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
struct Wgmma;  // N: the product's width (wgmma m64nNk16)

template <>
struct Wgmma<64> {
  // D(64x64, f32) (+)= A(64x16, smem, K-major) * B(64x16, smem, K-major)^T
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D(64x64, f32) += A(64x16, registers) * B(16x64, smem, MN-major: imm-trans-b 1)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // D(64x128, f32) += A(64x16, registers) * B(16x128, smem, MN-major: imm-trans-b 1)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  // D(64x256, f32) += A(64x16, registers) * B(16x256, smem, MN-major: imm-trans-b 1)
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_bf16(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Sq, int Sk,
    int H, int KV, int causal, int window, float cap, float scale, int kv_len) {
  using L = Layout<HD>;
  constexpr int ST = L::stages;
  constexpr int kTileBox = kBK * kBox * 2;  // bytes of one 64-column box of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t sq = base, sk = base + L::k_off, sv = base + L::v_off;
  const uint32_t bar_q = base + L::bar_off;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * ST, bar_empty = bar_v + 8 * ST;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal rows first

  // The kv tiles these rows can see: n_tiles from k_first, kBK keys each.
  const int k_live = min(kv_len, Sk);
  int k_end = k_live;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::q_bytes);
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c)
        tma_load(sq + c * kBQ * kBox * 2, &tm_q, bar_q, c * kBox, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(bar_empty + 8 * s, (t / ST - 1) & 1);  // both consumers done
        const int k0 = k_first + t * kBK;
        mbar_expect_tx(bar_k + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(sk + s * L::kv_bytes + c * kTileBox, &tm_k, bar_k + 8 * s, c * kBox, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(sv + s * L::kv_bytes + c * kTileBox, &tm_v, bar_v + 8 * s, c * kBox, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // which 64 rows of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int quad = lane & 3;  // the 4 threads of a row differ in quad
    const int r_lo = q0 + 64 * cw;  // this warpgroup's first row
    // Accumulator fragment of wgmma m64nN: element i of a thread lies in row
    // row + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + 2 * quad + (i & 1).
    const int row = r_lo + 16 * (tid >> 5) + (lane >> 2);
    const bool use_cap = cap > 0.f;
    const float s_log2 = __fmul_rn(scale, kLog2e);
    const float cap_log2 = __fmul_rn(cap, kLog2e);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};  // running max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the running sum

    // Q: 64 rows from r_lo, K-major, the 128B swizzle: 8-row groups 1024 B
    // apart; each k16 step is 32 B along a 128 B row, then the next box.
    const uint32_t q_rows = sq + cw * 64 * kBox * 2;
    mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      const uint32_t parity = (t / ST) & 1;
      const int k0 = k_first + t * kBK;
      const uint32_t k_tile = sk + s * L::kv_bytes;
      const uint32_t v_tile = sv + s * L::kv_bytes;

      // S = Q K^T (64 x 64, float32).
      float x[kBK / 2];
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
      fence_regs(x);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // k16 step inside a 128 B row
        const uint64_t da = sw128_desc(q_rows + (kk / 4) * kBQ * kBox * 2 + off, 16, 1024);
        const uint64_t db = sw128_desc(k_tile + (kk / 4) * kTileBox + off, 16, 1024);
        Wgmma<kBK>::ss(x, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);

      // Scale (then softcap), in log2 units.
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if (use_cap)
          x[i] = __fmul_rn(tanhf(__fdiv_rn(__fmul_rn(x[i], scale), cap)), cap_log2);
        else
          x[i] = __fmul_rn(x[i], s_log2);
      }
      // Masks, on tiles that cross an edge of this warpgroup's band only.
      const bool edge = k0 + kBK > k_live || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int qpos = row + 8 * ((i >> 1) & 1);
          bool ok = kpos < k_live;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x[i] = neg_inf();
        }
      }

      // Online softmax: rows row (e = 0) and row + 8 (e = 1).
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
      float r[2], base_e[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        base_e[e] = m_new == neg_inf() ? 0.f : m_new;  // a row with no live key yet
        r[e] = ex2(__fsub_rn(m[e], base_e[e]));
        m[e] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        x[i] = ex2(__fsub_rn(x[i], base_e[(i >> 1) & 1]));
        sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], x[i]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = __fadd_rn(__fmul_rn(l[e], r[e]), sum[e]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = __fmul_rn(acc[i], r[(i >> 1) & 1]);

      // P in bf16 as the register A operand: keys 16 kk .. 16 kk + 15.
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);

      // O += P V: V is MN-major (hd contiguous): 8-key groups 1024 B apart
      // (stride byte offset), 64-column boxes kTileBox apart (leading).
      mbar_wait(bar_v + 8 * s, parity);
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Wgmma<HD>::rs(acc, p[kk], sw128_desc(v_tile + kk * 16 * kBox * 2, kTileBox, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(bar_empty + 8 * s);  // this warpgroup is done with stage s
    }

    // out = acc / max(l, 1e-30), rows below Sq only.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] = __fadd_rn(l[e], __shfl_xor_sync(kFull, l[e], 1));
      l[e] = __fadd_rn(l[e], __shfl_xor_sync(kFull, l[e], 2));
      const float den = fmaxf(l[e], 1e-30f);
      const int qpos = row + 8 * e;
      if (qpos < Sq) {
        __nv_bfloat16* dst =
            o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD + 2 * quad;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(__fdiv_rn(acc[4 * j + 2 * e], den), __fdiv_rn(acc[4 * j + 2 * e + 1], den));
      }
    }
  }
}

// The 4-D tensor map over (hd, heads, S, B) of a contiguous bf16 tensor,
// in boxes of kBox columns x 1 head x `rows` positions, 128B-swizzled.
int encode(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads, 2ull * hd * heads * S};  // bytes
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past each edge
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, float cap, float scale, int kv_len,
           cudaStream_t stream) {
  static bool configured[kMaxDevices];  // one per instance: the smem attribute is set
  constexpr int smem = Layout<HD>::bytes;
  static_assert(smem <= 232448, "one CTA's shared memory on sm_90");
  static_assert(2 * (smem + 1024) > 233472, "two CTAs would share an SM's registers");
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = encode(&tm_q, q, HD, H, Sq, B, kBQ);
  if (rc) return rc;
  if (Sk > 0) {  // with no keys no kv tile is loaded: the maps stay unused
    if ((rc = encode(&tm_k, k, HD, KV, Sk, B, kBK))) return rc;
    if ((rc = encode(&tm_v, v, HD, KV, Sk, B, kBK))) return rc;
  } else {
    tm_k = tm_q;
    tm_v = tm_q;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma_bf16<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, causal, window, cap,
      scale, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------- float32, split TF32 on the tensor cores
namespace tf32 {

using tc::ex2;
using tc::fence_regs;
using tc::kConsumerRegs;
using tc::kEncodeFailed;
using tc::kProducerRegs;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::neg_inf;
using tc::smem_u32;
using tc::sw128_desc;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;

constexpr int kBK = 64;     // key rows per kv tile
constexpr int kChunk = 64;  // head-dim columns of a K chunk, head-dim rows of a V^T chunk
constexpr int kBox = 32;    // float32 columns per TMA box: 128 B, the swizzle span
constexpr int kBoxBytes = 64 * kBox * 4;   // a box of 64 rows: 8 KB
constexpr int kSlotBytes = 4 * kBoxBytes;  // a chunk: two boxes of hi, then two of lo
constexpr int kSplitThreads = 256;  // the prologue's block: 32 x 8

template <int HD>
struct Cfg {  // byte offsets from the 1024-aligned base of dynamic smem
  // hd 256 leaves room for the Q split of one consumer only.  Slots: as many
  // 32 KB chunks as the rest of a block's shared memory takes
  // (kernels/flash_attention.py:plan mirrors this).
  static constexpr int consumers = HD == 256 ? 1 : 2;
  static constexpr int bq = 64 * consumers;
  static constexpr int threads = 128 * (1 + consumers);
  static constexpr int slots = HD == 64 ? 5 : 3;
  static constexpr int chunks = HD / kChunk;  // K chunks, then as many V^T chunks, per tile
  static constexpr int q_bytes = bq * HD * 4;  // Q_hi; Q_lo follows it
  static constexpr int slot_off = 2 * q_bytes;
  static constexpr int bar_off = slot_off + slots * kSlotBytes;
  static constexpr int n_bars = 1 + 2 * slots;  // Q, then full and empty per slot
  static constexpr int bytes = 1024 + bar_off + 8 * n_bars;
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero;
// the low 13 bits are zero, so the tensor cores take the value exactly.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}

// Waits until at most one group of products is still running.
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// D(64x64, f32) (+)= A(64x8) * B(64x8)^T in TF32: both operands K-major
// (tf32 wgmma has no transposed form).
// A and B in shared memory:
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// A in registers (a0..a3: rows g and g + 8 of the warp's 16, columns t and
// t + 4, g = lane / 4, t = lane % 4), B in shared memory:
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The prologue: K_hi, K_lo (B, Sk, KV, hd) and V^T_hi, V^T_lo (B, KV, hd,
// Skp), Skp = Sk rounded up to 8, keys past Sk zero.  In V^T each group of 8
// keys is stored in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the score
// accumulator's fragment (columns 2t, 2t + 1 of each 8) is the A fragment
// (columns t, t + 4) of P V without a shuffle.  One block per (b, kv head)
// x 32 keys x 32 columns, transposed through shared memory.
__global__ void __launch_bounds__(kSplitThreads) flash_kv_split_tf32(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ khi,
    float* __restrict__ klo, float* __restrict__ vthi, float* __restrict__ vtlo, int Sk, int KV,
    int hd, int Skp) {
  __shared__ float tile[32][33];
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int key0 = blockIdx.y * 32;
  const int d0 = blockIdx.z * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    float x = 0.f;
    if (key0 + i < Sk) {
      const long long at = ((static_cast<long long>(b) * Sk + key0 + i) * KV + kvh) * hd + d0 + tx;
      const float kx = k[at];
      const float hi = tf32_rna(kx);
      khi[at] = hi;
      klo[at] = tf32_rna(kx - hi);  // kx - hi is exact
      x = v[at];
    }
    tile[i][tx] = x;
  }
  __syncthreads();
  if (key0 + tx >= Skp) return;
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);  // key stored at tx
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    const float x = tile[src][i];
    const float hi = tf32_rna(x);
    const long long at = ((static_cast<long long>(b) * KV + kvh) * hd + d0 + i) * Skp + key0 + tx;
    vthi[at] = hi;
    vtlo[at] = tf32_rna(x - hi);
  }
}

// Each warpgroup arrives once per slot it has consumed: lane 0 of each warp,
// after that warp's wait for the products that read the slot.
__device__ __forceinline__ void release(uint32_t bar_empty, int n, int slots, int lane) {
  if (lane == 0) mbar_arrive(bar_empty + 8 * (n % slots));
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::threads, 1) flash_fwd_wgmma_f32(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_khi,
    const __grid_constant__ CUtensorMap tm_klo, const __grid_constant__ CUtensorMap tm_vhi,
    const __grid_constant__ CUtensorMap tm_vlo, float* __restrict__ o, int Sq, int Sk, int H,
    int KV, int causal, int window, float cap, float scale, int kv_len) {
  using C = Cfg<HD>;
  constexpr int NS = C::slots;
  constexpr int NC = C::chunks;
  constexpr int BQ = C::bq;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's period
  const uint32_t q_hi = base, q_lo = base + C::q_bytes, slot0 = base + C::slot_off;
  const uint32_t bar_q = base + C::bar_off;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * NS;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first

  // The kv tiles these rows can see: n_tiles from k_first, kBK keys each.
  const int k_live = min(kv_len, Sk);
  int k_end = k_live;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq));
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * C::consumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    if constexpr (C::consumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::q_bytes);
#pragma unroll
      for (int g = 0; g < HD / kBox; ++g)
        tma_load(q_hi + g * BQ * kBox * 4, &tm_q, bar_q, g * kBox, h, q0, b);
      // Per kv tile NC chunks of K (64 head-dim columns of 64 keys), then NC
      // of V^T (64 head-dim rows of 64 keys), each as hi and lo, in a ring
      // of NS slots.
      int n = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = k_first + t * kBK;
        for (int part = 0; part < 2 * NC; ++part, ++n) {
          const int s = n % NS;
          if (n >= NS) mbar_wait(bar_empty + 8 * s, (n / NS - 1) & 1);  // its readers are done
          const uint32_t dst = slot0 + s * kSlotBytes, full = bar_full + 8 * s;
          mbar_expect_tx(full, kSlotBytes);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (part < NC) {
              const int col = part * kChunk + j * kBox;
              tma_load(dst + j * kBoxBytes, &tm_khi, full, col, kvh, k0, b);
              tma_load(dst + (2 + j) * kBoxBytes, &tm_klo, full, col, kvh, k0, b);
            } else {
              const int drow = (part - NC) * kChunk;
              tma_load(dst + j * kBoxBytes, &tm_vhi, full, k0 + j * kBox, drow, kvh, b);
              tma_load(dst + (2 + j) * kBoxBytes, &tm_vlo, full, k0 + j * kBox, drow, kvh, b);
            }
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    if constexpr (C::consumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // which 64 rows of the tile
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int quad = lane & 3;  // the 4 threads of a row differ in quad
    const int r_lo = q0 + 64 * cw;  // this warpgroup's first row
    // Accumulator fragment of wgmma m64n64: element i of a thread lies in row
    // row + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + 2 * quad + (i & 1).
    const int row = r_lo + 16 * (tid >> 5) + (lane >> 2);
    const bool use_cap = cap > 0.f;
    const float s_log2 = __fmul_rn(scale, tc::kLog2e);
    const float cap_log2 = __fmul_rn(cap, tc::kLog2e);

    // This warpgroup's 64 Q rows, as TMA wrote them (HD / 32 boxes of
    // 128 B rows, 8-row groups 1024 B apart), split in place: Q_hi where Q
    // was, Q_lo at the same offset after it.
    const uint32_t q_rows = cw * 64 * kBox * 4;
    mbar_wait(bar_q, 0);
#pragma unroll 4
    for (int i = tid; i < HD / kBox * 512; i += 128) {  // 16-byte pieces, 512 per box
      const uint32_t at = (i / 512) * BQ * kBox * 4 + q_rows + (i % 512) * 16;
      float4 x, hi, lo;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(q_hi + at));
      hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
      lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y), tf32_rna(x.z - hi.z),
                       tf32_rna(x.w - hi.w));
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(q_hi + at), "f"(hi.x),
                   "f"(hi.y), "f"(hi.z), "f"(hi.w) : "memory");
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(q_lo + at), "f"(lo.x),
                   "f"(lo.y), "f"(lo.z), "f"(lo.w) : "memory");
    }
    // The products read shared memory through the async proxy: make the
    // split visible to it, then wait for the whole warpgroup.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};  // running max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the running sum

    int n = 0;  // chunks consumed, in the producer's order
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_first + t * kBK;

      // S = Q K^T (64 x 64, float32) = Q_lo K_hi^T + Q_hi K_lo^T + Q_hi K_hi^T
      // per k8 step, the small terms first; a chunk's slot is released once
      // the next chunk's products are issued and its own have completed.
      float x[kBK / 2];
#pragma unroll
      for (int c = 0; c < NC; ++c, ++n) {
        const int s = n % NS;
        mbar_wait(bar_full + 8 * s, (n / NS) & 1);
        if (c == 0) {
          wgmma_fence();
          fence_regs(x);
        }
        const uint32_t kt = slot0 + s * kSlotBytes;
#pragma unroll
        for (int kk = 0; kk < kChunk / 8; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // k8 step inside a 128 B row
          const uint32_t qa = (2 * c + kk / 4) * BQ * kBox * 4 + q_rows + off;
          const uint64_t a_hi = sw128_desc(q_hi + qa, 16, 1024);
          const uint64_t a_lo = sw128_desc(q_lo + qa, 16, 1024);
          const uint64_t b_hi = sw128_desc(kt + (kk / 4) * kBoxBytes + off, 16, 1024);
          const uint64_t b_lo = sw128_desc(kt + (2 + kk / 4) * kBoxBytes + off, 16, 1024);
          mma_ss(x, a_lo, b_hi, c > 0 || kk > 0);
          mma_ss(x, a_hi, b_lo, 1);
          mma_ss(x, a_hi, b_hi, 1);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait_1();
          release(bar_empty, n - 1, NS, lane);
        }
      }
      wgmma_wait_all();
      fence_regs(x);
      release(bar_empty, n - 1, NS, lane);

      // Scale (then softcap), in log2 units.
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        if (use_cap)
          x[i] = __fmul_rn(tanhf(__fdiv_rn(__fmul_rn(x[i], scale), cap)), cap_log2);
        else
          x[i] = __fmul_rn(x[i], s_log2);
      }
      // Masks, on tiles that cross an edge of this warpgroup's band only.
      const bool edge = k0 + kBK > k_live || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const int qpos = row + 8 * ((i >> 1) & 1);
          bool ok = kpos < k_live;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) x[i] = neg_inf();
        }
      }

      // Online softmax: rows row (e = 0) and row + 8 (e = 1).
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
      float r[2], base_e[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        base_e[e] = m_new == neg_inf() ? 0.f : m_new;  // a row with no live key yet
        r[e] = ex2(__fsub_rn(m[e], base_e[e]));
        m[e] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        x[i] = ex2(__fsub_rn(x[i], base_e[(i >> 1) & 1]));
        sum[(i >> 1) & 1] = __fadd_rn(sum[(i >> 1) & 1], x[i]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = __fadd_rn(__fmul_rn(l[e], r[e]), sum[e]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = __fmul_rn(acc[c][i], r[(i >> 1) & 1]);

      // P split as the register A operand of k8 step j (keys 8 j .. 8 j + 7
      // in V^T's order 0, 2, 4, 6, 1, 3, 5, 7): x[4j], x[4j + 2], x[4j + 1], x[4j + 3].
      uint32_t p_hi[kBK / 8][4], p_lo[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float f[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hi = tf32_rna(f[e]);
          p_hi[j][e] = __float_as_uint(hi);
          p_lo[j][e] = __float_as_uint(tf32_rna(__fsub_rn(f[e], hi)));
        }
      }

      // O += P_lo V_hi + P_hi V_lo + P_hi V_hi, 64 output columns a chunk.
#pragma unroll
      for (int c = 0; c < NC; ++c, ++n) {
        const int s = n % NS;
        mbar_wait(bar_full + 8 * s, (n / NS) & 1);
        if (c == 0) {
          wgmma_fence();
#pragma unroll
          for (int c2 = 0; c2 < NC; ++c2) fence_regs(acc[c2]);
        }
        const uint32_t vt = slot0 + s * kSlotBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          const uint64_t b_hi = sw128_desc(vt + off, 16, 1024);
          const uint64_t b_lo = sw128_desc(vt + 2 * kBoxBytes + off, 16, 1024);
          mma_rs(acc[c], p_lo[kk], b_hi);
          mma_rs(acc[c], p_hi[kk], b_lo);
          mma_rs(acc[c], p_hi[kk], b_hi);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait_1();
          release(bar_empty, n - 1, NS, lane);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      release(bar_empty, n - 1, NS, lane);
    }

    // out = acc / max(l, 1e-30), rows below Sq only.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] = __fadd_rn(l[e], __shfl_xor_sync(kFull, l[e], 1));
      l[e] = __fadd_rn(l[e], __shfl_xor_sync(kFull, l[e], 2));
      const float den = fmaxf(l[e], 1e-30f);
      const int qpos = row + 8 * e;
      if (qpos < Sq) {
        float* dst = o + ((static_cast<long long>(b) * Sq + qpos) * H + h) * HD + 2 * quad;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j)
            *reinterpret_cast<float2*>(dst + kChunk * c + 8 * j) =
                make_float2(__fdiv_rn(acc[c][4 * j + 2 * e], den),
                            __fdiv_rn(acc[c][4 * j + 2 * e + 1], den));
      }
    }
  }
}

// The 4-D tensor map of a contiguous float32 tensor of extents `dims`
// (innermost first), in boxes of `box`, 128B-swizzled.
int encode(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
           const cuuint32_t (&box)[4]) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  const cuuint64_t strides[3] = {4 * dims[0], 4 * dims[0] * dims[1],
                                 4 * dims[0] * dims[1] * dims[2]};  // bytes
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                          strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past each edge
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, float* scratch, int B,
           int Sq, int Sk, int H, int KV, int causal, int window, float cap, float scale,
           int kv_len, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured[kMaxDevices];  // one per instance: the smem attribute is set
  static_assert(C::bytes <= 232448, "one CTA's shared memory on sm_90");
  static_assert(2 * (C::bytes + 1024) > 233472, "two CTAs would share an SM's registers");
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_f32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap tm_q, tm_khi, tm_klo, tm_vhi, tm_vlo;
  const cuuint64_t qh = static_cast<cuuint64_t>(HD);
  int rc = encode(&tm_q, q, {qh, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(Sq),
                             static_cast<cuuint64_t>(B)},
                  {kBox, 1, static_cast<cuuint32_t>(C::bq), 1});
  if (rc) return rc;
  if (Sk > 0) {  // with no keys no kv tile is loaded: the maps stay unused
    const int Skp = (Sk + 7) / 8 * 8;
    const long long nk = static_cast<long long>(B) * Sk * KV * HD;
    const long long nv = static_cast<long long>(B) * KV * HD * Skp;
    float* khi = scratch;
    float* klo = khi + nk;
    float* vthi = klo + nk;
    float* vtlo = vthi + nv;
    const dim3 split_grid(B * KV, (Skp + 31) / 32, HD / 32);
    flash_kv_split_tf32<<<split_grid, kSplitThreads, 0, stream>>>(k, v, khi, klo, vthi, vtlo,
                                                                  Sk, KV, HD, Skp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const cuuint64_t kdims[4] = {qh, static_cast<cuuint64_t>(KV), static_cast<cuuint64_t>(Sk),
                                 static_cast<cuuint64_t>(B)};
    const cuuint64_t vdims[4] = {static_cast<cuuint64_t>(Skp), qh, static_cast<cuuint64_t>(KV),
                                 static_cast<cuuint64_t>(B)};
    if ((rc = encode(&tm_khi, khi, kdims, {kBox, 1, kBK, 1}))) return rc;
    if ((rc = encode(&tm_klo, klo, kdims, {kBox, 1, kBK, 1}))) return rc;
    if ((rc = encode(&tm_vhi, vthi, vdims, {kBox, kChunk, 1, 1}))) return rc;
    if ((rc = encode(&tm_vlo, vtlo, vdims, {kBox, kChunk, 1, 1}))) return rc;
  } else {
    tm_khi = tm_klo = tm_vhi = tm_vlo = tm_q;
  }
  const dim3 grid(B * H, (Sq + C::bq - 1) / C::bq);
  flash_fwd_wgmma_f32<HD><<<grid, C::threads, C::bytes, stream>>>(
      tm_q, tm_khi, tm_klo, tm_vhi, tm_vlo, o, Sq, Sk, H, KV, causal, window, cap, scale,
      kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

}  // namespace

// Launches the kernel on `stream`; returns a CUDA error code (0 = launched),
// or 10000 + the CUresult where a tensor map could not be encoded.
// q (B,Sq,H,hd), k and v (B,Sk,KV,hd), o (B,Sq,H,hd): contiguous device
// tensors of one type, float32 (dtype 0) or bfloat16 (dtype 1), aligned to
// 16 bytes, with hd in {64, 128, 256} and H a multiple of KV.  In float32
// `scratch` holds 2 B Sk KV hd + 2 B KV hd Skp floats (Skp = Sk rounded up
// to 8; kernels/flash_attention.py:scratch_numel), which the prologue
// overwrites; bf16 takes none.  The caller checks all of this; B*H and Sq
// must be positive.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Sq, int Sk, int H, int KV,
                                      int head_dim, int dtype, int causal, int window,
                                      float cap, float scale, int kv_len, void* scratch,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    float* sc = static_cast<float*>(scratch);
    switch (head_dim) {
      case 64: return tf32::launch<64>(qf, kf, vf, of, sc, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
      case 128: return tf32::launch<128>(qf, kf, vf, of, sc, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
      case 256: return tf32::launch<256>(qf, kf, vf, of, sc, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 64: return tc::launch<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
      case 128: return tc::launch<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
      case 256: return tc::launch<256>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, cap, scale, kv_len, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
