// Blockwise (flash) attention forward for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the TPU kernel of the JAX package:
//   mxnet_tpu/parallel/attention.py  _flash_fwd_kernel (:48), launched by
//   _flash_forward (:92) behind attention(..., impl="flash").
//
// Contract (the same as flash_forward_plain in
// mxnet_tpu_torch/parallel/attention.py):
//   q    (B, Tq, H, D)   float32, bfloat16 or float16, D <= 256
//   k, v (B, Tk, H, D)   the same dtype as q
//   o    (B, Tq, H, D)   the same dtype as q
// Each tensor is read and written through its own (batch, seq, head)
// strides in elements; the head_dim axis is contiguous. So the public
// (B, T, H, D) layout is used as it is, without the reference's three
// transposes into (B*H, T, D).
//   s = (q . k) * scale, accumulated in float32, masked to -1e30 where
//       causal and k_pos > q_pos (the TPU kernel's top-left alignment;
//       the XLA reference aligns bottom-right, so the two differ when
//       Tq != Tk -- the port copies both); keys past Tk weigh 0;
//   per key tile of block_k keys, in increasing key order: m_new = max(m,
//       max s), p = exp(s - m_new), l = l exp(m - m_new) + sum p (the
//       unrounded float32 p), o = o exp(m - m_new) + p' v, where p' is p
//       rounded to v's dtype (the TPU kernel's p.astype(v.dtype));
//   out = o / l, cast to q's dtype once.
// exp(d) is 2^(d log2 e) by ex2.approx, with d = s - m formed first as
// the plain version forms it (so the prescale rounds d, whatever the
// size of s and m, and does not move p's rounding to v's dtype except
// where p lies within a few float32 ulps of a boundary). On an H100 it
// measured the same error against the plain version as expf, in less
// time (PERF.md).
//
// The key tile is the caller's block_k where that is 64 or 128, so p is
// rounded against the running max over the same blocks as in the JAX
// package; any other block_k runs in 64-key tiles (the wrapper maps a
// block_k that covers all of Tk <= 128 to the tile that does too), and
// its bf16/f16 rounding of p then follows 64-key blocks. In float32 p is
// not rounded, and the tile changes only the order of the sums; the one
// float32 instance that would not fit shared memory with 128-key tiles
// (D = 256) runs 64-key tiles.
//
// Design (FlashAttention-2's split, on the tensor cores). One block owns
// one (batch*head, tile of query rows) pair and loops over the key tiles
// itself (the TPU kernel's sequential grid axis and its fori_loop become
// this loop); each warp owns 16 query rows. A block has 8 warps (128
// rows) for 128-key tiles up to D = 64 and 4 (64 rows) otherwise: at D =
// 64 that measured best for each tile (PERF.md). bf16/f16 at D = 64, the
// transformer's and the long-context path's head_dim, run both products
// as wgmma (a warpgroup of 4 warps, 64 rows, at a time); every other
// instance runs mma.sync. The two share the staging, the fragments'
// layout (a warpgroup's wgmma accumulator holds each warp's 16 rows as
// mma.sync's does) and the softmax.
//   1. Staging. The Q tile and each K and V tile (block_k x D) come in
//      by cp.async 16-byte copies into shared memory, double buffered
//      where two stages fit in 116 KB (two blocks an SM): the copies of
//      tile j+1 are issued before tile j is computed, so they overlap its
//      arithmetic (one barrier a tile). Where two stages do not fit
//      (bf16/f16 with 128-key tiles from D = 128 and D = 256; float32
//      with 128-key tiles from D = 64 and D >= 128), one stage: the block
//      waits for its copies while the SM's other blocks compute. Rows are
//      chunks of 16 bytes stored under an XOR swizzle (chunk ^ row mod
//      8), so every ldmatrix (8 rows of one chunk) and every float32 V
//      read of a warp is free of bank conflicts. Past Tk and past D the
//      tiles hold zeros (cp.async with a source size of 0). A head_dim
//      that is not a multiple of 16 bytes, or a row whose address or
//      stride is not, loads element by element into the same zero-padded
//      tile.
//   2. S = Q K^T on the tensor cores, accumulated in float32 fragments:
//      bf16/f16 at D = 64 by wgmma.m64n{64,128}k16 reading Q and K from
//      shared memory (descriptors of the 128-byte swizzle, which is the
//      tile layout above at 128-byte rows; each tile 1024-byte aligned;
//      fence.proxy.async after the copies land); other bf16/f16 by
//      mma.sync.m16n8k16 on ldmatrix fragments of Q and K.
//      float32 by 3xTF32: each operand x is split into hi (x with the low
//      13 mantissa bits cleared) and lo (x - hi, exact, cleared the same
//      way), and hi.hi + hi.lo + lo.hi is summed by
//      mma.sync.m16n8k8.tf32; the dropped lo.lo and the clearing of lo
//      leave a relative error below 2^-20 a product, float32 level, where
//      one TF32 pass keeps 11 bits. The split is two masks and a
//      subtraction on the ALU: cvt.rna.tf32 ran on the conversion unit at
//      a fraction of that rate and made the splits the float32 kernel's
//      limit (PERF.md). ldmatrix moves 32-bit words as pairs of b16, so
//      the same fragments serve both types.
//   3. The online softmax runs on the accumulator fragments in registers:
//      a thread holds 2 rows x (block_k / 4) keys; the row max is reduced
//      over the quad of threads sharing the rows by __shfl_xor_sync; l is
//      kept as per-thread partial sums (the quad shares exp(m - m_new))
//      and reduced once at the end. The mask runs only on tiles that
//      cross the diagonal or Tk, in a pass of its own, so the unrolled
//      mma and softmax loops have no branch inside (a guard a 16-key step
//      measured slower than the work it skipped).
//   4. O += P V. P never leaves registers: the S fragments of two
//      adjacent n-tiles are the A operand of the PV product (bf16/f16:
//      rounded to v's dtype and packed in pairs, the register A of
//      wgmma.m64n64k16 at D = 64, with V read from shared memory as a
//      transposed B, or of mma.sync with V by ldmatrix.trans; float32:
//      split like any operand, with the keys of each 8-key step taken in
//      the order 0, 2, 4, 6, 1, 3, 5, 7, so the accumulator layout is the
//      A layout, and V read by 32-bit loads in that same order). wgmma's
//      register operands are held in place (an empty asm on each) from
//      before its fence to after its wait.
//   5. Epilogue: o / l is cast to q's dtype into the warp's own rows of
//      the Q tile, then stored by 16-byte coalesced stores.
// With causal, a block stops at the last key its last row can see; the
// tiles past it would add exactly 0 (exp(-1e30 - m) is 0; key 0 is
// visible to every row, so m is finite). Causal tiles are launched
// longest first (the grid's y index counts down from the last query
// tile). head_dim is a template parameter (16, 32, 64, 128, 256; a
// head_dim in between runs in the next one up, zero-padded) so every
// fragment array unrolls into registers. The 8-warp bf16/f16 instances
// are held to 128 registers, so two blocks share an SM. Shared memory:
// (rows + 2 x
// stages x block_k) x D elements: 80 KB for bf16 at D = 64 and block_k =
// 128. Registers, spills and shared memory of every instance are in
// chip_smoke.py's phase 8 log; the D = 256 instances spill.
//
// Bound. Per (batch, head) the kernel must read Q, K, V and write O once,
// (2 Tq + 2 Tk) D elements, and do 4 D flops per (query, key) pair the
// mask keeps (2 for QK^T, 2 for PV). At the transformer's shape (B 8, T
// 2048, H 8, D 64, causal) that is 3.4e10 flops against 67 MB in bf16:
// 0.035 ms at the dense bf16 tensor-core rate (989 TFLOP/s) and 0.020 ms
// at the HBM rate, so bf16 is bound by operations. float32 is bound by
// the same 3.4e10 flops at the card's tensor-core rate for float32
// operands (TF32, 495 TFLOP/s): 0.069 ms, above the 0.040 ms of its 134
// MB. The 3xTF32 route does 3 products for each, so it cannot come below
// 0.21 ms, three times that bound. What the design does about it: the
// products run on the tensor cores from conflict-free shared memory, P
// stays in registers, and the next tile's copies overlap this tile's
// arithmetic. What it leaves: in each
// warpgroup the softmax waits for QK^T and PV waits for the softmax
// (only other warpgroups overlap them), the softmax's ALU work is as
// large as the products' tensor-core time at D = 64, and every thread
// also issues the copies (TMA with a producer warp and two warpgroups
// taking turns, FlashAttention-3's shape, is the next step); mma.sync,
// where wgmma does not run, reaches a part of wgmma's rate from 16 rows a
// warp; and, in float32, the splits.
//
// Build: one library a dtype, so the three build in parallel:
//        nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -split-compile=0 -DMX_FLASH_DTYPE=<0
//        float32, 1 bfloat16, 2 float16> (mxnet_tpu_torch/kernels.py does
//        this at first use and keeps ptxas's report beside each library).
// flash_attention_forward returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a shape, head_dim or key tile it does not
// take; flash_attention_instance reports the instance a call would
// launch, and flash_attention_whole_chunks whether its tensors stage by
// cp.async (1) or element by element (0).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTwoStageBytes = 116 * 1024;  // two blocks an SM
constexpr int kMaxSmemBytes = 227 * 1024;

// Warps a block (16 query rows each): 8 for 128-key tiles up to D = 64,
// 4 otherwise (measured at D = 64; PERF.md)
template <int kD, int kTileK>
__host__ __device__ constexpr int n_warps() {
  return kTileK == 128 && kD <= 64 ? 8 : 4;
}

// ----------------------------------------------------------- conversions
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// two floats rounded to T and packed (the lower column in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 r = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// x = hi + lo + r, hi and lo TF32 (x and x - hi with the low 13
// mantissa bits cleared; x - hi is exact), |r| < 2^-21 |x|. Masks, not
// cvt.rna.tf32: the conversion unit's rate made the splits the float32
// kernel's limit (PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// exp(d) for d = s - m <= 0: 2^(d log2 e) by ex2.approx (2 ulp). d is
// formed as the plain version forms it, so the prescale scales its one
// rounding by log2 e, whatever the magnitude of s and m.
__device__ __forceinline__ float exp_d(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(d * kLog2e));
  return r;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros when !fill (source size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on a 16x8x16 tile (bf16 or f16 inputs, float32 sums)
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on a 16x8x8 tile of TF32 inputs
__device__ __forceinline__ void mma1688(float (&d)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t b0hi, uint32_t b1hi,
                                           uint32_t b0lo, uint32_t b1lo) {
  mma1688(d, alo, b0hi, b1hi);
  mma1688(d, ahi, b0lo, b1lo);
  mma1688(d, ahi, b0hi, b1hi);
}

// ---------------------------------------------------------------- wgmma
// A warpgroup's (4 warps, 64 rows) product on shared-memory tiles of
// 128-byte rows under the 128-byte swizzle (chunk ^ row mod 8: the tile
// layout above at D = 64 in bf16/f16, each tile 1024-byte aligned).
// Descriptor: start address, leading offset 1 (unused by the swizzled
// layouts here), stride 1024 bytes between 8-row groups, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers that an in-flight wgmma reads or writes where they are
template <int R, int C, typename X>
__device__ __forceinline__ void pin(X (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if constexpr (std::is_same<X, float>::value)
        asm volatile("" : "+f"(x[i][j])::"memory");
      else
        asm volatile("" : "+r"(x[i][j])::"memory");
    }
}
// make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, the warp's 16 rows as mma.sync fragments) += A B, A (64 x 16)
// and B (16 x N) K-major in shared memory
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a,
                                         uint64_t b);
// d += A B, A from registers (the mma.sync m16n8k16 A fragment of the
// warp's 16 rows), B (16 x N) N-major in shared memory (transposed)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(float (&d)[8][4],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 128>(float (&d)[16][4],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 64>(float (&d)[8][4],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 128>(float (&d)[16][4],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half, 64>(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------- tiles
struct Strides {
  int64_t b, t, h;  // in elements; the head_dim stride is 1
};

// Offset, in 16-byte chunks, of chunk c of row r in a tile of kC chunks a
// row: the chunk's slot within its 128-byte line is XORed with the row
// (mod 8), or for rows shorter than a line with the line's index, so 8
// rows at one chunk fall in 8 distinct bank groups.
template <int kC>
__device__ __forceinline__ int swz(int r, int c) {
  const int i = r * kC + c;
  const int key = kC >= 8 ? (r & 7) : ((i >> 3) & 7);
  return (i & ~7) | ((i ^ key) & 7);
}

// Stage rows t0 .. t0 + kRows - 1 of one (batch, head) slice into a tile
// of kC 16-byte chunks a row: zeros past n_t rows and past D elements.
// vec: every chunk of a row lies inside D or wholly past it, and every
// row start is 16-byte aligned, so cp.async copies whole chunks;
// otherwise element by element.
template <typename T, int kRows, int kC, int kThreads>
__device__ __forceinline__ void load_tile(const T* base, int64_t stride_t,
                                          int t0, int n_t, int D, bool vec,
                                          char* tile, int tid) {
  constexpr int kEpc = 16 / sizeof(T);
  constexpr int kChunks = kRows * kC;
  const int n_chunks = (D + kEpc - 1) / kEpc;
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int idx = it * kThreads + tid;
    if (kChunks % kThreads == 0 || idx < kChunks) {
      const int r = idx / kC;
      const int c = idx - r * kC;
      const int t = t0 + r;
      char* dst = tile + swz<kC>(r, c) * 16;
      const T* src = base + static_cast<int64_t>(t) * stride_t + c * kEpc;
      if (vec) {
        const bool in = t < n_t && c < n_chunks;
        cp_async16(smem_u32(dst), in ? src : base, in);
      } else {
        alignas(16) T vals[kEpc];
#pragma unroll
        for (int e = 0; e < kEpc; ++e)
          vals[e] = (t < n_t && c * kEpc + e < D) ? src[e] : from_float<T>(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
      }
    }
  }
}

// bf16/f16 at D = 64, whose 128-byte rows are wgmma's 128-byte-swizzle
// layout as they stand, run both products as wgmma
template <typename T, int kD>
__host__ __device__ constexpr bool uses_wgmma() {
  return sizeof(T) == 2 && kD == 64;
}

// the tiles, and 1024 bytes to align them for wgmma
template <typename T, int kD, int kTileK>
constexpr int smem_bytes(int stages) {
  return (16 * n_warps<kD, kTileK>() + 2 * stages * kTileK) * kD *
             static_cast<int>(sizeof(T)) +
         (uses_wgmma<T, kD>() ? 1024 : 0);
}

template <typename T, int kD, int kTileK>
constexpr int n_stages() {
  return smem_bytes<T, kD, kTileK>(2) <= kTwoStageBytes ? 2 : 1;
}

// ---------------------------------------------------------------- kernel
// Blocks an SM the register allocation must allow: two for the 8-warp
// bf16/f16 instances (at most 128 registers: faster than one block at
// D = 64 on an H100), one otherwise (float32 held to 128 registers
// spills and was slower; PERF.md).
template <typename T, int kD, int kTileK>
__host__ __device__ constexpr int min_blocks() {
  return n_warps<kD, kTileK>() == 8 && sizeof(T) == 2 ? 2 : 1;
}

template <typename T, int kD, int kTileK, int kStages>
__global__ void __launch_bounds__(32 * n_warps<kD, kTileK>(),
                                  min_blocks<T, kD, kTileK>())
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int H, int Tq,
                     int Tk, int D, float scale, int causal, int vec) {
  constexpr int kThreads = 32 * n_warps<kD, kTileK>();
  constexpr int kTileQ = 16 * n_warps<kD, kTileK>();
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kEpc = 16 / sizeof(T);       // elements a 16-byte chunk
  constexpr int kC = kD / kEpc;              // chunks a row
  constexpr int kNT = kTileK / 8;            // 8-key n-tiles of S
  constexpr int kDT = kD / 8;                // 8-column n-tiles of O
  constexpr int kQBytes = kTileQ * kC * 16;
  constexpr int kKVBytes = kTileK * kC * 16;
  static_assert(kC % 2 == 0, "a k-step is two chunks");
  constexpr bool kWgmma = uses_wgmma<T, kD>();
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw;
  if constexpr (kWgmma)
    smem += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  char* q_s = smem;
  char* k_s = smem + kQBytes;                // kStages K tiles
  char* v_s = k_s + kStages * kKVBytes;      // kStages V tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int q0 = qt * kTileQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // the fragment row (and row + 8)
  const int tq4 = lane & 3;   // the fragment column pair
  const int row0 = warp * 16;
  const int qpos0 = q0 + row0 + g;
  const int qpos1 = qpos0 + 8;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // keys this tile needs: all, or (causal) up to its last row's position
  int k_end = Tk;
  if (causal) k_end = min(Tk, min(q0 + kTileQ, Tq));
  const int n_kt = (k_end + kTileK - 1) / kTileK;

  load_tile<T, kTileQ, kC, kThreads>(qb, sq.t, q0, Tq, D, vec, q_s, tid);
  load_tile<T, kTileK, kC, kThreads>(kb, sk.t, 0, Tk, D, vec, k_s, tid);
  load_tile<T, kTileK, kC, kThreads>(vb, sv.t, 0, Tk, D, vec, v_s, tid);
  cp_async_commit();

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's partial row sums

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTileK;
    if constexpr (kStages == 2) {
      cp_async_wait_all();
      if constexpr (kWgmma) fence_proxy_async();
      __syncthreads();  // tile j has landed; tile j - 1 is consumed
      if (j + 1 < n_kt) {
        const int nxt = (j + 1) & 1;
        load_tile<T, kTileK, kC, kThreads>(kb, sk.t, k0 + kTileK, Tk, D,
                                           vec, k_s + nxt * kKVBytes, tid);
        load_tile<T, kTileK, kC, kThreads>(vb, sv.t, k0 + kTileK, Tk, D,
                                           vec, v_s + nxt * kKVBytes, tid);
      }
      cp_async_commit();
    } else {
      if (j > 0) {
        __syncthreads();  // tile j - 1 is consumed
        load_tile<T, kTileK, kC, kThreads>(kb, sk.t, k0, Tk, D, vec, k_s,
                                           tid);
        load_tile<T, kTileK, kC, kThreads>(vb, sv.t, k0, Tk, D, vec, v_s,
                                           tid);
        cp_async_commit();
      }
      cp_async_wait_all();
      if constexpr (kWgmma) fence_proxy_async();
      __syncthreads();
    }
    const char* ks = k_s + (kStages == 2 ? (j & 1) : 0) * kKVBytes;
    const char* vs = v_s + (kStages == 2 ? (j & 1) : 0) * kKVBytes;

    // S = Q K^T
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    if constexpr (kWgmma) {
      // the warpgroup's 64 rows of Q against the tile's keys, 16 of D a step
      const char* qw = q_s + (warp >> 2) * 64 * kC * 16;
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 2; ++kk)
        wgmma_ss<T, kTileK>(s, wgmma_desc(qw + 32 * kk),
                            wgmma_desc(ks + 32 * kk));
      wgmma_commit_wait();
      pin(s);
    } else {
#pragma unroll
      for (int kk = 0; kk < kC / 2; ++kk) {
        uint32_t a[4];
        const int qr = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_u32(q_s + swz<kC>(qr, 2 * kk + (lane >> 4)) * 16), a);
        uint32_t ahi[4], alo[4];
        if constexpr (kF32) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(__uint_as_float(a[e]), ahi[e], alo[e]);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(smem_u32(ks + swz<kC>(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                        2 * kk + ((lane >> 3) & 1)) * 16),
                  bk);
          if constexpr (kF32) {
            uint32_t bhi[4], blo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split(__uint_as_float(bk[e]), bhi[e], blo[e]);
            mma_3xtf32(s[2 * np], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
            mma_3xtf32(s[2 * np + 1], ahi, alo, bhi[2], bhi[3], blo[2],
                       blo[3]);
          } else {
            mma16816<T>(s[2 * np], a, bk[0], bk[1]);
            mma16816<T>(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }
      }
    }

    // scale, mask, online softmax on the fragments: element e of n-tile
    // i is row (e < 2 ? g : g + 8), key k0 + 8 i + 2 tq4 + (e & 1)
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= scale;
    // the mask, on the tiles that cross the diagonal or Tk only (one
    // branch a tile, so the unrolled loops above and below stay whole)
    if ((causal && k0 + kTileK - 1 > q0 + row0) || k0 + kTileK > Tk) {
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * tq4 + (e & 1);
          if (causal && kpos > (e < 2 ? qpos0 : qpos1)) s[i][e] = kNegInf;
          if (kpos >= Tk) s[i][e] = -INFINITY;  // outside the sequence
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp_d(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_d(s[i][e] - m[e >> 1]);
        l[e >> 1] += p;  // the unrounded p
        s[i][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V, P from the S fragments
    if constexpr (kWgmma) {
      // all of P packed first: wgmma reads its registers until the wait
      uint32_t pa[kNT / 2][4];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        pa[np][0] = pack2<T>(s[2 * np][0], s[2 * np][1]);
        pa[np][1] = pack2<T>(s[2 * np][2], s[2 * np][3]);
        pa[np][2] = pack2<T>(s[2 * np + 1][0], s[2 * np + 1][1]);
        pa[np][3] = pack2<T>(s[2 * np + 1][2], s[2 * np + 1][3]);
      }
      pin(acc);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)  // 16 keys: two 8-row groups
        wgmma_rs<T, kD>(acc, pa[np], wgmma_desc(vs + np * 16 * kC * 16));
      wgmma_commit_wait();
      pin(acc);
      pin(pa);
    } else {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if constexpr (kF32) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 2 * np + half;
            // A columns (t, t + 4) hold keys (2t, 2t + 1) of this 8-key step
            uint32_t ahi[4], alo[4];
            split(s[i][0], ahi[0], alo[0]);
            split(s[i][2], ahi[1], alo[1]);
            split(s[i][1], ahi[2], alo[2]);
            split(s[i][3], ahi[3], alo[3]);
            const int key = 8 * i + 2 * tq4;
#pragma unroll
            for (int dn = 0; dn < kDT; ++dn) {
              const int d = dn * 8 + g;
              const float v0 = *reinterpret_cast<const float*>(
                  vs + swz<kC>(key, d >> 2) * 16 + (d & 3) * 4);
              const float v1 = *reinterpret_cast<const float*>(
                  vs + swz<kC>(key + 1, d >> 2) * 16 + (d & 3) * 4);
              uint32_t b0hi, b0lo, b1hi, b1lo;
              split(v0, b0hi, b0lo);
              split(v1, b1hi, b1lo);
              mma_3xtf32(acc[dn], ahi, alo, b0hi, b1hi, b0lo, b1lo);
            }
          }
        } else {
          uint32_t a[4];
          a[0] = pack2<T>(s[2 * np][0], s[2 * np][1]);
          a[1] = pack2<T>(s[2 * np][2], s[2 * np][3]);
          a[2] = pack2<T>(s[2 * np + 1][0], s[2 * np + 1][1]);
          a[3] = pack2<T>(s[2 * np + 1][2], s[2 * np + 1][3]);
#pragma unroll
          for (int dp = 0; dp < kDT / 2; ++dp) {
            uint32_t bv[4];
            ldsm_x4_trans(
                smem_u32(vs + swz<kC>(np * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      2 * dp + (lane >> 4)) * 16),
                bv);
            mma16816<T>(acc[2 * dp], a, bv[0], bv[1]);
            mma16816<T>(acc[2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
  }

  // o / l, cast to q's dtype, through the warp's own rows of the Q tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncwarp();
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn) {
    const int col = dn * 8 + 2 * tq4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      char* dst = q_s + swz<kC>(row0 + g + 8 * r, col / kEpc) * 16 +
                  (col % kEpc) * sizeof(T);
      const float x0 = acc[dn][2 * r] / l[r];
      const float x1 = acc[dn][2 * r + 1] / l[r];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack2<T>(x0, x1);
      }
    }
  }
  __syncwarp();
  T* ob = o + b * so.b + h * so.h;
  const int n_chunks = (D + kEpc - 1) / kEpc;
#pragma unroll
  for (int idx = lane; idx < 16 * kC; idx += 32) {
    const int r = idx / kC;
    const int c = idx - r * kC;
    const int t = q0 + row0 + r;
    if (t >= Tq || c >= n_chunks) continue;
    const char* src = q_s + swz<kC>(row0 + r, c) * 16;
    T* dst = ob + static_cast<int64_t>(t) * so.t + c * kEpc;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const T* vals = reinterpret_cast<const T*>(src);
#pragma unroll
      for (int e = 0; e < kEpc; ++e)
        if (c * kEpc + e < D) dst[e] = vals[e];
    }
  }
}

// ------------------------------------------------------------------ host
template <typename T, int kD, int kTileK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int Tq, int Tk, int D, float scale, int causal,
                   int vec, cudaStream_t stream) {
  constexpr int kStages = n_stages<T, kD, kTileK>();
  constexpr int bytes = smem_bytes<T, kD, kTileK>(kStages);
  static_assert(bytes <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_fwd_kernel<T, kD, kTileK, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = n_warps<kD, kTileK>();
  const dim3 grid(B * H, (Tq + 16 * kWarps - 1) / (16 * kWarps));
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, Tq,
      Tk, D, scale, causal, vec);
  return cudaGetLastError();
}

// The instance a call takes: head_dim rounded up to 16, 32, 64, 128 or
// 256; the key tile (64 or 128); its stages and shared memory.
struct Instance {
  int d, tile_k, stages, smem, warps;
};

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<kD>, Int<kTileK>) for the instance of (D, tile_k); float32 at
// D = 256 keeps 64-key tiles (128 would not fit shared memory)
template <typename T, typename F>
auto with_instance(int D, int tile_k, F f) {
  auto tile = [&](auto dc) {
    constexpr int kD = decltype(dc)::value;
    if constexpr (smem_bytes<T, kD, 128>(1) <= kMaxSmemBytes) {
      if (tile_k == 128) return f(dc, Int<128>{});
    }
    return f(dc, Int<64>{});
  };
  if (D <= 16) return tile(Int<16>{});
  if (D <= 32) return tile(Int<32>{});
  if (D <= 64) return tile(Int<64>{});
  if (D <= 128) return tile(Int<128>{});
  return tile(Int<256>{});
}

template <typename T>
Instance instance_of(int D, int tile_k) {
  return with_instance<T>(D, tile_k, [](auto dc, auto kc) {
    constexpr int kD = decltype(dc)::value;
    constexpr int kTileK = decltype(kc)::value;
    constexpr int kStages = n_stages<T, kD, kTileK>();
    return Instance{kD, kTileK, kStages, smem_bytes<T, kD, kTileK>(kStages),
                    n_warps<kD, kTileK>()};
  });
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                     int H, int Tq, int Tk, int D, float scale, int causal,
                     int tile_k, int vec, cudaStream_t stream) {
  return with_instance<T>(D, tile_k, [&](auto dc, auto kc) {
    return launch<T, decltype(dc)::value, decltype(kc)::value>(
        q, k, v, o, sq, sk, sv, so, B, H, Tq, Tk, D, scale, causal, vec,
        stream);
  });
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether q, k, v and o load and store as whole 16-byte chunks (cp.async
// staging): D and every stride a multiple of the chunk, every base
// address aligned. Otherwise rows go element by element.
template <typename T>
bool whole_chunks(const void* q, const void* k, const void* v,
                  const void* o, const int64_t* strides, int D) {
  constexpr int kSize = sizeof(T);
  bool vec = (D * kSize) % 16 == 0 && aligned16(q) && aligned16(k) &&
             aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && (strides[i] * kSize) % 16 == 0;
  return vec;
}

// The library's entry points for dtype T. Strides are (batch, seq, head)
// in elements for q, k, v and o in that order (12 values). tile_k is the
// key tile, 64 or 128 (the wrapper maps the caller's block_k onto it).
template <typename T>
int forward(const void* q, const void* k, const void* v, void* o,
            const int64_t* strides, int B, int H, int Tq, int Tk, int D,
            float scale, int causal, int tile_k, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tk < 1 ||
      (tile_k != 64 && tile_k != 128))
    return cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  return dispatch<T>(q, k, v, o, sq, sk, sv, so, B, H, Tq, Tk, D, scale,
                     causal, tile_k,
                     whole_chunks<T>(q, k, v, o, strides, D),
                     static_cast<cudaStream_t>(stream));
}

// out = {padded head_dim, key tile, stages, dynamic shared memory bytes,
// warps a block} of the instance forward() launches for (D, tile_k).
template <typename T>
int instance(int D, int tile_k, int* out) {
  if (D < 1 || D > 256 || (tile_k != 64 && tile_k != 128))
    return cudaErrorInvalidValue;
  const Instance r = instance_of<T>(D, tile_k);
  out[0] = r.d;
  out[1] = r.tile_k;
  out[2] = r.stages;
  out[3] = r.smem;
  out[4] = r.warps;
  return cudaSuccess;
}

}  // namespace

#if MX_FLASH_DTYPE == 0
using FlashT = float;
#elif MX_FLASH_DTYPE == 1
using FlashT = __nv_bfloat16;
#elif MX_FLASH_DTYPE == 2
using FlashT = __half;
#else
#error "build once a dtype: -DMX_FLASH_DTYPE=0 (float32), 1 (bf16) or 2 (f16)"
#endif

extern "C" {

int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, const int64_t* strides, int B, int H,
                            int Tq, int Tk, int D, float scale, int causal,
                            int tile_k, void* stream) {
  return forward<FlashT>(q, k, v, o, strides, B, H, Tq, Tk, D, scale, causal,
                         tile_k, stream);
}

int flash_attention_instance(int D, int tile_k, int* out) {
  return instance<FlashT>(D, tile_k, out);
}

int flash_attention_whole_chunks(const void* q, const void* k, const void* v,
                                 const void* o, const int64_t* strides,
                                 int D) {
  return whole_chunks<FlashT>(q, k, v, o, strides, D);
}

}  // extern "C"
